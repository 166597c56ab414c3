"""K5: qk-norm and RoPE of q and k in one pass (CUDA, `csrc/qk_rope.cu`).

At inference `models.attention._project_qkv` hands q (b, s, qh, hd) and k
(b, s, kvh, hd) to the op ``repro_torch::qk_norm_rope``: Qwen3's qk-norm
(an RMS over head_dim times a float32 scale, where scales are given), then
RoPE at `positions`, each result in its input's dtype. It replaces no
Pallas kernel: the reference leaves both to XLA. The CUDA source says what
bounds it and how its design answers that.

Dispatch as K1's: the op sends CPU tensors to `qk_norm_rope_ref`, the plain
chain of `models.layers` (`rms_norm_headwise`, `rope_tables`, `apply_rope`),
CUDA tensors to the kernel (or the call raises), and fake or meta tensors
to its fake implementation (shapes and types only). The kernel launches on
the current stream, never synchronises and allocates nothing; the wrapper
allocates the outputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import apply_rope, rms_norm_headwise, rope_tables

#: the head_dims and dtypes the kernel takes; `takes` tells a caller
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
POSITION_DTYPES = (torch.int32, torch.int64)

KERNEL = _build.Kernel(
    "qk_norm_rope",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2,
)


def takes(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor) -> bool:
    """Whether K5 computes qk-norm and RoPE of these q, k and positions:
    CUDA tensors on one device, q and k 4-D of one dtype it reads and one
    head_dim it takes, positions (b, s) integers."""
    return (q.is_cuda and k.device == q.device and positions.device == q.device
            and q.dtype in DTYPES and k.dtype == q.dtype
            and q.dim() == 4 and k.dim() == 4 and q.shape[-1] in HEAD_DIMS
            and k.shape[-1] == q.shape[-1] and k.shape[:2] == q.shape[:2]
            and positions.dtype in POSITION_DTYPES and positions.shape == q.shape[:2])


def qk_norm_rope(q, k, q_scale, k_scale, positions, theta, eps=1e-6):
    """qk-norm (where `q_scale` and `k_scale` are given, each (hd,)) and RoPE
    of q (b, s, qh, hd) and k (b, s, kvh, hd) at `positions` (b, s) with
    base `theta`. Returns (q, k), new tensors in the inputs' dtype."""
    return torch.ops.repro_torch.qk_norm_rope.default(q, k, q_scale, k_scale, positions,
                                                      float(theta), float(eps))


def qk_norm_rope_ref(q, k, q_scale, k_scale, positions, theta, eps):
    """The plain chain: what `_project_qkv` runs without K5."""
    if q_scale is not None:
        q = rms_norm_headwise(q, q_scale, eps)
        k = rms_norm_headwise(k, k_scale, eps)
    cos, sin = rope_tables(positions, q.shape[-1], theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _qk_norm_rope_cuda(q, k, q_scale, k_scale, positions, theta, eps):
    if not takes(q, k, positions):
        raise ValueError(
            f"qk_norm_rope takes CUDA q (b, s, qh, hd) and k (b, s, kvh, hd) of one dtype in "
            f"{DTYPES} with hd in {HEAD_DIMS}, and positions (b, s) in {POSITION_DTYPES}; got q "
            f"{tuple(q.shape)} {q.dtype} {q.device}, k {tuple(k.shape)} {k.dtype} {k.device}, "
            f"positions {tuple(positions.shape)} {positions.dtype} {positions.device}")
    if (q_scale is None) != (k_scale is None):
        raise ValueError("qk_norm_rope takes both scales or neither")
    b, s, qh, hd = q.shape
    kvh = k.shape[2]
    if b * s >= 2**31:
        raise ValueError(f"qk_norm_rope takes fewer than 2^31 tokens, got {b} x {s}")
    if q_scale is not None:
        q_scale, k_scale = (t.to(device=q.device, dtype=torch.float32).contiguous()
                            for t in (q_scale, k_scale))
        if q_scale.shape != (hd,) or k_scale.shape != (hd,):
            raise ValueError(f"qk_norm_rope's scales must be ({hd},), got "
                             f"{tuple(q_scale.shape)} and {tuple(k_scale.shape)}")
    q, k = q.contiguous(), k.contiguous()
    for name, t in (("q", q), ("k", k)):
        if t.data_ptr() % (hd // 32 * t.element_size()):
            raise ValueError(f"qk_norm_rope reads {name} in vectors of {hd // 32} elements: its "
                             f"start must be aligned to them")
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    sb, ss = positions.stride()
    KERNEL(q.device, q.data_ptr(), k.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
           None if q_scale is None else q_scale.data_ptr(),
           None if k_scale is None else k_scale.data_ptr(), positions.data_ptr(),
           int(positions.dtype == torch.int64), sb, ss, b, s, qh, kvh, hd,
           int(q.dtype == torch.bfloat16), theta, eps)
    return q_out, k_out


def _qk_norm_rope_fake(q, k, q_scale, k_scale, positions, theta, eps):
    return q.new_empty(q.shape), k.new_empty(k.shape)


_build.define_op("qk_norm_rope(Tensor q, Tensor k, Tensor? q_scale, Tensor? k_scale, "
                 "Tensor positions, float theta, float eps) -> (Tensor, Tensor)",
                 _qk_norm_rope_cuda, qk_norm_rope_ref, _qk_norm_rope_fake)
