"""K2: fused calibration-NLL statistics (CUDA, `csrc/calib_nll.cu`).

Temperature Scaling fits T by minimizing
    NLL(T) = mean_r [ logsumexp(z_r / T) - z_{r,y_r} / T ].
Each Newton iteration needs NLL and its first two derivatives in T, which
reduce to four streaming row statistics (E_p[z], E_p[z^2], z_y, nll) at
p = softmax(z/T): one pass over the logits per iteration. Port of
`repro.kernels.calib_nll.calib_nll_kernel`; the CUDA source says what
bounds it and how its design answers that.

Dispatch: `calib_nll_kernel` calls the op ``repro_torch::calib_nll``.
The dispatcher sends CPU tensors to `ref.calib_nll_ref`, CUDA tensors to
the kernel (or the call raises), and fake or meta tensors to the op's
fake implementation, which reads no data. The op's FLOP formula counts
10 operations a logit (divide, subtract, exp, the sums S, W1 = sum z*e
and W2 = sum z^2*e and the running max), the work `PERF.md`'s bound
assumes.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import calib_nll_ref

#: operations per logit, for the FLOP counter and the roofline bound
FLOPS_PER_LOGIT = 10

KERNEL = _build.Kernel(
    "calib_nll",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)


def calib_nll_kernel(logits: torch.Tensor, labels: torch.Tensor, temperature):
    """logits (rows, vocab) float32 (on the card bfloat16 too, read as it
    is), labels (rows,) int32 with values in [0, vocab), temperature a
    scalar or a one-element float32 tensor (on the card it stays there, so
    a Newton loop never syncs).

    Returns (e1, e2, zy, nll), each (rows,) float32.
    """
    t = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device).reshape(1)
    return torch.ops.repro_torch.calib_nll.default(logits, labels, t)


def _calib_nll_cuda(logits, labels, t):
    _build.check_cuda_tensor(logits, "logits", (torch.float32, torch.bfloat16), 2)
    _build.check_cuda_tensor(labels, "labels", (torch.int32,), 1)
    rows, vocab = logits.shape
    if labels.shape[0] != rows:
        raise ValueError(f"labels has {labels.shape[0]} rows, logits {rows}")
    if vocab < 1 or rows >= 2**31 or vocab >= 2**31:
        raise ValueError(f"calib_nll takes 1 <= vocab and dims < 2^31, got {tuple(logits.shape)}")
    outs = [torch.empty(rows, dtype=torch.float32, device=logits.device) for _ in range(4)]
    KERNEL(logits.device, logits.data_ptr(), int(logits.dtype == torch.bfloat16),
           labels.data_ptr(), t.data_ptr(), rows, vocab, *(o.data_ptr() for o in outs))
    return tuple(outs)


def _calib_nll_cpu(logits, labels, t):
    return calib_nll_ref(logits, labels, t.reshape(()))


def _calib_nll_fake(logits, labels, t):
    return tuple(logits.new_empty(logits.shape[0], dtype=torch.float32) for _ in range(4))


_build.define_op("calib_nll(Tensor logits, Tensor labels, Tensor t) -> (Tensor, Tensor, Tensor, "
                 "Tensor)", _calib_nll_cuda, _calib_nll_cpu, _calib_nll_fake)


@register_flop_formula(torch.ops.repro_torch.calib_nll)
def _calib_nll_flops(logits_shape, *args, **kwargs) -> int:
    rows, vocab = logits_shape
    return FLOPS_PER_LOGIT * rows * vocab
