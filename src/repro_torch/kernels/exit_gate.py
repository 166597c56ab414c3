"""K1: fused early-exit gate (CUDA, `csrc/exit_gate.cu`).

Per row of a (rows, vocab) logits matrix and a scalar temperature:
    confidence = max softmax(z / T) = 1 / S
    entropy    = H(softmax(z / T)) = log S - W / S     (nats)
    argmax     = argmax z / T, first index on ties
without materialising the softmax: one online pass keeps (m, S, W, idx)
per row. Port of `repro.kernels.exit_gate.exit_gate_kernel`; the CUDA
source says what bounds it and how its design answers that.

Dispatch: `exit_gate_kernel` calls the op ``repro_torch::exit_gate``.
The dispatcher sends a CPU tensor to `ref.exit_gate_ref`, a CUDA tensor to
the kernel (or the call raises), and a fake or meta tensor to the op's
fake implementation, which only makes outputs of the right shape and
type: a traced step (`launch.hlo_cost`) never reads a `data_ptr()`. The
op's FLOP formula counts 6 operations a logit (divide, subtract, exp, and
the running max, sum and entropy sum), the work `PERF.md`'s bound assumes.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import exit_gate_ref

#: operations per logit, for the FLOP counter and the roofline bound
FLOPS_PER_LOGIT = 6

KERNEL = _build.Kernel(
    "exit_gate",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)


def exit_gate_kernel(logits: torch.Tensor, temperature=1.0):
    """logits: (rows, vocab) float32 or bfloat16; temperature: scalar.
    Returns (conf float32, ent float32, idx int32), each (rows,)."""
    return torch.ops.repro_torch.exit_gate.default(logits, float(temperature))


def _exit_gate_cuda(logits, temperature):
    _build.check_cuda_tensor(logits, "logits", (torch.float32, torch.bfloat16), 2)
    rows, vocab = logits.shape
    if vocab < 1 or rows >= 2**31 or vocab >= 2**31:
        raise ValueError(f"exit_gate takes 1 <= vocab and dims < 2^31, got {tuple(logits.shape)}")
    conf = torch.empty(rows, dtype=torch.float32, device=logits.device)
    ent = torch.empty(rows, dtype=torch.float32, device=logits.device)
    idx = torch.empty(rows, dtype=torch.int32, device=logits.device)
    KERNEL(logits.device, logits.data_ptr(), int(logits.dtype == torch.bfloat16), rows, vocab,
           temperature, conf.data_ptr(), ent.data_ptr(), idx.data_ptr())
    return conf, ent, idx


def _exit_gate_fake(logits, temperature):
    rows = logits.shape[0]
    return (logits.new_empty(rows, dtype=torch.float32), logits.new_empty(rows, dtype=torch.float32),
            logits.new_empty(rows, dtype=torch.int32))


_build.define_op("exit_gate(Tensor logits, float temperature) -> (Tensor, Tensor, Tensor)",
                 _exit_gate_cuda, exit_gate_ref, _exit_gate_fake)


@register_flop_formula(torch.ops.repro_torch.exit_gate)
def _exit_gate_flops(logits_shape, *args, **kwargs) -> int:
    rows, vocab = logits_shape
    return FLOPS_PER_LOGIT * rows * vocab
