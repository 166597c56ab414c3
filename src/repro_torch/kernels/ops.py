"""Public wrappers around the kernels.

Handle arbitrary leading dims and the CPU-vs-CUDA dispatch (inputs that
are not tensors land on `device`, ``cuda`` by default). `exit_gate` is
what `repro_torch.core.exits.gate_statistics` calls. Port of
`repro.kernels.ops`; the kernels mask their ragged edges, so nothing here
pads.
"""
from __future__ import annotations

import torch

from repro_torch._device import as_tensor
from repro_torch.kernels.calib_nll import calib_nll_kernel
from repro_torch.kernels.exit_gate import exit_gate_kernel


def exit_gate(logits, temperature=1.0, device=None):
    """(confidence, prediction, entropy) of softmax(logits/T).

    logits: (..., vocab). Same return order as
    `repro_torch.core.exits.gate_statistics`.
    """
    logits = as_tensor(logits, device)
    shape = logits.shape
    conf, ent, idx = exit_gate_kernel(logits.reshape(-1, shape[-1]).contiguous(), temperature)
    lead = shape[:-1]
    return conf.reshape(lead), idx.reshape(lead), ent.reshape(lead)


def _calib_logits(logits, device):
    """K2's logits: float32, except that a bfloat16 CUDA tensor stays
    bfloat16, which the kernel reads natively."""
    if isinstance(logits, torch.Tensor) and logits.is_cuda and logits.dtype == torch.bfloat16:
        return logits.contiguous()
    return as_tensor(logits, device, torch.float32).contiguous()


def calib_stats(logits, labels, temperature, device=None):
    """One-pass Newton statistics for Temperature Scaling over (N, vocab)
    validation logits: returns (nll_mean, dNLL/dT, d2NLL/dT2).

        dNLL/dT   = mean (z_y - E_p[z]) / T^2
        d2NLL/dT2 = mean [ -2 (z_y - E_p[z]) / T^3 + Var_p[z] / T^4 ]
    """
    z = _calib_logits(logits, device)
    y = as_tensor(labels, z.device).to(device=z.device, dtype=torch.int32).contiguous()
    return newton_stats(*calib_nll_kernel(z, y, temperature), temperature)


def newton_stats(e1, e2, zy, nll, temperature):
    """Reduce the per-row K2 statistics to (nll_mean, dNLL/dT, d2NLL/dT2)."""
    t = torch.as_tensor(temperature, dtype=torch.float32, device=e1.device)
    var = e2 - e1 * e1
    d1 = torch.mean((zy - e1) / (t * t))
    d2 = torch.mean(-2.0 * (zy - e1) / t**3 + var / t**4)
    return torch.mean(nll), d1, d2


def fit_temperature_kernel(logits, labels, t0=1.0, iters: int = 25,
                           t_min: float = 0.05, t_max: float = 20.0, device=None):
    """Newton's method on T using the fused one-pass kernel statistics:
    `iters` steps, each clipped to +-T/2, T clipped to [t_min, t_max].
    T stays a device scalar, so the loop never waits on the host.
    Returns (T, nll at the last step's input T), both 0-d tensors."""
    z = _calib_logits(logits, device)
    y = as_tensor(labels, z.device).to(device=z.device, dtype=torch.int32).contiguous()
    t = torch.full((), float(t0), dtype=torch.float32, device=z.device)
    nll = torch.full((), float("nan"), dtype=torch.float32, device=z.device)
    for _ in range(iters):
        nll, d1, d2 = calib_stats(z, y, t)
        delta = torch.where(d2.abs() > 1e-12, d1 / d2, torch.sign(d1) * 0.1)
        delta = torch.minimum(torch.maximum(delta, -0.5 * t), 0.5 * t)
        t = torch.clamp(t - delta, t_min, t_max)
    return t, nll
