"""Max-plus semiring solvers for deterministic-service FIFO queues.

The FIFO recurrence

    done_i = max(t_i, done_{i-1}) + s_i

is an affine map over the max-plus semiring: with f_i(x) = max(x + a_i, b_i),
a_i = s_i and b_i = t_i + s_i, we have done_i = (f_i . ... . f_1)(free).
The reference resolves the composed chain with `lax.associative_scan`.
On the card the composition has a closed form: with A = cumsum(a),

    done_i = A_i + max(free, max_{j<=i} (b_j - A_j))
           = A_i + max(free, cummax(t - A + a)_i),

one `torch.cumsum` and one `torch.cummax` along one axis of float64
tensors. The identity element (a, b) = (0, -inf) lets masked-out rows
pass through unchanged, as in the reference. The formula is valid for UNSORTED arrival
times t (done_i = max_{j<=i} (t_j + sum_{k=j..i} s_k) holds regardless of
ordering).

`fifo_oracle` / `kserver_oracle` are the deliberately naive per-request
Python references; `tests/test_torch_maxplus.py` pins the solvers against
them (exactly, on dyadic-rational inputs where float addition is exact).

Port of `repro.fleet.maxplus`. The reference pads chains to powers of two
for JAX's compile cache; eager PyTorch compiles nothing, so nothing is
padded. `fifo_done_maxplus` and `kserver_done_maxplus` run on `device`
(``cuda`` unless the caller names the CPU; without a GPU they raise).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = [
    "fifo_oracle",
    "kserver_oracle",
    "maxplus_fifo",
    "fifo_done_maxplus",
    "kserver_done_maxplus",
]


def fifo_oracle(t, service, free_s: float = 0.0) -> np.ndarray:
    """Per-request Python FIFO: the ground-truth oracle for the solvers."""
    t = np.asarray(t, dtype=np.float64)
    service = np.asarray(service, dtype=np.float64)
    done = np.empty(t.shape[0], dtype=np.float64)
    prev = float(free_s)
    for i in range(t.shape[0]):
        prev = max(float(t[i]), prev) + float(service[i])
        done[i] = prev
    return done


def kserver_oracle(t, service, k: int) -> np.ndarray:
    """Naive K-server FIFO: each job goes to the earliest-free server.

    With constant service times this matches the residue-class decomposition
    (job i waits for job i-K) used by the fleet cloud tier.
    """
    t = np.asarray(t, dtype=np.float64)
    service = np.asarray(service, dtype=np.float64)
    free = [0.0] * int(k)
    done = np.empty(t.shape[0], dtype=np.float64)
    for i in range(t.shape[0]):
        r = min(range(len(free)), key=lambda j: free[j])
        d = max(float(t[i]), free[r]) + float(service[i])
        free[r] = d
        done[i] = d
    return done


def maxplus_fifo(t: torch.Tensor, service: torch.Tensor, mask: torch.Tensor,
                 free, dim: int = 0) -> torch.Tensor:
    """Masked FIFO completion times along axis `dim` (tensor -> tensor).

    Every 1-D slice along `dim` is its own chain; `free` broadcasts against
    the output. Entries with ``mask == False`` are the semiring identity;
    their output positions are undefined and must be re-masked by the
    caller. On the card torch's scans are fastest along the innermost
    axis, so the compiled fleet keeps its chains on ``dim=-1``.
    """
    a = torch.where(mask, service, torch.zeros_like(service))
    acc = torch.cumsum(a, dim=dim)
    # b_j - A_j = t_j - A_{j-1}: the host `fifo_done` algebra
    x = torch.where(mask, t - (acc - a), torch.full_like(t, -torch.inf))
    run = torch.cummax(x, dim=dim).values
    free = torch.as_tensor(free, dtype=run.dtype, device=run.device)
    return acc + torch.maximum(run, free)


def _columns(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def fifo_done_maxplus(t, service, free_s: float = 0.0, device=None) -> np.ndarray:
    """Host-callable max-plus FIFO solver (float64 on `device`)."""
    dev = resolve_device(device)
    t, service = _columns(t, dev), _columns(service, dev)
    if t.shape[0] == 0:
        return np.empty(0, dtype=np.float64)
    mask = torch.ones(t.shape, dtype=torch.bool, device=dev)
    return maxplus_fifo(t, service, mask, float(free_s)).cpu().numpy()


def kserver_done_maxplus(t, service, k: int, device=None) -> np.ndarray:
    """K-server completion times via residue-class max-plus chains.

    Jobs must already be in FIFO order; chain r serves jobs r, r+K, r+2K, ...
    exactly as the fleet cloud tier decomposes its shared servers. All K
    chains solve in one call on a (ceil(n/K), K) view, whose padded tail
    is masked out.
    """
    dev = resolve_device(device)
    t, service = _columns(t, dev), _columns(service, dev)
    n, k = t.shape[0], int(k)
    if n == 0:
        return np.empty(0, dtype=np.float64)
    rows = -(-n // k)
    pad = rows * k - n

    def view(x):
        return torch.cat([x, x.new_zeros(pad)]).reshape(rows, k)

    mask = view(torch.ones(n, dtype=torch.bool, device=dev))
    done = maxplus_fifo(view(t), view(service), mask, 0.0)
    return done.reshape(-1)[:n].cpu().numpy()
