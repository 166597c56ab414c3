"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises when no GPU is
    present and none was named, so nothing silently runs on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def rank_device(device=None, local_rank: int = 0,
                local_world: int = 1) -> Tuple[torch.device, str]:
    """The device and the process-group backend of local rank
    `local_rank` of `local_world` ranks on this machine.

    * ``cuda:LOCAL_RANK`` with NCCL when the machine has a card per rank;
    * ``cuda:0`` with gloo for every rank when the ranks outnumber the
      cards (NCCL refuses two ranks on one card);
    * the CPU with gloo only when the caller names ``"cpu"``.

    Without a GPU and without a named device it raises, as
    `resolve_device` does; a named device other than ``"cpu"`` or
    ``"cuda"`` is an error, never a silent switch."""
    if not 0 <= local_rank < local_world:
        raise ValueError(f"local rank {local_rank} is not one of {local_world} ranks")
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), "gloo"
    if device is not None and torch.device(device) != torch.device("cuda"):
        raise ValueError(f"a rank takes device None, 'cuda' or 'cpu', not {device!r}: "
                         "its card follows from LOCAL_RANK")
    resolve_device(None)  # raises without a GPU
    n = torch.cuda.device_count()
    if n >= local_world:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def same_device(a, b) -> bool:
    """Whether two devices are one (``cuda`` names the current card, so it
    matches ``cuda:0`` there)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda":
        ia = torch.cuda.current_device() if a.index is None else a.index
        ib = torch.cuda.current_device() if b.index is None else b.index
        return ia == ib
    return a.index is None or b.index is None or a.index == b.index


def require_device(actual, device, what: str):
    """Raise ValueError unless `actual` is `device`: nothing is moved
    between devices behind the caller's back."""
    if not same_device(actual, device):
        raise ValueError(f"{what} live on {actual}, not on {device}")


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor stays on its own device (cast to `dtype` if given); anything
    else (numpy, lists) lands on `resolve_device(device)`."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve_device(device))


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (copied off the card) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
