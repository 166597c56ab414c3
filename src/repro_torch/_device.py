"""Device resolution shared by the port's entry points."""
from __future__ import annotations

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
