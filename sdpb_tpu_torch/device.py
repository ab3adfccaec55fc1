"""Device selection for the port's entry points: CUDA unless the
caller asks for the CPU; never a silent fall back."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda:0, raising when no CUDA device is present;
    anything else is taken as given (e.g. "cpu" for tests)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda", 0)
