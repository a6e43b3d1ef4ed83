"""Where the port's tensors live: CUDA by default, the CPU only when the
caller asks for it, and an error when CUDA was wanted but is absent.
There is no silent fallback."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` must be asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "arrow1_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
