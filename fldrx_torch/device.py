"""The device rule of the port's entry points: `None` means cuda, and cuda
without a GPU raises rather than falling back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means cuda; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return dev
