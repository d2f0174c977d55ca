"""Test-time padding: reflect-pad H, W on the bottom/right up to the
configuration's divisibility (reference main.py:842-849)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pad_amount", "pad_frames"]


def pad_amount(size: int, div: int) -> int:
    return (div - size % div) % div


def pad_frames(frames: torch.Tensor, div: int,
               mode: str = "reflect") -> torch.Tensor:
    """Pad [B, T, H, W, C] on bottom/right so H and W are multiples of `div`.

    'reflect' mirrors without repeating the edge (torch F.pad 'reflect',
    numpy/JAX pad 'reflect'; a pad longer than the frame mirrors the padded
    frame again, as numpy's and JAX's do); any other mode pads with zeros."""
    B, T, H, W, C = frames.shape
    ph, pw = pad_amount(H, div), pad_amount(W, div)
    if ph == 0 and pw == 0:
        return frames
    x = frames.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    if mode != "reflect":
        x = F.pad(x, (0, pw, 0, ph), mode="constant")
    else:
        # F.pad reflects at most size - 1 rows or columns at a time (at
        # least 1: a frame of one row or column raises there, not loops)
        left_h, left_w = ph, pw
        while left_h or left_w:
            kh = min(left_h, max(x.shape[2] - 1, 1))
            kw = min(left_w, max(x.shape[3] - 1, 1))
            x = F.pad(x, (0, kw, 0, kh), mode="reflect")
            left_h, left_w = left_h - kh, left_w - kw
    return x.permute(0, 2, 3, 1).reshape(B, T, H + ph, W + pw, C)
