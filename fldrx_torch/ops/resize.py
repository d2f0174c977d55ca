"""Bicubic / bilinear resize with PyTorch `F.interpolate` semantics
(align_corners=False by default), as two dense matrix contractions
out = W_h @ img @ W_w^T with interpolation matrices built once in float64
on the host — the same formulation as fldrx/ops/resize.py, so the two
packages agree to float32 rounding.

The products stay float32. On the card TF32 must be off for them
(`torch.backends.cuda.matmul.allow_tf32 = False`, the PyTorch default;
the Interpolator sets it): TF32 would cost about 1e-3.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_2d"]


def _cubic_weight(t: np.ndarray, A: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys); PyTorch uses A = -0.75."""
    t = np.abs(t)
    t2 = t * t
    t3 = t2 * t
    return np.where(
        t <= 1.0,
        (A + 2.0) * t3 - (A + 3.0) * t2 + 1.0,
        np.where(t < 2.0, A * t3 - 5.0 * A * t2 + 8.0 * A * t - 4.0 * A, 0.0),
    )


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int, mode: str,
                      align_corners: bool) -> np.ndarray:
    """Dense [out_size, in_size] interpolation matrix, float64 (read-only)."""
    if in_size == out_size:
        W = np.eye(out_size, dtype=np.float64)
        W.flags.writeable = False
        return W
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * scale
    else:
        scale = in_size / out_size
        src = (dst + 0.5) * scale - 0.5

    W = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    if mode == "bilinear":
        # PyTorch clamps src to >= 0 before taking floor (upsample_linear1d)
        src_c = np.maximum(src, 0.0)
        i0 = np.clip(np.floor(src_c).astype(np.int64), 0, in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        frac = src_c - i0
        np.add.at(W, (rows, i0), 1.0 - frac)
        np.add.at(W, (rows, i1), frac)
    elif mode == "bicubic":
        # 4 taps around floor(src); out-of-range taps clamp (replicate)
        i_base = np.floor(src).astype(np.int64)
        frac = src - i_base
        for k in range(-1, 3):
            idx = np.clip(i_base + k, 0, in_size - 1)
            np.add.at(W, (rows, idx), _cubic_weight(k - frac))
    else:
        raise ValueError(f"unknown resize mode: {mode}")
    W.flags.writeable = False
    return W


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, mode: str,
                   align_corners: bool, device: torch.device) -> torch.Tensor:
    """[out_size, in_size] float32 matrix on `device`, shared (read only):
    one host-to-device copy per (shape, device), not one per call. Made
    outside inference mode, so that training may use a matrix that
    inference cached."""
    with torch.inference_mode(False):
        return torch.as_tensor(
            _resize_matrix_np(in_size, out_size, mode,
                              align_corners).astype(np.float32), device=device)


def resize_2d(x: torch.Tensor, out_hw, mode: str = "bicubic",
              align_corners: bool = False) -> torch.Tensor:
    """Resize a [..., H, W, C] float32 tensor to `out_hw = (H', W')`.

    Equivalent to F.interpolate(x_nchw, size=out_hw, mode=mode,
    align_corners=align_corners) up to float accumulation order."""
    H, W = x.shape[-3], x.shape[-2]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if (out_h, out_w) == (H, W):
        return x
    Wh = _resize_matrix(H, out_h, mode, align_corners, x.device)
    Ww = _resize_matrix(W, out_w, mode, align_corners, x.device)
    xf = x.float()
    y = torch.einsum("oh,...hwc->...owc", Wh, xf)
    y = torch.einsum("pw,...owc->...opc", Ww, y)
    return y.to(x.dtype)
