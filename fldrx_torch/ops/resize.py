"""Bicubic / bilinear / nearest resize with PyTorch `F.interpolate` semantics
(align_corners=False by default), in two forms that share one coefficient
matrix per axis, built once in float64 on the host (`_resize_matrix_np`,
the formulation of fldrx/ops/resize.py, so the two packages agree to
float32 rounding):

* the dense form, out = W_h @ img @ W_w^T as two float32 einsums against
  the [out, in] matrices: a CPU tensor, and a CUDA tensor while grad mode
  is on (a training step: the flows' gradients come from it, and the
  step's other resizes stay as they were, so that its values, and the
  agreement of a data-parallel step with a single process, do not move
  for ≈0.4 ms of a ≈120 ms step). On the card TF32 must be off for them
  (`torch.backends.cuda.matmul.allow_tf32 = False`, the PyTorch default;
  the Interpolator sets it): TF32 would cost about 1e-3.
* the tap form, a CUDA tensor under no_grad or inference_mode: the
  `resize_taps_kernel` of csrc/resize.cu (built at first use, see
  ops/_build.py) applies each matrix's nonzeros (`_taps_np`: 4 taps a row for bicubic, 2 for bilinear,
  1 for nearest), rows first as the dense form, in one launch a call, or
  raises. `resize_taps_plain` is its arithmetic in PyTorch, equal to it bit
  for bit; `LAUNCHES` counts the launches.

The two forms differ only in the order of the float32 sums, within about
1e-7 relative.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..utils import trace
from . import _build

__all__ = ["resize_2d", "resize_taps_plain", "LAUNCHES"]

LAUNCHES = trace.counters("resize", {"resize": 0})

# the kernel's tiles: output elements (columns × C) a block of 256 threads,
# and the rows pass's footprint (input columns × C) in shared memory
TILE_ELEMS = 2048
SMEM_FLOATS = 4096


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
    elif mode == "nearest":
        # PyTorch 'nearest': src = floor(dst * in/out)
        idx = np.floor(dst * (in_size / out_size)).astype(np.int64)
        W[rows, np.clip(idx, 0, in_size - 1)] = 1.0
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


@functools.lru_cache(maxsize=None)
def _taps_np(in_size: int, out_size: int, mode: str,
             align_corners: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The nonzeros of `_resize_matrix_np`'s rows as tap tables: (idx
    [out, K] int32, ascending, and w [out, K] float32, the dense matrix's
    float32 values), K the most nonzeros of a row rounded up to 1, 2 or 4;
    a shorter row is padded with weight 0 at its last column. Clamped taps
    that fall on one edge column were merged by np.add.at, so both forms
    use the same coefficients. Read-only."""
    M = _resize_matrix_np(in_size, out_size, mode,
                          align_corners).astype(np.float32)
    rows, cols = np.nonzero(M)              # row-major: columns ascending
    count = np.bincount(rows, minlength=out_size)
    most = int(count.max())
    K = 1 if most <= 1 else 2 if most == 2 else 4
    k = np.arange(K)
    at = (np.cumsum(count) - count)[:, None] + np.minimum(k, count[:, None] - 1)
    idx = cols[at].astype(np.int32)
    w = np.where(k < count[:, None], M[rows[at], cols[at]], 0).astype(
        np.float32)
    idx.flags.writeable = False
    w.flags.writeable = False
    return idx, w


@functools.lru_cache(maxsize=256)
def _taps(in_size: int, out_size: int, mode: str, align_corners: bool,
          device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_taps_np`'s tables on `device`, shared (read only): one
    host-to-device copy each per (shape, device), made outside inference
    mode as `_resize_matrix`."""
    idx, w = _taps_np(in_size, out_size, mode, align_corners)
    with torch.inference_mode(False):
        return (torch.tensor(idx, device=device),
                torch.tensor(w, device=device))


@functools.lru_cache(maxsize=None)
def _tile_np(in_size: int, out_size: int, mode: str, align_corners: bool,
             C: int) -> Tuple[int, int, np.ndarray]:
    """(tw, floats, spans): the most output columns a block takes (a power
    of two, at most TILE_ELEMS elements) whose widest footprint fits
    SMEM_FLOATS; that footprint in floats; and each tile's first and last
    input column [tiles, 2] int32 (the taps of an exact sample, which has
    one, may lie inside its neighbours', so neither end is monotonic)."""
    idx, _ = _taps_np(in_size, out_size, mode, align_corners)
    tw = 1 << (out_size - 1).bit_length()
    while tw > 1 and tw * C > TILE_ELEMS:
        tw //= 2
    while True:
        first = np.arange(0, out_size, tw)
        spans = np.stack([np.minimum.reduceat(idx[:, 0], first),
                          np.maximum.reduceat(idx[:, -1], first)], 1)
        floats = int((spans[:, 1] - spans[:, 0] + 1).max()) * C
        if floats <= SMEM_FLOATS:
            spans = spans.astype(np.int32)
            spans.flags.writeable = False
            return tw, floats, spans
        if tw == 1:
            raise ValueError(f"resize_2d: {C} channels do not fit the "
                             "kernel's shared memory")
        tw //= 2


@functools.lru_cache(maxsize=256)
def _tile(in_size: int, out_size: int, mode: str, align_corners: bool,
          C: int, device: torch.device) -> Tuple[int, int, torch.Tensor]:
    """`_tile_np` with its spans on `device` (one copy per key)."""
    tw, floats, spans = _tile_np(in_size, out_size, mode, align_corners, C)
    with torch.inference_mode(False):
        return tw, floats, torch.tensor(spans, device=device)


def resize_taps_plain(x: torch.Tensor, out_hw, mode: str = "bicubic",
                      align_corners: bool = False) -> torch.Tensor:
    """Plain version of the tap kernel: the same taps in the same order,
    rows then columns, each sum in tap order (`resize_2d`'s values within
    float32 summation order; the kernel's bit for bit)."""
    H, W = x.shape[-3], x.shape[-2]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if (out_h, out_w) == (H, W):
        return x
    iy, wy = (torch.tensor(a, device=x.device)
              for a in _taps_np(H, out_h, mode, align_corners))
    ix, wx = (torch.tensor(a, device=x.device)
              for a in _taps_np(W, out_w, mode, align_corners))
    xf = x.float()
    rows = None
    for i in range(iy.shape[1]):
        term = wy[:, i, None, None] * xf.index_select(-3, iy[:, i].long())
        rows = term if rows is None else rows + term
    out = None
    for j in range(ix.shape[1]):
        term = wx[:, j, None] * rows.index_select(-2, ix[:, j].long())
        out = term if out is None else out + term
    return out.to(x.dtype)


def _resize_taps(x: torch.Tensor, out_h: int, out_w: int, mode: str,
                 align_corners: bool) -> torch.Tensor:
    """One launch of csrc/resize.cu on a CUDA tensor [..., H, W, C]."""
    *lead, H, W, C = x.shape
    if not 1 <= C <= 4:
        raise ValueError(f"resize_2d: the kernel takes 1 to 4 channels, got "
                         f"{C}")
    xf = x.float().reshape(-1, H, W, C)
    N = xf.shape[0]
    iy, wy = _taps(H, out_h, mode, align_corners, x.device)
    ix, wx = _taps(W, out_w, mode, align_corners, x.device)
    tw, floats, spans = _tile(W, out_w, mode, align_corners, C, x.device)
    out = torch.empty((N, out_h, out_w, C), dtype=torch.float32,
                      device=x.device)
    strides = (ctypes.c_longlong * 4)(*xf.stride())
    err = _build.library("resize").fldrx_resize_taps_f32(
        xf.data_ptr(), ctypes.addressof(strides), N, H, W, C,
        iy.data_ptr(), wy.data_ptr(), iy.shape[1],
        ix.data_ptr(), wx.data_ptr(), ix.shape[1], out_h, out_w, tw,
        spans.data_ptr(), floats, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "resize")
    LAUNCHES["resize"] += 1
    return out.reshape(*lead, out_h, out_w, C).to(x.dtype)


def _resize_dense(x: torch.Tensor, out_h: int, out_w: int, mode: str,
                  align_corners: bool) -> torch.Tensor:
    H, W = x.shape[-3], x.shape[-2]
    Wh = _resize_matrix(H, out_h, mode, align_corners, x.device)
    Ww = _resize_matrix(W, out_w, mode, align_corners, x.device)
    xf = x.float()
    y = torch.einsum("oh,...hwc->...owc", Wh, xf)
    y = torch.einsum("pw,...owc->...opc", Ww, y)
    return y.to(x.dtype)


def resize_2d(x: torch.Tensor, out_hw, mode: str = "bicubic",
              align_corners: bool = False) -> torch.Tensor:
    """Resize a [..., H, W, C] float32 tensor to `out_hw = (H', W')`.

    Equivalent to F.interpolate(x_nchw, size=out_hw, mode=mode,
    align_corners=align_corners) up to float accumulation order. A CPU
    tensor, and a CUDA tensor while grad mode is on, take the dense form;
    a CUDA tensor under no_grad or inference_mode the tap kernel (a fresh
    row-major tensor)."""
    H, W = x.shape[-3], x.shape[-2]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if (out_h, out_w) == (H, W):
        return x
    if _takes_kernel(x):
        return _resize_taps(x, out_h, out_w, mode, align_corners)
    return _resize_dense(x, out_h, out_w, mode, align_corners)


def _takes_kernel(x) -> bool:
    """The tap kernel takes a CUDA tensor while grad mode is off."""
    return x.is_cuda and not torch.is_grad_enabled()
