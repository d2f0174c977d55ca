"""The packed synthesis's layouts: the refine UNet's space-to-depth input,
and the u-plane layout of its output with its unpacks (counterpart of
fldrx/ops/repack.py).

`pack_s2d4` builds the UNet's input from its sources in one pass: the
channel concatenation, the cast to the UNet's dtype and the 4×4
space-to-depth (model/fldrnet.py `s2d`'s cell-major order) that the plain
version, `pack_s2d4_plain`, runs as three. A CUDA tensor launches the
`pack_s2d4_kernel` of csrc/repack.cu (each source read once, the output
written once: bytes bound it); a CPU tensor takes the plain version. fldrx
has no kernel here (it leaves its concatenation to XLA).

The u-plane form of a [H, W, C] frame is four planes [4, H/4, W·C], where
row y of the frame is row y//4 of plane y%4. The packed synthesis can
return its frames in this form (planes_out): its blend (ops/blend.py)
reads the refine UNet's space-to-depth output in place and writes either
form. Two unpacks return plain rows:

* `interleave_planes` on the device, the counterpart of fldrx's interleave
  kernel; the packed synthesis writes plain rows itself, so no model path
  launches it. A CUDA tensor launches the kernel in csrc/repack.cu (built
  at first use, see ops/_build.py) or raises; a CPU tensor takes the plain
  version. `LAUNCHES` counts kernel launches.
* `planes_to_plain_np` on the host, for frames that are fetched anyway.

`extract_planes` is the inverse, plain rows → u-planes, through the
`deinterleave_kernel` of the same source under the same rules. fldrx has no
caller of its `extract_planes`, so no model path of the port launches it;
chip_smoke.py holds it on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ..utils import trace
from . import _build

__all__ = ["interleave_planes", "interleave_planes_plain", "extract_planes",
           "extract_planes_plain", "planes_to_plain_np", "pack_s2d4",
           "pack_s2d4_plain", "LAUNCHES"]

LAUNCHES = trace.counters("repack", {"interleave": 0,
                                     "deinterleave": 0,
                                     "pack_s2d4": 0})

# pack_s2d4's limits: the kernel's source table and channels in a cell
MAX_SOURCES = 12
MAX_CHANNELS = 32


def interleave_planes_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain version of `interleave_planes`."""
    B, _, Hp4, WC = planes.shape
    return torch.stack([planes[:, u] for u in range(4)], 2).reshape(
        B, 4 * Hp4, WC)


def _check_dtype(fn: str, x: torch.Tensor) -> None:
    """The kernels move float32 and bfloat16 rows; both wrappers refuse
    any other dtype on every device, so the CPU behaves as the card."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: the repack kernels take float32 or bfloat16, "
                        f"got {x.dtype}")


def _launch(fn: str, src: torch.Tensor, shape, H: int) -> torch.Tensor:
    """Run the repack entry point `fn` on a CUDA tensor `src` of frames of
    H rows, plain or as u-planes, into a new tensor of `shape`, the other
    form."""
    if src.requires_grad:
        raise RuntimeError(f"{fn}: the kernel is inference only")
    src = src.contiguous()
    out = torch.empty(shape, dtype=src.dtype, device=src.device)
    err = getattr(_build.library("repack"), f"fldrx_{fn}")(
        src.data_ptr(), out.data_ptr(), src.shape[0], H,
        src.shape[-1] * src.element_size(),
        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, fn)
    return out


def interleave_planes(planes: torch.Tensor) -> torch.Tensor:
    """[B, 4, H/4, W·C] u-planes → [B, H, W·C] plain rows, bit-exact; on
    the card through the kernel."""
    if planes.dim() != 4 or planes.shape[1] != 4:
        raise ValueError(f"interleave_planes: planes {tuple(planes.shape)}, "
                         "expected [B, 4, H/4, W·C]")
    _check_dtype("interleave_planes", planes)
    if planes.device.type == "cpu":
        return interleave_planes_plain(planes)
    B, _, Hp4, WC = planes.shape
    out = _launch("interleave_planes", planes, (B, 4 * Hp4, WC), 4 * Hp4)
    LAUNCHES["interleave"] += 1
    return out


def extract_planes_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of `extract_planes`."""
    return torch.stack([rows[:, u::4] for u in range(4)], 1)


def extract_planes(rows: torch.Tensor) -> torch.Tensor:
    """[B, H, W·C] plain rows → [B, 4, H/4, W·C] u-planes (row y to plane
    y % 4, row y // 4), bit-exact; on the card through the kernel."""
    if rows.dim() != 3 or rows.shape[1] % 4:
        raise ValueError(f"extract_planes: rows {tuple(rows.shape)}, "
                         "expected [B, H, W·C] with H a multiple of 4")
    _check_dtype("extract_planes", rows)
    if rows.device.type == "cpu":
        return extract_planes_plain(rows)
    B, H, WC = rows.shape
    out = _launch("extract_planes", rows, (B, 4, H // 4, WC), H)
    LAUNCHES["deinterleave"] += 1
    return out


def planes_to_plain_np(a: np.ndarray) -> np.ndarray:
    """[..., 4, H/4, W·3] u-planes → [..., H, W, 3] plain rows, bit-exact."""
    lead, (_, hp4, wc) = a.shape[:-3], a.shape[-3:]
    W = wc // 3
    a = a.reshape(*lead, 4, hp4, W, 3)
    a = np.moveaxis(a, -4, -3)                 # [..., hp4, 4, W, 3]
    return np.ascontiguousarray(a).reshape(*lead, hp4 * 4, W, 3)


def pack_s2d4_plain(parts: Sequence[torch.Tensor],
                    dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `pack_s2d4`: the concatenation, the cast and the
    space-to-depth, each a pass of its own."""
    x = torch.cat(list(parts), -1).to(dtype)
    B, H, W, C = x.shape
    x = x.reshape(B, H // 4, 4, W // 4, 4, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 4, W // 4, 16 * C)


def _check_pack(parts, dtype: torch.dtype) -> int:
    """pack_s2d4's refusals, the same on every device; returns C."""
    if not 1 <= len(parts) <= MAX_SOURCES:
        raise ValueError(f"pack_s2d4: {len(parts)} sources, expected 1 to "
                         f"{MAX_SOURCES}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"pack_s2d4: output bfloat16 or float32, got {dtype}")
    lead, device = parts[0].shape[:3], parts[0].device
    C = 0
    for x in parts:
        shape = x.shape
        if len(shape) != 4 or shape[:3] != lead or shape[3] < 1:
            shapes = [tuple(p.shape) for p in parts]
            raise ValueError(f"pack_s2d4: sources {shapes}, expected "
                             "[B, H, W, c_i] with equal B, H, W")
        if x.dtype != torch.float32:
            raise TypeError(f"pack_s2d4: sources are float32, got {x.dtype}")
        if x.device != device:
            raise ValueError("pack_s2d4: sources on more than one device")
        C += shape[3]
    if lead[1] % 4 or lead[2] % 4:
        raise ValueError(f"pack_s2d4: H×W {lead[1]}×{lead[2]}, expected "
                         "multiples of 4")
    if C > MAX_CHANNELS:
        raise ValueError(f"pack_s2d4: {C} channels, at most {MAX_CHANNELS}")
    return C


def pack_s2d4(parts: Sequence[torch.Tensor],
              dtype: torch.dtype) -> torch.Tensor:
    """float32 NHWC sources [B, H, W, c_i] (H, W multiples of 4, C = Σc_i ≤
    32) → [B, H/4, W/4, 16·C] in `dtype` (bfloat16 or float32), cell-major:
    channel (u·4 + v)·C + offset_i + c holds source i's channel c at pixel
    (4·y + u, 4·x + v). Equal bit for bit to `pack_s2d4_plain` (bfloat16
    rounds to nearest even, as `.to` does). On the card one launch; a
    source is read in place where its channels are contiguous and either
    its pixels or its rows are (a view such as images[:, 0] at any batch
    stride; a flow field that a resize left W-major), else copied."""
    parts = list(parts)
    C = _check_pack(parts, dtype)
    if parts[0].device.type == "cpu":
        return pack_s2d4_plain(parts, dtype)
    B, H, W = parts[0].shape[:3]
    ptrs, strides, chans = [], [], []
    for k, x in enumerate(parts):
        if x.requires_grad:
            raise RuntimeError("pack_s2d4: the kernel is inference only")
        c = x.shape[3]
        sb, sh, sw, sc = x.stride()
        if not ((sc == 1 or c == 1) and (sw == c or sh == c)):
            x = parts[k] = x.contiguous()      # kept until the launch
            sb, sh, sw, _ = x.stride()
        ptrs.append(x.data_ptr())
        strides += [sb, sh, sw]
        chans.append(c)
    out = torch.empty((B, H // 4, W // 4, 16 * C), dtype=dtype,
                      device=parts[0].device)
    n = len(parts)
    ptrs = (ctypes.c_void_p * n)(*ptrs)
    strides = (ctypes.c_longlong * (3 * n))(*strides)
    chans = (ctypes.c_int * n)(*chans)
    err = _build.library("repack").fldrx_pack_s2d4(
        ctypes.addressof(ptrs), ctypes.addressof(strides),
        ctypes.addressof(chans), n, out.data_ptr(), B, H, W,
        int(dtype == torch.bfloat16),
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "pack_s2d4")
    LAUNCHES["pack_s2d4"] += 1
    return out
