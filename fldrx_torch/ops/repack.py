"""The u-plane layout of the packed synthesis's output, and its unpacks
(counterpart of fldrx/ops/repack.py).

The u-plane form of a [H, W, C] frame is four planes [4, H/4, W·C], where
row y of the frame is row y//4 of plane y%4. The packed synthesis blends in
this form because it reads the refine UNet's space-to-depth output in place
(model/fldrnet.py `blend6_planes`). Two unpacks return plain rows:

* `interleave_planes` on the device. A CUDA tensor launches the kernel in
  csrc/repack.cu (built at first use, see ops/_build.py) or raises; a CPU
  tensor takes the plain version. `LAUNCHES` counts kernel launches.
* `planes_to_plain_np` on the host, for frames that are fetched anyway.

`extract_planes` is the inverse, plain rows → u-planes, through the
`deinterleave_kernel` of the same source under the same rules. fldrx has no
caller of its `extract_planes`, so no model path of the port launches it;
chip_smoke.py holds it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from . import _build

__all__ = ["interleave_planes", "interleave_planes_plain", "extract_planes",
           "extract_planes_plain", "planes_to_plain_np", "LAUNCHES"]

LAUNCHES = trace.counters("repack", {"interleave": 0,
                                     "deinterleave": 0})


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
