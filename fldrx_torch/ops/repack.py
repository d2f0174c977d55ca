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

fldrx's inverse, `extract_planes`, runs on no path of fldrx and is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["interleave_planes", "interleave_planes_plain",
           "planes_to_plain_np", "LAUNCHES"]

LAUNCHES = {"interleave": 0}


def interleave_planes_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain version of `interleave_planes`."""
    B, _, Hp4, WC = planes.shape
    return torch.stack([planes[:, u] for u in range(4)], 2).reshape(
        B, 4 * Hp4, WC)


def interleave_planes(planes: torch.Tensor) -> torch.Tensor:
    """[B, 4, H/4, W·C] u-planes → [B, H, W·C] plain rows, bit-exact; on
    the card through the kernel."""
    if planes.dim() != 4 or planes.shape[1] != 4:
        raise ValueError(f"interleave_planes: planes {tuple(planes.shape)}, "
                         "expected [B, 4, H/4, W·C]")
    if planes.device.type == "cpu":
        return interleave_planes_plain(planes)
    if planes.requires_grad:
        raise RuntimeError("interleave_planes: the kernel is inference only")
    if planes.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the interleave kernel takes float32 or bfloat16, "
                        f"got {planes.dtype}")
    planes = planes.contiguous()
    B, _, Hp4, WC = planes.shape
    out = torch.empty((B, 4 * Hp4, WC), dtype=planes.dtype,
                      device=planes.device)
    lib = _build.library("repack")
    err = lib.fldrx_interleave_planes(
        planes.data_ptr(), out.data_ptr(), B, 4 * Hp4,
        WC * planes.element_size(),
        torch.cuda.current_stream(planes.device).cuda_stream)
    LAUNCHES["interleave"] += 1
    _build.check(err, "interleave_planes")
    return out


def planes_to_plain_np(a: np.ndarray) -> np.ndarray:
    """[..., 4, H/4, W·3] u-planes → [..., H, W, 3] plain rows, bit-exact."""
    lead, (_, hp4, wc) = a.shape[:-3], a.shape[-3:]
    W = wc // 3
    a = a.reshape(*lead, 4, hp4, W, 3)
    a = np.moveaxis(a, -4, -3)                 # [..., hp4, 4, W, 3]
    return np.ascontiguousarray(a).reshape(*lead, hp4 * 4, W, 3)
