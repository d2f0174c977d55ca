"""The warp path's hand-written kernels: bilinear gather and scatter-add
splat, their VJPs, and the differentiable forms built on them
(counterparts of fldrx/ops/fastwarp.py).

`gather(img, sx, sy, mask)`, `splat(vals, tx, ty)`, `gather_grad` and
`splat_grad` dispatch on the tensors' device: a CUDA tensor launches the
kernel in csrc/warp.cu (built at first use, see ops/_build.py) or raises; a
CPU tensor takes the plain version beside it. There is no silent fallback
from the card.

A ctypes kernel writes into a tensor that autograd never sees, so on the
card `gather` and `splat` raise when grad mode is on and an input requires
grad. The differentiable route is `gather_diff`/`splat_sum_diff`
(`torch.autograd.Function`s: forward through `gather`/`splat`, backward
through `gather_grad`/`splat_grad`) and, on top of them, `bwarp_diff` and
`softsplat_diff`. Their coordinates come from `sample_coords`/the splat
targets, so autograd supplies the S/(S-1) factor fldrx writes out.

The splat and gather_grad kernels accumulate with float atomicAdd, so on
the card the order of colliding adds — and with it the last bits of a sum —
changes from run to run; the TPU kernels they replace are deterministic.
Comparisons with the plain versions use a tolerance of 1e-4·(1 + |ref|) for
that reason. splat_grad has no atomics and is deterministic.

`LAUNCHES` counts kernel launches (not plain-version calls), so a run can
show that its path went through the kernels. `FORMS` tallies the VJP
kernels' launches by form ("gather_grad coords C=3 mask on": the outputs
asked for, C and the mask), so a run can show which forms its path
launches; nothing on the path reads it.

The gather and splat kernels take one of two routes (csrc/warp.cu), which
`_route` picks from C and the data pointers' alignment: VEC4, one thread
per 4-channel group with 16-byte loads, stores and reductions, where C is
a multiple of 4 and every pointer is 16-byte aligned; else SCALAR, 4-byte
accesses with threads on channels (the gather at C = 2, 3: on pixels,
stores staged through shared memory). A contiguous slice such as `x[1:]`
can start off a 16-byte boundary, so the pointers are checked on every
call. The VJP kernels' C entry points pick their layout themselves, from
C, the outputs asked for and the pointers (csrc/warp.cu): splat_grad's
dvals alone is the gather of g and runs on the gather's kernels;
gather_grad's coords alone at C = 2, 3 run a thread per pixel; the rest
run lane groups, 16 or 8 bytes wide where C and the pointers allow.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from . import _build
from .splat import softsplat, splat_sum_at
from .warp import (corner_taps, grid_sample_bilinear, ones_mask_sep,
                   sample_coords)

__all__ = ["gather", "gather_plain", "splat", "splat_plain", "gather_grad",
           "gather_grad_plain", "splat_grad", "splat_grad_plain",
           "gather_diff", "splat_sum_diff", "bwarp_diff", "softsplat_diff",
           "LAUNCHES", "FORMS"]

LAUNCHES = {"gather": 0, "splat": 0, "gather_grad": 0, "splat_grad": 0}
FORMS: Counter = Counter()

# the `route` argument of fldrx_gather_f32 and fldrx_splat_f32
SCALAR, VEC4 = 0, 1
# the kernels index within one frame in 32 bits
MAX_FRAME_ELEMS = 2 ** 31 - 1


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on {sorted(kinds)}: expected all on cpu "
                     "or all on cuda")


def refuse_grad(what: str, route: str, *tensors: torch.Tensor) -> None:
    """Raise when a kernel, whose output carries no grad_fn, is handed an
    input that requires grad while grad mode is on."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, but the kernel's output would "
            f"carry no gradient; use {route}")


def _f32(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t if t.is_contiguous() else t.contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _route(C: int, *ptrs: int) -> int:
    """VEC4 when C is a multiple of 4 and every data pointer is 16-byte
    aligned, else SCALAR."""
    return VEC4 if C % 4 == 0 and all(p % 16 == 0 for p in ptrs) else SCALAR


def _check_frame(what: str, elems: int) -> None:
    if elems > MAX_FRAME_ELEMS:
        raise ValueError(f"{what}: {elems} elements in one frame; the kernel "
                         f"takes at most {MAX_FRAME_ELEMS}")


def _check_gather_shapes(what, img, sx, sy):
    if img.dim() != 4 or sx.dim() != 3 or sx.shape != sy.shape \
            or sx.shape[0] != img.shape[0]:
        raise ValueError(f"{what}: img {tuple(img.shape)}, sx "
                         f"{tuple(sx.shape)}, sy {tuple(sy.shape)}")


def _check_splat_shapes(what, vals, tx, ty):
    if vals.dim() != 4 or tx.shape != vals.shape[:3] or ty.shape != tx.shape:
        raise ValueError(f"{what}: vals {tuple(vals.shape)}, tx "
                         f"{tuple(tx.shape)}, ty {tuple(ty.shape)}")


# ---------------------------------------------------------------------------
# forward kernels
# ---------------------------------------------------------------------------

def gather_plain(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                 mask: bool = False) -> torch.Tensor:
    """Plain version of `gather`."""
    out = grid_sample_bilinear(img, sx, sy)
    if mask:
        H, W = img.shape[1], img.shape[2]
        out = out * ones_mask_sep(sx, sy, H, W).unsqueeze(-1)
    return out


def gather(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
           mask: bool = False) -> torch.Tensor:
    """Bilinear gather of img [B,H,W,C] at absolute pixel coords sx, sy
    [B,H',W'] with zeros padding (grid_sample semantics) → [B,H',W',C];
    `mask` multiplies by the bwarp 0.999 validity mask."""
    _check_gather_shapes("gather", img, sx, sy)
    if not _on_card(img, sx, sy):
        return gather_plain(img, sx, sy, mask)
    refuse_grad("gather", "gather_diff or bwarp_diff", img, sx, sy)
    img, sx, sy = _f32(img, "img"), _f32(sx, "sx"), _f32(sy, "sy")
    B, H, W, C = img.shape
    Ho, Wo = sx.shape[1], sx.shape[2]
    _check_frame("gather", Ho * Wo * C)
    out = img.new_empty((B, Ho, Wo, C))
    src, dst = img.data_ptr(), out.data_ptr()
    err = _build.library("warp").fldrx_gather_f32(
        src, sx.data_ptr(), sy.data_ptr(), dst, B, H, W, C, Ho, Wo,
        int(bool(mask)), _route(C, src, dst), _stream(img))
    LAUNCHES["gather"] += 1
    _build.check(err, "gather")
    return out


def splat_plain(vals: torch.Tensor, tx: torch.Tensor,
                ty: torch.Tensor) -> torch.Tensor:
    """Plain version of `splat` (index_add_, ops/splat.py)."""
    return splat_sum_at(vals, tx, ty)


def splat(vals: torch.Tensor, tx: torch.Tensor,
          ty: torch.Tensor) -> torch.Tensor:
    """Bilinear scatter-add of vals [B,H,W,C] to absolute target coords
    tx, ty [B,H,W] into a zero [B,H,W,C] canvas; out-of-frame corners are
    dropped. Any C (4 at level 0, 49 for the coarse feature splats)."""
    _check_splat_shapes("splat", vals, tx, ty)
    if not _on_card(vals, tx, ty):
        return splat_plain(vals, tx, ty)
    refuse_grad("splat", "splat_sum_diff or softsplat_diff", vals, tx, ty)
    vals, tx, ty = _f32(vals, "vals"), _f32(tx, "tx"), _f32(ty, "ty")
    B, H, W, C = vals.shape
    _check_frame("splat", H * W * C)
    out = torch.empty_like(vals)           # zeroed by the entry point
    src, dst = vals.data_ptr(), out.data_ptr()
    err = _build.library("warp").fldrx_splat_f32(
        src, tx.data_ptr(), ty.data_ptr(), dst, B, H, W, C,
        _route(C, src, dst), _stream(vals))
    LAUNCHES["splat"] += 1
    _build.check(err, "splat")
    return out


# ---------------------------------------------------------------------------
# VJP kernels
# ---------------------------------------------------------------------------

def _dx(v00, v01, v10, v11, gy, fy):
    """d/dx of the bilinear sample with taps v00 (here), v01 (one step
    along x), v10, v11 (one step along the other axis) and fraction fy
    along it (gy = 1 − fy): the difference of two samples at integer x,
    in fldrx's association, (v01·gy + v11·fy) − (v00·gy + v10·fy). The
    kernels compute the same expression."""
    return (v01 * gy + v11 * fy) - (v00 * gy + v10 * fy)


def splat_grad_plain(vals: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                     g: torch.Tensor, coords: bool = True):
    """Plain version of `splat_grad`."""
    (g00, g01, g10, g11), _, fx, fy = corner_taps(g, tx, ty)
    gx, gy = 1 - fx, 1 - fy
    dvals = g00 * (gx * gy) + g01 * (fx * gy) + g10 * (gx * fy) \
        + g11 * (fx * fy)
    if not coords:
        return dvals, None, None
    dtx = (vals * _dx(g00, g01, g10, g11, gy, fy)).sum(-1)
    dty = (vals * _dx(g00, g10, g01, g11, gx, fx)).sum(-1)
    return dvals, dtx, dty


def splat_grad(vals: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
               g: torch.Tensor, coords: bool = True):
    """VJP of `splat` for the cotangent g [B,H,W,C] → (dvals [B,H,W,C],
    dtx, dty [B,H,W] or None when `coords` is false): dvals is the bilinear
    gather of g at the targets, dtx/dty the derivative of the four corner
    weights against g (fldrx _splat_diff_bwd)."""
    _check_splat_shapes("splat_grad", vals, tx, ty)
    if g.shape != vals.shape:
        raise ValueError(f"splat_grad: g {tuple(g.shape)}, vals "
                         f"{tuple(vals.shape)}")
    if not _on_card(vals, tx, ty, g):
        return splat_grad_plain(vals, tx, ty, g, coords)
    vals, tx, ty = _f32(vals, "vals"), _f32(tx, "tx"), _f32(ty, "ty")
    g = _f32(g, "g")
    B, H, W, C = vals.shape
    _check_frame("splat_grad", H * W * C)
    dvals = torch.empty_like(vals)
    dtx = torch.empty_like(tx) if coords else None
    dty = torch.empty_like(ty) if coords else None
    lib = _build.library("warp")
    err = lib.fldrx_splat_grad_f32(
        vals.data_ptr(), tx.data_ptr(), ty.data_ptr(), g.data_ptr(),
        dvals.data_ptr(), dtx.data_ptr() if coords else None,
        dty.data_ptr() if coords else None, B, H, W, C, _stream(vals))
    LAUNCHES["splat_grad"] += 1
    FORMS[f"splat_grad {'dvals+coords' if coords else 'dvals'} C={C}"] += 1
    _build.check(err, "splat_grad")
    return dvals, dtx, dty


def gather_grad_plain(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                      g: torch.Tensor, mask: bool = False,
                      want_img: bool = True, want_coords: bool = True):
    """Plain version of `gather_grad`."""
    H, W = img.shape[1], img.shape[2]
    gm = g * ones_mask_sep(sx, sy, H, W).unsqueeze(-1) if mask else g
    dimg = splat_sum_at(gm, sx, sy, (H, W)) if want_img else None
    if not want_coords:
        return dimg, None, None
    (i00, i01, i10, i11), _, fx, fy = corner_taps(img, sx, sy)
    dsx = (gm * _dx(i00, i01, i10, i11, 1 - fy, fy)).sum(-1)
    dsy = (gm * _dx(i00, i10, i01, i11, 1 - fx, fx)).sum(-1)
    return dimg, dsx, dsy


def gather_grad(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                g: torch.Tensor, mask: bool = False, want_img: bool = True,
                want_coords: bool = True):
    """VJP of `gather` for the cotangent g [B,H',W',C] → (dimg [B,H,W,C],
    dsx, dsy [B,H',W']), each None when not wanted: dimg is the splat of
    g·keep at (sx, sy), dsx/dsy the image's bilinear derivative against
    g·keep, where keep is the 0.999 mask when `mask` is set (fldrx
    _bwarp_diff_bwd without its S/(S-1) factor)."""
    _check_gather_shapes("gather_grad", img, sx, sy)
    if tuple(g.shape) != (*sx.shape, img.shape[3]):
        raise ValueError(f"gather_grad: g {tuple(g.shape)}, sx "
                         f"{tuple(sx.shape)}, img {tuple(img.shape)}")
    if not _on_card(img, sx, sy, g):
        return gather_grad_plain(img, sx, sy, g, mask, want_img, want_coords)
    if not (want_img or want_coords):
        return None, None, None
    img, sx, sy = _f32(img, "img"), _f32(sx, "sx"), _f32(sy, "sy")
    g = _f32(g, "g")
    B, H, W, C = img.shape
    Ho, Wo = sx.shape[1], sx.shape[2]
    _check_frame("gather_grad", max(H * W, Ho * Wo) * C)
    dimg = torch.empty_like(img) if want_img else None    # zeroed there
    dsx = torch.empty_like(sx) if want_coords else None
    dsy = torch.empty_like(sy) if want_coords else None
    lib = _build.library("warp")
    err = lib.fldrx_gather_grad_f32(
        img.data_ptr(), sx.data_ptr(), sy.data_ptr(), g.data_ptr(),
        dimg.data_ptr() if want_img else None,
        dsx.data_ptr() if want_coords else None,
        dsy.data_ptr() if want_coords else None,
        B, H, W, C, Ho, Wo, int(bool(mask)), _stream(img))
    LAUNCHES["gather_grad"] += 1
    form = "+".join(n for n, w in (("dimg", want_img),
                                   ("coords", want_coords)) if w)
    FORMS[f"gather_grad {form} C={C} mask {'on' if mask else 'off'}"] += 1
    _build.check(err, "gather_grad")
    return dimg, dsx, dsy


# ---------------------------------------------------------------------------
# differentiable forms (training path)
# ---------------------------------------------------------------------------

class _SplatFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, tx, ty):
        ctx.save_for_backward(vals, tx, ty)
        return splat(vals, tx, ty)

    @staticmethod
    def backward(ctx, g):
        vals, tx, ty = ctx.saved_tensors
        # the coarse feature splats have a detached flow: skip dtx/dty there
        coords = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        return splat_grad(vals, tx, ty, g, coords)


class _GatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, sx, sy, mask):
        ctx.save_for_backward(img, sx, sy)
        ctx.mask = mask
        return gather(img, sx, sy, mask)

    @staticmethod
    def backward(ctx, g):
        img, sx, sy = ctx.saved_tensors
        dimg, dsx, dsy = gather_grad(
            img, sx, sy, g, ctx.mask, want_img=ctx.needs_input_grad[0],
            want_coords=ctx.needs_input_grad[1] or ctx.needs_input_grad[2])
        return dimg, dsx, dsy, None


def splat_sum_diff(vals: torch.Tensor, tx: torch.Tensor,
                   ty: torch.Tensor) -> torch.Tensor:
    """`splat` with gradients to vals and the targets (fldrx
    splat_sum_diff, on absolute targets)."""
    return _SplatFn.apply(vals, tx, ty)


def gather_diff(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                mask: bool = False) -> torch.Tensor:
    """`gather` with gradients to img and the sampling coords."""
    return _GatherFn.apply(img, sx, sy, bool(mask))


def bwarp_diff(x: torch.Tensor, flow: torch.Tensor,
               with_mask: bool = True) -> torch.Tensor:
    """bwarp through the gather kernel, with the separable validity mask
    (fldrx bwarp_diff). x [B,H,W,C], flow [B,H,W,2]."""
    sx, sy = sample_coords(flow.float())
    return gather_diff(x.float(), sx, sy, with_mask).to(x.dtype)


def softsplat_diff(img: torch.Tensor, flow: torch.Tensor,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax splatting through the splat kernel, computed in float32;
    the wrapper algebra is plain torch, the scatter `splat_sum_diff`."""
    out = softsplat(img.float(), flow.float(),
                    None if z is None else z.float(),
                    splat_fn=splat_sum_diff)
    return out.to(img.dtype)
