"""The packed synthesis's six-way blend: the refine UNet's s2d4 logits and
the six candidate frames in, the interpolated frame out, written once in
the layout the caller keeps (counterpart of fldrx/model/fldrnet.py
blend_planes_24, which fldrx leaves to XLA).

`blend6_out` writes into a caller-given `out`, plain rows [B, H, W, 3] or
u-planes [B, 4, H/4, W·3] (ops/repack.py), told apart by its shape. A CUDA
tensor launches the `blend6_kernel` of csrc/blend.cu (built at first use,
see ops/_build.py) or raises; a CPU tensor takes the plain version,
`blend6_plain`: `blend6` on each u-plane of the logits (`blend6_planes`),
then, for plain rows, the interleave. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..utils import trace
from . import _build
from .repack import interleave_planes_plain

__all__ = ["blend6", "blend6_planes", "blend6_plain", "blend6_out",
           "LAUNCHES"]

LAUNCHES = trace.counters("blend", {"blend6": 0})

LOGITS = 16 * 6                 # the s2d4 cell's 16 pixels × 6 logits


def blend6(logits: torch.Tensor, cands, tb: torch.Tensor,
           Tparam: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The fast path's candidate blend with the (1−t)/t weights folded into
    the softmax logits: t_i·exp(o_i/T) = exp(o_i/T + log t_i), so the
    renormalising divisor cancels (fldrx blend_planes_24).
    logits [..., 6]; cands (warped0, warped1, im0, im1, x0, x1) [..., 3];
    tb [B, 1, ..., 1] of the same rank; the result is written to `out`."""
    logt = torch.log(tb)
    log1mt = torch.log(1.0 - tb)
    bias = torch.cat([log1mt, logt, log1mt, logt, log1mt, logt], -1)
    x = logits / Tparam + bias
    e = torch.exp(x - x.amax(-1, keepdim=True))
    pr = e / e.sum(-1, keepdim=True)
    acc = pr[..., 0:1] * cands[0]
    for i in range(1, 5):
        acc = acc + pr[..., i:i + 1] * cands[i]
    return torch.add(acc, pr[..., 5:6] * cands[5], out=out)


def blend6_planes(logits_s2d: torch.Tensor, cands, tb: torch.Tensor,
                  Tparam: torch.Tensor) -> torch.Tensor:
    """`blend6` straight from the refine UNet's s2d4 output into u-planes:
    logits_s2d [B, H/4, W/4, 16·6] in cell-major order (u·4+v)·6+c, cands
    plain [B, H, W, 3] → [B, 4, H/4, W·3]. Plane u of every operand is a
    strided view, so the 6-channel UNet output is never depth-to-space
    permuted; the 3-channel result is, by the interleave kernel or the
    host, at half the bytes."""
    B, Hp4, Wp4, _ = logits_s2d.shape
    lg = logits_s2d.reshape(B, Hp4, Wp4, 4, 4, 6)
    cs = [c.reshape(B, Hp4, 4, Wp4, 4, 3) for c in cands]
    tb = tb.reshape(B, 1, 1, 1, 1)
    out = torch.empty((B, 4, Hp4, Wp4, 4, 3), dtype=torch.float32,
                      device=logits_s2d.device)
    for u in range(4):
        blend6(lg[:, :, :, u], [c[:, :, u] for c in cs], tb, Tparam,
               out=out[:, u])
    return out.reshape(B, 4, Hp4, Wp4 * 12)


def blend6_plain(logits_s2d: torch.Tensor, cands: Sequence[torch.Tensor],
                 t: torch.Tensor, Tparam: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """Plain version of `blend6_out`: `blend6_planes` on the logits in
    float32, interleaved into plain rows where `out` has them."""
    planes = blend6_planes(logits_s2d.float(), cands, t, Tparam)
    if out.dim() == 4 and out.shape[-1] == 3:
        B, Hp4, WC = planes.shape[0], planes.shape[2], planes.shape[3]
        planes = interleave_planes_plain(planes).reshape(B, 4 * Hp4,
                                                         WC // 3, 3)
    return out.copy_(planes)


def _check(logits_s2d: torch.Tensor, cands: Sequence[torch.Tensor],
           t: torch.Tensor, Tparam: torch.Tensor, out: torch.Tensor):
    """blend6_out's refusals, the same on every device; returns (B, H, W,
    whether `out` is u-planes)."""
    tensors = [logits_s2d, *cands, t, Tparam, out]
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError("blend6_out: an input requires grad; the blend "
                           "is inference only")
    if len(cands) != 6:
        raise ValueError(f"blend6_out: {len(cands)} candidates, expected 6")
    if any(x.device != logits_s2d.device for x in tensors):
        raise ValueError("blend6_out: inputs on more than one device")
    shape = tuple(cands[0].shape)
    if len(shape) != 4 or shape[3] != 3:
        raise ValueError(f"blend6_out: candidate {shape}, expected "
                         "[B, H, W, 3]")
    B, H, W, _ = shape
    if H % 4 or W % 4:
        raise ValueError(f"blend6_out: H×W {H}×{W}, expected multiples of 4")
    for c in cands:
        if tuple(c.shape) != shape:
            raise ValueError(f"blend6_out: candidates "
                             f"{[tuple(x.shape) for x in cands]}, expected "
                             "equal [B, H, W, 3]")
        if c.dtype != torch.float32:
            raise TypeError(f"blend6_out: candidates are float32, got "
                            f"{c.dtype}")
        if c.stride()[1:] != (3 * W, 3, 1):
            raise ValueError(f"blend6_out: a candidate's rows are not "
                             f"contiguous (strides {c.stride()})")
    if logits_s2d.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"blend6_out: logits bfloat16 or float32, got "
                        f"{logits_s2d.dtype}")
    if tuple(logits_s2d.shape) != (B, H // 4, W // 4, LOGITS):
        raise ValueError(f"blend6_out: logits {tuple(logits_s2d.shape)}, "
                         f"expected {(B, H // 4, W // 4, LOGITS)}")
    if t.numel() != B or Tparam.numel() != 1:
        raise ValueError(f"blend6_out: t of {t.numel()} and T of "
                         f"{Tparam.numel()} values, expected {B} and 1")
    if t.dtype != torch.float32 or Tparam.dtype != torch.float32:
        raise TypeError("blend6_out: t and T are float32")
    rows, planes = (B, H, W, 3), (B, 4, H // 4, W * 3)
    if tuple(out.shape) not in (rows, planes):
        raise ValueError(f"blend6_out: out {tuple(out.shape)}, expected "
                         f"{rows} (rows) or {planes} (u-planes)")
    inner = out.shape[1:]
    dense = tuple(int(torch.Size(inner[k + 1:]).numel())
                  for k in range(len(inner)))
    if out.dtype != torch.float32 or out.stride()[1:] != dense:
        raise ValueError(f"blend6_out: out float32 and contiguous within an "
                         f"item, got {out.dtype} with strides {out.stride()}")
    return B, H, W, tuple(out.shape) == planes


def blend6_out(logits_s2d: torch.Tensor, cands: Sequence[torch.Tensor],
               t: torch.Tensor, Tparam: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """The six-way blend of the packed synthesis into `out`, returned.
    logits_s2d [B, H/4, W/4, 96] (bfloat16 or float32, cell-major as
    `blend6_planes` reads it); cands (warped0, warped1, im0, im1, x0, x1)
    float32 [B, H, W, 3] with contiguous rows at any batch stride (x0 and
    x1 may be views of the padded frame pair); t [B] values and T_param
    [1], float32; out float32 plain rows [B, H, W, 3] or u-planes
    [B, 4, H/4, W·3], contiguous within an item. On the card one launch,
    within 1e-6 of `blend6_plain` (the kernel's expf and logf against
    torch's exp and log); t and T stay on the device."""
    B, H, W, planes = _check(logits_s2d, cands, t, Tparam, out)
    if logits_s2d.device.type == "cpu":
        return blend6_plain(logits_s2d, cands, t, Tparam, out)
    logits_s2d = logits_s2d.contiguous()
    t = t.reshape(B).contiguous()
    Tparam = Tparam.reshape(1).contiguous()
    strides = [c.stride(0) for c in cands] + [out.stride(0)]
    ptrs = [c.data_ptr() for c in cands]
    if any(p % 16 for p in ptrs + [logits_s2d.data_ptr(), out.data_ptr()]) \
            or any(s % 4 for s in strides):
        raise ValueError("blend6_out: the kernel reads and writes 16-byte "
                         "vectors: every pointer and batch stride must be "
                         "16-byte aligned")
    ptrs = (ctypes.c_void_p * 6)(*ptrs)
    strides = (ctypes.c_longlong * 7)(*strides)
    err = _build.library("blend").fldrx_blend6(
        logits_s2d.data_ptr(), int(logits_s2d.dtype == torch.bfloat16),
        ctypes.addressof(ptrs), ctypes.addressof(strides), t.data_ptr(),
        Tparam.data_ptr(), out.data_ptr(), int(planes), B, H, W,
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "blend6")
    LAUNCHES["blend6"] += 1
    return out
