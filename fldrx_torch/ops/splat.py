"""Softmax splatting (forward warp), as in fldrx/ops/splat.py.

`splat_sum` is the plain version of the bilinear scatter-add: each source
pixel adds input·w into the 4 integer neighbours of (x, y) + flow, corners
outside the frame are dropped (reference kernel_Softsplat_updateOutput).
`softsplat` is the softmax wrapper: shift to [0,1], append the importance
channel exp(z) (or 1), splat, divide by the splatted importance (0 → 1)
and rescale to [-1,1]. `splat_fn` takes the kernel (ops/fastwarp.splat).

Layout: NHWC input, flow [B,H,W,2] (x-disp, y-disp).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["splat_sum", "splat_sum_at", "softsplat", "softsplat_vals",
           "softsplat_norm"]


def splat_sum_at(vals: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                 hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Scatter-add of `vals` [B,H',W',C] to absolute target coords tx/ty
    [B,H',W'] into a zero [B,H,W,C] canvas, with `index_add_` — one add per
    corner, NW, NE, SW, SE in turn. The canvas is (H, W) = `hw`, by default
    the source's own size."""
    B, _, _, C = vals.shape
    H, W = hw if hw is not None else vals.shape[1:3]
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    x0i = x0.long()
    y0i = y0.long()
    fx = (tx - x0).unsqueeze(-1)
    fy = (ty - y0).unsqueeze(-1)
    corners = (
        (x0i, y0i, (1 - fx) * (1 - fy)),           # NW
        (x0i + 1, y0i, fx * (1 - fy)),              # NE
        (x0i, y0i + 1, (1 - fx) * fy),              # SW
        (x0i + 1, y0i + 1, fx * fy),                # SE
    )
    N = H * W
    base = (torch.arange(B, device=vals.device) * N).view(B, 1, 1)
    out = torch.zeros(B * N, C, dtype=vals.dtype, device=vals.device)
    for xi, yi, w in corners:
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        upd = vals * (w * valid.unsqueeze(-1).to(vals.dtype))
        out.index_add_(0, idx.reshape(-1), upd.reshape(-1, C))
    return out.reshape(B, H, W, C)


def _targets(flow: torch.Tensor):
    H, W = flow.shape[-3], flow.shape[-2]
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device).unsqueeze(-1)
    return xs + flow[..., 0], ys + flow[..., 1]


def splat_sum(inp: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Raw summation splat: out[yy,xx] += inp[y,x]·bilinear_w, 4 corners."""
    tx, ty = _targets(flow)
    return splat_sum_at(inp, tx, ty)


def softsplat_vals(img: torch.Tensor,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The values softmax splatting scatters: [inp01·m, m] with
    inp01 = (img + 1) / 2 and m = exp(z) (or 1) → [B,H,W,C+1]."""
    B, H, W, C = img.shape
    inp01 = (img + 1.0) * 0.5
    if z is None:
        m = torch.ones((B, H, W, 1), dtype=img.dtype, device=img.device)
        return torch.cat([inp01, m], -1)
    m = torch.exp(z.to(img.dtype))
    return torch.cat([inp01 * m, m], -1)


def softsplat_norm(s: torch.Tensor) -> torch.Tensor:
    """Normalise a splat of `softsplat_vals` by its last channel (0 → 1)
    and rescale to [-1,1]."""
    norm = s[..., -1:]
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return (s[..., :-1] / norm - 0.5) * 2.0


def softsplat(img: torch.Tensor, flow: torch.Tensor,
              z: Optional[torch.Tensor] = None, splat_fn=None) -> torch.Tensor:
    """Softmax splatting (FunctionSoftsplat 'softmax' mode):

        inp01 = (img + 1) / 2;  m = exp(z) (or 1)
        s     = splat([inp01·m, m], flow)
        out   = (s[..., :-1] / where(s[..., -1:] == 0, 1, s[..., -1:]) - 0.5)·2

    `splat_fn(vals, tx, ty)` scatters to absolute targets; the default is
    the plain `splat_sum_at`."""
    splat_fn = splat_fn or splat_sum_at
    tx, ty = _targets(flow)
    return softsplat_norm(splat_fn(softsplat_vals(img, z), tx, ty))
