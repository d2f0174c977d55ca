"""Backward warping (flow gather) with PyTorch `grid_sample` semantics
(bilinear, zeros padding, align_corners=False), as in fldrx/ops/warp.py.

The reference normalises the flow-displaced grid with 2p/(S-1)-1 and
grid_sample un-normalises with the align_corners=False rule, so the
effective sample location is src = (pix + flow)·S/(S-1) - 0.5.

Layout: NHWC images, flow [..., 2] with channel 0 = x (width), 1 = y.
These are the plain tensor versions; ops/fastwarp.py holds the kernel.
"""

from __future__ import annotations

import torch

__all__ = ["corner_taps", "grid_sample_bilinear", "bwarp", "sample_coords",
           "ones_mask_sep"]


def corner_taps(x: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """The four bilinear taps of NHWC `x` [B,H,W,C] around absolute pixel
    coords (px, py) [B,H',W'], each 0 where it falls outside the frame.

    Returns ((v00, v01, v10, v11) [B,H',W',C], their validity masks
    [B,H',W'], fx, fy [B,H',W',1]): v01 is one pixel right of v00, v10 one
    pixel down."""
    B, H, W, C = x.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0).unsqueeze(-1)
    fy = (py - y0).unsqueeze(-1)
    x0i = x0.long()
    y0i = y0.long()
    flat = x.reshape(B, H * W, C)
    b_idx = torch.arange(B, device=x.device).view(B, 1, 1)

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat[b_idx, idx]                               # [B,H',W',C]
        return v * valid.unsqueeze(-1).to(x.dtype), valid

    v00, m00 = tap(x0i, y0i)
    v01, m01 = tap(x0i + 1, y0i)
    v10, m10 = tap(x0i, y0i + 1)
    v11, m11 = tap(x0i + 1, y0i + 1)
    return (v00, v01, v10, v11), (m00, m01, m10, m11), fx, fy


def grid_sample_bilinear(x: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                         with_ones_mask: bool = False):
    """Bilinear sample of NHWC `x` [B,H,W,C] at absolute pixel coords
    (px, py) [B,H',W'], zeros padding (each out-of-range tap adds 0).

    Returns samples [B,H',W',C]; with `with_ones_mask` also the sampled
    all-ones image [B,H',W',1] (for the 0.999 mask threshold)."""
    (v00, v01, v10, v11), (m00, m01, m10, m11), fx, fy = corner_taps(x, px, py)
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    out = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
    if not with_ones_mask:
        return out
    cd = x.dtype
    ones = (m00.to(cd).unsqueeze(-1) * w00 + m01.to(cd).unsqueeze(-1) * w01
            + m10.to(cd).unsqueeze(-1) * w10 + m11.to(cd).unsqueeze(-1) * w11)
    return out, ones


def sample_coords(flow: torch.Tensor):
    """bwarp sampling positions p·S/(S-1) - 0.5 for flow [..., H, W, 2]."""
    H, W = flow.shape[-3], flow.shape[-2]
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device).unsqueeze(-1)
    sx = (xs + flow[..., 0]) * (W / max(W - 1, 1)) - 0.5
    sy = (ys + flow[..., 1]) * (H / max(H - 1, 1)) - 0.5
    return sx, sy


def ones_mask_sep(sx: torch.Tensor, sy: torch.Tensor, H: int,
                  W: int) -> torch.Tensor:
    """bwarp's 0.999 validity mask in separable closed form: the sampled
    all-ones image over the rectangular frame factors as gx·gy with
    g = clip(min(s + 1, S - s), 0, 1) (equal to the corner sum up to 1 ulp
    at the frame border)."""
    gx = torch.clamp(torch.minimum(sx + 1.0, W - sx), 0.0, 1.0)
    gy = torch.clamp(torch.minimum(sy + 1.0, H - sy), 0.0, 1.0)
    return (gx * gy >= 0.999).to(sx.dtype)


def bwarp(x: torch.Tensor, flow: torch.Tensor,
          with_mask: bool = True) -> torch.Tensor:
    """Backward-warp NHWC `x` by `flow` [B,H,W,2]: grid_sample with zeros
    padding and the validity mask (sampled ones < 0.999 → 0), the mask in
    the reference's corner-sum form (reference fLDRnet.py:546-581)."""
    sx, sy = sample_coords(flow)
    out, ones = grid_sample_bilinear(x, sx, sy, with_ones_mask=True)
    if not with_mask:
        return out
    return out * (ones >= 0.999).to(x.dtype)
