"""Training losses (counterpart of fldrx/train/losses.py).

Shipped papermodel recipe:
  total = mean_l L1(out_l, bicubic↓ target)
        + 0.5  · edge-aware forward smoothness of the level-0 refine flow
        + 0.05 · endflow forward-warp photometric loss
T-optimisation swaps the reconstruction loss for MSE.

The endflow loss splats through `softsplat_diff`: the splat kernel forward
and the splat_grad kernel backward, so its gradient reaches the flow. The
optional backward-warp losses use the plain `bwarp`, as fldrx does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..config import FLDRConfig
from ..ops.fastwarp import softsplat_diff
from ..ops.resize import resize_2d
from ..ops.warp import bwarp


def charbonnier(x, y, eps=1e-3):
    return torch.mean(torch.sqrt((x - y) ** 2 + eps ** 2))


def _mse(x, y):
    return torch.mean((x - y) ** 2)


def _l1(x, y):
    return torch.mean(torch.abs(x - y))


def rec_loss_fn(cfg: FLDRConfig):
    if cfg.t_optimization or cfg.loss_type == "MSE":
        return _mse
    if cfg.loss_type == "L1_Charbonnier_loss":
        return charbonnier
    return _l1


@dataclasses.dataclass(frozen=True)
class LossShard:
    """What one process of a sharded train step computes of the loss
    (parallel/distributed.py).

    cols: the level-0 columns [lo, hi) its output covers, None for the
      whole width;
    own: 1.0 where it counts the terms on tensors that every process of its
      width group holds alike (the coarse levels' reconstruction,
      smoothness, the endflow warp, orthogonality), else 0.0, so that each
      enters the sum over the processes once;
    group_sum: the sum of a tensor over every process (no gradient)."""
    cols: Optional[Tuple[int, int]]
    own: float
    group_sum: Callable[[torch.Tensor], torch.Tensor]


def pyramid_rec_loss(cfg: FLDRConfig, out_pyramid: Sequence[torch.Tensor],
                     target: torch.Tensor,
                     shard: Optional[LossShard] = None) -> torch.Tensor:
    """Σ_l rec(out_l, bicubic↓target) / n_levels; target [B, H, W, 3] at
    level-0 resolution. With `shard`, out_pyramid[0] covers shard.cols and
    this process's part of the sum is returned."""
    f = rec_loss_fn(cfg)
    total = 0.0
    for level, out_l in enumerate(out_pyramid):
        if level == 0 and shard is not None and shard.cols is not None:
            lo, hi = shard.cols
            # the slab's mean, weighted by its share of the frame's pixels
            term = f(out_l, target[:, :, lo:hi]) * ((hi - lo)
                                                   / target.shape[2])
        else:
            tgt = target if level == 0 else resize_2d(
                target, tuple(out_l.shape[1:3]), "bicubic",
                cfg.align_corners)
            term = f(out_l, tgt)
            if shard is not None and level > 0:
                term = shard.own * term
        total = total + cfg.rec_lambda * term
    return total / len(out_pyramid)


def _gh(x):
    return x[:, 1:, :, :] - x[:, :-1, :, :]


def _gw(x):
    return x[:, :, 1:, :] - x[:, :, :-1, :]


def _edge_weight(img, w2):
    return (torch.exp(-w2 * torch.mean(_gh(img) ** 2, -1, keepdim=True)),
            torch.exp(-w2 * torch.mean(_gw(img) ** 2, -1, keepdim=True)))


def smoothness_forward_loss(flow: torch.Tensor, img0: torch.Tensor,
                            img1: torch.Tensor,
                            weight: float = 150.0) -> torch.Tensor:
    """Edge-aware forward smoothness: flow[..., 0:2] weighted by img0's
    edges, flow[..., 2:4] by img1's. flow [B,h,w,4] (the t-scaled refine
    flow at 1/8 res); img0/img1 [B,h,w,3] (inputs downscaled by 1/8)."""
    w2 = weight ** 2
    flow_01 = flow[..., 0:2]
    flow_10 = flow[..., 2:4]
    w0_gh, w0_gw = _edge_weight(img0, w2)
    w1_gh, w1_gw = _edge_weight(img1, w2)
    return 0.25 * (
        torch.mean(w0_gh * torch.abs(_gh(flow_01)))
        + torch.mean(w1_gh * torch.abs(_gh(flow_10)))
        + torch.mean(w0_gw * torch.abs(_gw(flow_01)))
        + torch.mean(w1_gw * torch.abs(_gw(flow_10))))


def endflow_forward_warp_loss(endflow, im0, im1, t) -> torch.Tensor:
    """Splat each input by the un-t-scaled endpoint flow and compare with
    the other input, L1. endflow = (flow_t0, flow_t1) at image res;
    im0/im1 [B,H,W,3]; t [B,1]."""
    flow_0t, flow_1t = endflow
    tb = t.reshape(im0.shape[0], 1, 1, 1)
    warped_fir = softsplat_diff(im0, (1.0 / tb) * flow_0t)
    warped_sec = softsplat_diff(im1, (1.0 / (1.0 - tb)) * flow_1t)
    return (torch.mean(torch.abs(warped_fir - im1))
            + torch.mean(torch.abs(warped_sec - im0)))


def smoothness_loss(flow: torch.Tensor, img: torch.Tensor,
                    weight: float = 150.0,
                    edge_aware: bool = True) -> torch.Tensor:
    """Single-image first-order smoothness (the non-papermodel form)."""
    f_gh = torch.abs(_gh(flow))
    f_gw = torch.abs(_gw(flow))
    if not edge_aware:
        return 0.5 * (torch.mean(f_gh) + torch.mean(f_gw))
    w_gh, w_gw = _edge_weight(img, weight ** 2)
    return 0.5 * (torch.mean(w_gh * f_gh) + torch.mean(w_gw * f_gw))


def warping_loss(frames: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp photometric loss. frames [B,2,H,W,3]; flow [B,H,W,4]
    (01 then 10)."""
    first, second = frames[:, 0], frames[:, 1]
    warped_sec = bwarp(second, flow[..., 0:2])
    warped_fir = bwarp(first, flow[..., 2:4])
    return (torch.mean(torch.abs(warped_sec - first))
            + torch.mean(torch.abs(warped_fir - second)))


def warping_loss_endflow(frames: torch.Tensor, gt: torch.Tensor, endflow):
    """Backward endflow photometric loss (off in the papermodel)."""
    flow_t0, flow_t1 = endflow
    warped_fir = bwarp(frames[:, 0], flow_t0)
    warped_sec = bwarp(frames[:, 1], flow_t1)
    return (torch.mean(torch.abs(warped_sec - gt))
            + torch.mean(torch.abs(warped_fir - gt)))


def _orth_offdiag(ev: torch.Tensor) -> torch.Tensor:
    g = ev @ ev.T
    return torch.sum(g) - torch.trace(g)


def orthogonality_loss(*evs: torch.Tensor) -> torch.Tensor:
    """0.5·(Σ_EVs Σ_{k≠l} EV_k·EV_l)², squared once over every EV."""
    off = torch.zeros((), device=evs[0].device)
    for ev in evs:
        off = off + _orth_offdiag(ev)
    return 0.5 * off ** 2


def distillation_loss(unref_flow_pyramid, gtflow: torch.Tensor) -> torch.Tensor:
    """Teacher-flow distillation with a confidence-adaptive robust loss
    (dormant in the shipped model). Flows [B,h,w,4] fine → coarse; gtflow
    [B,H,W,4] at 8× the finest flow."""
    top = resize_2d(unref_flow_pyramid[0],
                    (unref_flow_pyramid[0].shape[1] * 8,
                     unref_flow_pyramid[0].shape[2] * 8), "bilinear")
    Hh, Ww = top.shape[1], top.shape[2]
    top_sg = top.detach()
    pmap_10 = torch.exp(-0.3 * torch.sqrt(
        torch.sum((top_sg[..., :2] - gtflow[..., :2]) ** 2, -1, keepdim=True)))
    pmap_01 = torch.exp(-0.3 * torch.sqrt(
        torch.sum((top_sg[..., 2:] - gtflow[..., 2:]) ** 2, -1, keepdim=True)))
    alpha_10, alpha_01 = pmap_10 / 2, pmap_01 / 2
    eps_10 = 10.0 ** (-(10 * pmap_10 - 1) / 3)
    eps_01 = 10.0 ** (-(10 * pmap_01 - 1) / 3)
    loss = 0.0
    for f in unref_flow_pyramid[1:]:
        f_up = resize_2d(f, (Hh, Ww), "bilinear")
        d10 = f_up[..., :2] - gtflow[..., :2]
        d01 = f_up[..., 2:] - gtflow[..., 2:]
        loss = loss + torch.mean((d10 ** 2 + eps_10 ** 2) ** alpha_10)
        loss = loss + torch.mean((d01 ** 2 + eps_01 ** 2) ** alpha_01)
    return loss


def total_loss(cfg: FLDRConfig, fwd_out: dict, target: torch.Tensor,
               frames: torch.Tensor, t: torch.Tensor, params=None,
               epoch=None, shard: Optional[LossShard] = None):
    """The shipped training loss and its metrics. frames [B,2,H,W,3] are
    the level-0 inputs; target [B,H,W,3]; t [B,1].

    Optional switches (off in the papermodel): cfg.warping_loss adds the
    epoch-annealed backward-warp term, alpha = warp_alpha·(1 −
    exp(−(epochs/4 − epoch))) while epoch ≤ epochs/4; cfg.orth_loss adds
    the EV orthogonality penalty when it is at least 0.1.

    With `shard` the loss and every metric but the PSNR are this process's
    part: level 0's reconstruction over shard.cols, the other terms times
    shard.own. Every term is a plain mean over the batch, so the batch's
    loss is the sum of the parts over a width group, averaged over equal
    batch shards. The PSNR is not a sum of parts: its squared error and
    pixel count are summed over every process before the log."""
    rec = pyramid_rec_loss(cfg, fwd_out["out_pyramid"], target, shard)
    s = cfg.scales[0]
    h, w = frames.shape[2] // s, frames.shape[3] // s
    img0_ds = resize_2d(frames[:, 0], (h, w), "bicubic", cfg.align_corners)
    img1_ds = resize_2d(frames[:, 1], (h, w), "bicubic", cfg.align_corners)
    smooth = cfg.smoothness * smoothness_forward_loss(
        fwd_out["flow_refine_pyramid"][0], img0_ds, img1_ds)
    warp = cfg.warp_alpha * endflow_forward_warp_loss(
        fwd_out["endflow_pyramid"][0], frames[:, 0], frames[:, 1], t)
    if cfg.warping_loss and epoch is not None:
        fine = fwd_out["unrefined_flow_pyramid"][0]
        H, W = frames.shape[2], frames.shape[3]
        fine_up = float(s) * resize_2d(fine, (H, W), "bicubic",
                                       cfg.align_corners)
        ep = float(epoch)
        alpha = (cfg.warp_alpha * (1.0 - math.exp(-(cfg.epochs / 4 - ep)))
                 if ep <= cfg.epochs / 4 else 0.0)
        warp = warp + alpha * warping_loss(frames, fine_up)
    orth = torch.zeros((), device=target.device)
    penalty = None
    if cfg.orth_loss and params is not None:
        evs = [params["pca"]["ev"].float()]
        if not cfg.exac_one_ev:
            for k in sorted(params.get("pca_multi", {})):
                evs.append(params["pca_multi"][k]["ev"].float())
        orth = orthogonality_loss(*evs)
        penalty = torch.where(orth >= 0.1, orth, torch.zeros_like(orth))
    if shard is not None:
        smooth, warp, orth = (shard.own * v for v in (smooth, warp, orth))
        if penalty is not None:
            penalty = shard.own * penalty
    total = rec + smooth + warp
    if penalty is not None:
        total = total + penalty
    # per-batch PSNR on [0,1]-denormed frames (data_range 1)
    out0 = fwd_out["out_pyramid"][0]
    if shard is None:
        mse = torch.mean((out0 / 2 - target / 2) ** 2)
    else:
        if shard.cols is not None:
            target = target[:, :, shard.cols[0]:shard.cols[1]]
        sse, n = shard.group_sum(torch.stack([
            torch.sum((out0.detach() / 2 - target / 2) ** 2),
            torch.tensor(float(target.numel()), device=target.device)]))
        mse = sse / n
    psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
    return total, {"loss": total, "rec": rec, "smooth": smooth, "warp": warp,
                   "orth": orth, "psnr": psnr}
