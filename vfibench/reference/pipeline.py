"""The plain reference's test pass and training steps, from the inputs the
benchmark makes: uint8 frames for the test pass (padded and turned into a
bicubic pyramid here, as the reference's main.py does), float32 batches for
training. NCHW inside; NHWC at the boundary, as the benchmark compares.

Float32 everywhere but the test pass's PCA (float64, as the oracle), with
TF32 off for matmuls and cuDNN convs while it runs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .model import (features_torch, flow_step_torch, flow_torch,
                    softsplat_torch, synthesize_torch)


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matmuls and cuDNN convs; the flags as they were after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def pad_reflect(x: torch.Tensor, div: int) -> torch.Tensor:
    """NCHW padded on the bottom and right to multiples of `div` by
    mirroring without repeating the edge (the reference's np.pad
    'reflect'); a pad longer than the frame mirrors the padded frame
    again."""
    ph = (div - x.shape[2] % div) % div
    pw = (div - x.shape[3] % div) % div
    while ph or pw:
        kh = min(ph, x.shape[2] - 1)
        kw = min(pw, x.shape[3] - 1)
        x = F.pad(x, (0, kw, 0, kh), mode="reflect")
        ph, pw = ph - kh, pw - kw
    return x


def pyramid(images: torch.Tensor, scales: Sequence[int], n_levels: int):
    """images [B,3,2,H,W] → n_levels levels; level i is the bicubic
    downscale by scales[0]/scales[i], each from the full resolution."""
    B, C, T, H, W = images.shape
    flat = images.permute(0, 2, 1, 3, 4).reshape(B * T, C, H, W)
    out = [images]
    for i in range(1, n_levels):
        f = scales[0] / scales[i]
        lev = F.interpolate(flat, size=(int(H * f), int(W * f)),
                            mode="bicubic", align_corners=False)
        out.append(lev.reshape(B, T, C, *lev.shape[2:]).permute(0, 2, 1, 3, 4))
    return out


def _padded_images(frames_u8: torch.Tensor, geom: dict) -> torch.Tensor:
    """uint8 frames [2, H, W, 3] → [1, 3, 2, Hp, Wp] in [-1, 1], padded."""
    x = (frames_u8.float() / 255.0 - 0.5) * 2.0                  # [2,H,W,3]
    x = pad_reflect(x.permute(0, 3, 1, 2), 2 ** geom["S_tst"] * geom["wiS"])
    return x.permute(1, 0, 2, 3).unsqueeze(0)


def flow_pair(sd, frames_u8: torch.Tensor, geom: dict) -> torch.Tensor:
    """One pair of uint8 frames [2, H, W, 3] → the flow [1, h, w, 4] at the
    padded frame's flow grid."""
    S = geom["S_tst"]
    with strict_float32(), torch.no_grad():
        pyr = pyramid(_padded_images(frames_u8, geom), geom["scales"], S + 1)
        flow = flow_torch(sd, pyr, S, geom["nf"], geom["wiS"], torch.float64)
    return flow.permute(0, 2, 3, 1)


def synthesize_pair(sd, flow: torch.Tensor, frames_u8: torch.Tensor,
                    ts: Sequence[float], geom: dict,
                    unet_int8: bool = False, spreads: list = None
                    ) -> torch.Tensor:
    """The frames [len(ts), H, W, 3] in [-1, 1] of one pair of uint8
    frames [2, H, W, 3] from a flow [1, h, w, 4], one t at a time, in the
    configuration's synthesis algebra: fldrx's fast path where geom states
    fast_warp and the flow grid is 96 or more each way, z at half
    resolution where it also states packed_synth; the refine UNet through
    int8 with `unet_int8`. A list passed as
    `spreads` gets each frame's RMS blend spread (synthesize_torch)."""
    H, W = frames_u8.shape[1], frames_u8.shape[2]
    with strict_float32(), torch.no_grad():
        images = _padded_images(frames_u8, geom)
        flow = flow.float().permute(0, 3, 1, 2)
        Hp, Wp = images.shape[3], images.shape[4]
        fast = (geom.get("fast_warp", False)
                and min(flow.shape[2], flow.shape[3]) >= 96)
        z_half = (fast and geom.get("packed_synth", False)
                  and Hp % 64 == 0 and Wp % 64 == 0)
        outs = []
        for t in ts:
            tt = torch.full((1,), float(t), device=flow.device)
            out = synthesize_torch(sd, flow, images, tt, fast=fast,
                                   z_half=z_half, unet_int8=unet_int8,
                                   with_spread=spreads is not None)
            if spreads is not None:
                out, spread = out
                spreads.append(float(torch.sqrt(torch.mean(
                    spread[0, :, :H, :W].double() ** 2))))
            outs.append(out[0, :, :H, :W].permute(1, 2, 0))
        return torch.stack(outs, 0)


def infer_pair(sd, frames_u8: torch.Tensor, ts: Sequence[float], geom: dict):
    """One pair of uint8 frames [2, H, W, 3] → (flow [1, h, w, 4], frames
    [len(ts), H, W, 3]): the reference's whole test pass. geom: the sizes
    (vfibench/work.py geometry) and the configuration's fast_warp and
    packed_synth."""
    flow = flow_pair(sd, frames_u8, geom)
    return flow, synthesize_pair(sd, flow, frames_u8, ts, geom)


def train_forward(sd, frames: torch.Tensor, t: torch.Tensor, geom: dict):
    """The training forward (DCTXVFInet.forward is_training=True): flow
    and synthesis at every level S_trn..0. frames [B,2,H,W,3] in [-1, 1];
    t [B,1]. Returns per level, fine → coarse, the frame [B,3,h,w], the
    t-scaled flow and the end-point flows."""
    S = geom["S_trn"]
    images = frames.permute(0, 4, 1, 2, 3)                    # [B,3,2,H,W]
    pyr = pyramid(images, geom["scales"], S + 1)
    flow, outs, refines, ends = None, [], [], []
    for level in range(S, -1, -1):
        feat = features_torch(sd, pyr[level], geom["nf"], geom["wiS"],
                              torch.float32)
        flow = flow_step_torch(sd, feat, flow)
        out, refine, end = synthesize_torch(sd, flow, pyr[level], t,
                                            train_outputs=True)
        outs.append(out)
        refines.append(refine)
        ends.append(end)
    return outs[::-1], refines[::-1], ends[::-1]


def _gh(x):
    return x[:, :, 1:, :] - x[:, :, :-1, :]


def _gw(x):
    return x[:, :, :, 1:] - x[:, :, :, :-1]


def _edge_weights(img, w2):
    return (torch.exp(-w2 * torch.mean(_gh(img) ** 2, 1, keepdim=True)),
            torch.exp(-w2 * torch.mean(_gw(img) ** 2, 1, keepdim=True)))


def train_loss(sd, batch: Dict[str, torch.Tensor], geom: dict):
    """The shipped papermodel loss: the mean over levels of L1 against the
    bicubic-downscaled target, + smoothness · the edge-aware forward
    smoothness of level 0's t-scaled flow, + warp_alpha · the end-point
    forward-warp L1 of level 0."""
    frames, target, t = batch["frames"], batch["target"], batch["t"]
    outs, refines, ends = train_forward(sd, frames, t, geom)
    tgt = target.permute(0, 3, 1, 2)
    rec = 0.0
    for out in outs:
        ref = tgt if out.shape[-2:] == tgt.shape[-2:] else F.interpolate(
            tgt, size=out.shape[-2:], mode="bicubic", align_corners=False)
        rec = rec + torch.mean(torch.abs(out - ref))
    rec = rec / len(outs)
    im0 = frames[:, 0].permute(0, 3, 1, 2)
    im1 = frames[:, 1].permute(0, 3, 1, 2)
    s = geom["scales"][0]
    hw = (im0.shape[2] // s, im0.shape[3] // s)
    img0 = F.interpolate(im0, size=hw, mode="bicubic", align_corners=False)
    img1 = F.interpolate(im1, size=hw, mode="bicubic", align_corners=False)
    w2 = 150.0 ** 2
    f01, f10 = refines[0][:, 0:2], refines[0][:, 2:4]
    w0h, w0w = _edge_weights(img0, w2)
    w1h, w1w = _edge_weights(img1, w2)
    smooth = 0.25 * (torch.mean(w0h * torch.abs(_gh(f01)))
                     + torch.mean(w1h * torch.abs(_gh(f10)))
                     + torch.mean(w0w * torch.abs(_gw(f01)))
                     + torch.mean(w1w * torch.abs(_gw(f10))))
    tb = t.reshape(-1, 1, 1, 1)
    flow_t0, flow_t1 = ends[0]
    warp = (torch.mean(torch.abs(softsplat_torch(im0, flow_t0 / tb) - im1))
            + torch.mean(torch.abs(softsplat_torch(im1, flow_t1 / (1 - tb))
                                   - im0)))
    return rec + geom["smoothness"] * smooth + geom["warp_alpha"] * warp


def adam_update(sd, state: dict, lrs: Dict[str, float], step: int,
                betas=(0.9, 0.999), eps=1e-8) -> None:
    """One Adam update (no weight decay) of every leaf with a gradient, at
    its group's rate lrs[name]; step counts from 1."""
    b1, b2 = betas
    with torch.no_grad():
        for name, p in sd.items():
            if p.grad is None:
                continue
            g = p.grad
            m, v = state.setdefault(name, (torch.zeros_like(p),
                                           torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
            p.addcdiv_(m, denom, value=-lrs[name] / (1 - b1 ** step))


def train_steps(sd, batches: List[Dict[str, torch.Tensor]], geom: dict,
                lrs: Dict[str, float]) -> dict:
    """Training steps from the leaves of `sd` (which require grad), one
    per batch. Returns {"loss": [float per step], "grad1": {name: first
    step's gradient}, "delta": {name: change of the leaf over all the
    steps}}; sd's leaves end updated."""
    start = {k: v.detach().clone() for k, v in sd.items()}
    state: dict = {}
    losses, grad1 = [], {}
    with strict_float32():
        for i, batch in enumerate(batches):
            for p in sd.values():
                p.grad = None
            loss = train_loss(sd, batch, geom)
            loss.backward()
            if i == 0:
                grad1 = {k: p.grad.detach().clone() for k, p in sd.items()
                         if p.grad is not None}
            losses.append(float(loss.detach()))
            adam_update(sd, state, lrs, i + 1)
    delta = {k: (sd[k].detach() - start[k]) for k in grad1}
    return {"loss": losses, "grad1": grad1, "delta": delta}
