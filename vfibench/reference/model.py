"""The plain reference fLDRnet: the reference's semantics in plain torch,
NCHW, on any device.

A frozen copy of `fldrx_torch/tools/reference_oracle.py` (itself the
reference's fLDRnet.py, softSplat.py and pca_comp.py re-expressed as
functional torch on the raw state dict), with these changes: every tensor
it makes is made on its inputs' device; the PCA transform takes the dtype
of its inputs (float64 at test time as the oracle has it, float32 in
training); in-place writes became the equal out-of-place forms, so that
autograd runs through them; and the synthesis can also return the training
outputs (the t-scaled flow and the end-point flows), so the same functions
serve the test and the training forward; and the synthesis can follow the
algebra of fldrx's fast path, which a configuration with fast_warp states
(`synthesize_torch`). Autograd gives the gradients.

It imports nothing of fldrx_torch or fldrx.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def torch_to_pca_diff(im, wiS, comps, mean, EV, mean_vec):
    """Reference to_pca_diff (pca_comp.py:473-528). im: [chan, H, W];
    mean [64]; EV [comps, 64]; mean_vec [comps], all of im's dtype."""
    chan, height, width = im.shape
    blocks_y = height // wiS
    blocks_x = width // wiS
    imtem = im.unsqueeze(0)
    toblock = nn.Unfold(kernel_size=wiS, stride=wiS)
    imtem = toblock(imtem).squeeze(0)
    blocked = (
        imtem.reshape(-1, blocks_y, blocks_x)
        .permute(0, 2, 1)
        .reshape(chan, wiS ** 2, blocks_x, blocks_y)
        .permute(0, 2, 3, 1)
        .reshape(chan, blocks_x, blocks_y, wiS, wiS)
    )
    pca_ready = blocked.reshape(-1, wiS * wiS)
    loc = pca_ready - mean
    tr = torch.matmul(loc, EV.permute(1, 0))
    tr = tr / mean_vec
    tr = tr.reshape(chan, blocks_x, blocks_y, comps).permute(0, 3, 2, 1)
    tr = tr.reshape(-1, blocks_y, blocks_x)
    mi, ma = torch.min(tr), torch.max(tr)
    tr = (tr - mi) / (ma - mi)
    return tr * 2 - 1


def conv(sd, name, x, stride=1, pad=1):
    return F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"],
                    stride=stride, padding=pad)


def splat_sum_torch(inp, flow):
    """kernel_Softsplat_updateOutput semantics (softSplat.py:12-52), NCHW."""
    B, C, H, W = inp.shape
    dev = inp.device
    ox = torch.arange(W, dtype=flow.dtype, device=dev)[None, None, :] + flow[:, 0]
    oy = torch.arange(H, dtype=flow.dtype, device=dev)[None, :, None] + flow[:, 1]
    x0 = torch.floor(ox)
    y0 = torch.floor(oy)
    tx = (ox - x0)
    ty = (oy - y0)
    x0 = x0.long()
    y0 = y0.long()
    out = torch.zeros(B, C, H * W, dtype=inp.dtype, device=dev)
    for xi, yi, w in (
        (x0, y0, (1 - tx) * (1 - ty)),
        (x0 + 1, y0, tx * (1 - ty)),
        (x0, y0 + 1, (1 - tx) * ty),
        (x0 + 1, y0 + 1, tx * ty),
    ):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))          # [B,H,W]
        src = inp * (w * valid.to(inp.dtype))[:, None]               # [B,C,H,W]
        out = out.scatter_add(2, idx.reshape(B, 1, -1).expand(B, C, -1),
                              src.reshape(B, C, -1))
    return out.reshape(B, C, H, W)


def softsplat_torch(img, flow, z=None):
    """FunctionSoftsplat 'softmax' mode (softSplat.py:320-352)."""
    inp01 = (img + 1) / 2
    if z is None:
        m = torch.ones(img.shape[0], 1, img.shape[2], img.shape[3],
                       dtype=img.dtype, device=img.device)
        weighted = inp01
    else:
        m = z.exp()
        weighted = inp01 * m
    s = splat_sum_torch(torch.cat([weighted, m], 1), flow)
    norm = s[:, -1:]
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return (s[:, :-1] / norm - 0.5) * 2


def bwarp_torch(x, flo, withmask=True):
    """DCTVFInet.bwarp (fLDRnet.py:546-581)."""
    B, C, H, W = x.size()
    dev = x.device
    xx = torch.arange(0, W, device=dev).view(1, 1, 1, W).expand(B, 1, H, W)
    yy = torch.arange(0, H, device=dev).view(1, 1, H, 1).expand(B, 1, H, W)
    grid = torch.cat((xx, yy), 1).to(flo.dtype)
    vgrid = grid + flo
    vx = 2.0 * vgrid[:, 0] / max(W - 1, 1) - 1.0
    vy = 2.0 * vgrid[:, 1] / max(H - 1, 1) - 1.0
    vgrid = torch.stack([vx, vy], -1)
    output = F.grid_sample(x, vgrid, align_corners=False)
    mask = F.grid_sample(torch.ones_like(x), vgrid, align_corners=False)
    mask = (mask >= 0.999).to(x.dtype)
    return output * mask if withmask else output


def int8(x):
    """x rounded through int8 with one scale for the tensor (its largest
    magnitude to 127), back in x's dtype."""
    s = x.detach().abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(x / s).clamp(-127, 127) * s


def refine_unet_torch(sd, x, in_int8=False):
    """PCARefineUNet.forward (fLDRnet.py:619-644). With in_int8, each
    conv's input, weight and output are rounded through int8 (per-tensor
    scale): the step below the bfloat16 a configuration may state for the
    UNet, whose convs store their outputs in it."""
    r = F.relu
    pre = "vfinet.refine_unet"

    def cv(name, x, stride=1):
        w, b = sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"]
        if not in_int8:
            return F.conv2d(x, w, b, stride=stride, padding=1)
        return int8(F.conv2d(int8(x), int8(w), b, stride=stride, padding=1))

    enc1 = r(cv("enc1", x, 2))
    enc2 = r(cv("enc2", enc1, 2))
    out = r(cv("enc3", enc2, 2))
    out = r(cv("dec0", out))
    out = F.interpolate(out, scale_factor=2, mode="nearest")
    out = r(cv("dec1", torch.cat((out, enc2), 1)))
    out = F.interpolate(out, scale_factor=2, mode="nearest")
    out = r(cv("dec2", torch.cat((out, enc1), 1)))
    out = F.interpolate(out, scale_factor=2, mode="nearest")
    return cv("dec3", out)


def flow_step_torch(sd, feat, flow_prev):
    """DCTVFInet flow estimation (fLDRnet.py:376-397)."""
    r = F.relu
    B, C, H, W = feat.shape
    fx = feat.reshape(B, 2, C // 2, H, W)
    f0, f1 = fx[:, 0], fx[:, 1]
    if flow_prev is None:
        x = torch.cat((f0, f1), 1)
        for i in (0, 2, 4, 6):
            x = r(conv(sd, f"vfinet.conv_flow_bottom.{i}", x))
        x = conv(sd, "vfinet.conv_flow_bottom.8", x)
        return x[:, :4]
    up = F.interpolate(flow_prev.detach(), size=(H, W), mode="bilinear",
                       align_corners=False)
    up = up * (up.shape[3] / flow_prev.shape[3])
    w1 = softsplat_torch(f1, up[:, :2])
    w0 = softsplat_torch(f0, up[:, 2:])
    a = conv(sd, "vfinet.conv_flow1", torch.cat([f0, w1], 1))
    b = conv(sd, "vfinet.conv_flow1", torch.cat([f1, w0], 1))
    x = torch.cat([a, b, up], 1)
    for i in (0, 2, 4, 6):
        x = r(conv(sd, f"vfinet.conv_flow2.{i}", x))
    x = conv(sd, "vfinet.conv_flow2.8", x)
    return x[:, :4] + up


def bwarp_mask(flo):
    """bwarp's validity mask alone: the sampled all-ones image ≥ 0.999."""
    B, _, H, W = flo.shape
    ones = torch.ones(B, 1, H, W, dtype=flo.dtype, device=flo.device)
    return bwarp_torch(ones, flo, withmask=False).ge(0.999).to(flo.dtype)


def synthesize_torch(sd, flow_l, images, t, train_outputs=False,
                     fast=False, z_half=False, unet_int8=False,
                     with_spread=False):
    """Synthesis at one level (fLDRnet.py:400-524). images: [B,3,2,H,W];
    t: [B] or [B,1]. Returns the frame [B,3,H,W]; with train_outputs also
    the t-scaled flow at the flow grid [B,4,h,w] and the end-point flows
    (flow_t0, flow_t1) at the frame's size.

    `fast` takes the algebra of fldrx's fast path (fast_warp, at a flow
    grid of 96 or more each way): t scales the full-resolution flows, and
    the flowback flows are composed at the flow grid, then upsampled and
    masked at full resolution. `z_half` (its packed synthesis, frames
    multiples of 64) computes the importance maps z at half resolution
    from bilinear halves of the frames and flows, upsampled bilinearly.
    `unet_int8` runs the refine UNet through int8 (refine_unet_torch).
    `with_spread` also returns the blend's spread: per pixel and channel,
    the root of the blend-weighted mean square of the six candidates about
    the frame, what an error of the UNet's logits is multiplied by."""
    t = t.to(flow_l.dtype).reshape(-1, 1, 1, 1)
    flow_10 = flow_l[:, :2]
    flow_01 = flow_l[:, 2:]
    flow_t0 = t * flow_01
    flow_t1 = (1 - t) * flow_10
    flow_refine = torch.cat([flow_t0, flow_t1], 1)
    H, W = images.shape[3], images.shape[4]
    upscale = H // flow_l.shape[2]

    def up(f):
        return upscale * F.interpolate(f, scale_factor=(upscale, upscale),
                                       mode="bilinear", align_corners=False)

    x0, x1 = images[:, :, 0], images[:, :, 1]
    z_alpha = sd["vfinet.z_alpha"].float()
    if z_half:
        hw = (H // 2, W // 2)

        def half(f, k):
            return k * F.interpolate(f, size=hw, mode="bilinear",
                                     align_corners=False)

        x0h, x1h = half(x0, 1.0), half(x1, 1.0)
        f10h, f01h = half(flow_10, upscale / 2), half(flow_01, upscale / 2)
        z0 = torch.mean(z_alpha[0] * torch.abs(x0h - bwarp_torch(x1h, f01h)),
                        dim=1, keepdim=True)
        z1 = torch.mean(z_alpha[1] * torch.abs(x1h - bwarp_torch(x0h, f10h)),
                        dim=1, keepdim=True)
        z0 = F.interpolate(z0, size=(H, W), mode="bilinear",
                           align_corners=False)
        z1 = F.interpolate(z1, size=(H, W), mode="bilinear",
                           align_corners=False)
    flow_10f, flow_01f = up(flow_10), up(flow_01)
    if fast:
        flow_t0, flow_t1 = t * flow_01f, (1 - t) * flow_10f
    else:
        flow_t0, flow_t1 = up(flow_t0), up(flow_t1)
    if not z_half:
        im_1_0 = bwarp_torch(x1, flow_01f)
        z0 = torch.mean(z_alpha[0] * torch.abs(x0 - im_1_0), dim=1,
                        keepdim=True)
        im_0_1 = bwarp_torch(x0, flow_10f)
        z1 = torch.mean(z_alpha[1] * torch.abs(x1 - im_0_1), dim=1,
                        keepdim=True)
    warped0 = softsplat_torch(x0, flow_t0, z=z0)
    warped1 = softsplat_torch(x1, flow_t1, z=z1)

    if fast:
        fb0 = bwarp_torch(flow_10 * t, (1 - t) * flow_01, withmask=False)
        fb1 = bwarp_torch(flow_01 * (1 - t), t * flow_10, withmask=False)
        flowback_0 = up(fb0) * bwarp_mask((1 - t) * flow_01f)
        flowback_1 = up(fb1) * bwarp_mask(t * flow_10f)
    else:
        flowback_0 = bwarp_torch(flow_10f * t, (1 - t) * flow_01f)
        flowback_1 = bwarp_torch(flow_01f * (1 - t), t * flow_10f)
    im0_tot = bwarp_torch(x0, flowback_0)
    im1_tot = bwarp_torch(x1, flowback_1)

    refine_in = torch.cat([x0, x1, warped0, warped1, flow_t0, flow_t1,
                           flowback_0, flowback_1, im0_tot, im1_tot], 1)
    out = refine_unet_torch(sd, refine_in, unet_int8)
    T = sd["vfinet.T_param"].float()
    occ = F.softmax(out[:, :6] / T, dim=1)

    div = ((1 - t) * occ[:, 0:1] + t * occ[:, 1:2]
           + (1 - t) * occ[:, 2:3] + t * occ[:, 3:4]
           + (1 - t) * occ[:, 4:5] + t * occ[:, 5:6])
    out_l = ((1 - t) * occ[:, 0:1] * warped0 + t * occ[:, 1:2] * warped1
             + (1 - t) * occ[:, 2:3] * im0_tot + t * occ[:, 3:4] * im1_tot
             + (1 - t) * occ[:, 4:5] * x0 + t * occ[:, 5:6] * x1)
    out_l = out_l / div
    if with_spread:
        cands = (warped0, warped1, im0_tot, im1_tot, x0, x1)
        var = sum(((1 - t) if i % 2 == 0 else t) * occ[:, i:i + 1]
                  * (c - out_l) ** 2 for i, c in enumerate(cands)) / div
        return out_l, torch.sqrt(var)
    if train_outputs:
        return out_l, flow_refine, (flow_t0, flow_t1)
    return out_l


def features_torch(sd, level_images, nf=16, wiS=8, pca_dtype=torch.float64):
    """The block-PCA features and the residual context convs of one
    pyramid level [B,3,2,H,W] → [B, 3·2·nf, H/wiS, W/wiS] float32. The
    min-max spans the whole batch, as the reference's does."""
    B, C, T, H, W = level_images.shape
    im = level_images.reshape(B * C * T, H, W).to(pca_dtype)
    f = torch_to_pca_diff(im, wiS, nf, sd["Mean8"].to(pca_dtype),
                          sd["EV8"].to(pca_dtype),
                          sd["meanVec8"].to(pca_dtype))
    f = f.reshape(B, C * T * nf, H // wiS, W // wiS).float()
    r = F.relu(conv(sd, "rec_ctx_ds.0", f))
    r = F.relu(conv(sd, "rec_ctx_ds.2", r))
    return r + f


def flow_torch(sd, pyramid, S, nf=16, wiS=8, pca_dtype=torch.float64):
    """The test forward's flow (DCTXVFInet.forward is_training=False,
    fLDRnet.py:106-223) over pyramid levels S..0: [B,4,h,w] at level 0's
    flow grid, channels (flow_10 x, y, flow_01 x, y)."""
    flow = None
    for level in range(S, -1, -1):
        feat = features_torch(sd, pyramid[level], nf, wiS, pca_dtype)
        flow = flow_step_torch(sd, feat, flow)
    return flow
