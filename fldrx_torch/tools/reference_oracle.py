"""A CPU-torch oracle of the reference fLDRnet *test* forward pass, the
reference's semantics and not the port's code: nothing on the port's
inference path imports it. `tools/parity_report.py` measurement 1 holds the
port's strict path against it.

This re-expresses the semantics of the reference's fLDRnet.py (DCTXVFInet /
DCTVFInet / PCARefineUNet), softSplat.py and pca_comp.py as plain
functional torch on the raw state dict: `tools/convert_ckpt.py`
`load_reference_state_dict` of a reference .pt, or `params_to_state_dict`
of the converted .npz. A copy of tests/reference_oracle.py with
tests/test_block_pca.py's `torch_to_pca_diff`, so that it imports no JAX;
tests/test_torch_oracle.py holds the two equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def torch_to_pca_diff(im, wiS, comps, mean, EV, mean_vec):
    """Reference to_pca_diff re-expressed for CPU torch (pca_comp.py:473-528).
    im: [chan, H, W] f32; mean [64] f64; EV [comps,64] f64; mean_vec [comps]."""
    chan, height, width = im.shape
    blocks_y = height // wiS
    blocks_x = width // wiS
    imtem = torch.as_tensor(im).unsqueeze(0)
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
    ox = torch.arange(W, dtype=flow.dtype)[None, None, :] + flow[:, 0]
    oy = torch.arange(H, dtype=flow.dtype)[None, :, None] + flow[:, 1]
    x0 = torch.floor(ox)
    y0 = torch.floor(oy)
    tx = (ox - x0)
    ty = (oy - y0)
    x0 = x0.long()
    y0 = y0.long()
    out = torch.zeros(B, C, H * W, dtype=inp.dtype)
    for xi, yi, w in (
        (x0, y0, (1 - tx) * (1 - ty)),
        (x0 + 1, y0, tx * (1 - ty)),
        (x0, y0 + 1, (1 - tx) * ty),
        (x0 + 1, y0 + 1, tx * ty),
    ):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))          # [B,H,W]
        src = inp * (w * valid.to(inp.dtype))[:, None]               # [B,C,H,W]
        out.scatter_add_(2, idx.reshape(B, 1, -1).expand(B, C, -1),
                         src.reshape(B, C, -1))
    return out.reshape(B, C, H, W)


def softsplat_torch(img, flow, z=None):
    """FunctionSoftsplat 'softmax' mode (softSplat.py:320-352)."""
    inp01 = (img + 1) / 2
    if z is None:
        m = torch.ones(img.shape[0], 1, img.shape[2], img.shape[3])
        weighted = inp01
    else:
        m = z.exp()
        weighted = inp01 * m
    s = splat_sum_torch(torch.cat([weighted, m], 1), flow)
    norm = s[:, -1:].clone()
    norm[norm == 0.0] = 1.0
    return (s[:, :-1] / norm - 0.5) * 2


def bwarp_torch(x, flo, withmask=True):
    """DCTVFInet.bwarp (fLDRnet.py:546-581)."""
    B, C, H, W = x.size()
    xx = torch.arange(0, W).view(1, 1, 1, W).expand(B, 1, H, W)
    yy = torch.arange(0, H).view(1, 1, H, 1).expand(B, 1, H, W)
    grid = torch.cat((xx, yy), 1).float()
    vgrid = grid + flo
    vgrid[:, 0] = 2.0 * vgrid[:, 0].clone() / max(W - 1, 1) - 1.0
    vgrid[:, 1] = 2.0 * vgrid[:, 1].clone() / max(H - 1, 1) - 1.0
    vgrid = vgrid.permute(0, 2, 3, 1)
    output = F.grid_sample(x, vgrid, align_corners=False)
    mask = F.grid_sample(torch.ones(x.size()), vgrid, align_corners=False)
    mask = mask.masked_fill_(mask < 0.999, 0).masked_fill_(mask > 0, 1)
    return output * mask if withmask else output


def refine_unet_torch(sd, x):
    """PCARefineUNet.forward (fLDRnet.py:619-644)."""
    r = F.relu
    pre = "vfinet.refine_unet"
    enc1 = r(conv(sd, f"{pre}.enc1", x, stride=2, pad=1))
    enc2 = r(conv(sd, f"{pre}.enc2", enc1, stride=2, pad=1))
    out = r(conv(sd, f"{pre}.enc3", enc2, stride=2, pad=1))
    out = r(conv(sd, f"{pre}.dec0", out))
    out = F.interpolate(out, scale_factor=2, mode="nearest")
    out = r(conv(sd, f"{pre}.dec1", torch.cat((out, enc2), 1)))
    out = F.interpolate(out, scale_factor=2, mode="nearest")
    out = r(conv(sd, f"{pre}.dec2", torch.cat((out, enc1), 1)))
    out = F.interpolate(out, scale_factor=2, mode="nearest")
    return conv(sd, f"{pre}.dec3", out)


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


def synthesize_torch(sd, flow_l, images, t):
    """Level-0 synthesis (fLDRnet.py:400-524). images: [B,3,2,H,W]."""
    B = flow_l.shape[0]
    t = torch.as_tensor(t, dtype=torch.float32).view(-1, 1, 1, 1)
    flow_10 = flow_l[:, :2]
    flow_01 = flow_l[:, 2:]
    flow_t0 = t * flow_01
    flow_t1 = (1 - t) * flow_10
    H, W = images.shape[3], images.shape[4]
    upscale = H // flow_l.shape[2]

    def up(f):
        return upscale * F.interpolate(f, scale_factor=(upscale, upscale),
                                       mode="bilinear", align_corners=False)

    flow_t0, flow_t1 = up(flow_t0), up(flow_t1)
    flow_10, flow_01 = up(flow_10), up(flow_01)
    x0, x1 = images[:, :, 0], images[:, :, 1]

    z_alpha = sd["vfinet.z_alpha"].float()
    im_1_0 = bwarp_torch(x1, flow_01)
    z0 = torch.mean(z_alpha[0] * torch.abs(x0 - im_1_0), dim=1, keepdim=True)
    im_0_1 = bwarp_torch(x0, flow_10)
    z1 = torch.mean(z_alpha[1] * torch.abs(x1 - im_0_1), dim=1, keepdim=True)
    warped0 = softsplat_torch(x0, flow_t0, z=z0)
    warped1 = softsplat_torch(x1, flow_t1, z=z1)

    flowback_0 = bwarp_torch(flow_10 * t, (1 - t) * flow_01)
    flowback_1 = bwarp_torch(flow_01 * (1 - t), t * flow_10)
    im0_tot = bwarp_torch(x0, flowback_0)
    im1_tot = bwarp_torch(x1, flowback_1)

    refine_in = torch.cat([x0, x1, warped0, warped1, flow_t0, flow_t1,
                           flowback_0, flowback_1, im0_tot, im1_tot], 1)
    out = refine_unet_torch(sd, refine_in)
    T = sd["vfinet.T_param"].float()
    occ = F.softmax(out[:, :6] / T, dim=1)

    div = ((1 - t) * occ[:, 0:1] + t * occ[:, 1:2]
           + (1 - t) * occ[:, 2:3] + t * occ[:, 3:4]
           + (1 - t) * occ[:, 4:5] + t * occ[:, 5:6])
    out_l = ((1 - t) * occ[:, 0:1] * warped0 + t * occ[:, 1:2] * warped1
             + (1 - t) * occ[:, 2:3] * im0_tot + t * occ[:, 3:4] * im1_tot
             + (1 - t) * occ[:, 4:5] * x0 + t * occ[:, 5:6] * x1)
    return out_l / div


def oracle_forward_test(sd, pyramid, t, S_tst, nf=16, wiS=8):
    """Full test forward (DCTXVFInet.forward is_training=False,
    fLDRnet.py:106-223). pyramid[i]: numpy [B,3,2,H_i,W_i] in [-1,1]."""
    mean = sd["Mean8"].double()
    EV = sd["EV8"].double()
    mean_vec = sd["meanVec8"].double()
    feats = []
    for i in range(S_tst + 1):
        arr = torch.from_numpy(np.asarray(pyramid[i])).float()
        B, C, T, H, W = arr.shape
        im = arr.reshape(B * C * T, H, W)
        f = torch_to_pca_diff(im.double(), wiS, nf, mean, EV, mean_vec)
        f = f.reshape(B, C * T * nf, H // wiS, W // wiS).float()
        r = F.relu(conv(sd, "rec_ctx_ds.0", f))
        r = F.relu(conv(sd, "rec_ctx_ds.2", r))
        feats.append(r + f)
    flow = None
    for level in range(S_tst, 0, -1):
        flow = flow_step_torch(sd, feats[level], flow)
    flow = flow_step_torch(sd, feats[0], flow)
    images0 = torch.from_numpy(np.asarray(pyramid[0])).float()
    return synthesize_torch(sd, flow, images0, t).numpy()
