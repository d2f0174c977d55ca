"""The plain reference PWC-Net teacher: the reference's
OpticalFlow/PWCNet.py, as its MyPWC.get_flow (useful.py:105-117) calls it,
in plain torch, NCHW, on any device.

Published network (Sun et al., CVPR 2018): a six-level extractor (three
3×3 convs a level, the first of stride 2; 16, 32, 64, 96, 128, 196
channels), a decoder a level from the coarsest (6) to level 2, each a cost
volume of ±4 pixels (81 channels) over the second image's features warped
by the upsampled flow, then a dense stack (each conv's output put in front
of its input: 128, 128, 96, 64, 32) and a 2-channel flow conv, the finer
levels also taking the coarser level's flow and features through 4×4
stride-2 deconvs; a dilated refiner (dilations 1, 2, 4, 8, 16, 1; widths
128, 128, 128, 96, 64, 32, 2) added to level 2's flow; the flow ×20,
resized bilinearly from and to the input size (a multiple of 64 inside)
and scaled by the resize ratios.

- the cost volume is written out: 81 channel means of the first features
  times the second's shifted by (dx, dy), zeros outside the frame,
  channel (dy + 4)·9 + (dx + 4);
- the warp is `F.grid_sample` (bilinear, zeros outside, align_corners
  False: the default of the torch the reference runs on) on a [-1, 1]
  linspace grid plus the flow over (size − 1)/2, of the features with an
  all-ones channel beside them; where that channel samples to 0.999 or
  less the output is zeroed;
- convs and deconvs are `F.conv2d` and `F.conv_transpose2d`, the resizes
  `F.interpolate`.

Weights: `init_weights(seed, spec)` draws them here, from the seed, at
the widths of the configuration's `pwcnet` entry, in the tree that both
the program and this reference take (`extractor`/`level<i>`, `dec<l>`,
`refiner`; OIHW convs, torch's [in, out, kh, kw] deconvs), as a checkpoint
would be handed to both. `forward` refuses a tree whose shapes are not the
configuration's (`check_tree`).

Departures from the reference: seeded random weights (normal over
sqrt(fan-in), biases normal at 0.01), since the trained checkpoint is not
in the repository; the tree's names, not the reference's module names;
images come and flows go NHWC, as the program hands them over; the
program tests its warp's mask in the separable closed form
`gx·gy >= 0.999` where this tests the sampled ones `> 0.999`, as the
reference does (the two differ where the sampled ones lie within an ulp
of 0.999). Float32 with TF32 off for matmuls and cuDNN convs, without
gradients.

It imports nothing of fldrx_torch or fldrx.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .pipeline import strict_float32

MEAN = (0.429, 0.431, 0.397)
DENSE = ("one", "two", "thr", "fou", "fiv")
BIAS_STD = 0.01


def layout(spec: dict) -> dict:
    """The parameter tree at `spec`'s widths (the configuration's `pwcnet`
    entry), each leaf {"w": shape, "b": shape}."""
    ext, dense = list(spec["extractor"]), list(spec["decoder"])
    volume = (2 * int(spec["max_displacement"]) + 1) ** 2

    def conv(cin, cout, k=3):
        return {"w": (cout, cin, k, k), "b": (cout,)}

    def deconv(cin, cout):
        return {"w": (cin, cout, 4, 4), "b": (cout,)}

    tree = {"extractor": {}}
    cin = 3
    for lv, c in enumerate(ext):
        tree["extractor"][f"level{lv}"] = [conv(cin, c), conv(c, c),
                                           conv(c, c)]
        cin = c
    # a level's stack starts from the cost volume and, below the coarsest,
    # the first image's features, the upsampled flow and features (2 each)
    first = {lv: volume + (ext[lv - 1] + 4 if lv < 6 else 0)
             for lv in range(2, 7)}
    for lv in (6, 5, 4, 3, 2):
        d = {}
        if lv < 6:
            d["upflow"] = deconv(2, 2)
            d["upfeat"] = deconv(first[lv + 1] + sum(dense), 2)
        c = first[lv]
        for name, w in zip(DENSE, dense):
            d[name] = conv(c, w)
            c += w
        d["six"] = conv(c, 2)
        tree[f"dec{lv}"] = d
    widths = list(spec["refiner_widths"]) + [2]
    cins = [first[2] + sum(dense)] + widths[:-1]
    tree["refiner"] = [conv(a, b) for a, b in zip(cins, widths)]
    return tree


def _leaves(tree, path=""):
    if isinstance(tree, dict) and set(tree) == {"w", "b"}:
        yield path, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")


def _map(tree, fn):
    if isinstance(tree, dict) and set(tree) == {"w", "b"}:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return [_map(v, fn) for v in tree]


def init_weights(seed: int, spec: dict, device="cpu") -> dict:
    """Seeded weights at `spec`'s widths, drawn on the CPU (one seed, the
    same weights on every device) and moved to `device`: each weight
    normal over sqrt(fan-in), each bias normal at BIAS_STD."""
    g = torch.Generator().manual_seed(int(seed) % 2 ** 63)

    def draw(leaf):
        w = leaf["w"]
        # a conv's fan-in is its [1:]; a deconv's, [in, out, kh, kw], is
        # its input channels times the kernel
        fan = w[0] * w[2] * w[3] if w[2] == 4 else w[1] * w[2] * w[3]
        return {"w": (torch.randn(w, generator=g) / math.sqrt(fan)).to(
                    device),
                "b": (BIAS_STD * torch.randn(leaf["b"], generator=g)).to(
                    device)}

    return _map(layout(spec), draw)


def check_tree(params: dict, spec: dict) -> int:
    """The tree's parameter count; ValueError where a leaf is missing or
    its shape is not `spec`'s."""
    got = {p: leaf for p, leaf in _leaves(params)}
    n = 0
    for path, leaf in _leaves(layout(spec)):
        for k in ("w", "b"):
            have = got.get(path, {}).get(k)
            if have is None or tuple(have.shape) != leaf[k]:
                raise ValueError(
                    f"{path}/{k}: {None if have is None else tuple(have.shape)}"
                    f", the configuration's widths give {leaf[k]}")
            n += have.numel()
    return n


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv(p: dict, x: torch.Tensor, stride: int = 1,
          dilation: int = 1) -> torch.Tensor:
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=dilation,
                    dilation=dilation)


def _deconv(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.conv_transpose2d(x, p["w"], p["b"], stride=2, padding=1)


def extractor(p: dict, x: torch.Tensor) -> list:
    """The six levels' features of x [B,3,H,W]."""
    feats = []
    for lv in range(len(p)):
        blk = p[f"level{lv}"]
        x = _lrelu(_conv(blk[0], x, stride=2))
        x = _lrelu(_conv(blk[1], x))
        x = _lrelu(_conv(blk[2], x))
        feats.append(x)
    return feats


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, d: int) -> torch.Tensor:
    """[B,C,H,W] twice → [B,(2d+1)²,H,W]: the channel mean of f1 times f2
    at (x + dx, y + dy), zeros outside, dy outer."""
    H, W = f1.shape[2], f1.shape[3]
    f2p = F.pad(f2, (d, d, d, d))
    return torch.stack([(f1 * f2p[:, :, dy:dy + H, dx:dx + W]).mean(1)
                        for dy in range(2 * d + 1)
                        for dx in range(2 * d + 1)], 1)


def backward_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The reference's Decoder.Backward: x [B,C,H,W] sampled at the pixel
    plus flow [B,2,H,W], zeroed where the sampled ones are 0.999 or less."""
    B, _, H, W = x.shape
    gx = torch.linspace(-1.0, 1.0, W, device=x.device).view(1, 1, W)
    gy = torch.linspace(-1.0, 1.0, H, device=x.device).view(1, H, 1)
    grid = torch.stack([gx + flow[:, 0] / ((W - 1.0) / 2.0),
                        gy + flow[:, 1] / ((H - 1.0) / 2.0)], -1)
    ones = x.new_ones((B, 1, H, W))
    out = F.grid_sample(torch.cat([x, ones], 1), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    mask = (out[:, -1:] > 0.999).to(x.dtype)
    return out[:, :-1] * mask


def decoder(p: dict, spec: dict, level: int, f1: torch.Tensor,
            f2: torch.Tensor, previous) -> dict:
    d = int(spec["max_displacement"])
    if previous is None:
        feat = _lrelu(cost_volume(f1, f2, d))
    else:
        flow = _deconv(p["upflow"], previous["flow"])
        upfeat = _deconv(p["upfeat"], previous["feat"])
        # the upsampled flow is at the flow's 1/flow_scale, on a grid
        # 2^level times coarser than the image
        warped = backward_warp(f2, flow * (float(spec["flow_scale"])
                                           / 2 ** level))
        feat = torch.cat([_lrelu(cost_volume(f1, warped, d)), f1, flow,
                          upfeat], 1)
    for name in DENSE:
        feat = torch.cat([_lrelu(_conv(p[name], feat)), feat], 1)
    return {"flow": _conv(p["six"], feat), "feat": feat}


def refiner(p: list, spec: dict, feat: torch.Tensor) -> torch.Tensor:
    x = feat
    dil = list(spec["refiner_dilations"])
    for i, d in enumerate(dil):
        x = _lrelu(_conv(p[i], x, dilation=d))
    return _conv(p[len(dil)], x)


def forward(params: dict, spec: dict, im1: torch.Tensor,
            im2: torch.Tensor) -> torch.Tensor:
    """PWCNet.forward: im1, im2 [B,3,H,W] RGB in [0, 1] → the flow from im1
    to im2, [B,2,H,W] in pixels."""
    H, W = im1.shape[2], im1.shape[3]
    div = float(spec["divisor"])
    mean = torch.tensor(MEAN, dtype=im1.dtype, device=im1.device).view(
        1, 3, 1, 1)
    ph, pw = int(math.ceil(H / div) * div), int(math.ceil(W / div) * div)
    im1 = F.interpolate(im1 - mean, size=(ph, pw), mode="bilinear",
                        align_corners=False)
    im2 = F.interpolate(im2 - mean, size=(ph, pw), mode="bilinear",
                        align_corners=False)
    f1 = extractor(params["extractor"], im1)
    f2 = extractor(params["extractor"], im2)
    est = None
    for level in (6, 5, 4, 3, 2):
        est = decoder(params[f"dec{level}"], spec, level, f1[level - 1],
                      f2[level - 1], est)
    flow = est["flow"] + refiner(params["refiner"], spec, est["feat"])
    flow = float(spec["flow_scale"]) * F.interpolate(
        flow, size=(H, W), mode="bilinear", align_corners=False)
    scale = torch.tensor([W / pw, H / ph], dtype=flow.dtype,
                         device=flow.device).view(1, 2, 1, 1)
    return flow * scale


def bidirectional_flow(params: dict, spec: dict, im0: torch.Tensor,
                       im1: torch.Tensor) -> torch.Tensor:
    """MyPWC.get_flow: im0, im1 [B,H,W,3] RGB in [0, 1] → [B,H,W,4] =
    (flow_10, flow_01), float32 with TF32 off, without gradients; `params`
    must have `spec`'s widths."""
    check_tree(params, spec)
    a = im0.permute(0, 3, 1, 2).float()
    b = im1.permute(0, 3, 1, 2).float()
    with torch.no_grad(), strict_float32():
        flow01 = forward(params, spec, a, b)
        flow10 = forward(params, spec, b, a)
    return torch.cat([flow10, flow01], 1).permute(0, 2, 3, 1)
