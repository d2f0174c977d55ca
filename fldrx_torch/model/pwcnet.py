"""PWC-Net optical flow in PyTorch — the counterpart of
fldrx/model/pwcnet.py, the reference's dormant distillation teacher (its QVI
variant, wired through the reference's useful.py:105-144).

Architecture: a 6-level conv extractor, one decoder per level (the cost
volume over backward-warped features, a dense-concat conv stack, learned
up-flow/up-feat deconvs), a dilated context refiner, ×20 flow scaling with
a bilinear resize to and from 64-divisible sizes.

Layout: NHWC at every function boundary, as in fldrx. Conv weights are OIHW
(`F.conv2d`), deconv weights torch's ConvTranspose2d [in, out, kh, kw]
(`F.conv_transpose2d`); `weights.pwc_params_from_numpy` carries fldrx's tree
across. The convs stay library calls, as fldrx leaves them to XLA. The cost
volume runs through the hand-written kernel (ops/correlation.py) and the
warp through the gather kernel (ops/fastwarp.py), both in their
differentiable forms, so the same functions serve callers that need
gradients; `get_bidirectional_flow` runs under `torch.inference_mode()`, as
fldrx's teacher runs without gradients.

Spans (utils/trace.py): `teacher`, a request, around each
`get_bidirectional_flow` call; in it, per direction, `resize` (to and from
the 64-divisible size), `extractor`, `decoders` and `refiner`; in
`decoders`, per level, `corr` around the cost volume and `warp` around the
backward warp, so that the decoders' own time is their convs, deconvs and
concatenations.

The trained teacher's checkpoint is not in the repository: until it is,
`init_pwc_params` gives seeded random weights at the published widths.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.correlation import correlation_diff
from ..ops.fastwarp import gather_diff
from ..ops.resize import resize_2d
from ..utils import trace
from ..weights import named_leaves, unflatten_params

Params = Dict[str, Any]

_MEAN = (0.429, 0.431, 0.397)
_LEVEL_CHANNELS = (16, 32, 64, 96, 128, 196)
_DECODER_IN = {2: 81 + 32 + 2 + 2, 3: 81 + 64 + 2 + 2, 4: 81 + 96 + 2 + 2,
               5: 81 + 128 + 2 + 2, 6: 81}
_DBL_BACKWARD = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_DEC_CONVS = ("one", "two", "thr", "fou", "fiv")


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv(p: Params, x: torch.Tensor, stride: int = 1, pad: int = 1,
          dilation: int = 1) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], stride=stride,
                 padding=pad, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def deconv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=4, s=2, p=1) on NHWC: output 2× spatial (fldrx
    `_deconv4x4s2`)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["w"], p["b"], stride=2,
                           padding=1)
    return y.permute(0, 2, 3, 1)


def extractor(p: Params, x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    for lv in range(6):
        blk = p[f"level{lv}"]
        x = _lrelu(_conv(blk[0], x, stride=2))
        x = _lrelu(_conv(blk[1], x))
        x = _lrelu(_conv(blk[2], x))
        feats.append(x)
    return feats


def backward_warp_pwc(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The reference's Decoder.Backward (fldrx `_backward_warp_pwc`):
    grid_sample on a [-1, 1] linspace grid plus flow/((S−1)/2), zeros
    outside, masked where the sampled all-ones image is below 0.999.

    The sample positions are built as fldrx builds them; the grid comes
    from torch.linspace, as in the reference (jnp.linspace rounds some
    entries 1 ulp differently). The gather kernel tests the mask in its
    separable closed form, `gx·gy >= 0.999`, where fldrx thresholds the
    corner sum with a strict `>`: the two differ only where the sampled
    ones lie within an ulp of 0.999 (tests/test_torch_pwcnet.py holds the
    masks equal at its shapes)."""
    B, H, W, C = x.shape
    xs = torch.linspace(-1.0, 1.0, W, dtype=flow.dtype, device=flow.device)
    ys = torch.linspace(-1.0, 1.0, H, dtype=flow.dtype, device=flow.device)
    gx = xs + flow[..., 0] / ((W - 1.0) / 2.0)
    gy = ys[:, None] + flow[..., 1] / ((H - 1.0) / 2.0)
    px = ((gx + 1.0) * W - 1.0) / 2.0
    py = ((gy + 1.0) * H - 1.0) / 2.0
    return gather_diff(x, px, py, mask=True)


def decoder(p: Params, level: int, feat1: torch.Tensor, feat2: torch.Tensor,
            previous: Optional[Dict[str, torch.Tensor]]):
    if previous is None:
        with trace.span("corr"):
            vol = correlation_diff(feat1, feat2)
        feat = _lrelu(vol)
    else:
        flow_in = deconv(p["upflow"], previous["flow"])
        upfeat = deconv(p["upfeat"], previous["feat"])
        with trace.span("warp"):
            warped = backward_warp_pwc(feat2, flow_in * _DBL_BACKWARD[level])
        with trace.span("corr"):
            vol = correlation_diff(feat1, warped)
        feat = torch.cat([_lrelu(vol), feat1, flow_in, upfeat], -1)
    for name in _DEC_CONVS:
        feat = torch.cat([_lrelu(_conv(p[name], feat)), feat], -1)
    return {"flow": _conv(p["six"], feat), "feat": feat}


def refiner(p: List[Params], feat: torch.Tensor) -> torch.Tensor:
    x = feat
    for i, d in enumerate((1, 2, 4, 8, 16, 1)):
        x = _lrelu(_conv(p[i], x, pad=d, dilation=d))
    return _conv(p[6], x)


def pwc_forward(params: Params, im1: torch.Tensor,
                im2: torch.Tensor) -> torch.Tensor:
    """PWCNet.forward: im1, im2 [B,H,W,3] RGB in [0,1] float32 → flow
    [B,H,W,2] in pixels at the input resolution."""
    B, H, W, _ = im1.shape
    mean = torch.tensor(_MEAN, dtype=im1.dtype, device=im1.device)
    im1 = im1 - mean
    im2 = im2 - mean
    ph = int(np.ceil(H / 64.0) * 64)
    pw = int(np.ceil(W / 64.0) * 64)
    if (ph, pw) != (H, W):
        with trace.span("resize"):
            im1 = resize_2d(im1, (ph, pw), "bilinear")
            im2 = resize_2d(im2, (ph, pw), "bilinear")

    with trace.span("extractor"):
        f1 = extractor(params["extractor"], im1)
        f2 = extractor(params["extractor"], im2)
    est = None
    with trace.span("decoders"):
        for level in (6, 5, 4, 3, 2):
            est = decoder(params[f"dec{level}"], level, f1[level - 1],
                          f2[level - 1], est)
    with trace.span("refiner"):
        flow = est["flow"] + refiner(params["refiner"], est["feat"])

    with trace.span("resize"):
        flow = 20.0 * resize_2d(flow, (H, W), "bilinear")
    return flow * torch.tensor([W / pw, H / ph], dtype=flow.dtype,
                               device=flow.device)


def get_bidirectional_flow(params: Params, im0: torch.Tensor,
                           im1: torch.Tensor) -> torch.Tensor:
    """The teacher's get_flow (reference useful.py:112-117), without
    gradients: [B,H,W,4] = (flow_10, flow_01). One `teacher` span, a
    request."""
    with torch.inference_mode(), trace.span("teacher", request=True):
        flow01 = pwc_forward(params, im0, im1)
        flow10 = pwc_forward(params, im1, im0)
        return torch.cat([flow10, flow01], -1)


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------

def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int,
               cout: int) -> Params:
    """fldrx's init: normal / sqrt(fan_in), zero bias; OIHW."""
    w = torch.randn((cout, cin, kh, kw), generator=gen) / np.sqrt(cin * kh * kw)
    return {"w": w, "b": torch.zeros(cout)}


def _deconv_init(gen: torch.Generator, cin: int, cout: int) -> Params:
    """The same spread for a 4×4 deconv, in torch's [in, out, kh, kw]."""
    w = torch.randn((cin, cout, 4, 4), generator=gen) / np.sqrt(cin * 16)
    return {"w": w, "b": torch.zeros(cout)}


def init_pwc_params(generator: torch.Generator, device=None) -> Params:
    """Fresh teacher parameters with fldrx init_pwc_params' tree, shapes and
    spread, drawn from `generator` (a CPU torch.Generator, so one seed
    gives the same weights on every device) and moved to `device` (default
    cuda)."""
    dev = resolve_device(device)
    g = generator
    p: Params = {"extractor": {}}
    cin = 3
    for lv, cout in enumerate(_LEVEL_CHANNELS):
        p["extractor"][f"level{lv}"] = [_conv_init(g, 3, 3, cin, cout),
                                        _conv_init(g, 3, 3, cout, cout),
                                        _conv_init(g, 3, 3, cout, cout)]
        cin = cout
    for level in (2, 3, 4, 5, 6):
        cur = _DECODER_IN[level]
        d: Params = {}
        if level < 6:
            prev = _DECODER_IN[level + 1]
            d["upflow"] = _deconv_init(g, 2, 2)
            d["upfeat"] = _deconv_init(g, prev + 128 + 128 + 96 + 64 + 32, 2)
        widths = [(cur, 128), (cur + 128, 128), (cur + 256, 96),
                  (cur + 352, 64), (cur + 416, 32), (cur + 448, 2)]
        for name, (ci, co) in zip(_DEC_CONVS + ("six",), widths):
            d[name] = _conv_init(g, 3, 3, ci, co)
        p[f"dec{level}"] = d
    rin = 81 + 32 + 2 + 2 + 128 + 128 + 96 + 64 + 32
    rw = [(rin, 128), (128, 128), (128, 128), (128, 96), (96, 64), (64, 32),
          (32, 2)]
    p["refiner"] = [_conv_init(g, 3, 3, ci, co) for ci, co in rw]
    return unflatten_params({n: v.to(dev) for n, v in named_leaves(p)})
