"""fLDRnet in PyTorch — the counterpart of fldrx/model/fldrnet.py:
the inference forward, the training forward and fresh parameters.

Layout: NHWC activations at every function boundary, as in fldrx, so the
two packages compare like with like; convs run through `F.conv2d` on
channels-last views of them (OIHW weights, see weights.py).

Parameters are the nested dict of tensors from `weights.params_from_numpy`.

Channel-order contract inherited from the reference and baked into the
trained weights: PCA features are ordered (c, t, comp) → channel
c·2nf + t·nf + comp, and the flow step splits that axis at 48, mixing frames
between the halves.

Kernels: the warps go through ops/fastwarp (gather, splat) and, under bf16,
the refine UNet's packed convs through ops/fastconv.conv3x3. dec0/dec1 and
every flow-path conv stay `F.conv2d`, as fldrx leaves them to XLA. The
fast warps are the differentiable forms (`bwarp_diff`, `softsplat_diff`:
kernel forward, kernel backward), so the same functions serve inference,
under `torch.inference_mode()`, and training. The packed synthesis calls
the forward kernels directly and is inference only.

The packed synthesis (`synthesize_packed_multi`) is a TPU layout in fldrx;
here it computes the same values in plain NHWC up to the refine UNet, whose
space-to-depth output the final blend reads in place (ops/blend.py), writing
the frame once, as plain rows or as u-planes (ops/repack.py).

Spans (utils/trace.py, recorded only while a profiler runs) name the
stages: `features` and `levels` of the flow (inference and training),
`pack` and `z` of the t-independent extras, and for each t of a synthesis
`splat`, `flowback`, `gather`, `refine_in` (the UNet's input; packed, one
launch of ops/repack.py's `pack_s2d4` kernel, which concatenates, casts and
space-to-depths in one pass; else the concatenation and the cast),
`unet` and `blend` (packed, one launch of ops/blend.py's kernel).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FLDRConfig
from ..device import resolve_device
from ..ops import fastwarp
from ..ops.block_pca import block_pca_features, pca_projection
from ..ops.fastconv import conv3x3
from ..ops.blend import blend6_out
from ..ops.repack import pack_s2d4
from ..ops.resize import resize_2d
from ..ops.splat import softsplat, softsplat_norm, softsplat_vals
from ..ops.warp import bwarp, ones_mask_sep, sample_coords
from ..utils import trace
from ..weights import named_leaves, unflatten_params

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           pad: int = 1) -> torch.Tensor:
    """NHWC conv with the OIHW weight p["w"] and bias p["b"], zero padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].to(x.dtype),
                 p["b"].to(x.dtype), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


relu = F.relu


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """nn.UpsamplingNearest2d(scale_factor=2) on NHWC."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, H * 2, W * 2, C)


def _seq_conv_relu(ps: Sequence[Params], x: torch.Tensor) -> torch.Tensor:
    """conv-ReLU chain with no activation after the last conv."""
    for i, p in enumerate(ps):
        x = conv2d(p, x)
        if i != len(ps) - 1:
            x = relu(x)
    return x


# ---------------------------------------------------------------------------
# refine UNet
# ---------------------------------------------------------------------------

def refine_unet(p: Params, x: torch.Tensor) -> torch.Tensor:
    enc1 = relu(conv2d(p["enc1"], x, stride=2, pad=1))
    enc2 = relu(conv2d(p["enc2"], enc1, stride=2, pad=1))
    out = relu(conv2d(p["enc3"], enc2, stride=2, pad=1))
    out = relu(conv2d(p["dec0"], out))
    out = torch.cat([upsample_nearest2x(out), enc2], -1)
    out = relu(conv2d(p["dec1"], out))
    out = torch.cat([upsample_nearest2x(out), enc1], -1)
    out = relu(conv2d(p["dec2"], out))
    return conv2d(p["dec3"], upsample_nearest2x(out))


def s2d(x: torch.Tensor, f: int) -> torch.Tensor:
    """[B,H,W,C] → [B,H/f,W/f,f²C]; cell-major channel order (u·f+v)·C+c."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // f, f, W // f, f, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // f, W // f, f * f * C)


def d2s(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of s2d."""
    B, Hf, Wf, Cf = x.shape
    C = Cf // (f * f)
    x = x.reshape(B, Hf, Wf, f, f, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hf * f, Wf * f, C)


@functools.lru_cache(maxsize=None)
def _repack_conv_idx(kh: int, kw: int, C: int, K: int, pin: int, pout: int,
                     stride: int, pad: int):
    """Gather index + mask (numpy, read only) that re-index HWIO conv
    weights [kh,kw,C,K] for packed operands: each fine-kernel tap lands at
    exactly one position of a 3×3 packed kernel [3,3,pin²C,pout²K]."""
    idx = np.zeros((3, 3, pin * pin * C, pout * pout * K), np.int64)
    mask = np.zeros((3, 3, pin * pin * C, pout * pout * K), bool)
    blk = np.arange(C)[:, None] * K + np.arange(K)[None, :]
    for io in range(pout):
        for jo in range(pout):
            for ky in range(kh):
                for kx in range(kw):
                    dy, uy = divmod(stride * io + ky - pad, pin)
                    dx, ux = divmod(stride * jo + kx - pad, pin)
                    ci = (uy * pin + ux) * C
                    co = (io * pout + jo) * K
                    idx[dy + 1, dx + 1, ci:ci + C, co:co + K] = \
                        (ky * kw + kx) * C * K + blk
                    mask[dy + 1, dx + 1, ci:ci + C, co:co + K] = True
    idx.flags.writeable = False
    mask.flags.writeable = False
    return idx, mask


@functools.lru_cache(maxsize=32)
def _repack_conv_idx_dev(kh, kw, C, K, pin, pout, stride, pad, device: str):
    # one host-to-device copy per (shape, device), not one per call; made
    # outside inference mode, so that training may index with them after
    # inference cached them
    idx, mask = _repack_conv_idx(kh, kw, C, K, pin, pout, stride, pad)
    with torch.inference_mode(False):
        return (torch.tensor(idx, device=device),
                torch.tensor(mask, device=device))


def _repack_conv_w(w: torch.Tensor, pin: int, pout: int, stride: int,
                   pad: int) -> torch.Tensor:
    """Re-index OIHW conv weights [K,C,kh,kw] for packed operands (weight
    exact; requires pin == stride·pout) → OIHW [pout²K, pin²C, 3, 3]."""
    K, C, kh, kw = w.shape
    if pin != stride * pout:
        raise ValueError(f"packing needs pin == stride·pout ({pin}, {stride}, {pout})")
    idx, mask = _repack_conv_idx_dev(kh, kw, C, K, pin, pout, stride, pad,
                                     str(w.device))
    flat = w.permute(2, 3, 1, 0).reshape(-1)        # HWIO order
    # index_select, not flat[idx]: its backward is one index_add_, where
    # advanced indexing's sorts ~10^5 duplicate indices per conv
    taps = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)
    packed = torch.where(mask, taps, torch.zeros((), dtype=w.dtype,
                                                 device=w.device))
    return packed.permute(3, 2, 0, 1)


def _packed_conv(p: Params, x: torch.Tensor, pin: int, pout: int,
                 stride: int, pad: int = 1) -> torch.Tensor:
    w = _repack_conv_w(p["w"], pin, pout, stride, pad)
    b = p["b"].repeat(pout * pout)
    if x.dtype == torch.bfloat16:
        return conv3x3(x, w, b)                      # the hand-written kernel
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def refine_unet_s2d_core(p: Params, xs4: torch.Tensor) -> torch.Tensor:
    """The refine UNet on space-to-depth packed tensors (weight exact):
    cell-major s2d4 input [B, H/4, W/4, 16·C] → s2d4 output
    [B, H/4, W/4, 16·out]."""
    e1 = relu(_packed_conv(p["enc1"], xs4, 4, 2, 2))   # s2d2(half), 64ch
    e2 = relu(_packed_conv(p["enc2"], e1, 2, 1, 2))    # plain quarter, 32ch
    e3 = relu(_packed_conv(p["enc3"], s2d(e2, 2), 2, 1, 2))  # eighth, 64ch
    d0 = relu(conv2d(p["dec0"], e3))
    u0 = torch.cat([upsample_nearest2x(d0), e2], -1)   # 96ch quarter
    d1 = relu(conv2d(p["dec1"], u0))                   # 32ch quarter
    # half grid, packed: d1 repeated per cell beside that cell's e1 slice
    e1c = e1.shape[-1] // 4
    u1 = torch.cat([torch.cat([d1, e1[..., cell * e1c:(cell + 1) * e1c]], -1)
                    for cell in range(4)], -1)         # 4·(32+16)
    d2 = relu(_packed_conv(p["dec2"], u1, 2, 2, 1))    # s2d2(half), 64ch
    # full grid packed: s2d4 cell (u,v) ← d2 cell (u//2, v//2)
    d2c = d2.shape[-1] // 4
    u2 = torch.cat([d2[..., ((u // 2) * 2 + v // 2) * d2c:
                       ((u // 2) * 2 + v // 2 + 1) * d2c]
                    for u in range(4) for v in range(4)], -1)   # 16·16
    return _packed_conv(p["dec3"], u2, 4, 4, 1)        # s2d4(full), 16·out


def refine_unet_s2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """refine_unet through the packed form (H, W multiples of 4)."""
    return d2s(refine_unet_s2d_core(p, s2d(x, 4)), 4)


def unet_reach() -> int:
    """The refine UNet's receptive reach: the largest distance, in input
    columns, between an output column and an input column it depends on.
    Each layer maps an interval of its output columns to the interval it
    reads (3×3 convs with padding 1, the stride-2 encoders, nearest 2×
    upsampling, the skip concatenations); the reach is the widest over the
    8 phases of the stride-8 grid."""
    def conv(iv, stride=1):
        return stride * iv[0] - 1, stride * iv[1] + 1

    def up(iv):
        return iv[0] // 2, iv[1] // 2

    def union(a, b):
        return min(a[0], b[0]), max(a[1], b[1])

    # each maps columns [lo, hi] of a layer's output to the input's
    def enc1(iv):
        return conv(iv, 2)

    def enc2(iv):
        return enc1(conv(iv, 2))

    def dec0(iv):
        return enc2(conv(conv(iv), 2))              # dec0 ∘ enc3

    def dec1(iv):
        c = conv(iv)
        return union(dec0(up(c)), enc2(c))

    def dec2(iv):
        c = conv(iv)
        return union(dec1(up(c)), enc1(c))

    reach = 0
    for x in range(8):
        lo, hi = dec2(up(conv((x, x))))            # dec3 on up(dec2)
        reach = max(reach, x - lo, hi - x)
    return reach


UNET_GRID = 8           # the UNet's stride: slabs start on multiples of it
# columns a width slab of the level-0 synthesis takes on each side for the
# refine UNet (its reach, rounded up to the grid), so that its output over
# the slab equals the whole frame's
UNET_HALO = -(-unet_reach() // UNET_GRID) * UNET_GRID


def unet_columns(cols: Tuple[int, int], W: int) -> Tuple[int, int]:
    """The columns [a, b) of a frame W wide that the refine UNet reads for
    output columns [lo, hi): UNET_HALO on each side, none beyond the
    frame."""
    lo, hi = cols
    return max(0, lo - UNET_HALO), min(W, hi + UNET_HALO)


# ---------------------------------------------------------------------------
# flow
# ---------------------------------------------------------------------------

def level_flow(p: Params, feat: torch.Tensor,
               flow_prev: Optional[torch.Tensor],
               fast: bool = True) -> torch.Tensor:
    """One flow step on PCA features [B, h, w, 96], split at 48.
    Returns flow [B, h, w, 4] = (flow_10 x, y, flow_01 x, y). The feature
    splats (48 + 1 channels) go through the splat kernel unless `fast` is
    false (fldrx runs them as its exact XLA scatter either way)."""
    ssplat = fastwarp.softsplat_diff if fast else softsplat
    half = feat.shape[-1] // 2
    feat0 = feat[..., :half]
    feat1 = feat[..., half:]
    if flow_prev is None:
        tmp = _seq_conv_relu(p["flow_bottom"], torch.cat([feat0, feat1], -1))
        return tmp[..., :4]
    # the reference scales all 4 channels by the width ratio only, and
    # stops the gradient through the previous level's flow
    h, w = feat.shape[1], feat.shape[2]
    prev = flow_prev.detach()
    up = resize_2d(prev, (h, w), "bilinear") * (w / flow_prev.shape[2])
    warped1 = ssplat(feat1, up[..., 0:2])
    warped0 = ssplat(feat0, up[..., 2:4])
    a = conv2d(p["conv_flow1"], torch.cat([feat0, warped1], -1))
    b = conv2d(p["conv_flow1"], torch.cat([feat1, warped0], -1))
    tmp = _seq_conv_relu(p["conv_flow2"], torch.cat([a, b, up], -1))
    return tmp[..., :4] + up


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------

def _warp_fns(fast: bool):
    """(bwarp, softsplat): the exact plain ops, or the differentiable
    kernel forms."""
    if fast:
        return fastwarp.bwarp_diff, fastwarp.softsplat_diff
    return bwarp, softsplat


def _bwarp_ones_mask(flow: torch.Tensor) -> torch.Tensor:
    """bwarp's 0.999 mask from the sampling coords, separable form:
    flow [B, H, W, 2] → [B, H, W, 1]."""
    H, W = flow.shape[1], flow.shape[2]
    sx, sy = sample_coords(flow)
    return ones_mask_sep(sx, sy, H, W).unsqueeze(-1)


def z_metrics(p: Params, x0, x1, flow_10, flow_01, fast: bool = False):
    """Softsplat importance metrics z0/z1 (t-independent). The fast form
    gathers through the kernel with the separable mask."""
    z_alpha = p["z_alpha"].to(x0.dtype)
    bw, _ = _warp_fns(fast)
    im_1_0 = bw(x1, flow_01)
    im_0_1 = bw(x0, flow_10)
    z0 = torch.mean(z_alpha[0] * torch.abs(x0 - im_1_0), -1, keepdim=True)
    z1 = torch.mean(z_alpha[1] * torch.abs(x1 - im_0_1), -1, keepdim=True)
    return z0, z1


def synthesize(p: Params, flow_l: torch.Tensor, images: torch.Tensor,
               t: torch.Tensor, crop_hw: Optional[Tuple[int, int]] = None,
               fast: bool = False, precomputed=None,
               compute_dtype=torch.float32,
               cols: Optional[Tuple[int, int]] = None):
    """Warp + blend at one level (fldrx synthesize).

    flow_l [B, h, w, 4]; images [B, 2, H, W, 3]; t [B, 1]; `crop_hw` crops
    the full-resolution flows and frames before the warps (validation).
    Returns (out [B, H, W, 3], flow_refine, occ_0, (flow_t0, flow_t1)).

    With `cols` (lo, hi), multiples of UNET_GRID, the warps still cover the
    whole frame but the refine UNet reads only `unet_columns` and the blend
    makes only columns [lo, hi): out and occ_0 are [B, H, hi − lo, ·], equal
    to those columns of the whole frame's (width-sharded training)."""
    B = flow_l.shape[0]
    tb = t.reshape(B, 1, 1, 1).to(flow_l.dtype)
    flow_10 = flow_l[..., 0:2]
    flow_01 = flow_l[..., 2:4]
    flow_t0 = tb * flow_01
    flow_t1 = (1.0 - tb) * flow_10
    flow_refine = torch.cat([flow_t0, flow_t1], -1)

    H, W = images.shape[2], images.shape[3]
    upscale = H // flow_l.shape[1]

    def up(f):
        return upscale * resize_2d(f, (H, W), "bilinear")

    if precomputed is not None:
        flow_10, flow_01, z0, z1 = precomputed[:4]
        if fast:
            # scalar t commutes through the linear resize
            flow_t0, flow_t1 = tb * flow_01, (1.0 - tb) * flow_10
        else:
            flow_t0, flow_t1 = up(flow_t0), up(flow_t1)
    else:
        flow_t0, flow_t1 = up(flow_t0), up(flow_t1)
        flow_10, flow_01 = up(flow_10), up(flow_01)

    x0 = images[:, 0]
    x1 = images[:, 1]
    if crop_hw is not None:
        ch, cw = crop_hw
        flow_t0, flow_t1 = flow_t0[:, :ch, :cw], flow_t1[:, :ch, :cw]
        flow_10, flow_01 = flow_10[:, :ch, :cw], flow_01[:, :ch, :cw]
        x0, x1 = x0[:, :ch, :cw], x1[:, :ch, :cw]
    bw, ssplat = _warp_fns(fast)
    if precomputed is None:
        z0, z1 = z_metrics(p, x0, x1, flow_10, flow_01, fast)

    with trace.span("splat"):
        warped0 = ssplat(x0, flow_t0, z=z0)
        warped1 = ssplat(x1, flow_t1, z=z1)

    with trace.span("flowback"):
        if fast and min(flow_l.shape[1], flow_l.shape[2]) >= 96:
            # compose the flows at the feature grid and upsample the
            # result; the validity mask is applied at full resolution
            fb0 = bw(flow_l[..., 0:2] * tb, (1.0 - tb) * flow_l[..., 2:4],
                     False)
            fb1 = bw(flow_l[..., 2:4] * (1.0 - tb), tb * flow_l[..., 0:2],
                     False)
            flowback_0 = up(fb0)
            flowback_1 = up(fb1)
            if crop_hw is not None:
                flowback_0 = flowback_0[:, :crop_hw[0], :crop_hw[1]]
                flowback_1 = flowback_1[:, :crop_hw[0], :crop_hw[1]]
            # flow_01/flow_10 are cropped already, so the masks are too
            flowback_0 = flowback_0 * _bwarp_ones_mask((1.0 - tb) * flow_01)
            flowback_1 = flowback_1 * _bwarp_ones_mask(tb * flow_10)
        else:
            flowback_0 = bw(flow_10 * tb, (1.0 - tb) * flow_01)
            flowback_1 = bw(flow_01 * (1.0 - tb), tb * flow_10)
    with trace.span("gather"):
        im0_tot = bw(x0, flowback_0)
        im1_tot = bw(x1, flowback_1)

    with trace.span("refine_in"):
        parts = [x0, x1, warped0, warped1, flow_t0, flow_t1,
                 flowback_0, flowback_1, im0_tot, im1_tot]
        if cols is not None:
            lo, hi = cols
            if lo % UNET_GRID or hi % UNET_GRID:
                raise ValueError(f"slab {cols} is off the UNet's "
                                 f"{UNET_GRID}-column grid")
            a, b = unet_columns(cols, x0.shape[2])
            parts = [v[:, :, a:b] for v in parts]
        refine_in = torch.cat(parts, -1).to(compute_dtype)      # 26 ch
    with trace.span("unet"):
        unet = (refine_unet_s2d
                if refine_in.shape[1] % 4 == 0 and refine_in.shape[2] % 4 == 0
                else refine_unet)
        out = unet(p["refine"], refine_in).float()
    if cols is not None:
        out = out[:, :, lo - a:hi - a]
        x0, x1, warped0, warped1, im0_tot, im1_tot = (
            v[:, :, lo:hi] for v in (x0, x1, warped0, warped1, im0_tot,
                                     im1_tot))

    with trace.span("blend"):
        T = p["T_param"].float()
        occ = torch.softmax(out[..., :6] / T, -1)
        w0 = (1 - tb) * occ[..., 0:1]
        w1 = tb * occ[..., 1:2]
        w2 = (1 - tb) * occ[..., 2:3]
        w3 = tb * occ[..., 3:4]
        w4 = (1 - tb) * occ[..., 4:5]
        w5 = tb * occ[..., 5:6]
        divisor = w0 + w1 + w2 + w3 + w4 + w5
        out_l = (w0 * warped0 + w1 * warped1 + w2 * im0_tot + w3 * im1_tot
                 + w4 * x0 + w5 * x1) / divisor
    return out_l, flow_refine, occ[..., 0:1], (flow_t0, flow_t1)


def can_use_packed(flow_l: torch.Tensor, images: torch.Tensor) -> bool:
    """Shape gate of the packed synthesis: frames divisible by 32 and a
    flow grid large enough for the low-res flowback composition."""
    H, W = images.shape[2], images.shape[3]
    return (H % 32 == 0 and W % 32 == 0
            and min(flow_l.shape[1], flow_l.shape[2]) >= 96)


def synthesize_packed_multi(p: Params, flow_l: torch.Tensor,
                            images: torch.Tensor, ts, precomputed=None,
                            compute_dtype=torch.float32,
                            planes_out: bool = False) -> torch.Tensor:
    """Level-0 synthesis of the fast packed path for a chunk of t values,
    with the values of fldrx synthesize_packed_multi:

    * scalar t commuted through the precomputed full-res flows;
    * the low-res flowback composition (gather at the flow grid),
      upsampled and masked with ones_mask_sep at full resolution;
    * im_tot gathers with the separable mask;
    * the UNet in s2d4 form fed in canonical channel order, its input
      packed in one pass (`pack_s2d4`);
    * the log-t folded six-way blend with no divisor, read from the UNet's
      s2d4 logits as they are (`blend6_out`, one launch a t on the card).

    The t-independent splat values are built once for the whole chunk, and
    the chunk's frames are allocated once: each t's blend writes its frame
    there. ts: sequence of [B, 1] t tensors. Returns [T, B, H, W, 3], or
    with planes_out the u-planes [T, B, 4, H/4, W·3] (the same values;
    fldrx planes_out)."""
    B = flow_l.shape[0]
    flow_l = flow_l.float()
    # the frames' rows are read in place by pack_s2d4 and the blend (a
    # copy only where a caller's padding left them channel-planar)
    images = images.float().contiguous()
    flow_10 = flow_l[..., 0:2]
    flow_01 = flow_l[..., 2:4]
    H, W = images.shape[2], images.shape[3]
    upscale = H // flow_l.shape[1]
    x0 = images[:, 0]
    x1 = images[:, 1]
    if precomputed is not None:
        flow_10f, flow_01f, z0, z1 = precomputed[:4]
    else:
        flow_10f = upscale * resize_2d(flow_10, (H, W), "bilinear")
        flow_01f = upscale * resize_2d(flow_01, (H, W), "bilinear")
        z0, z1 = z_metrics(p, x0, x1, flow_10f, flow_01f, fast=True)

    vals0 = softsplat_vals(x0, z0)
    vals1 = softsplat_vals(x1, z1)
    xs = torch.arange(W, dtype=torch.float32, device=images.device)
    ys = torch.arange(H, dtype=torch.float32,
                      device=images.device).unsqueeze(-1)
    Tparam = p["T_param"].float()
    shape = (B, 4, H // 4, W * 3) if planes_out else (B, H, W, 3)
    result = None
    for i, t in enumerate(ts):
        with trace.span("splat"):
            tb = t.reshape(B, 1, 1, 1).float()
            ft0 = tb * flow_01f
            ft1 = (1.0 - tb) * flow_10f
            warped0 = softsplat_norm(fastwarp.splat(vals0, xs + ft0[..., 0],
                                                    ys + ft0[..., 1]))
            warped1 = softsplat_norm(fastwarp.splat(vals1, xs + ft1[..., 0],
                                                    ys + ft1[..., 1]))
        with trace.span("flowback"):
            # flowback composition at the flow grid, no mask
            sx, sy = sample_coords((1.0 - tb) * flow_01)
            fb0 = fastwarp.gather(flow_10 * tb, sx, sy)
            sx, sy = sample_coords(tb * flow_10)
            fb1 = fastwarp.gather(flow_01 * (1.0 - tb), sx, sy)
            fb0 = (upscale * resize_2d(fb0, (H, W), "bilinear")
                   * _bwarp_ones_mask((1.0 - tb) * flow_01f))
            fb1 = (upscale * resize_2d(fb1, (H, W), "bilinear")
                   * _bwarp_ones_mask(tb * flow_10f))
        with trace.span("gather"):
            # row-major for the blend: the kernel's output is, the CPU's
            # plain gather follows its W-major coordinates
            sx, sy = sample_coords(fb0)
            im0 = fastwarp.gather(x0, sx, sy, mask=True).contiguous()
            sx, sy = sample_coords(fb1)
            im1 = fastwarp.gather(x1, sx, sy, mask=True).contiguous()
        with trace.span("refine_in"):
            refine_in = pack_s2d4([x0, x1, warped0, warped1, ft0, ft1,
                                   fb0, fb1, im0, im1], compute_dtype)
        with trace.span("unet"):
            logits = refine_unet_s2d_core(p["refine"], refine_in)
        with trace.span("blend"):
            if result is None:      # after the first UNet: not in its peak
                result = torch.empty((len(ts), *shape), dtype=torch.float32,
                                     device=images.device)
            blend6_out(logits, (warped0, warped1, im0, im1, x0, x1), tb,
                       Tparam, out=result[i])
    return result


# ---------------------------------------------------------------------------
# top-level forward
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _stage_dtype(cfg: FLDRConfig, stage: str, default):
    """Per-stage compute dtype: cfg.flow_dtype / cfg.unet_dtype override
    the session compute dtype."""
    return _DTYPES.get(getattr(cfg, stage, "") or "", default)


def _packed_enabled(cfg: FLDRConfig) -> bool:
    return cfg.fast_warp and cfg.packed_synth


def _level_pca(params: Params, cfg: FLDRConfig, level: int) -> Params:
    """The PCA fit that pyramid level `level` is transformed with."""
    pca = params["pca"]
    if not cfg.exac_one_ev:
        pca = params.get("pca_multi", {}).get(f"s{cfg.scales[level]}", pca)
    return pca


def pca_extrema(params: Params, cfg: FLDRConfig,
                pyramid: Sequence[torch.Tensor], n_levels: int):
    """[(min, max)] of each level's block-PCA components before the
    min-max: what a part of a batch contributes to the batch's extremes."""
    out = []
    for i in range(n_levels):
        pca = _level_pca(params, cfg, i)
        f = pca_projection(pyramid[i], pca["mean"], pca["ev"],
                           pca["mean_vec"], wiS=cfg.wiS)
        out.append((f.amin(), f.amax()))
    return out


def extract_features(params: Params, cfg: FLDRConfig,
                     pyramid: Sequence[torch.Tensor], n_levels: int,
                     compute_dtype=torch.float32,
                     minmax=None) -> List[torch.Tensor]:
    """Per-level PCA features + the residual context convs. `minmax(feat,
    level)` → (min, max), if given, supplies the whole batch's extremes
    where `pyramid` holds a part of the batch (ops/block_pca.py)."""
    feats = []
    for i in range(n_levels):
        pca = _level_pca(params, cfg, i)
        f = block_pca_features(
            pyramid[i], pca["mean"], pca["ev"], pca["mean_vec"], wiS=cfg.wiS,
            per_item_minmax=cfg.per_item_minmax,
            minmax=None if minmax is None else functools.partial(
                minmax, level=i)).to(compute_dtype)
        r = relu(conv2d(params["rec_ctx"]["conv0"], f))
        r = relu(conv2d(params["rec_ctx"]["conv1"], r))
        feats.append(r + f)
    return feats


def forward_flow(params: Params, cfg: FLDRConfig,
                 pyramid: Sequence[torch.Tensor],
                 compute_dtype=torch.float32, minmax=None) -> torch.Tensor:
    """Coarse-to-fine flow estimation (levels S_tst..0); t-independent.
    `minmax`: see extract_features."""
    compute_dtype = _stage_dtype(cfg, "flow_dtype", compute_dtype)
    with trace.span("features"):
        feats = extract_features(params, cfg, pyramid, cfg.S_tst + 1,
                                 compute_dtype, minmax)
    vp = params["vfinet"]
    flow = None
    with trace.span("levels"):
        for level in range(cfg.S_tst, -1, -1):
            flow = level_flow(vp, feats[level], flow)
    return flow


def flow_extras(params: Params, cfg: FLDRConfig, flow: torch.Tensor,
                images: torch.Tensor):
    """The t-independent synthesis work: full-res flows and the z maps.
    On the packed path with H, W multiples of 64, z is computed at half
    resolution (two half-size gathers, bilinearly upsampled)."""
    fast = cfg.fast_warp
    flow = flow.float()
    images = images.float()
    B, _, H, W, _ = images.shape
    upscale = H // flow.shape[1]
    with trace.span("pack"):
        flow_10 = upscale * resize_2d(flow[..., 0:2], (H, W), "bilinear")
        flow_01 = upscale * resize_2d(flow[..., 2:4], (H, W), "bilinear")
    packed = _packed_enabled(cfg) and can_use_packed(flow, images)
    with trace.span("z"):
        if fast and packed and H % 64 == 0 and W % 64 == 0:
            Hh, Wh = H // 2, W // 2
            imgs2 = resize_2d(images.reshape(B * 2, H, W, 3), (Hh, Wh),
                              "bilinear").reshape(B, 2, Hh, Wh, 3)
            fl10h = (upscale / 2) * resize_2d(flow[..., 0:2], (Hh, Wh),
                                              "bilinear")
            fl01h = (upscale / 2) * resize_2d(flow[..., 2:4], (Hh, Wh),
                                              "bilinear")
            z0h, z1h = z_metrics(params["vfinet"], imgs2[:, 0], imgs2[:, 1],
                                 fl10h, fl01h, fast=True)
            z0 = resize_2d(z0h, (H, W), "bilinear")
            z1 = resize_2d(z1h, (H, W), "bilinear")
        else:
            z0, z1 = z_metrics(params["vfinet"], images[:, 0], images[:, 1],
                               flow_10, flow_01, fast)
    return (flow_10, flow_01, z0, z1)


def forward_synthesis(params: Params, cfg: FLDRConfig, flow: torch.Tensor,
                      images: torch.Tensor, t: torch.Tensor,
                      orig_hw: Optional[Tuple[int, int]] = None,
                      precomputed=None,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Level-0 synthesis for one t given the flow (and optionally the
    t-independent extras from `flow_extras`) → [B, H, W, 3]."""
    fast = cfg.fast_warp
    compute_dtype = _stage_dtype(cfg, "unet_dtype", compute_dtype)
    if _packed_enabled(cfg) and can_use_packed(flow, images):
        out = synthesize_packed_multi(params["vfinet"], flow, images, [t],
                                      precomputed=precomputed,
                                      compute_dtype=compute_dtype)[0]
    else:
        out = synthesize(params["vfinet"], flow.float(), images.float(), t,
                         fast=fast,
                         precomputed=precomputed[:4] if precomputed else None,
                         compute_dtype=compute_dtype)[0]
    if orig_hw is not None:
        out = out[:, :orig_hw[0], :orig_hw[1]]
    return out


def forward_synthesis_multi(params: Params, cfg: FLDRConfig,
                            flow: torch.Tensor, images: torch.Tensor, ts,
                            precomputed=None,
                            compute_dtype=torch.float32,
                            planes_out: bool = False) -> torch.Tensor:
    """Level-0 synthesis for a chunk of t values → [T, B, H, W, 3]. The
    packed path takes the whole chunk in one call, sharing its
    t-independent setup and writing each frame in place; there planes_out
    returns the u-planes [T, B, 4, H/4, W·3] (elsewhere it is ignored:
    callers check the shape)."""
    if _packed_enabled(cfg) and can_use_packed(flow, images):
        return synthesize_packed_multi(
            params["vfinet"], flow, images, ts, precomputed=precomputed,
            compute_dtype=_stage_dtype(cfg, "unet_dtype", compute_dtype),
            planes_out=planes_out)
    return torch.stack(
        [forward_synthesis(params, cfg, flow, images, t,
                           precomputed=precomputed,
                           compute_dtype=compute_dtype) for t in ts], 0)


def forward_test(params: Params, cfg: FLDRConfig,
                 pyramid: Sequence[torch.Tensor], t: torch.Tensor,
                 orig_hw: Optional[Tuple[int, int]] = None,
                 compute_dtype=torch.float32, minmax=None) -> torch.Tensor:
    """Inference: flow on levels S_tst..0, synthesis at level 0.
    pyramid[i]: [B, 2, H_i, W_i, 3]; returns [B, H, W, 3] cropped to
    orig_hw. `minmax`: see extract_features."""
    flow = forward_flow(params, cfg, pyramid, compute_dtype, minmax)
    return forward_synthesis(params, cfg, flow, pyramid[0], t, orig_hw,
                             compute_dtype=compute_dtype)


def forward_train(params: Params, cfg: FLDRConfig,
                  pyramid: Sequence[torch.Tensor], t: torch.Tensor,
                  validation: bool = False,
                  compute_dtype=torch.float32, minmax=None,
                  cols: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """Training forward: flow and synthesis at every level S_trn..0 (fldrx
    forward_train). With cfg.fast_warp_train the warps are the kernel forms
    with kernel backward passes. Returns the out pyramid (fine → coarse),
    the refined and unrefined flow pyramids, occ_0 at level 0, the mean
    picture and the endflow pyramid. `minmax`: see extract_features.
    `cols` (lo, hi): level 0's output and occ_0 cover only those columns
    (synthesize)."""
    S = cfg.S_trn
    fast = cfg.fast_warp_train
    with trace.span("features"):
        feats = extract_features(params, cfg, pyramid, S + 1, compute_dtype,
                                 minmax)
    vp = params["vfinet"]
    crop = None
    if validation:
        crop = (cfg.validation_patch_size, cfg.validation_patch_size)

    outs, flow_refines, unrefined, endflows = [], [], [], []
    flow = None
    with trace.span("levels"):
        for level in range(S, -1, -1):
            flow = level_flow(vp, feats[level], flow, fast=fast)
            out, fr, occ0, endflow = synthesize(
                vp, flow.float(), pyramid[level].float(), t, crop_hw=crop,
                fast=fast, cols=cols if level == 0 else None)
            outs.append(out)
            flow_refines.append(fr)
            unrefined.append(flow)
            endflows.append(endflow)
    return {
        "out_pyramid": outs[::-1],
        "flow_refine_pyramid": flow_refines[::-1],
        "unrefined_flow_pyramid": unrefined[::-1],
        "occ_0": occ0,
        "mean_pics": torch.mean(pyramid[0], 1),
        "endflow_pyramid": endflows[::-1],
    }


# ---------------------------------------------------------------------------
# initialisation (xavier-normal weights, zero bias)
# ---------------------------------------------------------------------------

def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int,
               cout: int) -> Params:
    std = float(np.sqrt(2.0 / (cin * kh * kw + cout * kh * kw)))
    w = torch.randn((cout, cin, kh, kw), generator=gen) * std     # OIHW
    return {"w": w, "b": torch.zeros(cout)}


def init_params(generator: torch.Generator, cfg: FLDRConfig,
                device=None) -> Params:
    """Fresh parameters with fldrx init_params' tree and shapes (conv
    weights OIHW here) on `device` (default cuda): xavier-normal from
    `generator` (a CPU torch.Generator; its numbers are not jax.random's),
    zero biases, and PCA placeholders that the first-batch fit replaces."""
    device = resolve_device(device)
    nf, dnf, u = cfg.nf, cfg.dctvfi_nf, cfg.unet_nf
    g = generator
    flow_bottom = [_conv_init(g, 3, 3, 2 * nf, 2 * nf),
                   _conv_init(g, 3, 3, 2 * nf, 2 * nf),
                   _conv_init(g, 3, 3, 2 * nf, 2 * nf),
                   _conv_init(g, 3, 3, 2 * nf, nf),
                   _conv_init(g, 3, 3, nf, 6)]
    conv_flow2 = [_conv_init(g, 3, 3, 2 * nf + 4, 2 * nf),
                  _conv_init(g, 3, 3, 2 * nf, 2 * nf),
                  _conv_init(g, 3, 3, 2 * nf, nf),
                  _conv_init(g, 3, 3, nf, nf),
                  _conv_init(g, 3, 3, nf, 4)]
    refine = {"enc1": _conv_init(g, 4, 4, cfg.unet_in, u),
              "enc2": _conv_init(g, 4, 4, u, 2 * u),
              "enc3": _conv_init(g, 4, 4, 2 * u, 4 * u),
              "dec0": _conv_init(g, 3, 3, 4 * u, 4 * u),
              "dec1": _conv_init(g, 3, 3, 6 * u, 2 * u),
              "dec2": _conv_init(g, 3, 3, 3 * u, u),
              "dec3": _conv_init(g, 3, 3, u, cfg.unet_out)}

    def pca_placeholder():
        return {"mean": torch.zeros(cfg.wiS ** 2),
                "ev": torch.eye(dnf, cfg.wiS ** 2),
                "mean_vec": torch.ones(dnf)}

    params = {"pca": pca_placeholder()}
    if not cfg.exac_one_ev:
        params["pca_multi"] = {f"s{s}": pca_placeholder()
                               for s in cfg.scales[:4]}
    params["rec_ctx"] = {"conv0": _conv_init(g, 3, 3, dnf * 6, dnf * 6),
                         "conv1": _conv_init(g, 3, 3, dnf * 6, dnf * 6)}
    params["vfinet"] = {"T_param": torch.ones(1), "z_alpha": torch.ones(2),
                        "flow_bottom": flow_bottom,
                        "conv_flow1": _conv_init(g, 3, 3, 2 * nf, nf),
                        "conv_flow2": conv_flow2, "refine": refine}
    return unflatten_params({n: v.to(device)
                             for n, v in named_leaves(params)})
