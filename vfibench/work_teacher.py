"""The work of a PWC-Net teacher call, counted from the configuration's
widths, as vfibench/work.py counts fLDRnet's (its conv_flops,
resize_flops, floor_ms and compute_ms; the same rules):

- a conv counts 2 · out pixels · C_in · C_out · k² (a dilated conv the
  same), a 4×4 stride-2 deconv 2 · in pixels · C_in · C_out · 16;
- the cost volume 2 operations a channel for each of its (2d + 1)²
  displacements, the warp 4 corners a channel (8 operations), the resizes
  their taps (bilinear, separable);
- bytes are each stage's inputs read once and its outputs written once,
  and its weights; what a stage makes and uses inside itself is free.

A call is what the reference's MyPWC.get_flow does: two forward passes
(im0 → im1, im1 → im0), each extracting both images' features, so the
extractor counts four times a call. Stages, a direction: `extractor`,
`decoders` (the dense stacks, the flow convs and the deconvs), `corr` (the
five cost volumes), `warp` (the four warps), `refiner`, `resize` — the
program's span names.
"""

from __future__ import annotations

import math
from typing import List

from .work import F32, conv_flops, resize_flops

_B = 4                  # float32 bytes


def geometry(config: dict) -> dict:
    """The sizes the counts need, from the configuration's `pwcnet`
    widths, batch and crop."""
    w = config["pwcnet"]
    d = int(w["max_displacement"])
    return {"levels": [int(c) for c in w["extractor"]],
            "dense": [int(c) for c in w["decoder"]],
            "refiner": [int(c) for c in w["refiner_widths"]],
            "volume": (2 * d + 1) ** 2, "divisor": int(w["divisor"]),
            "batch": int(config["batch_size"]),
            "size": int(config["crop_size"])}


def _stage(name: str, flops: int, nbytes: int) -> dict:
    return {"name": name, "flops": {F32: int(flops)} if flops else {},
            "bytes": int(nbytes)}


def _conv_params(convs) -> int:
    return sum(cin * cout * k * k + cout for cin, cout, k in convs)


def decoder_in(g: dict, level: int) -> int:
    """The channels a level's dense stack starts from: the cost volume,
    and below the coarsest level the first image's features, the
    upsampled flow and the upsampled features (2 each)."""
    if level == 6:
        return g["volume"]
    return g["volume"] + g["levels"][level - 1] + 4


def direction_stages(g: dict, H: int, W: int, batch: int) -> List[dict]:
    """One forward pass (PWCNet.forward) on `batch` pairs of H×W."""
    B, c = batch, g["levels"]
    ph = int(math.ceil(H / g["divisor"]) * g["divisor"])
    pw = int(math.ceil(W / g["divisor"]) * g["divisor"])
    hw = [(ph >> (lv + 1), pw >> (lv + 1)) for lv in range(6)]
    stages = []
    # the extractor, both images
    convs, flops, feat_px = [], 0, 0
    cin = 3
    for lv, (h, w) in enumerate(hw):
        convs += [(cin, c[lv], 3), (c[lv], c[lv], 3), (c[lv], c[lv], 3)]
        flops += 2 * (conv_flops(h, w, cin, c[lv], 3, B)
                      + 2 * conv_flops(h, w, c[lv], c[lv], 3, B))
        feat_px += h * w * c[lv]
        cin = c[lv]
    stages.append(_stage("extractor", flops, _B * (
        2 * B * (ph * pw * 3 + feat_px) + _conv_params(convs))))
    # the decoders: dense stacks, flow convs, deconvs; the cost volumes and
    # warps apart
    dec_flops = dec_bytes = corr_flops = corr_bytes = 0
    warp_flops = warp_bytes = 0
    prev = None                             # the coarser level's stack
    for level in (6, 5, 4, 3, 2):
        h, w = hw[level - 1]
        cl, px = c[level - 1], B * h * w
        n = decoder_in(g, level)
        reads = g["volume"] + (0 if prev is None else cl)
        convs = []
        for k in g["dense"]:
            convs.append((n, k, 3))
            n += k
        convs.append((n, 2, 3))                     # the flow
        dec_flops += sum(conv_flops(h, w, a, b, 3, B) for a, b, _ in convs)
        if prev is not None:
            hp, wp = hw[level]
            convs += [(2, 2, 4), (prev, 2, 4)]      # upflow, upfeat
            dec_flops += (conv_flops(hp, wp, 2, 2, 4, B)
                          + conv_flops(hp, wp, prev, 2, 4, B))
            reads_coarse = B * hp * wp * (prev + 2)
            # a warp: the features and the flow in, the features out
            warp_flops += 8 * cl * px
            warp_bytes += _B * px * (2 * cl + 2)
        else:
            reads_coarse = 0
        # the stack reads the volume, the first features and the coarser
        # level's flow and stack; it writes its flow and its stack, which
        # the next level (or the refiner) reads
        dec_bytes += _B * (px * (reads + 2 + n) + reads_coarse
                           + _conv_params(convs))
        # the cost volume: both features in, the volume out
        corr_flops += 2 * g["volume"] * cl * px
        corr_bytes += _B * px * (2 * cl + g["volume"])
        prev = n
    stages.append(_stage("decoders", dec_flops, dec_bytes))
    stages.append(_stage("corr", corr_flops, corr_bytes))
    stages.append(_stage("warp", warp_flops, warp_bytes))
    # the refiner at level 2, on the finest stack; its flow added
    h, w = hw[1]
    widths = [prev] + g["refiner"] + [2]
    convs = [(a, b, 3) for a, b in zip(widths[:-1], widths[1:])]
    ref_flops = sum(conv_flops(h, w, a, b, 3, B) for a, b, _ in convs)
    stages.append(_stage("refiner", ref_flops, _B * (
        B * h * w * (prev + 2 + 2) + _conv_params(convs))))
    # the resizes: the images to the 64-divisible size, the flow back
    rs_flops = resize_flops(B * 2, h, w, H, W, 2)
    rs_bytes = _B * B * 2 * (h * w + H * W)
    if (ph, pw) != (H, W):
        rs_flops += resize_flops(2 * B * 3, H, W, ph, pw, 2)
        rs_bytes += _B * 2 * B * 3 * (H * W + ph * pw)
    stages.append(_stage("resize", rs_flops, rs_bytes))
    return stages


def call_stages(g: dict, H: int = None, W: int = None,
                batch: int = None) -> List[dict]:
    """A bidirectional call: both directions' stages, stage by stage
    (the configuration's batch and crop by default)."""
    H = H or g["size"]
    W = W or g["size"]
    one = direction_stages(g, H, W, batch or g["batch"])
    return [dict(st, flops={k: 2 * v for k, v in st["flops"].items()},
                 bytes=2 * st["bytes"]) for st in one]


def stage(stages: List[dict], name: str) -> dict:
    return next(st for st in stages if st["name"] == name)


def conv_flops_of(stages: List[dict]) -> int:
    """The convs' and deconvs' flops alone (what a flop counter sees)."""
    return sum(stage(stages, n)["flops"].get(F32, 0)
               for n in ("extractor", "decoders", "refiner"))
