"""The analytic floor of the port on an NVIDIA H100: per kernel, and per
stage of the 4K ×8 interpolation pipeline.

    python -m fldrx_torch.tools.roofline [--chip SXM|PCIe] [--hw H W]
                                         [--measured FILE]

Pure arithmetic from the shapes: it needs no device. A floor is the
larger of three times, the work's HBM bytes over the memory rate, its
bf16 tensor-core flops over the tensor-core rate, and its other flops
(float32 matmuls and convolutions with TF32 off, elementwise arithmetic)
over the float32 rate; each input counts as read once and each output as
written once. A matmul or convolution counts 2·M·N·K flops as the port
issues it on the card (the UNet's packed convolutions with their
structural zeros), as torch.utils.flop_counter.FlopCounterMode counts
them; a resize counts its taps, as csrc/resize.cu runs it on the card
(`resize_taps`). The CPU's dense form of the resizes, two einsums against
[out, in] matrices, is counted apart by `cpu_resize_flops`.

(a) Per kernel: `gather`, `splat`, `gather_grad`, `splat_grad`,
`conv3x3`, `correlation`, `interleave`, `deinterleave`, `pack_s2d4`,
`resize_taps` and `blend6` give (bytes, flops, the rate's index in PEAKS)
for a kernel's shapes; `kernel_bound` turns them into chip_smoke.py phase
2's bound.

(b) Per stage: `stages(H, W)` for a frame of H×W padded as the deploy
mix pads it (bench_inputs.deploy_config: papermodel_test5, S_tst = 5,
float32 flow path, bf16 refine UNet, t chunks of 4). The flow stages
(pyramid, features, levels, z, pack) run once per pair; the synthesis
stages (splat, flowback, gather, refine_in, unet_cat, unet, blend) once
per t. `--measured` takes tools/perfprobe2.py's JSON, taken on the card,
and puts each stage's in-context times beside its floor: the delta (the
whole minus the run with that stage stubbed out) and the span (the card's
time in the stage's calls within the whole), each with the floor's share
of it.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Published dense peaks by H100 variant (NVIDIA data sheets): memory
# bytes/s, bf16 tensor-core flop/s, float32 flop/s outside the tensor cores.
PEAKS = {
    "PCIe": (2.0e12, 756e12, 51e12),
    "SXM": (3.35e12, 989e12, 67e12),
}
MEM, TC, F32 = 0, 1, 2          # indices into a PEAKS entry

F4, BF2 = 4, 2                  # bytes of float32, bfloat16


def peaks_for(name: str):
    """(variant, peaks) of a card named by nvidia-smi (PCIe or else SXM)."""
    variant = "PCIe" if "PCIe" in name else "SXM"
    return variant, PEAKS[variant]


def bound_ms(peaks, nbytes: float, flops: float, flop_rate: float):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / peaks[MEM] * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# (a) the kernels: (bytes, flops, rate index)
# ---------------------------------------------------------------------------

def gather(B: int, H: int, W: int, C: int):
    """Bilinear gather of C float32 channels at B·H·W sample points: the
    image, both coordinates read, the output written; 7C + 12 flops a
    point."""
    n = B * H * W
    return F4 * (2 * n * C + 2 * n), n * (7 * C + 12), F32


def splat(B: int, H: int, W: int, C: int):
    """Bilinear scatter-add of C float32 channels from B·H·W points."""
    n = B * H * W
    return F4 * (2 * n * C + 2 * n), n * (8 * C + 10), F32


def gather_grad(B: int, H: int, W: int, C: int, want_img: bool):
    """The gather's VJP: img and g read, dimg written where asked; sx, sy
    read, dsx, dsy written."""
    n = B * H * W
    return (F4 * (n * C * (2 + want_img) + 4 * n),
            n * ((26 if want_img else 18) * C + 20), F32)


def splat_grad(B: int, H: int, W: int, C: int, coords: bool):
    """The splat's VJP: g read, dvals written, tx, ty read; with coords
    vals read, dtx, dty written."""
    n = B * H * W
    return (F4 * (n * C * (2 + coords) + 2 * n * (1 + coords)),
            n * ((25 if coords else 7) * C + 12), F32)


def conv3x3(H: int, W: int, Cin: int, K: int):
    """3×3 pad-1 convolution, bf16 input, weights and output, float32
    bias."""
    return (BF2 * (H * W * Cin + 9 * Cin * K + H * W * K) + F4 * K,
            2.0 * H * W * K * Cin * 9, TC)


def correlation(B: int, H: int, W: int, C: int):
    """The 81-channel cost volume of two float32 feature maps."""
    px = B * H * W
    return F4 * (2 * px * C + 81 * px), 81 * px * (2 * C + 1), F32


def interleave(B: int, H: int, WC: int):
    """u-planes [B, 4, H/4, WC] ↔ rows [B, H, WC], float32: a permutation
    (so is the deinterleave)."""
    return 2 * F4 * B * H * WC, 0, F32


deinterleave = interleave


def pack_s2d4(B: int, H: int, W: int, C: int, out_bytes: int):
    """C float32 channels of B·H·W pixels in, their space-to-depth out in
    `out_bytes` an element: a copy with one rounding."""
    return (F4 + out_bytes) * B * H * W * C, 0, F32


def resize_taps(N: int, H: int, W: int, C: int, OH: int, OW: int,
                taps: int):
    """The tap kernel's resize of N·C float32 planes H×W to OH×OW, `taps`
    a row and a column (4 bicubic, 2 bilinear, 1 nearest): the input rows
    and columns that some tap reads (all of them, but for a downscale by
    more than the taps), the output written, the two tap tables; 2 flops a
    tap, rows first over the whole input width, then columns."""
    rows, cols = min(H, OH * taps), min(W, OW * taps)
    flops = 0 if (OH, OW) == (H, W) else 2.0 * taps * N * C * OH * (W + OW)
    return (F4 * N * C * (rows * cols + OH * OW) + 8 * taps * (OH + OW),
            flops, F32)


def blend6(B: int, H: int, W: int, logit_bytes: int):
    """The six-way blend of B·H·W pixels: 6 logits of `logit_bytes` and
    the six 3-channel float32 candidates in, the float32 frame out; the
    softmax and the weighted sum (66 flops a pixel)."""
    n = B * H * W
    return (logit_bytes * 6 * n + F4 * (6 * 3 * n + 3 * n), 66.0 * n,
            F32)


def kernel_bound(peaks, work) -> Tuple[float, str]:
    """A kernel's bound (ms, by) from one of the functions above."""
    nbytes, flops, rate = work
    return bound_ms(peaks, nbytes, flops, peaks[rate])


# ---------------------------------------------------------------------------
# (b) the stages of the 4K ×8 pair
# ---------------------------------------------------------------------------

@dataclass
class Work:
    """Bytes and flops of a piece of work: tc are bf16 matmul and
    convolution flops (tensor cores), mm the float32 ones (TF32 off), other
    the elementwise, gather and splat arithmetic."""

    nbytes: float = 0.0
    tc: float = 0.0
    mm: float = 0.0
    other: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.nbytes + o.nbytes, self.tc + o.tc, self.mm + o.mm,
                    self.other + o.other)

    def __mul__(self, k: float) -> "Work":
        return Work(self.nbytes * k, self.tc * k, self.mm * k, self.other * k)

    def flops_only(self) -> "Work":
        return Work(0.0, self.tc, self.mm, self.other)

    def floor(self, peaks) -> Tuple[float, str]:
        """(ms, bound_by): the largest of bytes, tensor-core flops and the
        float32 flops (mm + other)."""
        times = {"bytes": self.nbytes / peaks[MEM],
                 "tensor cores": self.tc / peaks[TC],
                 "f32": (self.mm + self.other) / peaks[F32]}
        by = max(times, key=times.get)
        return times[by] * 1e3, by


def resize(n: int, h: int, w: int, c: int, oh: int, ow: int,
           taps: int) -> Work:
    """A float32 resize as the card runs it (`resize_taps`)."""
    return _kernel(resize_taps(n, h, w, c, oh, ow, taps))


def dense_resize_flops(n: int, h: int, w: int, c: int, oh: int,
                       ow: int) -> float:
    """resize_2d's CPU form of [n, h, w, c] to (oh, ow): two dense float32
    einsums, rows then columns (none where the size is unchanged)."""
    if (oh, ow) == (h, w):
        return 0.0
    return 2.0 * n * c * (oh * h * w + oh * ow * w)


def conv_flops(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * h * w * cout * cin * k * k


def _kernel(work) -> Work:
    nbytes, flops, rate = work
    return Work(nbytes, tc=flops if rate == TC else 0.0,
                other=flops if rate == F32 else 0.0)


# widths of papermodel_test5 (config.py, model/fldrnet.py init_params)
FEAT = 96                       # PCA features: 3 channels × 2 frames × 16
NF = 48
FLOW_BOTTOM = ((FEAT, FEAT), (FEAT, FEAT), (FEAT, FEAT), (FEAT, NF), (NF, 6))
CONV_FLOW1 = (2 * NF, NF)
CONV_FLOW2 = ((2 * NF + 4, 2 * NF), (2 * NF, 2 * NF), (2 * NF, NF), (NF, NF),
              (NF, 4))
LEVELS = 6                      # S_tst + 1
WIS = 8                         # PCA block size
PCA_K = 16                      # components per block
UNET_IN = 26                    # refine_in's channels


def unet_convs(H: int, W: int):
    """(h, w, cin, cout) of the refine UNet's seven convolutions on an
    H×W frame, as refine_unet_s2d_core runs them: enc1, enc2, enc3, dec2
    and dec3 packed (conv3x3), dec0 and dec1 plain."""
    q, e = (H // 4, W // 4), (H // 8, W // 8)
    return (("enc1", *q, 16 * UNET_IN, 64), ("enc2", *q, 64, 32),
            ("enc3", *e, 128, 64), ("dec0", *e, 64, 64),
            ("dec1", *q, 96, 32), ("dec2", *q, 192, 64),
            ("dec3", *q, 256, 96))


def pyramid(H: int, W: int) -> Work:
    """build_pyramid: levels 1..5 by bicubic resizes of both frames from
    full resolution, each its own launch and so its own read."""
    return sum((resize(*r) for r in resizes("pyramid", H, W)), Work())


def _grid(H: int, W: int, level: int) -> Tuple[int, int]:
    return (H >> level) // WIS, (W >> level) // WIS


def features(H: int, W: int) -> Work:
    """extract_features: each level's block-PCA projection, min-max, and
    the two residual context convolutions (float32)."""
    w = Work()
    for i in range(LEVELS):
        hb, wb = _grid(H, W, i)
        px = hb * wb
        w = w + Work(
            F4 * (2 * 3 * (H >> i) * (W >> i) + FEAT * px
                  + 2 * 9 * FEAT * FEAT),
            mm=(2.0 * 6 * px * WIS * WIS * PCA_K
                + 2 * conv_flops(hb, wb, FEAT, FEAT)),
            other=6.0 * FEAT * px)
    return w


def levels(H: int, W: int) -> Work:
    """The coarse-to-fine flow levels S_tst..0 (level_flow): flow_bottom at
    the coarsest; elsewhere the previous flow's bilinear upsample, the two
    49-channel feature splats, conv_flow1 twice and conv_flow2."""
    w = Work()
    for i in range(LEVELS - 1, -1, -1):
        hb, wb = _grid(H, W, i)
        px = hb * wb
        if i == LEVELS - 1:
            w = w + Work(mm=sum(conv_flops(hb, wb, a, b)
                                for a, b in FLOW_BOTTOM))
            continue
        w = w + Work(mm=2 * conv_flops(hb, wb, *CONV_FLOW1)
                     + sum(conv_flops(hb, wb, a, b) for a, b in CONV_FLOW2))
        w = w + _kernel(splat(1, hb, wb, NF + 1)).flops_only() * 2
    w = w + sum((resize(*r).flops_only() for r in resizes("levels", H, W)),
                Work())
    feats = sum(FEAT * _grid(H, W, i)[0] * _grid(H, W, i)[1]
                for i in range(LEVELS))
    weights = (sum(a * b for a, b in FLOW_BOTTOM + CONV_FLOW2)
               + CONV_FLOW1[0] * CONV_FLOW1[1]) * 9
    h0, w0 = _grid(H, W, 0)
    return w + Work(F4 * (feats + weights + 4 * h0 * w0))


def z(H: int, W: int) -> Work:
    """flow_extras' z (its `z` span): both frames and both flows resized
    to H/2×W/2, z_metrics's two masked gathers there, |x − warp| and the
    channel mean, and z0, z1 upsampled to H×W."""
    h0, w0 = _grid(H, W, 0)
    Hh, Wh = H // 2, W // 2
    n = Hh * Wh
    taps = sum(resize(*r).other for r in resizes("z", H, W))
    other = taps + 2 * _kernel(gather(1, Hh, Wh, 3)).other + 2 * 7.0 * n
    return Work(F4 * (2 * 3 * H * W + 4 * h0 * w0 + 2 * H * W), other=other)


def pack(H: int, W: int) -> Work:
    """flow_extras' full-resolution flows (its `pack` span): flow_10 and
    flow_01 upsampled from the flow grid and scaled."""
    h0, w0 = _grid(H, W, 0)
    taps = sum(resize(*r).other for r in resizes("pack", H, W))
    return Work(F4 * (4 * h0 * w0 + 2 * 2 * H * W),
                other=taps + 2 * 2.0 * H * W)


def synth_splat(H: int, W: int) -> Work:
    """One t's two softmax splats: 4 channels (x·e^z, e^z) at H×W."""
    return _kernel(splat(1, H, W, 4)) * 2


def flowback(H: int, W: int) -> Work:
    """One t's two flowback gathers at the flow grid (2 channels, no mask)
    and their bilinear upsamples to H×W."""
    h0, w0 = _grid(H, W, 0)
    return (_kernel(gather(1, h0, w0, 2)) * 2
            + sum((resize(*r) for r in resizes("flowback", H, W)), Work()))


def synth_gather(H: int, W: int) -> Work:
    """One t's two im_tot gathers: 3 channels at H×W with the mask."""
    return _kernel(gather(1, H, W, 3)) * 2


def refine_in(H: int, W: int) -> Work:
    """One t's UNet input: the ten float32 tensors (26 channels) in, the
    bf16 s2d4 tensor out (one launch of the pack_s2d4 kernel)."""
    return _kernel(pack_s2d4(1, H, W, UNET_IN, BF2))


def unet_cat(H: int, W: int) -> Work:
    """The UNet's skip concatenations, bf16: u0 = (d0 upsampled, e2) at the
    quarter grid, u1 = (d1, each cell's e1), u2 = d2's cells."""
    q = (H // 4) * (W // 4)
    e = (H // 8) * (W // 8)
    u0 = 64 * e + 32 * q + 96 * q
    u1 = 32 * q + 64 * q + 192 * q
    u2 = 64 * q + 256 * q
    return Work(BF2 * (u0 + u1 + u2))


def unet(H: int, W: int) -> Work:
    """One t's refine UNet convolutions in bf16: its s2d4 input and the
    weights in, the 96-channel s2d4 logits out."""
    tc = sum(conv_flops(h, w, a, b) for _, h, w, a, b in unet_convs(H, W))
    weights = sum(9 * a * b for *_, a, b in unet_convs(H, W))
    q = (H // 4) * (W // 4)
    return Work(BF2 * (16 * UNET_IN * q + weights + 96 * q), tc=tc)


def blend(H: int, W: int) -> Work:
    """One t's six-way blend (`blend6`) with the UNet's bf16 logits."""
    return _kernel(blend6(1, H, W, BF2))


def resizes(stage: str, H: int, W: int):
    """The resizes a stage runs on an H×W frame, as (n, h, w, c, oh, ow,
    taps): the pyramid's five bicubic levels of both frames; the levels'
    bilinear flow upsamples (their `levels` span); z's frames and flows to
    half resolution and its two maps back (both bilinear); the pack's two
    flow fields and one t's two flowbacks, bilinear from the flow grid."""
    h0, w0 = _grid(H, W, 0)
    Hh, Wh = H // 2, W // 2
    return {
        "pyramid": [(2, H, W, 3, H >> i, W >> i, 4)
                    for i in range(1, LEVELS)],
        "levels": [(1, *_grid(H, W, i + 1), 4, *_grid(H, W, i), 2)
                   for i in range(LEVELS - 2, -1, -1)],
        "z": [(2, H, W, 3, Hh, Wh, 2)] + [(1, h0, w0, 2, Hh, Wh, 2)] * 2
        + [(1, Hh, Wh, 1, H, W, 2)] * 2,
        "pack": [(1, h0, w0, 2, H, W, 2)] * 2,
        "flowback": [(1, h0, w0, 2, H, W, 2)] * 2,
    }[stage]


def cpu_resize_flops(stage: str, H: int, W: int) -> float:
    """The dense float32 einsum flops of a stage's resizes in their CPU
    form (`resize_2d` on a CPU tensor), as FlopCounterMode counts them."""
    return sum(dense_resize_flops(*r[:6]) for r in resizes(stage, H, W))


FLOW_STAGES = {"pyramid": pyramid, "features": features, "levels": levels,
               "z": z, "pack": pack}
SYNTH_STAGES = {"splat": synth_splat, "flowback": flowback,
                "gather": synth_gather, "refine_in": refine_in,
                "unet_cat": unet_cat, "unet": unet, "blend": blend}
T_PER_PAIR = 7                  # ×8: the multiple − 1 interpolated frames


def padded(H: int, W: int, div: int = 256) -> Tuple[int, int]:
    """The deploy mix's padding: up to multiples of 2^S_tst · 8 = 256."""
    return -(-H // div) * div, -(-W // div) * div


def stages(H: int, W: int) -> Dict[str, Tuple[str, Work]]:
    """{stage: ("pair" or "t", its Work)} for a padded H×W frame."""
    out = {k: ("pair", f(H, W)) for k, f in FLOW_STAGES.items()}
    out.update({k: ("t", f(H, W)) for k, f in SYNTH_STAGES.items()})
    return out


def report(chip: str = "SXM", hw=(2160, 4096),
           measured: Optional[dict] = None) -> dict:
    """Each stage's flops, bytes and floor (ms per pair or per t), with
    perfprobe2's in-context ms per pair or per t beside it where given (it
    must be of the same frame); and the floor of one interpolated
    frame."""
    peaks = PEAKS[chip]
    if measured is not None and list(measured["hw"]) != list(hw):
        raise ValueError(f"measured at {measured['hw']}, the floors are for "
                         f"{list(hw)}")
    H, W = padded(*hw)
    rows = {}
    per_frame = 0.0
    for name, (per, w) in stages(H, W).items():
        ms, by = w.floor(peaks)
        row = {"per": per, "tc_flops": w.tc, "other_flops": w.mm + w.other,
               "f32_mm_flops": w.mm, "hbm_bytes": w.nbytes,
               "floor_ms": ms, "bound_by": by}
        if measured is not None:
            m = measured_ms(measured, name)
            span = measured_ms(measured, name, "span_ms")
            row.update(measured_ms=m, span_ms=span,
                       share_of_floor=None if not m else ms / m,
                       share_of_span=None if not span else ms / span)
        rows[name] = row
        per_frame += ms / T_PER_PAIR if per == "pair" else ms
    return {"chip": chip, "peaks": dict(zip(("bytes_per_s", "tc_flops_per_s",
                                             "f32_flops_per_s"), peaks)),
            "frame": list(hw), "padded": [H, W], "t_per_pair": T_PER_PAIR,
            "stages": rows, "floor_ms_per_frame": per_frame,
            "floor_frames_per_s": 1e3 / per_frame}


def measured_ms(probe: dict, stage: str,
                key: str = "delta_ms") -> Optional[float]:
    """A stage's in-context ms from perfprobe2's JSON, per pair for a flow
    stage, per t for a synthesis stage: `delta_ms`, the whole minus the
    run without it, or `span_ms`, the card's time in its calls; None where
    perfprobe2 has no stub for it."""
    for part in ("flow", "synthesis"):
        v = probe[part]["variants"].get(stage)
        if v is not None:
            per_t = part == "synthesis"
            return v[key] / (probe["t_per_pair"] if per_t else 1)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chip", choices=sorted(PEAKS), default="SXM")
    ap.add_argument("--hw", nargs=2, type=int, metavar=("H", "W"),
                    help="the frame (default: the measured one, or "
                         "2160 4096)")
    ap.add_argument("--measured", help="perfprobe2's JSON from the card")
    args = ap.parse_args(argv)
    measured = None
    if args.measured:
        with open(args.measured) as f:
            measured = json.load(f)
    hw = args.hw or (measured["hw"] if measured else (2160, 4096))
    rep = report(args.chip, tuple(hw), measured)
    print(f"H100 {rep['chip']}: {rep['peaks']['bytes_per_s'] / 1e12:g} TB/s, "
          f"{rep['peaks']['tc_flops_per_s'] / 1e12:g} TFLOP/s bf16, "
          f"{rep['peaks']['f32_flops_per_s'] / 1e12:g} TFLOP/s float32; "
          f"frame {rep['frame'][0]}x{rep['frame'][1]} padded to "
          f"{rep['padded'][0]}x{rep['padded'][1]}")
    print(f"{'stage':12s} {'per':4s} {'tc GFLOP':>9s} {'f32 GFLOP':>9s} "
          f"{'MB':>8s} {'floor ms':>9s} {'bound by':12s} {'delta ms':>9s} "
          f"{'share':>6s} {'span ms':>9s} {'share':>6s}")

    def col(v, fmt):
        return "" if v is None else format(v, fmt)

    for name, r in rep["stages"].items():
        print(f"{name:12s} {r['per']:4s} {r['tc_flops'] / 1e9:9.2f} "
              f"{r['other_flops'] / 1e9:9.2f} {r['hbm_bytes'] / 1e6:8.1f} "
              f"{r['floor_ms']:9.4f} {r['bound_by']:12s} "
              f"{col(r.get('measured_ms'), '9.4f'):>9s} "
              f"{col(r.get('share_of_floor'), '6.3f'):>6s} "
              f"{col(r.get('span_ms'), '9.4f'):>9s} "
              f"{col(r.get('share_of_span'), '6.3f'):>6s}")
    print(f"floor per interpolated frame {rep['floor_ms_per_frame']:.3f} ms "
          f"({rep['floor_frames_per_s']:.1f} frames/s)")
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
