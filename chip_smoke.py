#!/usr/bin/env python3
"""Smoke run of fldrx_torch on one NVIDIA GPU: builds the hand-written CUDA
kernels from the sources in this checkout, holds each against its plain
PyTorch version at the shapes its paths give it, drives the paths the port
has — papermodel_test5 ×8 interpolation with a bf16 refine UNet,
papermodel training, the PWC-Net teacher, the golden-clip evaluation, the
multi-device evaluation, data-parallel and width-sharded training, the
PNG decoder, asynchronous checkpoints, the probes and the roofline, the
tools (the parity report against the reference's oracle among them) and
the bench — through their entry points (the evaluator's among them), and
checks what comes out.

    python3 chip_smoke.py

Phases, all of them on every run, in order; any failure raises and the
script exits non-zero:
  1. card check: a CUDA device must be present; prints its name and power
     limit (nvidia-smi).
  2. kernels: the build (each kernel's registers and spills; conv3x3's
     SASS must hold tensor-core instructions, and the adds of the splat
     and of gather_grad's dimg must be RED reductions, no ATOM, both
     counted with cuobjdump); then the gather and the splat at every shape
     the paths give them (GATHER_ROWS, SPLAT_ROWS: 4K im_tot gather
     2304×4096×3 with mask, flowback gather 288×512×2, training gather
     8×512×512×3, the teacher's dec2 warp 8×128×128×32; splat C=4 at
     2304×4096 and 8×512×512, C=49 at 288×512 and 8×64×64; smooth random
     flows) and the two VJP kernels at the forms the train step launches
     (GATHER_GRAD_ROWS, SPLAT_GRAD_ROWS: gather_grad coords only at
     8×512×512×3 and dimg with coords at 8×512×512×2, mask on, the latter
     also from inputs one float into their storage; splat_grad with
     dtx/dty at 8×512×512×4 and dvals only at 8×64×64×49; the rows
     timed before the forms were known, gather_grad dimg with coords at
     C=3 and splat_grad with dtx/dty at C=49; and the warps and VJP forms
     of one rank of the width-sharded step, 8e, at its batch shard of 4:
     4×512×512 and 4×64×64), each timed through the
     wrapper and as the bare launch of its C entry point; conv3x3
     at the five packed shapes of the 4K path (enc1 576×1024 416→64, enc2
     64→32, enc3 288×512 128→64, dec2 192→64, dec3 256→96) on random dense
     weights and at enc1 on the checkpoint's repacked weights, against
     float32 F.conv2d (≤ 2e-2 max abs, ≤ 1e-2 relative L2), timed through
     the wrapper and as the bare launch; the teacher's correlation at its
     five cost volumes (CORR_ROWS: dec2 8×128×128 C=32 to dec6 8×8×8
     C=196; the bare launch also timed on the device alone, queued behind
     a sleep, and its kernels' registers and spills printed); the
     interleave of the synthesis's u-planes (1×4×576×12288 f32, the
     padded 4K frame) and the
     deinterleave, which no path launches (1×2304×12288 f32, bit for bit
     and through the round trip). Each against its plain version on the
     same inputs (the gather within 1e-5, splat_grad's dvals bit for bit,
     the splat and the other VJP outputs within 1e-4·(1+|ref|), the
     correlation within 1e-5·(1+|ref|)), with the
     median time of 20 launches beside the plain version's, the PyTorch
     library call's (F.grid_sample for the gather and for splat_grad's
     dvals alone, index_add_ for the splat, grid_sampler_2d_backward with
     the same outputs for gather_grad, cuDNN bf16 channels-last for
     conv3x3; none for the correlation and splat_grad with dtx/dty) and
     the bound from bytes and operations.
  3. inference held: prepare_model() with the real checkpoint on cuda and
     on cpu, interpolate_multi_np at 768×1280 with three t values; the two
     outputs must agree to PSNR ≥ 60 dB.
  4. inference at full size, through fldrx_torch.bench's timed pairs (the
     code path of `python -m fldrx_torch.bench`): bench.py's synthetic
     2160×4096 uint8 frames, ×8 (7 t values, chunks of 4, returned as
     u-planes as in bench.py), one warm-up pair then 3 timed pairs;
     outputs finite and in [-1.1, 1.1];
     frames/s and peak memory. Kernel launch counts are zeroed just before
     the timed pairs and read after; each pair must launch exactly gather
     30, splat 24 and conv3x3 35 times (PER_PAIR).
  5a. train step held: the real checkpoint on cuda and on cpu, one
     make_train_step each on the same batch (B=2, 256×256, S_trn=3, bench
     texture with a per-sample pan, t from a seeded torch.Generator);
     loss and each metric agree to 1e-4 relative, every gradient leaf to
     relative L2 ≤ 1e-3. TF32 is off.
  5b. training at full size: papermodel phase="train" (S_trn=3, batch 8,
     512×512 crops of the bench texture, per-sample pan, t from a
     torch.Generator), starting from init_params and fit_pca_from_batch on
     the first batch as a fresh run does; one warm-up step then 5 timed
     steps fenced by torch.cuda.synchronize(); losses finite; ms per step,
     samples/s, peak memory and kernel launches per step (counts zeroed
     just before the timed steps; exactly gather 24, splat 16,
     gather_grad 24 and splat_grad 16 per step, PER_STEP, and the VJP
     launches per form, FORMS_PER_STEP); then a SaveManager save into a
     temporary directory and a load that must restore the parameters and
     the optimiser state exactly. The card machine has no PIL and no JAX,
     so this drives the trainer's entry points (TrainState,
     make_train_step, fit_pca_from_batch, SaveManager) on in-memory
     batches, not train() over PNG clips.
  6a. teacher held: PWC-Net on seeded random weights (one torch.Generator
     seed, the same weights on cuda and on cpu; the trained checkpoint is
     not in the repository), get_bidirectional_flow on one 270×480 pair
     (not a multiple of 64: the resize path); relative L2 ≤ 1e-4, TF32 off.
  6b. teacher at full width: the published PWC widths on the training
     recipe's batch, 8 pairs of 512×512 crops of the bench texture; one
     warm-up call then 5 timed calls fenced by torch.cuda.synchronize();
     ms per bidirectional call, peak memory, and launches per call, which
     must be correlation 10 (5 decoders × 2 directions) and gather 8 (4
     warped decoders × 2).
  7. golden clip on the card: (a) papermodel S_tst=3, fast_warp, float32 at
     512×768, pan family ×8, mean within 0.05 dB of 44.828
     (tests/test_goldenclip.py's pin); (b) the deploy mix at 2160×4096, pan
     ×8, mean and per-t PSNR, mean within 0.15 dB of 44.139 (fldrx's reading
     of the same protocol, PARITY.md §2), with the launch counts zeroed just
     before its inference and read after (PER_PAIR); (c) metrics_torch on
     two of the 4K predictions against the host's psnr and ssim_bgr: ≤ 1e-4
     dB and ≤ 1e-5 SSIM; (d) evaluate() on the same 4K clip as an 8-bit test
     set (GoldenTestSet), the deploy mix, once with the metrics on the card
     (plain rows through the interleave kernel; launch counts zeroed just
     before and read after, PER_PAIR) and once on the host (u-planes
     unpacked on the worker threads): the two agree to 1e-4 dB and 1e-5 SSIM,
     and the mean lies within 0.15 dB of 44.139 moved by the 8-bit rounding
     of the targets (each t's float MSE plus the targets' rounding MSE).
  8. multi-device evaluation and data-parallel training on one card: two
     shards or two ranks share cuda:0 and run one after the other, so the
     times measure the split's overhead, not scaling. (a) t-parallel:
     build_parallel_eval(mode="t") over two shards, bench.py's 4K pair at
     ×8 in the deploy mix, one warm-up then 2 timed pairs, against the
     single-device output (PSNR ≥ 60 dB), launches per pair exactly
     PER_PAIR_T; (b) width-sharded: make_sharded_fast_eval on two slabs,
     halo 256, the same pair, against the single-device output by fldrx's
     bulk criteria (BULK: mean abs < 2e-3, share above 5e-2 < 5e-4, also
     within SEAM columns of the slab seam; fldrx's max < 0.3 is printed,
     not held, since one device's own max varies run to run beyond it on
     the card; the pack's z maps are the strict ones), one flow run per
     pair and no spill, launches per pair
     exactly PER_PAIR_SP; then halo 64 on the texture panned 96 px takes
     the exact fallback once and matches make_sharded_eval within 2e-5
     mean abs, each printed beside the path's own run-to-run spread;
     (c) evaluate() on the 4K golden clip as
     an 8-bit test set through parallel_eval in each mode, each mean
     within 0.05 dB of 7d's; (d) the data-parallel train step on two gloo
     ranks (nccl refuses two ranks on one device) from the checkpoint,
     batch 8 at 512×512 split 4 + 4, S_trn=3, TF32 off, against the
     single-process step on the same global batch: loss and each metric
     within 1e-4 relative, every averaged gradient and updated parameter
     leaf within relative L2 1e-3, the ranks' parameters equal; then 3
     timed steps per rank, each rank launching exactly PER_STEP and
     FORMS_PER_STEP a step; (e) the same at dp 2 × sp 2 on four gloo
     ranks: each rank takes its batch shard of 4 at the full 512 columns
     and makes level 0's refine UNet, blend and reconstruction loss over
     its slab of 256 columns, the UNet reading the slab and its 32-column
     halo (each rank's UNet input width printed and required), with the
     bars of (d); ms per step and peak memory per rank (four processes
     time-share one card: overhead, not scaling).
  9. the last modules. (a) The PNG decoder (data/native.py): the native
     library's build, and where it cannot be built (no libpng) the error
     naming why; with PIL hidden, the named NoPNGDecoder; then the 4K
     golden pair's 8-bit frames written as an X-Test scene (the script's
     own zlib PNG writer; the 24 files ×8 does not read are 1×1), each
     decoded bit for bit, ms per 4K frame at 1 and 3 threads, and
     evaluate() through get_test_dataset("X-Test") within 1e-4 dB of 7d,
     decoding exactly 9 frames for the pair. (b) Asynchronous checkpoints
     at 5b's recipe: 5 timed steps each with an AsyncSaveManager save
     after every step, with a SaveManager save and with none, ms per step
     printed, with the save() calls' ms and a synchronous snapshot's;
     three saves into their own managers, each file equal bit for bit to
     the snapshot taken at its save() while the next step updates the
     parameters in place, and a resume from the last equal to the state
     saved. (c) tools/perfprobe.py and tools/perfprobe2.py on bench.py's
     4K pair, then tools/roofline.py with perfprobe2's record: every
     stage's floor at or below its in-context span (the card's time in its
     calls), the floor's share of each span and ablation delta printed.
  10. the tools: eval.profiling's time_levels (S_tst 1-5) and fps_meter
     on bench.py's 4K pair in the deploy mix, one t, and a trace whose
     Chrome trace names the gather, splat and conv3x3 kernels;
     eval.demo.run_synthetic(out_dir=None), each t's PSNR within 0.05 dB
     of the port's CPU values (DEMO_CPU_DB); goldenclip_report at
     512×768, all four configurations above the naive frame average;
     parity_report's measurements 2-3 at 2160×4096 on the card and on the
     CPU: the strict and fast float32 outputs each ≥ 60 dB against the
     CPU's (phase 3's bar), fast float32 against strict within 0.5 dB of
     the CPU's reading (the departure is fldrx's own algebra: 51.85 dB at
     768×1024 for both packages on the CPU), the bf16 PSNRs printed.
  10b. parity_report's measurement 1: at 768×1280, S_tst = 5, t = 0.375,
     against the reference's torch oracle on the CPU with the state dict
     of the in-repo .npz (convert_ckpt.params_to_state_dict), both on one
     pyramid, from PyTorch's default TF32 flags as the tool's command
     starts: the strict path on the card within 1e-4 max abs (ROADMAP's
     North star bar); fast_warp float32 and the deploy mix on the card
     each within 0.5 dB PSNR of the same configuration on the CPU; the
     deploy run, its launches zeroed just before and read after, launches
     gather, splat, conv3x3 and the interleave (its output in plain rows).
     One JSON line: max abs, mean abs and PSNR
     of each run, the oracle's and each run's seconds, the card line.
  11. `python -m fldrx_torch.bench` once, its JSON line; a JSON line for the
     kernels, the card line, then the last line
     {"ok": true, "device": {...}}.

Each phase prints its seconds, and the run its total.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

def bound(peaks, kernel: str, *shape):
    """(bound ms, what bounds it) of a kernel at its shape, from
    fldrx_torch.tools.roofline, the one spec of the card."""
    from fldrx_torch.tools import roofline
    return roofline.kernel_bound(peaks, getattr(roofline, kernel)(*shape))


def median_ms(fn, n: int = 20, setup=None) -> float:
    """The median time of n runs of fn on the card, by CUDA events; setup,
    if given, runs before each, outside the timed window."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if setup is not None:
            setup()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def queued_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device ms per run of fn: n runs queued behind a sleep kernel, so the
    host's launch time between them does not show; the median of reps."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def index_add_yardstick(vals, tx, ty):
    """The splat's library yardstick: a closure running one index_add_ of
    the four corners' updates (precomputed) into a zeroed canvas."""
    import torch
    B, H, W, C = vals.shape
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - x0)[..., None], (ty - y0)[..., None]
    base = (torch.arange(B, device=vals.device) * H * W).view(B, 1, 1)
    idx, upd = [], []
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0.long() + dx, y0.long() + dy
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx.append((base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
                   .reshape(-1))
        upd.append((vals * w * ok[..., None]).reshape(-1, C))
    idx, upd = torch.cat(idx), torch.cat(upd)
    canvas = torch.zeros(B * H * W, C, device=vals.device)
    return lambda: canvas.index_add_(0, idx, upd)


def sass(lib: str) -> str:
    """The SASS of a built library, by the toolkit's cuobjdump."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True, check=True,
                          timeout=120).stdout


def tensor_core_instructions(lib: str) -> int:
    """The number of HMMA (mma.sync) and HGMMA (wgmma) instructions in the
    SASS of a built library."""
    return sum(("HMMA" in ln or "HGMMA" in ln)
               for ln in sass(lib).splitlines())


def excess(got, ref, rel: float = 1e-4) -> float:
    """max(|got − ref| − rel·(1 + |ref|)): ≤ 0 when within tolerance."""
    return ((got - ref).abs() - rel * (1 + ref.abs())).max().item()


def sass_atomics(lib: str, kernel: str) -> dict:
    """For each function of a built library whose mangled name holds
    `kernel`: its SASS reductions (RED, REDG: no value returned), those of
    them on four floats (F32x4), and atomics (ATOM, ATOMG, ATOMS: the old
    value returned)."""
    counts, fn = {}, None
    for ln in sass(lib).splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ")[1].strip()
            fn = name if kernel in name else None
            if fn:
                counts[fn] = {"RED": 0, "RED.F32x4": 0, "ATOM": 0}
        elif fn and "*/" in ln:
            words = [w for w in ln.split("*/", 1)[1].split()
                     if not w.startswith("@")]
            op = words[0].split(".") if words else [""]
            if op[0] in ("RED", "REDG"):
                counts[fn]["RED"] += 1
                counts[fn]["RED.F32x4"] += "F32x4" in op
            elif op[0].startswith("ATOM"):
                counts[fn]["ATOM"] += 1
    return counts


def check_kernels(peaks):
    from fldrx_torch.ops import _build

    t0 = time.time()
    logs = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    hmma = tensor_core_instructions(_build.library_path("conv3x3"))
    print(f"conv3x3: {hmma} HMMA/HGMMA instructions in its SASS", flush=True)
    if not hmma:
        raise AssertionError("conv3x3 was not compiled to tensor-core "
                             "instructions")
    # the splat's adds must be fire-and-forget reductions (RED), not
    # atomics that return the old value (ATOM), and the vector route's
    # reductions 16-byte ones
    fwd = {k: v for k, v in sass_atomics(_build.library_path("warp"),
                                         "splat_").items()
           if "grad" not in k}
    print(f"splat SASS: {fwd}", flush=True)
    if not fwd or any(v["ATOM"] or not v["RED"]
                      or ("vec4" in k) != (v["RED.F32x4"] == v["RED"])
                      for k, v in fwd.items()):
        raise AssertionError(f"splat kernels without RED, with ATOM or "
                             f"without 16-byte RED on the vector route: "
                             f"{fwd}")
    # gather_grad's dimg adds too: each lane-group instantiation (<4>, <2>,
    # <1>: floats per unit) has RED, the <4> one 16-byte RED, and none ATOM
    bwd = sass_atomics(_build.library_path("warp"), "gather_grad_lanes")
    print(f"gather_grad SASS: {bwd}", flush=True)
    if len(bwd) != 3 or any(v["ATOM"] or not v["RED"]
                            or ("ILi4E" in k) != (v["RED.F32x4"] == v["RED"])
                            for k, v in bwd.items()):
        raise AssertionError(f"gather_grad kernels without RED, with ATOM or "
                             f"without 16-byte RED at 4 floats a unit: {bwd}")
    return warp_rows(peaks)


# The gather and splat at every shape the paths give them: (label, B, H,
# W, C, mask for the gather, the coarse grid of the random flow, its ±px).
# 4K: the im_tot gathers and level-0 splats at the padded 2304×4096 frame,
# the flowback gathers and the largest feature splats at its 288×512 flow
# grid; training: level 0 at 8×512×512 and the feature splats at 8×64×64;
# the teacher: dec2's warp.
# The sp slab rows: one of two width slabs of the padded 4K frame with its
# halo of 256 columns each side, 2304×(2048 + 512); the sharded path's
# gather runs with the kernel's mask off (the mask of the frame's bounds is
# a separate multiply), and is timed with it on too. The sp training rows:
# what one rank of the width-sharded step (8e) warps, its batch shard of 4
# at the full 512 columns.
GATHER_ROWS = (
    ("4K im_tot", 1, 2304, 4096, 3, True, (36, 64), 40.0),
    ("4K flowback", 1, 288, 512, 2, False, (36, 64), 5.0),
    ("training", 8, 512, 512, 3, True, (8, 8), 24.0),
    ("teacher dec2", 8, 128, 128, 32, True, (8, 8), 8.0),
    ("sp slab im_tot", 1, 2304, 2560, 3, True, (36, 40), 40.0),
    ("sp slab im_tot as launched", 1, 2304, 2560, 3, False, (36, 40), 40.0),
    ("sp training, one rank", 4, 512, 512, 3, True, (8, 8), 24.0),
)
SPLAT_ROWS = (
    ("4K level 0", 1, 2304, 4096, 4, (36, 64), 40.0),
    ("4K feature", 1, 288, 512, 49, (36, 64), 5.0),
    ("training level 0", 8, 512, 512, 4, (8, 8), 24.0),
    ("training feature", 8, 64, 64, 49, (8, 8), 3.0),
    ("sp slab level 0", 1, 2304, 2560, 4, (36, 40), 40.0),
    ("sp training level 0, one rank", 4, 512, 512, 4, (8, 8), 24.0),
    ("sp training feature, one rank", 4, 64, 64, 49, (8, 8), 3.0),
)


def smooth_targets(g, B, H, W, coarse, px):
    """Absolute coords (x + flow_x, y + flow_y) [B, H, W] of a smooth
    random flow: uniform ±px displacements on a coarse grid, resized
    bilinearly."""
    import torch

    from fldrx_torch.ops.resize import resize_2d

    cf = (torch.rand(B, *coarse, 2, device="cuda", generator=g) * 2 - 1) * px
    flow = resize_2d(cf, (H, W), "bilinear")
    xs = torch.arange(W, device="cuda", dtype=torch.float32)
    ys = torch.arange(H, device="cuda", dtype=torch.float32)[:, None]
    return xs + flow[..., 0], ys + flow[..., 1]


def bare_launch(fn: str, *args, lib: str = "warp"):
    """The C entry point `fn` of a library (csrc/<lib>.cu) alone on fixed
    buffers: a tensor passes its data pointer, None a null pointer, an int
    itself; the current stream goes last."""
    import torch

    from fldrx_torch.ops import _build

    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    f = getattr(_build.library(lib), fn)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: _build.check(f(*vals, stream), fn)


def at_offset(x, offset: int):
    """A contiguous copy of x that starts `offset` floats into its storage
    (offset 1: off every 8- and 16-byte boundary)."""
    flat = x.new_empty(x.numel() + offset)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


def grid_of(sx, sy, H: int, W: int):
    """grid_sample's normalised grid (align_corners=False) for absolute
    pixel coords."""
    import torch
    return torch.stack([(2 * sx + 1) / W - 1, (2 * sy + 1) / H - 1], -1)


def gather_row(peaks, g, label, B, H, W, C, mask, coarse, px):
    import torch
    import torch.nn.functional as F

    from fldrx_torch.ops import fastwarp

    img = torch.rand(B, H, W, C, device="cuda", generator=g) * 2 - 1
    sx, sy = smooth_targets(g, B, H, W, coarse, px)
    got = fastwarp.gather(img, sx, sy, mask)
    ref = fastwarp.gather_plain(img, sx, sy, mask)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"gather {label} disagrees with its plain "
                             f"version: {err}")
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = grid_of(sx, sy, H, W)
    out = torch.empty_like(got)
    route = fastwarp._route(C, img.data_ptr(), out.data_ptr())
    launch = bare_launch("fldrx_gather_f32", img, sx, sy, out, B, H, W, C, H,
                         W, int(mask), route)
    b, by = bound(peaks, "gather", B, H, W, C)
    return dict(
        shape=f"{label}: img {B}x{H}x{W}x{C} f32, mask "
              f"{'on' if mask else 'off'}",
        kernel_route=("scalar", "vec4")[route], max_abs_err=err,
        ms=median_ms(lambda: fastwarp.gather(img, sx, sy, mask)),
        kernel_ms=median_ms(launch),
        plain_ms=median_ms(lambda: fastwarp.gather_plain(img, sx, sy, mask)),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(lambda: F.grid_sample(
            img_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False)))


def splat_row(peaks, g, label, B, H, W, C, coarse, px):
    import torch

    from fldrx_torch.ops import fastwarp

    vals = torch.rand(B, H, W, C, device="cuda", generator=g)
    tx, ty = smooth_targets(g, B, H, W, coarse, px)
    got = fastwarp.splat(vals, tx, ty)
    ref = fastwarp.splat_plain(vals, tx, ty)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not excess(got, ref) <= 0:
        raise AssertionError(f"splat {label} disagrees with its plain "
                             f"version: max abs {err}")
    # the entry point zeroes its canvas, then adds into it; the index_add_
    # yardstick adds into a canvas zeroed once
    out = torch.zeros_like(vals)
    route = fastwarp._route(C, vals.data_ptr(), out.data_ptr())
    launch = bare_launch("fldrx_splat_f32", vals, tx, ty, out, B, H, W, C,
                         route)
    b, by = bound(peaks, "splat", B, H, W, C)
    return dict(
        shape=f"{label}: vals {B}x{H}x{W}x{C} f32",
        kernel_route=("scalar", "vec4")[route], max_abs_err=err,
        ms=median_ms(lambda: fastwarp.splat(vals, tx, ty)),
        kernel_ms=median_ms(launch),
        plain_ms=median_ms(lambda: fastwarp.splat_plain(vals, tx, ty)),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(index_add_yardstick(vals, tx, ty)))


# The VJP kernels at the forms the train step launches (batch 8, level 0 at
# 512×512; the feature splats at the 64×64 level-0 feature grid), the rows
# timed before those forms were known, kept for continuity, and the same
# forms at one rank's batch shard of 4 in the width-sharded step (8e).
# gather_grad: (label, B, H, W, C, mask, want_img, offset, coarse grid, ±px);
# the z and im_tot gathers warp data frames, so only coords are wanted; the
# flowback gathers warp a flow and want dimg too; offset 1 starts img and g
# one float into their storage, off every 8-byte boundary (the scalar
# layout where C = 2 would take float2).
GATHER_GRAD_ROWS = (
    ("step z, im_tot: coords", 8, 512, 512, 3, True, False, 0, (8, 8), 24.0),
    ("step flowback: dimg+coords", 8, 512, 512, 2, True, True, 0, (8, 8),
     24.0),
    ("flowback one float in: dimg+coords", 8, 512, 512, 2, True, True, 1,
     (8, 8), 24.0),
    ("old V1 row: dimg+coords", 8, 512, 512, 3, True, True, 0, (8, 8), 24.0),
    ("sp step z, im_tot: coords, one rank", 4, 512, 512, 3, True, False, 0,
     (8, 8), 24.0),
    ("sp step flowback: dimg+coords, one rank", 4, 512, 512, 2, True, True,
     0, (8, 8), 24.0),
)
# splat_grad: (label, B, H, W, C, coords, coarse grid, ±px); the feature
# splats' flow is detached, so they want dvals only
SPLAT_GRAD_ROWS = (
    ("step level 0: dvals+coords", 8, 512, 512, 4, True, (8, 8), 24.0),
    ("step feature: dvals", 8, 64, 64, 49, False, (8, 8), 3.0),
    ("old V2 row: dvals+coords", 8, 64, 64, 49, True, (8, 8), 3.0),
    ("sp step level 0: dvals+coords, one rank", 4, 512, 512, 4, True, (8, 8),
     24.0),
    ("sp step feature: dvals, one rank", 4, 64, 64, 49, False, (8, 8), 3.0),
)


def gather_grad_row(peaks, g, label, B, H, W, C, mask, want_img, offset,
                    coarse, px):
    """gather_grad at one form against its plain version (every output
    within 1e-4·(1+|ref|)); the library call is grid_sampler_2d_backward
    with the same outputs asked for (it has no mask)."""
    import torch

    from fldrx_torch.ops import fastwarp

    img = at_offset(torch.rand(B, H, W, C, device="cuda", generator=g) * 2 - 1,
                    offset)
    cot = at_offset(torch.randn(B, H, W, C, device="cuda", generator=g),
                    offset)
    sx, sy = smooth_targets(g, B, H, W, coarse, px)
    got = fastwarp.gather_grad(img, sx, sy, cot, mask, want_img)
    ref = fastwarp.gather_grad_plain(img, sx, sy, cot, mask, want_img)
    torch.cuda.synchronize()
    pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
    errs = [(a - b).abs().max().item() for a, b in pairs]
    if not max(excess(a, b) for a, b in pairs) <= 0:
        raise AssertionError(f"gather_grad {label} disagrees with its plain "
                             f"version: max abs {errs}")
    # dimg is zeroed before each bare launch, outside the timed window, as
    # the step's is (an entry point that does not zero it would otherwise
    # add into the last launch's sums); one that does zeroes it again
    dimg = torch.zeros_like(img) if want_img else None
    launch = bare_launch("fldrx_gather_grad_f32", img, sx, sy, cot, dimg,
                         torch.empty_like(sx), torch.empty_like(sy), B, H, W,
                         C, H, W, int(mask))
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
    grid = grid_of(sx, sy, H, W)
    b, by = bound(peaks, "gather_grad", B, H, W, C, want_img)
    return dict(
        shape=f"{label}: img {B}x{H}x{W}x{C} f32, mask "
              f"{'on' if mask else 'off'}",
        max_abs_err=max(errs),
        ms=median_ms(lambda: fastwarp.gather_grad(img, sx, sy, cot, mask,
                                                  want_img)),
        kernel_ms=median_ms(launch, setup=dimg.zero_ if want_img else None),
        plain_ms=median_ms(lambda: fastwarp.gather_grad_plain(
            img, sx, sy, cot, mask, want_img)),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            cot_nchw, img_nchw, grid, 0, 0, False, [want_img, True])))


def splat_grad_row(peaks, g, label, B, H, W, C, coords, coarse, px):
    """splat_grad at one form against its plain version (dvals bit for
    bit, dtx/dty within 1e-4·(1+|ref|)); dvals alone is one grid_sample of
    the cotangent, the library call there; with dtx/dty no single PyTorch
    call computes it."""
    import torch
    import torch.nn.functional as F

    from fldrx_torch.ops import fastwarp

    vals = torch.rand(B, H, W, C, device="cuda", generator=g)
    cot = torch.randn(B, H, W, C, device="cuda", generator=g)
    tx, ty = smooth_targets(g, B, H, W, coarse, px)
    got = fastwarp.splat_grad(vals, tx, ty, cot, coords)
    ref = fastwarp.splat_grad_plain(vals, tx, ty, cot, coords)
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() for a, b in zip(got, ref)
            if b is not None]
    if not (errs[0] == 0 and (not coords or (excess(got[1], ref[1]) <= 0
                                             and excess(got[2], ref[2]) <= 0))):
        raise AssertionError(f"splat_grad {label} disagrees with its plain "
                             f"version: max abs {errs}")
    launch = bare_launch("fldrx_splat_grad_f32", vals, tx, ty, cot,
                         torch.empty_like(vals),
                         torch.empty_like(tx) if coords else None,
                         torch.empty_like(ty) if coords else None, B, H, W, C)
    cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
    grid = grid_of(tx, ty, H, W)
    b, by = bound(peaks, "splat_grad", B, H, W, C, coords)
    return dict(
        shape=f"{label}: vals {B}x{H}x{W}x{C} f32", max_abs_err=max(errs),
        ms=median_ms(lambda: fastwarp.splat_grad(vals, tx, ty, cot, coords)),
        kernel_ms=median_ms(launch),
        plain_ms=median_ms(lambda: fastwarp.splat_grad_plain(
            vals, tx, ty, cot, coords)),
        bound_ms=b, bound_by=by,
        library_ms=None if coords else median_ms(lambda: F.grid_sample(
            cot_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False)))


WARP_KERNELS = ("gather", "splat", "gather_grad", "splat_grad")


def warp_rows(peaks, kernels=WARP_KERNELS):
    """Phase 2 for the warp kernels (all of WARP_KERNELS, or those named):
    the gather and the splat at GATHER_ROWS and SPLAT_ROWS (the gather
    within 1e-5, expected 0; the splat within 1e-4·(1+|ref|)), gather_grad
    and splat_grad at GATHER_GRAD_ROWS and SPLAT_GRAD_ROWS; each against
    its plain version, timed through the wrapper, as the bare launch, as
    the plain version and as the library call."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, fn, table in (("gather", gather_row, GATHER_ROWS),
                            ("splat", splat_row, SPLAT_ROWS),
                            ("gather_grad", gather_grad_row, GATHER_GRAD_ROWS),
                            ("splat_grad", splat_grad_row, SPLAT_GRAD_ROWS)):
        if name not in kernels:
            continue
        rows[name] = [fn(peaks, g, *r) for r in table]
        torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            lib = r["library_ms"]
            print(f"kernel {name}: err {r['max_abs_err']:.3g}, {r['ms']:.4f} "
                  f"ms (bare {r['kernel_ms']:.4f}"
                  + (f", {r['kernel_route']}" if "kernel_route" in r else "")
                  + f"; plain {r['plain_ms']:.3f}, library "
                  f"{'none' if lib is None else f'{lib:.4f}'}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}) at {r['shape']}",
                  flush=True)
    meta = {
        "gather": dict(replaces="fldrx/ops/fastwarp.py:307",
                       tolerance="1e-5 max abs (expected 0)",
                       library_call="F.grid_sample, no mask"),
        "splat": dict(replaces="fldrx/ops/fastwarp.py:986",
                      also_replaces="fldrx/ops/fastwarp.py:776",
                      tolerance="1e-4*(1+|ref|)",
                      library_call="index_add_ of the four corners' updates "
                                   "into a zeroed canvas"),
        "gather_grad": dict(replaces="fldrx/ops/fastwarp.py:1569",
                            tolerance="1e-4*(1+|ref|)",
                            library_call="torch.ops.aten."
                                         "grid_sampler_2d_backward, the same "
                                         "outputs, no mask"),
        "splat_grad": dict(replaces="fldrx/ops/fastwarp.py:1529",
                           tolerance="dvals bit-exact, dtx/dty "
                                     "1e-4*(1+|ref|)",
                           library_call="dvals alone: F.grid_sample of the "
                                        "cotangent; with dtx/dty none"),
    }
    # the top-level numbers are the first row's, but max_abs_err is the
    # largest of all rows
    return {name: dict(name=name, route="cuda",
                       source="fldrx_torch/csrc/warp.cu", **meta[name],
                       **dict(rs[0], max_abs_err=max(r["max_abs_err"]
                                                     for r in rs)),
                       shapes=rs[1:])
            for name, rs in rows.items()}


def check_interleave(dev, peaks, results):
    """Phase 2 at the shape the evaluator's device-metrics path gives the
    interleave: the padded 4K frame's u-planes, 1×4×576×12288 f32."""
    import torch

    from fldrx_torch.ops import repack

    g = torch.Generator(device=dev).manual_seed(3)
    B, H, WC = 1, 2304, 4096 * 3
    planes = torch.randn(B, 4, H // 4, WC, device=dev, generator=g)
    got = repack.interleave_planes(planes)
    ref = repack.interleave_planes_plain(planes)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("interleave disagrees with its plain version")
    b, by = bound(peaks, "interleave", B, H, WC)
    results["interleave"] = dict(
        name="interleave", route="cuda", source="fldrx_torch/csrc/repack.cu",
        replaces="fldrx/ops/repack.py:77", also_replaces="fldrx/ops/repack.py:102",
        library_call="planes.transpose(1, 2).contiguous()",
        tolerance="bit-exact", max_abs_err=(got - ref).abs().max().item(),
        ms=median_ms(lambda: repack.interleave_planes(planes)),
        plain_ms=median_ms(lambda: repack.interleave_planes_plain(planes)),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(lambda: planes.transpose(1, 2).contiguous()),
        shape=f"planes {B}x4x{H // 4}x{WC} f32")
    del planes, got, ref
    torch.cuda.empty_cache()
    r = results["interleave"]
    print(f"kernel interleave: err {r['max_abs_err']:.3g}, {r['ms']:.4f} ms "
          f"(plain {r['plain_ms']:.3f}, library {r['library_ms']:.4f}, bound "
          f"{r['bound_ms']:.4f} by {r['bound_by']}) at {r['shape']}",
          flush=True)


# the packed refine UNet's conv3x3 calls on the 4K path (refine_unet_s2d_core
# at the quarter grid 576×1024 and the eighth grid 288×512), 7 each per pair
CONV_SHAPES = (("enc1", 576, 1024, 416, 64), ("enc2", 576, 1024, 64, 32),
               ("enc3", 288, 512, 128, 64), ("dec2", 576, 1024, 192, 64),
               ("dec3", 576, 1024, 256, 96))


def conv_row(peaks, x, w, bias, label):
    """Hold conv3x3 on (x, w, bias) against float32 F.conv2d (≤ 2e-2 max
    abs, ≤ 1e-2 relative L2) and time it: through the wrapper (weight
    packing included), the kernel launch alone, the plain version and
    cuDNN bf16 channels-last; the bound from the dense conv's bytes and
    operations."""
    import torch
    import torch.nn.functional as F

    from fldrx_torch.ops import _build, fastconv

    _, H, W, Cin = x.shape
    K = w.shape[0]
    got = fastconv.conv3x3(x, w, bias).float()
    ref = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), bias,
                   padding=1).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    rel = ((got - ref).norm() / ref.norm()).item()
    if not (err <= 2e-2 and rel <= 1e-2):
        raise AssertionError(f"conv3x3 {label} disagrees with float32 "
                             f"F.conv2d: max abs {err}, rel L2 {rel}")
    del got, ref
    nb = fastconv.block_n(K)
    wp, bf = fastconv.pack_weights(w, nb), bias.float()
    out = torch.empty(1, H, W, K, device=x.device, dtype=torch.bfloat16)
    lib = _build.library("conv3x3")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(lib.fldrx_conv3x3_bf16(
            x.data_ptr(), wp.data_ptr(), bf.data_ptr(), out.data_ptr(), 1, H,
            W, Cin, K, nb, stream), "conv3x3")

    x_cl = x.permute(0, 3, 1, 2)                 # channels-last NCHW view
    w_cl = w.contiguous(memory_format=torch.channels_last)
    b16 = bias.to(torch.bfloat16)
    b, by = bound(peaks, "conv3x3", H, W, Cin, K)
    return dict(
        shape=f"{label} x 1x{H}x{W}x{Cin} bf16 -> {K}", max_abs_err=err,
        rel_l2_err=rel,
        ms=median_ms(lambda: fastconv.conv3x3(x, w, bias)),
        kernel_ms=median_ms(launch),
        plain_ms=median_ms(lambda: fastconv.conv3x3_plain(x, w, bias)),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(lambda: F.conv2d(x_cl, w_cl, b16, padding=1)))


def check_conv3x3(dev, peaks, results):
    """Phase 2 for conv3x3 at the five packed shapes of the 4K path on
    random dense weights, and at enc1 on the checkpoint's weights repacked
    as the model repacks them (mostly structural zeros)."""
    import torch

    from fldrx_torch.api import DEFAULT_NPZ
    from fldrx_torch.model.fldrnet import _repack_conv_w
    from fldrx_torch.weights import load_npz, params_from_numpy

    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for label, H, W, Cin, K in CONV_SHAPES:
        x = (torch.rand(1, H, W, Cin, device=dev, generator=g) * 2 - 1
             ).to(torch.bfloat16)
        std = float(np.sqrt(2.0 / (9 * Cin + 9 * K)))
        w = (torch.randn(K, Cin, 3, 3, device=dev, generator=g) * std
             ).to(torch.bfloat16)
        bias = torch.randn(K, device=dev, generator=g) * 0.1
        rows.append(conv_row(peaks, x, w, bias, label))
        if label == "enc1":
            p = params_from_numpy(load_npz(DEFAULT_NPZ)[0]["vfinet"]["refine"]
                                  ["enc1"], dev)
            w_real = _repack_conv_w(p["w"], 4, 2, 2, 1).to(torch.bfloat16)
            real = conv_row(peaks, x, w_real, p["b"].repeat(4),
                            "enc1, checkpoint weights")
            del p, w_real
        del x, w, bias
        torch.cuda.empty_cache()
    results["conv3x3"] = dict(
        name="conv3x3", route="cuda", source="fldrx_torch/csrc/conv3x3.cu",
        replaces="fldrx/ops/fastconv.py:69",
        tolerance="2e-2 max abs, 1e-2 rel L2 vs float32 F.conv2d",
        library_call="F.conv2d bf16 channels-last (cuDNN)", **rows[0])
    results["conv3x3"]["max_abs_err"] = max(r["max_abs_err"]
                                            for r in rows + [real])
    results["conv3x3"]["shapes"] = rows[1:] + [real]
    for r in rows + [real]:
        print(f"kernel conv3x3: err {r['max_abs_err']:.3g} (rel "
              f"{r['rel_l2_err']:.3g}), {r['ms']:.4f} ms (kernel "
              f"{r['kernel_ms']:.4f}, plain {r['plain_ms']:.3f}, cuDNN "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}) at {r['shape']}", flush=True)


def check_deinterleave(dev, peaks, results):
    """Phase 2 for the deinterleave, which no path launches (fldrx has no
    caller of extract_planes): plain rows of the padded 4K frame,
    1×2304×12288 f32, bit for bit against the plain version, and the round
    trip through the interleave."""
    import torch

    from fldrx_torch.ops import repack

    g = torch.Generator(device=dev).manual_seed(5)
    B, H, WC = 1, 2304, 4096 * 3
    rows = torch.randn(B, H, WC, device=dev, generator=g)
    got = repack.extract_planes(rows)
    ref = repack.extract_planes_plain(rows)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("deinterleave disagrees with its plain version")
    if not torch.equal(repack.interleave_planes(got), rows):
        raise AssertionError("interleave_planes(extract_planes(x)) != x")
    b, by = bound(peaks, "deinterleave", B, H, WC)
    results["deinterleave"] = dict(
        name="deinterleave", route="cuda",
        source="fldrx_torch/csrc/repack.cu",
        replaces="fldrx/ops/repack.py:91",
        also_replaces="fldrx/ops/repack.py:182",
        path="none: fldrx has no caller of extract_planes; launched here "
             "in phase 2 only",
        library_call="rows.view(B, H // 4, 4, WC).transpose(1, 2)"
                     ".contiguous()",
        tolerance="bit-exact, and the round trip", round_trip_exact=True,
        max_abs_err=(got - ref).abs().max().item(),
        ms=median_ms(lambda: repack.extract_planes(rows)),
        plain_ms=median_ms(lambda: repack.extract_planes_plain(rows)),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(lambda: rows.view(B, H // 4, 4, WC)
                             .transpose(1, 2).contiguous()),
        shape=f"rows {B}x{H}x{WC} f32")
    del rows, got, ref
    torch.cuda.empty_cache()
    r = results["deinterleave"]
    print(f"kernel deinterleave: err {r['max_abs_err']:.3g}, {r['ms']:.4f} "
          f"ms (plain {r['plain_ms']:.3f}, library {r['library_ms']:.4f}, "
          f"bound {r['bound_ms']:.4f} by {r['bound_by']}) at {r['shape']}",
          flush=True)


# The correlation at the teacher's five cost volumes on the training
# recipe's batch (8 pairs of 512×512): (label, B, H, W, C), the extractor
# widths of dec2 (128×128) to dec6 (8×8); a teacher call launches each twice.
CORR_ROWS = (
    ("dec2", 8, 128, 128, 32),
    ("dec3", 8, 64, 64, 64),
    ("dec4", 8, 32, 32, 96),
    ("dec5", 8, 16, 16, 128),
    ("dec6", 8, 8, 8, 196),
)


def resource_usage(lib: str, kernel: str) -> dict:
    """For each function of a built library whose mangled name holds
    `kernel`: its registers, stack and local (spill) bytes a thread, by
    the toolkit's cuobjdump; a template's arguments are kept as <…>."""
    import re

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    out = subprocess.run([os.path.join(home, "bin", "cuobjdump"),
                          "-res-usage", lib], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    usage, fn = {}, None
    for ln in out.splitlines():
        ln = ln.strip()
        if ln.startswith("Function "):
            name = ln[len("Function "):].rstrip(":")
            fn = None
            if kernel in name:
                args = re.findall(r"Li(\d+)E", name.split(kernel, 1)[1])
                fn = kernel + (f"<{','.join(args)}>" if args else "")
        elif fn and ln.startswith("REG:"):
            vals = dict(w.split(":", 1) for w in ln.split() if ":" in w)
            usage[fn] = {k: int(vals[k]) for k in ("REG", "STACK", "LOCAL")}
            fn = None
    return usage


def correlation_row(peaks, g, label, B, H, W, C):
    """The correlation at one volume: against its plain version (1e-5·(1 +
    |ref|)), the bare launch equal to the wrapper's output bit for bit;
    timed through the wrapper, as the bare launch (per call, and on the
    device alone: queued_ms) and as the plain version."""
    import torch

    from fldrx_torch.ops import correlation

    f1 = torch.randn(B, H, W, C, device="cuda", generator=g)
    f2 = torch.randn(B, H, W, C, device="cuda", generator=g)
    got = correlation.correlation(f1, f2)
    ref = correlation.correlation_cost_volume(f1, f2)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not excess(got, ref, 1e-5) <= 0:
        raise AssertionError(f"correlation {label} {B}x{H}x{W}x{C} "
                             f"disagrees with its plain version: max abs "
                             f"{err}")
    out = torch.empty_like(ref)
    bare = bare_launch("fldrx_correlation_f32", f1, f2, out, B, H, W, C,
                       lib="correlation")
    bare()
    torch.cuda.synchronize()
    if not torch.equal(out, got):
        raise AssertionError(f"correlation {label}: the bare launch differs "
                             "from the wrapper's")
    b, by = bound(peaks, "correlation", B, H, W, C)
    return dict(
        ms=median_ms(lambda: correlation.correlation(f1, f2)),
        kernel_ms=median_ms(bare), device_ms=queued_ms(bare),
        plain_ms=median_ms(
            lambda: correlation.correlation_cost_volume(f1, f2)),
        bound_ms=b, bound_by=by, library_ms=None, max_abs_err=err,
        shape=f"{label} f1, f2 {B}x{H}x{W}x{C} f32 -> 81")


def correlation_rows(peaks):
    """Phase 2 for the correlation: every row of CORR_ROWS, and the
    registers and spills of the kernels built (there is no single PyTorch
    call that computes the 81-channel volume, so no library yardstick)."""
    import torch

    from fldrx_torch.ops import _build

    g = torch.Generator(device="cuda").manual_seed(2)
    rows = [correlation_row(peaks, g, *r) for r in CORR_ROWS]
    torch.cuda.empty_cache()
    usage = resource_usage(_build.library_path("correlation"),
                           "correlation_kernel")
    for k, v in usage.items():
        print(f"  {k}: {v['REG']} registers, {v['STACK']} bytes stack, "
              f"{v['LOCAL']} bytes local (spills)", flush=True)
    for r in rows:
        print(f"kernel correlation: err {r['max_abs_err']:.3g}, "
              f"{r['ms']:.4f} ms (bare {r['kernel_ms']:.4f}, device "
              f"{r['device_ms']:.4f}; plain {r['plain_ms']:.3f}, library: "
              f"none, bound {r['bound_ms']:.4f} by {r['bound_by']}) at "
              f"{r['shape']}", flush=True)
    # the top-level numbers are dec2's, max_abs_err the largest of all rows
    return dict(name="correlation", route="cuda",
                source="fldrx_torch/csrc/correlation.cu",
                replaces="fldrx/ops/correlation.py:62",
                library_call="none: no single PyTorch call computes the "
                             "volume",
                tolerance="1e-5*(1+|ref|)",
                **dict(rows[0], max_abs_err=max(r["max_abs_err"]
                                                for r in rows)),
                shapes=rows[1:], resources=usage)


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

# the kernels each path must launch
INFER_KERNELS = ("gather", "splat", "conv3x3")
TRAIN_KERNELS = ("gather", "splat", "gather_grad", "splat_grad")
TEACHER_KERNELS = ("correlation", "gather")
EVAL_KERNELS = INFER_KERNELS + ("interleave",)


def _counters():
    from fldrx_torch.ops import correlation, fastconv, fastwarp, repack
    return (fastwarp.LAUNCHES, fastconv.LAUNCHES, correlation.LAUNCHES,
            repack.LAUNCHES)


def launches():
    out = {}
    for d in _counters():
        out.update(d)
    return out


def require_launched(seen, kernels, where):
    missing = [k for k in kernels if seen[k] == 0]
    if missing:
        raise AssertionError(f"{where}: kernels not launched: {missing} "
                             f"({seen})")


# launches per 4K ×8 pair: gather 30 (2 flowback and 2 im_tot gathers per
# t, and the 2 half-resolution z gathers), splat 24 (2 level-0 splats per t,
# and 2 feature splats at each of 5 levels), conv3x3 35 (5 packed convs per
# t); per training step (S_trn = 3: synthesis at 4 levels): gather 24 (2 z,
# 2 flowback and 2 im_tot gathers per level) and splat 16 (2 softmax splats
# per level, 2 feature splats at each of 3 levels, 2 in the endflow loss),
# and one VJP launch for each
PER_PAIR = {"gather": 30, "splat": 24, "conv3x3": 35}
PER_STEP = {"gather": 24, "splat": 16, "gather_grad": 24, "splat_grad": 16}
# the VJP launches per step by form (fastwarp.FORMS): the z and im_tot
# gathers warp data frames (coords only), the flowback gathers a flow (dimg
# too); the softmax and endflow splats want dtx/dty, the feature splats'
# flow is detached (dvals only)
FORMS_PER_STEP = {"gather_grad coords C=3 mask on": 16,
                  "gather_grad dimg+coords C=2 mask on": 8,
                  "splat_grad dvals+coords C=4": 10,
                  "splat_grad dvals C=49": 6}


def require_counts(seen, per, n: int, where: str):
    """Each kernel of `per` launched exactly per[k] times in each of n
    pairs (or steps)."""
    bad = {k: seen[k] for k in per if seen[k] != per[k] * n}
    if bad:
        raise AssertionError(f"{where}: launches {bad} in {n} run(s), "
                             f"expected {per} per run")


def reset_launches():
    from fldrx_torch.ops import fastwarp
    for d in _counters():
        for k in d:
            d[k] = 0
    fastwarp.FORMS.clear()


def main_path_held():
    import torch

    from fldrx_torch.api import prepare_model
    from fldrx_torch.ops.metrics import psnr
    from fldrx_torch.bench_inputs import bench_frames, deploy_config

    cfg = deploy_config()
    frames = bench_frames(768, 1280)
    t_values = [0.25, 0.5, 0.75]
    gpu, _, _ = prepare_model(cfg=cfg, device="cuda")
    reset_launches()
    t0 = time.time()
    out_gpu = gpu.interpolate_multi_np(frames, t_values)
    seen = launches()
    t1 = time.time()
    cpu, _, _ = prepare_model(cfg=cfg, device="cpu")
    out_cpu = cpu.interpolate_multi_np(frames, t_values)
    t2 = time.time()
    if out_gpu.shape != (3, 1, 768, 1280, 3):
        raise AssertionError(f"output shape {out_gpu.shape}")
    require_launched(seen, INFER_KERNELS, "inference held")
    db = psnr(out_cpu + 1.0, out_gpu + 1.0, data_range=2.0)
    print(json.dumps({"phase": "main_path_held", "hw": [768, 1280],
                      "t_values": t_values, "psnr_gpu_vs_cpu_db": db,
                      "max_abs": float(np.abs(out_gpu - out_cpu).max()),
                      "launches": seen, "gpu_s": t1 - t0,
                      "cpu_s": t2 - t1}), flush=True)
    if not db >= 60.0:
        raise AssertionError(f"GPU and CPU outputs differ: {db:.2f} dB")
    del gpu, cpu
    torch.cuda.empty_cache()


def main_path_4k(card: str):
    """Phase 4: bench.py's run through fldrx_torch.bench's timed pairs."""
    import torch

    from fldrx_torch import bench
    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import bench_frames, deploy_config

    cfg = deploy_config()
    interp, _, _ = prepare_model(cfg=cfg, device="cuda")
    H, W = bench.H, bench.W
    frames = torch.as_tensor(bench_frames(H, W)).cuda()
    ts = bench.t_values()
    stats = []

    def on_chunk(out):
        stats.append(torch.stack([out.amin(), out.amax(),
                                  (~torch.isfinite(out)).sum().float()]))

    torch.cuda.reset_peak_memory_stats()
    res = bench.timed_pairs(interp, frames, ts, bench.ITERS, on_chunk,
                            before_timed=reset_launches)
    seen = launches()
    out, iters = res["out"], bench.ITERS
    last = len(ts) - (len(ts) - 1) // cfg.t_chunk * cfg.t_chunk
    if tuple(out.shape) != (last, 1, 4, H // 4, W * 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    st = torch.stack(stats).cpu().numpy()
    lo, hi, nonfinite = float(st[:, 0].min()), float(st[:, 1].max()), \
        int(st[:, 2].sum())
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"phase": "main_path_4k", "hw": [H, W], "multiple": 8,
                      "pairs": iters, "fps": res["fps"],
                      "s_per_pair": res["s_per_pair"],
                      "warmup_s": res["warmup_s"],
                      "peak_mem_gib": peak_gb, "launches": seen,
                      "out_min": lo, "out_max": hi, "nonfinite": nonfinite,
                      "card": card}), flush=True)
    if nonfinite or lo < -1.1 or hi > 1.1:
        raise AssertionError(f"outputs out of range: [{lo}, {hi}], "
                             f"{nonfinite} non-finite")
    require_launched(seen, INFER_KERNELS, "inference at 4K")
    require_counts(seen, PER_PAIR, iters, "inference at 4K")
    return seen


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

def draw_t(gen, B: int):
    """t in (0, 1) from a torch.Generator, in X-Train's range
    [1/32, 31/32]."""
    import torch
    return (1 / 32 + (30 / 32) * torch.rand(B, 1, generator=gen)).numpy()


def train_step_held(devs=("cuda", "cpu")):
    """5a: one train step from the real checkpoint on the card and on the
    CPU, on the same batch."""
    import torch

    from fldrx_torch.api import DEFAULT_NPZ
    from fldrx_torch.bench_inputs import train_batch, train_config
    from fldrx_torch.train.trainer import TrainState, make_train_step
    from fldrx_torch.weights import load_npz, named_leaves, params_from_numpy

    cfg = train_config().replace(batch_size=2)
    gen = torch.Generator().manual_seed(5)
    batch = train_batch(256, draw_t(gen, 2), seed=5)
    tree = load_npz(DEFAULT_NPZ)[0]
    runs = {}
    for dev in devs:
        t0 = time.time()
        params = params_from_numpy(tree, dev)
        state = TrainState.create(params, cfg)
        m = make_train_step(cfg)(state, batch)
        runs[dev] = ({k: float(v) for k, v in m.items()},
                     {n: p.grad.detach().double().cpu()
                      for n, p in named_leaves(params) if p.grad is not None},
                     time.time() - t0)
    (mg, gg, sg), (mc, gc, sc) = runs[devs[0]], runs[devs[1]]
    metric_rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
                  for k in mc}
    grad_rel = {k: float((gg[k] - gc[k]).norm() / max(gc[k].norm(), 1e-30))
                for k in gc}
    worst = max(grad_rel, key=grad_rel.get)
    print(json.dumps({"phase": "train_step_held", "hw": [256, 256],
                      "batch": 2, "S_trn": cfg.S_trn, "t": batch["t"][:, 0]
                      .tolist(), "metrics_gpu": mg, "metrics_cpu": mc,
                      "max_metric_rel": max(metric_rel.values()),
                      "grad_leaves": len(gc), "max_grad_rel_l2": grad_rel[worst],
                      "worst_leaf": worst, "gpu_s": sg, "cpu_s": sc}),
          flush=True)
    if set(gg) != set(gc) or len(gc) != 44:
        raise AssertionError(f"gradient leaves differ: {sorted(gg)} vs "
                             f"{sorted(gc)}")
    bad = {k: v for k, v in metric_rel.items()
           if not (v <= 1e-4 or mg[k] == mc[k])}
    if bad:
        raise AssertionError(f"train step metrics differ card vs cpu: {bad}")
    if not grad_rel[worst] <= 1e-3:
        raise AssertionError(f"gradient {worst} differs card vs cpu: "
                             f"rel L2 {grad_rel[worst]}")


def train_full(card: str, dev: str = "cuda"):
    """5b: training at full size from a fresh start, then a checkpoint
    round trip."""
    import tempfile

    import torch

    from fldrx_torch.bench_inputs import train_batch, train_config
    from fldrx_torch.model.fldrnet import init_params
    from fldrx_torch.ops import fastwarp
    from fldrx_torch.train.checkpoint import SaveManager
    from fldrx_torch.train.loop import assign_params, fit_pca_from_batch
    from fldrx_torch.train.trainer import TrainState, make_train_step
    from fldrx_torch.weights import (flatten_params, params_from_numpy,
                                     params_to_numpy)

    cfg = train_config()
    B, S = cfg.batch_size, cfg.patch_size
    gen = torch.Generator().manual_seed(0)
    t0 = time.time()
    batches = []
    for i in range(6):
        b = train_batch(S, draw_t(gen, B), seed=100 + i)
        batches.append({k: torch.as_tensor(v).to(dev) for k, v in b.items()})
    data_s = time.time() - t0
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    assign_params(params, fit_pca_from_batch(
        batches[0]["frames"].cpu().numpy(), cfg, dev))
    state = TrainState.create(params, cfg)
    step = make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(state, batches[0])["loss"]]                # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    iters = 5
    reset_launches()
    t0 = time.perf_counter()
    for b in batches[1:]:
        m = step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen = launches()
    forms = {k: v / iters for k, v in sorted(fastwarp.FORMS.items())}
    losses = torch.stack(losses).cpu().tolist()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: v / iters for k, v in seen.items()}

    with tempfile.TemporaryDirectory() as d:
        sm = SaveManager(cfg.replace(checkpoint_dir=os.path.join(d, "ck"),
                                     text_dir=os.path.join(d, "tx")))
        sm.save(state.params, {"last_epoch": 0}, step=state.step,
                opt_state=state.optimizer_state())
        tree, meta, opt = sm.load()
    restored = TrainState.create(params_from_numpy(tree, dev), cfg)
    restored.load_optimizer_state(opt, int(meta["step"]))
    p_a = flatten_params(params_to_numpy(state.params))
    p_b = flatten_params(params_to_numpy(restored.params))
    o_a, o_b = state.optimizer_state(), restored.optimizer_state()
    exact = (set(p_a) == set(p_b) and set(o_a) == set(o_b)
             and all(np.array_equal(p_a[k], p_b[k]) for k in p_a)
             and all(np.array_equal(o_a[k][f], o_b[k][f])
                     for k in o_a for f in o_a[k])
             and restored.step == state.step == 1 + iters
             and [g["lr"] for g in restored.optimizer.param_groups]
             == [g["lr"] for g in state.optimizer.param_groups])
    print(json.dumps({"phase": "train_full", "hw": [S, S], "batch": B,
                      "S_trn": cfg.S_trn, "steps": iters,
                      "ms_per_step": dt / iters * 1e3,
                      "samples_per_s": B * iters / dt, "warmup_s": warm_s,
                      "data_s": data_s, "peak_mem_gib": peak_gb,
                      "losses": losses, "launches_per_step": per_step,
                      "vjp_forms_per_step": forms,
                      "checkpoint_exact": exact, "card": card}), flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    require_launched(seen, TRAIN_KERNELS, "training at full size")
    require_counts(seen, PER_STEP, iters, "training at full size")
    if forms != FORMS_PER_STEP:
        raise AssertionError(f"training at full size: VJP launches per step "
                             f"by form {forms}, expected {FORMS_PER_STEP}")
    if not exact:
        raise AssertionError("checkpoint round trip did not restore the "
                             "parameters and optimiser state exactly")
    return seen


# ---------------------------------------------------------------------------
# phase 6: the PWC-Net teacher
# ---------------------------------------------------------------------------

def teacher_frames(B: int, H: int, W: int, seed: int):
    """B pairs of the bench texture as the teacher takes them: RGB in
    [0, 1], float32 [B, H, W, 3] each."""
    from fldrx_torch.bench_inputs import train_batch

    if H == W:
        fr = train_batch(H, np.full((B, 1), 0.5, np.float32), seed)["frames"]
    else:
        from fldrx_torch.bench_inputs import texture
        fr = texture(H, W, [(0, 0), (22, 13)])[None]
    fr = np.clip((fr + 1.0) / 2.0, 0.0, 1.0)
    return fr[:, 0], fr[:, 1]


def teacher_held():
    """6a: the teacher on the card against the CPU, same weights, one
    270×480 pair."""
    import torch

    from fldrx_torch.model.pwcnet import get_bidirectional_flow, init_pwc_params

    im0, im1 = teacher_frames(1, 270, 480, 0)
    flows, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        params = init_pwc_params(torch.Generator().manual_seed(0), dev)
        flows[dev] = get_bidirectional_flow(
            params, torch.as_tensor(im0, device=dev),
            torch.as_tensor(im1, device=dev)).double().cpu()
        secs[dev] = time.time() - t0
    g, c = flows["cuda"], flows["cpu"]
    rel = float((g - c).norm() / c.norm())
    print(json.dumps({"phase": "teacher_held", "hw": [270, 480],
                      "rel_l2_gpu_vs_cpu": rel,
                      "max_abs": float((g - c).abs().max()),
                      "max_flow": float(c.abs().max()),
                      "gpu_s": secs["cuda"], "cpu_s": secs["cpu"]}),
          flush=True)
    if tuple(g.shape) != (1, 270, 480, 4) or not torch.isfinite(g).all():
        raise AssertionError(f"teacher output {tuple(g.shape)}")
    if not rel <= 1e-4:
        raise AssertionError(f"teacher card vs cpu: relative L2 {rel}")


def teacher_full(card: str):
    """6b: the teacher at the published widths on 8 pairs of 512×512."""
    import torch

    from fldrx_torch.model.pwcnet import get_bidirectional_flow, init_pwc_params

    params = init_pwc_params(torch.Generator().manual_seed(0), "cuda")
    im0, im1 = (torch.as_tensor(x).cuda() for x in teacher_frames(8, 512,
                                                                  512, 7))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    get_bidirectional_flow(params, im0, im1)                  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    iters = 5
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = get_bidirectional_flow(params, im0, im1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen = launches()
    per_call = {k: v / iters for k, v in seen.items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(out).all())
    print(json.dumps({"phase": "teacher_full", "hw": [512, 512], "pairs": 8,
                      "calls": iters, "ms_per_call": dt / iters * 1e3,
                      "warmup_s": warm_s, "peak_mem_gib": peak_gb,
                      "launches_per_call": per_call,
                      "flow_abs_max": float(out.abs().max()),
                      "card": card}), flush=True)
    if tuple(out.shape) != (8, 512, 512, 4) or not finite:
        raise AssertionError(f"teacher output {tuple(out.shape)}, finite "
                             f"{finite}")
    require_launched(seen, TEACHER_KERNELS, "teacher at full width")
    if per_call != {"correlation": 10, "gather": 8}:
        raise AssertionError(f"teacher launches per call {per_call}, "
                             "expected correlation 10 and gather 8")
    return seen


# ---------------------------------------------------------------------------
# phase 7: the golden clip on the card
# ---------------------------------------------------------------------------

GOLDEN_PIN_512 = 44.828      # tests/test_goldenclip.py, fldrx f32 on the CPU
GOLDEN_4K = 44.139           # fldrx, the same protocol at 4K (PARITY.md §2)


def golden_clip(card: str):
    import torch

    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import deploy_config
    from fldrx_torch.config import papermodel
    from fldrx_torch.eval.goldenclip import golden_pair, golden_psnrs
    from fldrx_torch.ops import metrics
    from fldrx_torch.ops.metrics_torch import make_chunk_metrics

    # (a) the CPU test's configuration, on the card
    cfg = papermodel().replace(S_tst=3, fast_warp=True,
                               compute_dtype="float32")
    interp = prepare_model(cfg=cfg, device="cuda")[0]
    t0 = time.time()
    ps_a, mean_a = golden_psnrs(interp, 512, 768, 8)
    s_a = time.time() - t0
    del interp

    # (b) the deploy mix at 4K
    H, W = 2160, 4096
    t0 = time.time()
    frames, ts, gts = golden_pair(H, W, 8)
    render_s = time.time() - t0
    interp = prepare_model(cfg=deploy_config(), device="cuda")[0]
    reset_launches()
    t0 = time.time()
    preds = interp.interpolate_multi_np(frames, list(ts))[:, 0]
    infer_s = time.time() - t0
    seen = launches()
    ps_b = [metrics.psnr(metrics.denorm255(gt),
                         np.around(metrics.denorm255(p)))
            for p, gt in zip(preds, gts)]
    mean_b = float(np.mean(ps_b))

    # (c) metrics on the card against the host, two 4K predictions
    t0 = time.time()
    pick = [0, 3]
    dev_p, dev_s = make_chunk_metrics()(
        torch.as_tensor(preds[pick]).cuda(), torch.as_tensor(gts[pick]).cuda())
    host = []
    for i in pick:
        out_img = np.around(metrics.denorm255(preds[i]))
        tgt_img = metrics.denorm255(gts[i])
        host.append((metrics.psnr(tgt_img, out_img),
                     metrics.ssim_bgr(tgt_img, out_img)))
    d_psnr = max(abs(a - h[0]) for a, h in zip(dev_p.tolist(), host))
    d_ssim = max(abs(a - h[1]) for a, h in zip(dev_s.tolist(), host))
    print(json.dumps({
        "phase": "golden_clip", "a_hw": [512, 768],
        "a_mean_db": mean_a, "a_psnrs": list(map(float, ps_a)), "a_s": s_a,
        "b_hw": [H, W], "b_mean_db": mean_b, "b_psnrs": ps_b,
        "b_render_s": render_s, "b_infer_s": infer_s, "b_launches": seen,
        "c_psnr_dev_host": [[a, h[0]] for a, h in zip(dev_p.tolist(), host)],
        "c_ssim_dev_host": [[a, h[1]] for a, h in zip(dev_s.tolist(), host)],
        "c_max_psnr_diff_db": d_psnr, "c_max_ssim_diff": d_ssim,
        "c_s": time.time() - t0, "card": card}), flush=True)
    require_launched(seen, INFER_KERNELS, "golden clip 4K")
    require_counts(seen, PER_PAIR, 1, "golden clip 4K")
    seen_eval, psnr_7d = golden_evaluate(interp, frames, ts, gts, ps_b,
                                         card)
    if not abs(mean_a - GOLDEN_PIN_512) < 0.05:
        raise AssertionError(f"golden clip 512x768: {mean_a} dB, pinned "
                             f"{GOLDEN_PIN_512} ± 0.05")
    if not abs(mean_b - GOLDEN_4K) < 0.15:
        raise AssertionError(f"golden clip 4K deploy mix: {mean_b} dB, "
                             f"fldrx {GOLDEN_4K} ± 0.15")
    if not (d_psnr <= 1e-4 and d_ssim <= 1e-5):
        raise AssertionError(f"metrics on the card vs host: {d_psnr} dB, "
                             f"{d_ssim} SSIM")
    return seen_eval, (frames, ts, gts, psnr_7d)


def golden_evaluate(interp, frames, ts, gts, ps_float, card: str):
    """(d): evaluate() on the 4K golden clip as an 8-bit test set, metrics
    on the card and on the host. The 8-bit targets add their rounding
    error to each t's error: the float reading's MSE plus the targets'
    rounding MSE predicts the 8-bit reading, and that shift moves fldrx's
    44.139 for the check."""
    from fldrx_torch.data.datasets import frames_to_tensor
    from fldrx_torch.eval.evaluator import evaluate
    from fldrx_torch.eval.goldenclip import GoldenTestSet, to_uint8_frames
    from fldrx_torch.ops import metrics

    ds = GoldenTestSet(frames, ts, gts)
    cfg = interp.cfg
    reset_launches()
    t0 = time.time()
    on = evaluate(interp, cfg, "golden", multiple=8, dataset=ds,
                  verbose=False)
    on_s = time.time() - t0
    seen = launches()
    t0 = time.time()
    off = evaluate(interp, cfg, "golden", multiple=8, dataset=ds,
                   verbose=False, device_metrics=False)
    off_s = time.time() - t0
    shifted = []
    for p, gt in zip(ps_float, gts):
        mse = 255.0 ** 2 / 10 ** (p / 10)
        q = metrics.denorm255(frames_to_tensor(to_uint8_frames(gt)[None])[0]) \
            - metrics.denorm255(gt)
        shifted.append(10 * np.log10(255.0 ** 2 / (mse + np.mean(q ** 2))))
    shift = float(np.mean(shifted) - np.mean(ps_float))
    expect = GOLDEN_4K + shift
    print(json.dumps({
        "phase": "golden_evaluate", "hw": list(gts.shape[1:3]),
        "psnr_device_metrics": on.psnr, "ssim_device_metrics": on.ssim,
        "psnr_host_metrics": off.psnr, "ssim_host_metrics": off.ssim,
        "n_samples": [on.n_samples, off.n_samples],
        "rounding_shift_db": shift, "expected_db": expect,
        "device_metrics_s": on_s, "host_metrics_s": off_s,
        "fps_device_metrics": on.frames_per_sec, "launches": seen,
        "card": card}), flush=True)
    require_launched(seen, EVAL_KERNELS, "evaluate, metrics on the card")
    require_counts(seen, PER_PAIR, 1, "evaluate, metrics on the card")
    if not on.n_samples == off.n_samples == len(ts):
        raise AssertionError(f"evaluate scored {on.n_samples}, "
                             f"{off.n_samples} of {len(ts)} frames")
    if not (abs(on.psnr - off.psnr) <= 1e-4 and abs(on.ssim - off.ssim)
            <= 1e-5):
        raise AssertionError(f"evaluate, metrics on the card vs the host: "
                             f"{on.psnr} vs {off.psnr} dB, {on.ssim} vs "
                             f"{off.ssim}")
    if not abs(on.psnr - expect) < 0.15:
        raise AssertionError(f"evaluate on the 8-bit golden clip: {on.psnr} "
                             f"dB, expected {expect} ± 0.15")
    return seen, on.psnr


# ---------------------------------------------------------------------------
# phase 8: multi-device evaluation and data-parallel training, on one card
# ---------------------------------------------------------------------------

# Two shards or two ranks share cuda:0, one after the other: the timings
# measure the split's overhead, not scaling.
SHARED = ["cuda:0", "cuda:0"]
# launches per 4K ×8 pair: mode t on 2 shards synthesises 8 t slots (7
# padded to a multiple of 2): gather 2 z + 4 per slot, splat 10 feature + 2
# per slot, conv3x3 5 per slot, and each slot's plain rows through the
# interleave; mode sp on 2 slabs: splat 10 feature + 2 per t and slab,
# gather 2 im_tot per t and slab (the strict z maps and the pack's
# flowbacks launch none), conv3x3 5 per t and slab
PER_PAIR_T = {"gather": 34, "splat": 26, "conv3x3": 40, "interleave": 8}
PER_PAIR_SP = {"gather": 28, "splat": 38, "conv3x3": 70}
# fldrx's bulk criteria for the sharded fast path against the unsharded
# one (tests/test_parallel.py:92-101). On the card the splat's atomic adds
# vary a 4K ×8 output's last bits from run to run, and a few pixels cross
# the 0.999 mask or the splat's empty-target threshold, so that the
# single-device path and the strict path each differ from themselves by
# more than 0.3 at a few pixels, and a max bar cannot be held. Where
# sharding could err, within SEAM columns of each slab seam, the share
# bar is held again on those columns alone (an artefact along the seam
# would be a large share of them); the maxima are printed beside the
# single-device path's own run-to-run spread.
BULK = {"mean": 2e-3, "share_above_5e-2": 5e-4,
        "seam_share_above_5e-2": 5e-4}
SEAM = 32


def bulk(d, seams=()):
    """fldrx's bulk statistics of an absolute difference [T, H, W, 3];
    with seams (slab boundary columns) also the share above 5e-2 and the
    max within SEAM columns of them."""
    import torch
    out = {"mean": float(d.mean()),
           "share_above_5e-2": float((d > 5e-2).float().mean()),
           "max": float(d.max())}
    if seams:
        band = torch.cat([d[:, :, c - SEAM:c + SEAM] for c in seams], 2)
        out["seam_share_above_5e-2"] = float((band > 5e-2).float().mean())
        out["seam_max"] = float(band.max())
    return out


def timed_calls(fn, n: int):
    """One warm-up call, then n calls with the launch counts zeroed just
    before them; returns (last output, s per call, launches)."""
    import torch
    fn()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / n, launches()


def parallel_eval_4k(card: str):
    """8a and 8b: bench.py's pair at ×8, deploy mix, through the t-parallel
    and the width-sharded evaluation on two shards of cuda:0, against the
    single-device output; then the sharded path's exact spill fallback."""
    import torch

    from fldrx_torch import bench
    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import bench_frames, deploy_config, texture
    from fldrx_torch.ops.metrics import psnr
    from fldrx_torch.parallel.mesh import make_mesh
    from fldrx_torch.parallel.spatial import (build_parallel_eval,
                                              make_sharded_eval,
                                              make_sharded_fast_eval)

    cfg = deploy_config()
    interp, _, _ = prepare_model(cfg=cfg, device="cuda")
    frames = bench_frames(bench.H, bench.W)
    ts = bench.t_values()
    ref = torch.as_tensor(interp.interpolate_multi_np(frames, ts)[:, 0])
    # the single-device path against itself: the card's run-to-run spread
    spread = bulk((torch.as_tensor(interp.interpolate_multi_np(
        frames, ts)[:, 0]) - ref).abs())
    frames_dev = torch.as_tensor(frames).cuda()
    pairs = 2

    # 8a: t-parallel
    fn_t = build_parallel_eval(interp.params, cfg, "t", devices=SHARED)
    out_t, s_t, seen_t = timed_calls(lambda: fn_t(frames_dev, ts), pairs)
    out_t = out_t.cpu()
    db = psnr(ref.numpy() + 1.0, out_t.numpy() + 1.0, data_range=2.0)
    res_t = {"phase": "parallel_t", "hw": [bench.H, bench.W], "shards":
             SHARED, "pairs": pairs, "psnr_vs_single_db": db,
             "max_abs": float((out_t - ref).abs().max()),
             "fps_two_shards_one_card": len(ts) / s_t, "s_per_pair": s_t,
             "launches_per_pair": {k: v / pairs for k, v in seen_t.items()},
             "card": card}
    print(json.dumps(res_t), flush=True)
    del out_t
    torch.cuda.empty_cache()

    # 8b: width-sharded, halo 256
    sp = make_sharded_fast_eval(interp.params, cfg,
                                make_mesh(SHARED, dp=1, sp=2), halo=256)
    torch.cuda.reset_peak_memory_stats()
    out_sp, s_sp, seen_sp = timed_calls(lambda: sp.multi(frames_dev, ts),
                                        pairs)
    peak_sp = torch.cuda.max_memory_allocated() / 2 ** 30
    counters = dict(sp.counters)
    d = bulk((out_sp.cpu() - ref).abs(), seams=(bench.W // 2,))
    del out_sp
    torch.cuda.empty_cache()

    # the exact fallback: halo 64 leaves 32 px, a pan of 96 px exceeds it;
    # against make_sharded_eval, whose own repeat gives the card's spread
    panned = np.clip(np.round((texture(bench.H, bench.W, [(0, 0), (96, 0)])
                               [None] + 1.0) * 127.5), 0, 255).astype(
                                   np.uint8)
    mesh = make_mesh(SHARED, dp=1, sp=2)
    spill = make_sharded_fast_eval(interp.params, cfg, mesh, halo=64,
                                   verbose=False)
    got = spill(panned, [[0.5]]).cpu()
    exact_fn = make_sharded_eval(interp.params, cfg, mesh)
    exact = exact_fn(panned, [[0.5]]).cpu()
    spill_d = bulk((got - exact).abs())
    exact_spread = bulk((exact_fn(panned, [[0.5]]).cpu() - exact).abs())
    res_sp = {"phase": "parallel_sp", "hw": [bench.H, bench.W], "slabs":
              SHARED, "halo": 256, "pairs": pairs, "bulk_vs_single": d,
              "single_vs_itself": spread, "bulk_limits": BULK,
              "counters": counters,
              "fps_two_slabs_one_card": len(ts) / s_sp, "s_per_pair": s_sp,
              "peak_mem_gib": peak_sp,
              "launches_per_pair": {k: v / pairs for k, v in seen_sp.items()},
              "spill_halo64_pan96": {"counters": dict(spill.counters),
                                     "vs_sharded_eval": spill_d,
                                     "sharded_eval_vs_itself":
                                         exact_spread},
              "card": card}
    print(json.dumps(res_sp), flush=True)

    if not db >= 60.0:
        raise AssertionError(f"t-parallel vs single device: {db:.2f} dB")
    require_counts(seen_t, PER_PAIR_T, pairs, "t-parallel 4K")
    if any(d[k] >= BULK[k] for k in BULK):
        raise AssertionError(f"width-sharded vs single device: {d}, limits "
                             f"{BULK}")
    if counters != {"n_flow_runs": 1 + pairs, "n_spill_fallbacks": 0}:
        raise AssertionError(f"width-sharded counters {counters}")
    require_counts(seen_sp, PER_PAIR_SP, pairs, "width-sharded 4K")
    if spill.counters != {"n_flow_runs": 1, "n_spill_fallbacks": 1}:
        raise AssertionError(f"spill run counters {spill.counters}")
    # 2e-5 held on the mean: the max is not reproducible run to run
    if not spill_d["mean"] <= 2e-5:
        raise AssertionError(f"spill fallback vs make_sharded_eval: "
                             f"{spill_d}")
    return seen_t, seen_sp


def parallel_evaluate(card: str, golden):
    """8c: evaluate() on the 4K golden clip as an 8-bit test set through
    parallel_eval in each mode, against phase 7d's single-device reading."""
    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import deploy_config
    from fldrx_torch.eval.evaluator import evaluate
    from fldrx_torch.eval.goldenclip import GoldenTestSet
    from fldrx_torch.parallel.spatial import build_parallel_eval

    frames, ts, gts, psnr_7d = golden
    ds = GoldenTestSet(frames, ts, gts)
    cfg = deploy_config()
    interp = prepare_model(cfg=cfg, device="cuda")[0]
    out = {}
    for mode in ("t", "sp"):
        fn = build_parallel_eval(interp.params, cfg, mode, devices=SHARED)
        reset_launches()
        t0 = time.time()
        res = evaluate(interp, cfg, "golden", multiple=8, dataset=ds,
                       verbose=False, parallel_eval=fn)
        out[mode] = {"psnr": res.psnr, "ssim": res.ssim,
                     "n_samples": res.n_samples, "s": time.time() - t0,
                     "launches": launches()}
    print(json.dumps({"phase": "parallel_evaluate", "hw": list(gts.shape[1:3]),
                      "psnr_7d_single": psnr_7d, "modes": out,
                      "card": card}), flush=True)
    for mode, r in out.items():
        if r["n_samples"] != len(ts) or not abs(r["psnr"] - psnr_7d) < 0.05:
            raise AssertionError(f"evaluate through parallel_eval {mode}: "
                                 f"{r}, phase 7d {psnr_7d} ± 0.05")


def mesh_rank_steps(rank, world_size, tree, specs, sp):
    """One rank of 8d or 8e, at dp world_size/sp × sp on ranks sharing
    cuda:0: a step from the parameter tree on the first global batch, then
    timed steps on the rest. specs: (t, seed) of each global batch
    (bench_inputs.train_batch at the training size). Returns (metrics,
    gradients, parameters after the first step), ms per timed step,
    launches and VJP launches by form per timed step, the peak memory in
    GiB and the widths of the refine UNet's inputs at level 0 in the first
    step."""
    import torch

    from fldrx_torch.bench_inputs import train_batch, train_config
    from fldrx_torch.model import fldrnet
    from fldrx_torch.ops import fastwarp
    from fldrx_torch.parallel.mesh import make_mesh
    from fldrx_torch.train.trainer import TrainState, make_train_step
    from fldrx_torch.weights import (flatten_params, named_leaves,
                                     params_from_numpy, params_to_numpy)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config()
    batches = [train_batch(cfg.patch_size, t, seed) for t, seed in specs]
    params = params_from_numpy(tree, "cuda:0")
    state = TrainState.create(params, cfg)
    step = make_train_step(cfg, make_mesh(["cuda:0"] * world_size,
                                          dp=world_size // sp, sp=sp))
    widths, unet = [], fldrnet.refine_unet_s2d

    def recording(p, x):
        if x.shape[1] == cfg.patch_size:
            widths.append(x.shape[2])
        return unet(p, x)

    fldrnet.refine_unet_s2d = recording
    try:
        m = step(state, batches[0])
    finally:
        fldrnet.refine_unet_s2d = unet
    first = ({k: float(v) for k, v in m.items()},
             {n: p.grad.cpu().numpy() for n, p in named_leaves(params)
              if p.grad is not None},
             flatten_params(params_to_numpy(params)))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:]:
        step(state, b)
    torch.cuda.synchronize()
    n = len(batches) - 1
    return (first, (time.perf_counter() - t0) / n * 1e3,
            {k: v / n for k, v in launches().items()},
            {k: v / n for k, v in sorted(fastwarp.FORMS.items())},
            torch.cuda.max_memory_allocated() / 2 ** 30, widths)


def mesh_train_step(card: str, dp: int, sp: int, phase_name: str):
    """8d and 8e: the train step at dp × sp on dp·sp gloo ranks sharing
    cuda:0 (nccl refuses two ranks on one device), batch 8 at 512×512,
    S_trn=3, against the single-process step on the same global batch from
    the same parameters (the checkpoint): metrics within 1e-4 relative,
    every gradient and updated parameter within 1e-3 relative L2, every
    rank's parameters equal, and each rank's launches per timed step
    exactly PER_STEP and FORMS_PER_STEP. Returns rank 0's launches per
    step."""
    import torch

    from fldrx_torch.api import DEFAULT_NPZ
    from fldrx_torch.bench_inputs import train_batch, train_config
    from fldrx_torch.model.fldrnet import UNET_HALO
    from fldrx_torch.parallel.distributed import spawn
    from fldrx_torch.train.trainer import TrainState, make_train_step
    from fldrx_torch.weights import (flatten_params, load_npz, named_leaves,
                                     params_from_numpy, params_to_numpy)

    cfg = train_config()
    gen = torch.Generator().manual_seed(11)
    specs = [(draw_t(gen, cfg.batch_size), 200 + i) for i in range(4)]
    tree = load_npz(DEFAULT_NPZ)[0]
    params = params_from_numpy(tree, "cuda")
    m = make_train_step(cfg)(TrainState.create(params, cfg), train_batch(
        cfg.patch_size, *specs[0]))
    one = ({k: float(v) for k, v in m.items()},
           {n: p.grad.cpu().numpy() for n, p in named_leaves(params)
            if p.grad is not None},
           flatten_params(params_to_numpy(params)))
    del params, m
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = spawn(mesh_rank_steps, dp * sp, tree, specs, sp,
                  backend="gloo", timeout=900)
    spawn_s = time.time() - t0
    r0 = ranks[0][0]

    def rel(a, b):
        return float(np.linalg.norm(a.astype(np.float64) - b)
                     / max(np.linalg.norm(b.astype(np.float64)), 1e-30))

    metric_rel = {k: abs(r0[0][k] - v) / max(abs(v), 1e-30)
                  for k, v in one[0].items()}
    grad_rel = {k: rel(r0[1][k], v) for k, v in one[1].items()}
    param_rel = {k: rel(r0[2][k], v) for k, v in one[2].items()}
    ranks_equal = all(np.array_equal(r[0][2][k], r0[2][k])
                      for r in ranks[1:] for k in r0[2])
    wg = max(grad_rel, key=grad_rel.get)
    wp = max(param_rel, key=param_rel.get)
    S = cfg.patch_size
    print(json.dumps({"phase": phase_name, "ranks": ["cuda:0"] * (dp * sp),
                      "dp": dp, "sp": sp, "backend": "gloo",
                      "batch": cfg.batch_size, "hw": [S, S],
                      "S_trn": cfg.S_trn, "metrics_mesh": r0[0],
                      "metrics_one": one[0],
                      "max_metric_rel": max(metric_rel.values()),
                      "max_grad_rel_l2": grad_rel[wg], "worst_grad": wg,
                      "max_param_rel_l2": param_rel[wp], "worst_param": wp,
                      "ranks_equal": ranks_equal,
                      "ms_per_step_ranks_share_one_card":
                          [r[1] for r in ranks],
                      "peak_mem_gib_per_rank": [r[4] for r in ranks],
                      "unet_input_width_per_rank": [r[5] for r in ranks],
                      "launches_per_step_per_rank": [r[2] for r in ranks],
                      "vjp_forms_per_step_per_rank": [r[3] for r in ranks],
                      "spawn_s": spawn_s, "card": card}), flush=True)
    bad = {k: v for k, v in metric_rel.items()
           if not (v <= 1e-4 or r0[0][k] == one[0][k])}
    if bad:
        raise AssertionError(f"{phase_name}: metrics differ: {bad}")
    if set(grad_rel) != set(r0[1]) or not grad_rel[wg] <= 1e-3:
        raise AssertionError(f"{phase_name}: gradient {wg}: {grad_rel[wg]}")
    if set(param_rel) != set(r0[2]) or not param_rel[wp] <= 1e-3:
        raise AssertionError(f"{phase_name}: parameter {wp}: "
                             f"{param_rel[wp]}")
    if not ranks_equal:
        raise AssertionError(f"{phase_name}: the ranks hold different "
                             "parameters")
    # each rank's level-0 refine UNet reads its slab and the halo, no
    # column beyond the frame: S/sp + UNET_HALO where sp = 2
    want = [S // sp + UNET_HALO] if sp == 2 else [S] if sp == 1 else None
    for r, (_, _, seen, forms, _, widths) in enumerate(ranks):
        where = f"{phase_name}, rank {r}"
        require_launched(seen, TRAIN_KERNELS, where)
        require_counts(seen, PER_STEP, 1, where)
        if forms != FORMS_PER_STEP:
            raise AssertionError(f"{where}: VJP launches per step by form "
                                 f"{forms}, expected {FORMS_PER_STEP}")
        if want is not None and widths != want:
            raise AssertionError(f"{where}: refine UNet input widths "
                                 f"{widths}, expected {want}")
    return ranks[0][2]


# ---------------------------------------------------------------------------
# phase 9: the last modules — the PNG decoder, asynchronous checkpoints, the
# probes and the roofline
# ---------------------------------------------------------------------------

def write_png(path: str, rgb: np.ndarray, level: int = 6) -> None:
    """Write an [H, W, 3] uint8 (8-bit) or uint16 (16-bit) array as an RGB
    PNG with zlib alone: IHDR, one IDAT of filter-0 rows, IEND."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    depth = 16 if rgb.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(rgb, ">u2" if depth == 16 else np.uint8)
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw, level))
                + chunk(b"IEND", b""))


def write_x_test(root: str, frames: np.ndarray, gts: np.ndarray) -> dict:
    """The golden pair as an X-Test scene, root/Type1/golden/0000..0032.png:
    at ×8 make_x_test_items reads files 0 (I0), 32 (I1) and 4, 8, …, 28 (the
    targets); the other 24 files are 1×1 placeholders. frames and gts in
    [-1, 1] as the golden clip renders them; returns the 9 uint8 BGR
    frames by file index."""
    from fldrx_torch.eval.goldenclip import to_uint8_frames

    d = os.path.join(root, "Type1", "golden")
    os.makedirs(d)
    u8 = {0: to_uint8_frames(frames[0, 0]), 32: to_uint8_frames(frames[0, 1])}
    for k, gt in enumerate(gts):
        u8[4 * (k + 1)] = to_uint8_frames(gt)
    blank = np.zeros((1, 1, 3), np.uint8)
    for i in range(33):
        # a PNG holds RGB; the arrays are BGR, as the decoder returns them
        write_png(os.path.join(d, f"{i:04d}.png"),
                  u8[i][..., ::-1] if i in u8 else blank)
    return u8


def decoder_on_card(card: str, golden):
    """9a: the PNG decoder on the card's host. The native library's build
    (it needs a C++ compiler and libpng) and the error that names why it
    cannot be built; without PIL, the named NoPNGDecoder; then the golden
    4K pair as an X-Test tree: each frame decoded bit for bit, ms per 4K
    frame at 3 frames a call on 1 and 3 threads, and evaluate() through
    get_test_dataset("X-Test") within 1e-4 dB of 7d, decoding exactly 9
    frames for the pair."""
    import shutil
    import tempfile
    import warnings

    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import deploy_config
    from fldrx_torch.data import native
    from fldrx_torch.data.datasets import get_test_dataset
    from fldrx_torch.eval.evaluator import evaluate

    frames, ts, gts, psnr_7d = golden
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lib = native.get_lib()
    warned = [str(w.message) for w in caught]
    rec = {"phase": "decoder", "native_built": lib is not None,
           "png_h": os.path.exists("/usr/include/png.h"),
           "build_error": (native.build_error() or "")[-600:],
           "warnings": [w[-300:] for w in warned], "card": card}
    if lib is None and "png" not in rec["build_error"]:
        raise AssertionError(f"decoder: the build failed, not for libpng: "
                             f"{rec['build_error']}")
    saved = sys.modules.get("PIL", False)
    sys.modules["PIL"] = None                      # as where PIL is missing
    try:
        native.read_bgr(os.devnull)
        raise AssertionError("decoder: no NoPNGDecoder without PIL")
    except native.NoPNGDecoder as e:
        rec["error_without_pil"] = str(e)[-300:]
    finally:
        if saved is False:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved
    root = tempfile.mkdtemp()
    try:
        t0 = time.time()
        u8 = write_x_test(root, frames, gts)
        rec["write_s"] = time.time() - t0
        d = os.path.join(root, "Type1", "golden")
        paths = {i: os.path.join(d, f"{i:04d}.png") for i in u8}
        try:
            got = native.read_bgr_batch([paths[i] for i in sorted(u8)])
        except native.NoPNGDecoder as e:          # neither decoder here
            rec["no_decoder"] = str(e)[-300:]
            print(json.dumps(rec), flush=True)
            return rec
        rec["decoder"] = native.decoder_in_use()
        rec["bit_exact"] = all(np.array_equal(g, u8[i])
                               for g, i in zip(got, sorted(u8)))
        three = [paths[i] for i in (0, 4, 8)]
        for threads in (1, 3):
            native.read_bgr_batch(three, threads)
            t0 = time.perf_counter()
            native.read_bgr_batch(three, threads)
            rec[f"ms_per_frame_threads_{threads}"] = \
                (time.perf_counter() - t0) / 3 * 1e3
        cfg = deploy_config().replace(x_test_data_path=root)
        interp = prepare_model(cfg=cfg, device="cuda")[0]
        ds = get_test_dataset(cfg, "X-Test", 8)
        reset_launches()
        t0 = time.time()
        res = evaluate(interp, cfg, "X-Test", multiple=8, dataset=ds,
                       verbose=False)
        rec.update(evaluate_s=time.time() - t0, launches=launches(),
                   psnr=res.psnr, ssim=res.ssim, psnr_7d=psnr_7d,
                   diff_db=res.psnr - psnr_7d, n_samples=res.n_samples,
                   frames_decoded=ds.frames_decoded,
                   decoder_in_evaluate=native.decoder_in_use())
    finally:
        shutil.rmtree(root)
    print(json.dumps(rec), flush=True)
    if not rec["bit_exact"]:
        raise AssertionError("decoder: a decoded frame differs from the "
                             "array written")
    if lib is not None and rec["decoder"] != "native":
        raise AssertionError(f"decoder: built, but {rec['decoder']} ran")
    require_launched(rec["launches"], EVAL_KERNELS, "evaluate on X-Test")
    require_counts(rec["launches"], PER_PAIR, 1, "evaluate on X-Test")
    if not (res.n_samples == len(ts) and ds.frames_decoded == 9):
        raise AssertionError(f"decoder: evaluate scored {res.n_samples} "
                             f"frames and decoded {ds.frames_decoded}, "
                             f"expected {len(ts)} and 9")
    if not abs(rec["diff_db"]) <= 1e-4:
        raise AssertionError(f"decoder: evaluate on the X-Test tree "
                             f"{res.psnr} dB, phase 7d {psnr_7d}")
    return rec


def npz_write_ms(blob: dict, d: str) -> dict:
    """The median of 3 writes of a checkpoint's arrays: np.savez into a
    file, against np.savez into memory and one write of the whole."""
    import io

    def median(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    buf = io.BytesIO()

    def in_memory():
        buf.seek(0)
        buf.truncate()
        np.savez(buf, **blob)

    def whole():
        with open(os.path.join(d, "whole.npz"), "wb") as f:
            f.write(buf.getbuffer())

    return {"savez_to_file_ms": median(
                lambda: np.savez(os.path.join(d, "direct.npz"), **blob)),
            "savez_in_memory_ms": median(in_memory),
            "write_whole_ms": median(whole),
            "checkpoint_mb": sum(v.nbytes for v in blob.values()) / 1e6,
            "arrays": len(blob)}


def async_checkpoints(card: str, dev: str = "cuda"):
    """9b: 5b's recipe (batch 8, 512×512, S_trn=3, fresh parameters with
    the PCA fit on the first batch), one warm-up step, then 5 timed steps
    three times: with an AsyncSaveManager save after every step, with a
    SaveManager save, and with none (each step reads its loss and saves
    TrainState.optimizer_tensors(), as train() does); the save() calls'
    median ms, a synchronous `snapshot`'s, and npz_write_ms. Every
    asynchronous file equals a snapshot taken at its save() bit for bit,
    parameters and optimiser state, while the next steps update the
    parameters in place; a resume from the last one equals the state
    saved."""
    import tempfile

    import torch

    from fldrx_torch.bench_inputs import train_batch, train_config
    from fldrx_torch.model.fldrnet import init_params
    from fldrx_torch.train.checkpoint import (AsyncSaveManager, SaveManager,
                                              snapshot)
    from fldrx_torch.train.loop import assign_params, fit_pca_from_batch
    from fldrx_torch.train.trainer import TrainState, make_train_step
    from fldrx_torch.weights import (flatten_params, params_from_numpy,
                                     params_to_numpy)

    cfg = train_config()
    B, S = cfg.batch_size, cfg.patch_size
    gen = torch.Generator().manual_seed(0)
    batches = []
    for i in range(6):
        b = train_batch(S, draw_t(gen, B), seed=200 + i)
        batches.append({k: torch.as_tensor(v).to(dev) for k, v in b.items()})
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    assign_params(params, fit_pca_from_batch(
        batches[0]["frames"].cpu().numpy(), cfg, dev))
    state = TrainState.create(params, cfg)
    step = make_train_step(cfg)
    float(step(state, batches[0])["loss"])                    # warm-up
    torch.cuda.synchronize()
    rec = {"phase": "async_checkpoints", "hw": [S, S], "batch": B,
           "S_trn": cfg.S_trn, "steps": 5, "card": card}
    with tempfile.TemporaryDirectory() as d:
        def manager(kind, name):
            return kind(cfg.replace(checkpoint_dir=os.path.join(d, name),
                                    text_dir=os.path.join(d, "tx")))

        sms = {"none": None, "sync": manager(SaveManager, "sync"),
               "async": manager(AsyncSaveManager, "async")}
        for name, sm in sms.items():
            calls = []
            t0 = time.perf_counter()
            for i, b in enumerate(batches[1:]):
                float(step(state, b)["loss"])
                if sm is not None:
                    t1 = time.perf_counter()
                    sm.save(state.params, {"last_epoch": i},
                            opt_state=state.optimizer_tensors(),
                            step=state.step)
                    calls.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            rec[f"ms_per_step_{name}"] = (time.perf_counter() - t0) / 5 * 1e3
            if calls:
                rec[f"save_call_ms_{name}"] = float(np.median(calls))
        t0 = time.perf_counter()
        sms["async"].close()
        rec["close_wait_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        blob = snapshot(state.params, {}, state.optimizer_tensors(),
                        state.step)
        rec["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
        rec.update(npz_write_ms(blob, d))

        # each save into its own manager, its snapshot taken at save(),
        # the next step running while the writer writes
        saves = []
        for i, b in enumerate(batches[1:4]):
            sm = manager(AsyncSaveManager, f"each{i}")
            meta = {"last_epoch": i}
            sm.save(state.params, meta, opt_state=state.optimizer_tensors(),
                    step=state.step)
            saves.append((sm, snapshot(state.params, meta,
                                       state.optimizer_state(), state.step)))
            float(step(state, b)["loss"])
        mismatched = []
        for sm, want in saves:
            sm.close()
            with np.load(sm._path("latest")) as z:
                if set(z.files) != set(want) or not all(
                        np.array_equal(z[k], want[k]) for k in want):
                    mismatched.append(sm.ckpt_dir)
        rec["files_equal_snapshots"] = not mismatched
        rec["files_checked"] = len(saves)
        tree, meta, opt = saves[-1][0].load()
        resumed = TrainState.create(params_from_numpy(tree, dev), cfg)
        resumed.load_optimizer_state(opt, int(meta["step"]))
        again = snapshot(resumed.params, {"last_epoch": 2},
                         resumed.optimizer_state(), resumed.step)
        want = saves[-1][1]
        rec["resume_equal"] = set(again) == set(want) and all(
            np.array_equal(again[k], want[k]) for k in want)
        rec["params_moved_after_save"] = any(
            not np.array_equal(v, want[f"params/{k}"]) for k, v in
            flatten_params(params_to_numpy(state.params)).items())
    print(json.dumps(rec), flush=True)
    if mismatched:
        raise AssertionError(f"async checkpoints differ from their "
                             f"snapshots: {mismatched}")
    if not (rec["resume_equal"] and rec["params_moved_after_save"]):
        raise AssertionError("async checkpoints: the resume differs from "
                             "the state saved, or the steps after it did "
                             "not move the parameters")
    return rec


def probes_and_roofline(card: str):
    """9c: tools/perfprobe.py and tools/perfprobe2.py on bench.py's 4K pair
    on the card, then tools/roofline.py with perfprobe2's record: every
    stage perfprobe2 reaches has a floor at or below its in-context span,
    the card's time in its calls within the whole pipeline (a floor above
    it is a miscount); the floor's share of each stage's span and of its
    ablation delta (what the pipeline pays for it) is printed."""
    import tempfile

    from fldrx_torch.tools import perfprobe, perfprobe2, roofline

    t0 = time.time()
    probe = perfprobe.run()
    probe_s = time.time() - t0
    print(json.dumps(probe), flush=True)
    t0 = time.time()
    probe2 = perfprobe2.run()
    probe2_s = time.time() - t0
    print(json.dumps(probe2), flush=True)
    variant = roofline.peaks_for(card)[0]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "perfprobe2.json")
        with open(path, "w") as f:
            json.dump(probe2, f)
        roofline.main(["--chip", variant, "--measured", path])
    rep = roofline.report(variant, tuple(probe2["hw"]), probe2)
    shares = {k: r["share_of_floor"] for k, r in rep["stages"].items()}
    spans = {k: r["share_of_span"] for k, r in rep["stages"].items()}
    over = {k: (r["floor_ms"], r["span_ms"])
            for k, r in rep["stages"].items()
            if r["span_ms"] is not None and not r["floor_ms"] <= r["span_ms"]}
    print(json.dumps({"phase": "probes_and_roofline", "perfprobe_s": probe_s,
                      "perfprobe2_s": probe2_s, "share_of_floor": shares,
                      "share_of_span": spans,
                      "floor_ms_per_frame": rep["floor_ms_per_frame"],
                      "floor_above_measured": over, "card": card}),
          flush=True)
    if over:
        raise AssertionError(f"roofline: floors above their in-context "
                             f"times (a miscount): {over}")
    return rep


# ---------------------------------------------------------------------------
# phase 10: the tools on the card
# ---------------------------------------------------------------------------

# the synthetic demo's PSNR at t = 0.25, 0.5, 0.75: the port on the CPU
# (float32, the plain versions of the kernels), which
# tests/test_torch_tools.py holds within 0.01 dB of fldrx's
DEMO_CPU_DB = (52.75391386202856, 52.797337825297326, 50.964893831195454)
TRACED_KERNELS = ("gather", "splat", "conv3x3")


def tools_on_card(card: str):
    """10: eval.profiling's time_levels, fps_meter and trace on bench.py's
    4K pair in the deploy mix (the trace must name the gather, splat and
    conv3x3 kernels); the synthetic demo within 0.05 dB of DEMO_CPU_DB at
    each t, writing no file; goldenclip_report at 512×768, all four
    configurations above the naive baseline; parity_report's measurements
    2-3 at 4K on the card and on the CPU: the strict and the fast float32
    outputs each at least 60 dB against the CPU's, and fast float32's
    departure from strict within 0.5 dB of the CPU's."""
    import tempfile

    import torch

    from fldrx_torch import bench
    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import bench_frames, deploy_config
    from fldrx_torch.eval import demo, profiling
    from fldrx_torch.tools import goldenclip_report, parity_report

    interp, _, _ = prepare_model(cfg=deploy_config(), device="cuda")
    frames = torch.as_tensor(bench_frames(bench.H, bench.W)).cuda()
    t = np.full((1, 1), 0.5, np.float32)
    levels = profiling.time_levels(interp, frames, t)
    fps = profiling.fps_meter(interp, frames, t)
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as path:
            interp(frames, t)
            torch.cuda.synchronize()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel"})
    traced = {k: [n for n in kernels if f"(anonymous namespace)::{k}_" in n]
              for k in TRACED_KERNELS}
    del interp
    torch.cuda.empty_cache()

    demo_db = demo.run_synthetic(out_dir=None, device="cuda")
    golden = goldenclip_report.main(hw=(512, 768), device="cuda")
    base = golden.pop("naive frame-average baseline")
    torch.cuda.empty_cache()
    card_out = parity_report.fast_path_outputs(device="cuda")
    torch.cuda.empty_cache()
    cpu_out = parity_report.fast_path_outputs(device="cpu")
    psnr = parity_report.psnr_between
    parity, parity_cpu = ({"fast_f32_vs_strict": psnr(o["fast_f32"],
                                                      o["strict"]),
                           "bf16_vs_strict": psnr(o["fast_bf16"],
                                                  o["strict"]),
                           "bf16_vs_fast_f32": psnr(o["fast_bf16"],
                                                    o["fast_f32"])}
                          for o in (card_out, cpu_out))
    card_vs_cpu = {k: psnr(card_out[k], cpu_out[k]) for k in card_out}
    print(json.dumps({"phase": "tools", "time_levels_s": levels,
                      "fps_meter_4k_single_t": fps,
                      "traced_kernels": traced, "demo_db": demo_db,
                      "demo_cpu_db": DEMO_CPU_DB,
                      "golden_512x768_db": golden,
                      "golden_naive_baseline_db": base,
                      "parity_4k_db": parity, "parity_4k_cpu_db": parity_cpu,
                      "parity_4k_card_vs_cpu_db": card_vs_cpu,
                      "card": card}), flush=True)
    if list(levels) != ["S_tst=1 total_s"] + [
            f"{k}_s" for s in range(2, 6)
            for k in (f"S_tst={s} total", f"level_{s}_delta")] \
            or not all(v > 0 for k, v in levels.items() if "total" in k):
        raise AssertionError(f"time_levels: {levels}")
    if not fps > 0:
        raise AssertionError(f"fps_meter: {fps}")
    if not all(traced.values()):
        raise AssertionError(f"the trace names no kernel of {traced}")
    if len(demo_db) != len(DEMO_CPU_DB) or not all(
            abs(a - b) <= 0.05 for a, b in zip(demo_db, DEMO_CPU_DB)):
        raise AssertionError(f"demo: {demo_db}, CPU {DEMO_CPU_DB} ± 0.05")
    if len(golden) != len(goldenclip_report.CONFIGS) or not all(
            v > base for v in golden.values()):
        raise AssertionError(f"golden-clip report: {golden}, naive {base}")
    # the fast configuration's departure from the strict path is fldrx's
    # own algebra (half-resolution z, flowbacks composed at the flow grid),
    # which the port reproduces on the CPU (tests/test_torch_tools.py); on
    # the card each run holds phase 3's 60 dB against the CPU's, and the
    # departure stays the CPU's within 0.5 dB
    if not (card_vs_cpu["strict"] >= 60 and card_vs_cpu["fast_f32"] >= 60
            and abs(parity["fast_f32_vs_strict"]
                    - parity_cpu["fast_f32_vs_strict"]) <= 0.5):
        raise AssertionError(f"parity: card {parity}, CPU {parity_cpu}, "
                             f"card against CPU {card_vs_cpu}")


# measurement 1 on the card: the strict path within ROADMAP's North star
# bar of the reference's oracle; each fast configuration's PSNR against the
# oracle within ORACLE_DB of its own reading on the CPU
ORACLE_MAX_ABS = 1e-4
ORACLE_DB = 0.5


def oracle_on_card(card: str):
    """10b: parity_report's measurement 1 at 768×1280, S_tst = 5, t =
    0.375 against the reference's torch oracle on the CPU, its state dict
    from the in-repo .npz (params_to_state_dict), started from PyTorch's
    default TF32 flags as the tool's own command is: the strict path on
    the card within ORACLE_MAX_ABS max abs; fast_warp float32 and the
    deploy mix on the card each within ORACLE_DB of the same configuration
    on the CPU; the deploy run, counted alone, launches gather, splat,
    conv3x3 and the interleave."""
    import torch

    from fldrx_torch.bench_inputs import deploy_config
    from fldrx_torch.tools import parity_report

    strict = parity_report.strict_config()
    fast_f32 = strict.replace(fast_warp=True)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # PyTorch's default
    try:
        card_runs = parity_report.measure_oracle(
            {"strict": strict, "fast_f32": fast_f32}, device="cuda")
        reset_launches()
        deploy = parity_report.measure_oracle({"deploy": deploy_config()},
                                              device="cuda")
        seen = launches()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu_runs = parity_report.measure_oracle(
        {"fast_f32": fast_f32, "deploy": deploy_config()}, device="cpu")
    card_runs["deploy"] = deploy["deploy"]
    names = ("max_abs", "mean_abs", "psnr_db", "s")
    print(json.dumps({
        "phase": "oracle", "hw": card_runs["hw"], "S_tst": card_runs["S_tst"],
        "t": parity_report.ORACLE_T, "source": card_runs["source"],
        "card": {k: {n: card_runs[k][n] for n in names}
                 for k in ("strict", "fast_f32", "deploy")},
        "cpu": {k: {n: cpu_runs[k][n] for n in names}
                for k in ("fast_f32", "deploy")},
        "oracle_s": [card_runs["oracle_s"], deploy["oracle_s"],
                     cpu_runs["oracle_s"]],
        "deploy_launches": seen, "card_line": card}), flush=True)
    strict_err = card_runs["strict"]["max_abs"]
    if not strict_err <= ORACLE_MAX_ABS:
        raise AssertionError(f"strict path on the card against the oracle: "
                             f"max abs {strict_err} > {ORACLE_MAX_ABS}")
    for k in ("fast_f32", "deploy"):
        a, b = card_runs[k]["psnr_db"], cpu_runs[k]["psnr_db"]
        if not abs(a - b) <= ORACLE_DB:
            raise AssertionError(f"{k} against the oracle: {a} dB on the "
                                 f"card, {b} dB on the CPU")
    # the deploy run returns plain rows: its u-planes go through the
    # interleave, as in the evaluator's device-metrics run
    require_launched(seen, EVAL_KERNELS, "measurement 1, deploy")
    return seen


def bench_line():
    """`python -m fldrx_torch.bench` once; returns its JSON record."""
    out = subprocess.run([sys.executable, "-m", "fldrx_torch.bench"],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"fldrx_torch.bench exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    if set(rec) != {"metric", "value", "unit", "card"} or \
            not rec["value"] > 0:
        raise AssertionError(f"fldrx_torch.bench printed {rec}")
    return rec


def phase(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.time()
    out = fn(*args)
    print(f"phase {name}: {time.time() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    import torch
    start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import fldrx_torch  # noqa: F401  (fails outside a checkout of the repo)
    from fldrx_torch.bench import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    from fldrx_torch.tools import roofline
    variant, peaks = roofline.peaks_for(card)
    print(f"card: {card} ({variant} peaks); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    results = phase("2 kernels", check_kernels, peaks)
    phase("2 conv3x3", check_conv3x3, "cuda", peaks, results)
    results["correlation"] = phase("2 correlation", correlation_rows, peaks)
    phase("2 interleave", check_interleave, "cuda", peaks, results)
    phase("2 deinterleave", check_deinterleave, "cuda", peaks, results)
    phase("3 inference held", main_path_held)
    seen = phase("4 inference 4K", main_path_4k, card)
    phase("5a train step held", train_step_held)
    seen_train = phase("5b training full size", train_full, card)
    phase("6a teacher held", teacher_held)
    seen_teacher = phase("6b teacher full width", teacher_full, card)
    seen_eval, golden = phase("7 golden clip", golden_clip, card)
    seen_t, seen_sp = phase("8ab parallel evaluation 4K", parallel_eval_4k,
                            card)
    phase("8c parallel evaluate", parallel_evaluate, card, golden)
    phase("8d data-parallel step", mesh_train_step, card, 2, 1,
          "dp_train_step")
    seen_sp_train = phase("8e width-sharded step", mesh_train_step, card, 2,
                          2, "sp_train_step")
    phase("9a PNG decoder", decoder_on_card, card, golden)
    del golden
    phase("9b asynchronous checkpoints", async_checkpoints, card)
    phase("9c probes and roofline", probes_and_roofline, card)
    phase("10 tools", tools_on_card, card)
    seen_oracle = phase("10b parity measurement 1", oracle_on_card, card)
    bench_rec = phase("bench", bench_line)
    # launches: the count of the path the row is timed for (the 4K pairs
    # for the forward kernels, the timed train steps for the VJP kernels,
    # the timed teacher calls for the correlation, the evaluator's
    # device-metrics run for the interleave; the deinterleave is on no
    # path, and the 4K pairs show its 0); launches_train: over the 5 timed
    # train steps; launches_teacher: over the 5 timed teacher calls;
    # launches_eval: over that run; launches_t_parallel and launches_sp:
    # over phase 8a's and 8b's 2 timed pairs; launches_sp_train: per step
    # of one rank of 8e (every rank launches the same); launches_oracle:
    # over 10b's deploy run
    path_of = {"gather_grad": seen_train, "splat_grad": seen_train,
               "correlation": seen_teacher, "interleave": seen_eval}
    for k, r in results.items():
        r["launches"] = path_of.get(k, seen)[k]
        r["launches_train"] = seen_train[k]
        r["launches_teacher"] = seen_teacher[k]
        r["launches_eval"] = seen_eval[k]
        r["launches_t_parallel"] = seen_t[k]
        r["launches_sp"] = seen_sp[k]
        r["launches_sp_train"] = seen_sp_train[k]
        r["launches_oracle"] = seen_oracle[k]
    print(json.dumps(bench_rec))
    print(f"chip_smoke: {time.time() - start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": list(results.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
