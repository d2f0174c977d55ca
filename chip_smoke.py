#!/usr/bin/env python3
"""Smoke run of fldrx_torch on one NVIDIA GPU: builds the hand-written CUDA
kernels from the sources in this checkout, holds each against its plain
PyTorch version at the shapes its paths give it, drives the two paths the
port has — papermodel_test5 ×8 interpolation with a bf16 refine UNet, and
papermodel training — through their entry points, and checks what comes
out.

    python3 chip_smoke.py

Phases, all of them on every run, in order; any failure raises and the
script exits non-zero:
  1. card check: a CUDA device must be present; prints its name and power
     limit (nvidia-smi).
  2. kernels: gather (2304×4096×3, smooth random flow of ±40 px), splat
     (C=4 at 2304×4096, C=49 at 288×512), conv3x3 (enc1, 416→64 at
     576×1024), and at the training shapes gather (8×512×512×3, mask on),
     splat (C=4 at 8×512×512, C=49 at 8×64×64), gather_grad (8×512×512×3,
     mask on) and splat_grad (C=4 at 8×512×512, C=49 at 8×64×64); each
     against its plain version on the same inputs, with the median time
     of 20 launches beside the plain version's, the PyTorch library
     call's and the bound from bytes and operations.
  3. inference held: prepare_model() with the real checkpoint on cuda and
     on cpu, interpolate_multi_np at 768×1280 with three t values; the two
     outputs must agree to PSNR ≥ 60 dB.
  4. inference at full size: bench.py's synthetic 2160×4096 uint8 frames,
     ×8 (7 t values, chunks of 4), one warm-up pair then 3 timed pairs;
     outputs finite and in [-1.1, 1.1]; frames/s and peak memory. Kernel
     launch counts are zeroed just before the timed pairs and read after.
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
     just before the timed steps); then a SaveManager save into a
     temporary directory and a load that must restore the parameters and
     the optimiser state exactly. The card machine has no PIL and no JAX,
     so this drives the trainer's entry points (TrainState,
     make_train_step, fit_pca_from_batch, SaveManager) on in-memory
     batches, not train() over PNG clips.
  6. a JSON line for the kernels, the card line, then the last line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks by H100 variant (NVIDIA data sheets): memory
# bytes/s, bf16 tensor-core flop/s, f32 flop/s outside the tensor cores.
PEAKS = {
    "PCIe": (2.0e12, 756e12, 51e12),
    "SXM": (3.35e12, 989e12, 67e12),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    variant = "PCIe" if "PCIe" in name else "SXM"
    return variant, PEAKS[variant]


def bound_ms(peaks, nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def median_ms(fn, n: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
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


def excess(got, ref, rel: float = 1e-4) -> float:
    """max(|got − ref| − rel·(1 + |ref|)): ≤ 0 when within tolerance."""
    return ((got - ref).abs() - rel * (1 + ref.abs())).max().item()

def check_kernels(dev, peaks):
    import torch
    import torch.nn.functional as F

    from fldrx_torch.ops import _build, fastconv, fastwarp
    from fldrx_torch.ops.resize import resize_2d
    from fldrx_torch.ops.warp import sample_coords

    t0 = time.time()
    logs = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    g = torch.Generator(device=dev).manual_seed(0)
    bw, bf16_rate, f32_rate = peaks
    results = {}

    # gather: an im_tot gather at 4K, with the 0.999 mask
    H, W, C = 2304, 4096, 3
    img = torch.rand(1, H, W, C, device=dev, generator=g) * 2 - 1
    coarse = (torch.rand(1, 36, 64, 2, device=dev, generator=g) * 2 - 1) * 40
    flow = resize_2d(coarse, (H, W), "bilinear")
    sx, sy = sample_coords(flow)
    got = fastwarp.gather(img, sx, sy, mask=True)
    ref = fastwarp.gather_plain(img, sx, sy, mask=True)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"gather disagrees with its plain version: {err}")
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(2 * sx + 1) / W - 1, (2 * sy + 1) / H - 1], -1)
    nbytes = 4 * (H * W * C + 2 * H * W + H * W * C)
    flops = H * W * (7 * C + 12)
    b, by = bound_ms(peaks, nbytes, flops, f32_rate)
    results["gather"] = dict(
        name="gather", route="cuda", source="fldrx_torch/csrc/warp.cu",
        replaces="fldrx/ops/fastwarp.py:307",
        max_abs_err=err,
        ms=median_ms(lambda: fastwarp.gather(img, sx, sy, mask=True)),
        plain_ms=median_ms(lambda: fastwarp.gather_plain(img, sx, sy, True)),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(lambda: F.grid_sample(
            img_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False)),
        shape=f"img 1x{H}x{W}x{C} f32, mask on")
    del img, coarse, flow, sx, sy, got, ref, img_nchw, grid

    # splat: the level-0 softmax splat (C=4) and a coarse feature splat (C=49)
    checks = []
    for (H, W, C) in ((2304, 4096, 4), (288, 512, 49)):
        vals = torch.rand(1, H, W, C, device=dev, generator=g)
        coarse = (torch.rand(1, 36, 64, 2, device=dev, generator=g) * 2 - 1) \
            * 40 * H / 2304
        flow = resize_2d(coarse, (H, W), "bilinear")
        tx = torch.arange(W, device=dev, dtype=torch.float32) + flow[..., 0]
        ty = torch.arange(H, device=dev, dtype=torch.float32)[:, None] \
            + flow[..., 1]
        got = fastwarp.splat(vals, tx, ty)
        ref = fastwarp.splat_plain(vals, tx, ty)
        torch.cuda.synchronize()
        excess = ((got - ref).abs() - 1e-4 * (1 + ref.abs())).max().item()
        err = (got - ref).abs().max().item()
        if not excess <= 0:
            raise AssertionError(f"splat C={C} disagrees with its plain "
                                 f"version: max abs {err}")
        checks.append({"shape": f"1x{H}x{W}x{C}", "max_abs_err": err})
        if C == 4:
            nbytes = 4 * (H * W * C + 2 * H * W + H * W * C)
            b, by = bound_ms(peaks, nbytes, H * W * (8 * C + 10), f32_rate)
            results["splat"] = dict(
                name="splat", route="cuda", source="fldrx_torch/csrc/warp.cu",
                replaces="fldrx/ops/fastwarp.py:986",
                also_replaces="fldrx/ops/fastwarp.py:776",
                ms=median_ms(lambda: fastwarp.splat(vals, tx, ty)),
                plain_ms=median_ms(lambda: fastwarp.splat_plain(vals, tx, ty)),
                bound_ms=b, bound_by=by,
                library_ms=median_ms(index_add_yardstick(vals, tx, ty)),
                shape=f"vals 1x{H}x{W}x{C} f32")
        del vals, coarse, flow, tx, ty, got, ref
    results["splat"]["max_abs_err"] = max(c["max_abs_err"] for c in checks)
    results["splat"]["checks"] = checks

    # conv3x3: enc1 of the packed refine UNet at 4K
    H, W, Cin, K = 576, 1024, 416, 64
    x = (torch.rand(1, H, W, Cin, device=dev, generator=g) * 2 - 1
         ).to(torch.bfloat16)
    std = float(np.sqrt(2.0 / (9 * Cin + 9 * K)))
    w = (torch.randn(K, Cin, 3, 3, device=dev, generator=g) * std
         ).to(torch.bfloat16)
    bias = torch.randn(K, device=dev, generator=g) * 0.1
    got = fastconv.conv3x3(x, w, bias).float()
    ref = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), bias,
                   padding=1).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    rel = ((got - ref).norm() / ref.norm()).item()
    if not (err <= 2e-2 and rel <= 1e-2):
        raise AssertionError(f"conv3x3 disagrees with float32 F.conv2d: "
                             f"max abs {err}, rel L2 {rel}")
    x_cl = x.permute(0, 3, 1, 2)                 # channels-last NCHW view
    nbytes = 2 * (H * W * Cin + 9 * Cin * K + H * W * K) + 4 * K
    b, by = bound_ms(peaks, nbytes, 2.0 * H * W * K * Cin * 9, bf16_rate)
    results["conv3x3"] = dict(
        name="conv3x3", route="cuda", source="fldrx_torch/csrc/conv3x3.cu",
        replaces="fldrx/ops/fastconv.py:69",
        max_abs_err=err, rel_l2_err=rel,
        ms=median_ms(lambda: fastconv.conv3x3(x, w, bias)),
        plain_ms=median_ms(lambda: fastconv.conv3x3_plain(x, w, bias)),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(lambda: F.conv2d(x_cl, w, bias.to(torch.bfloat16),
                                              padding=1)),
        shape=f"x 1x{H}x{W}x{Cin} bf16 -> {K}")
    del x, w, bias, got, ref, x_cl
    torch.cuda.empty_cache()
    for r in results.values():
        print(f"kernel {r['name']}: err {r['max_abs_err']:.3g}, "
              f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, library "
              f"{r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by "
              f"{r['bound_by']})", flush=True)
    return results


def check_train_kernels(dev, peaks, results):
    """Phase 2 at the training shapes (batch 8, 512×512 frames, 64×64
    level-0 feature grid): gather and splat as forward kernels, and the two
    VJP kernels gather_grad and splat_grad."""
    import torch
    import torch.nn.functional as F

    from fldrx_torch.ops import fastwarp
    from fldrx_torch.ops.resize import resize_2d

    g = torch.Generator(device=dev).manual_seed(1)
    f32_rate = peaks[2]
    B = 8

    def coords(H, W, px):
        coarse = (torch.rand(B, 8, 8, 2, device=dev, generator=g) * 2 - 1) * px
        flow = resize_2d(coarse, (H, W), "bilinear")
        xs = torch.arange(W, device=dev, dtype=torch.float32)
        ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
        return xs + flow[..., 0], ys + flow[..., 1]

    def row(fn, plain, library, nbytes, flops, **kw):
        b, by = bound_ms(peaks, nbytes, flops, f32_rate)
        return dict(ms=median_ms(fn), plain_ms=median_ms(plain), bound_ms=b,
                    bound_by=by,
                    library_ms=None if library is None else median_ms(library),
                    **kw)

    # gather and its VJP: the bwarps of the frames at level 0, mask on
    H = W = 512
    C = 3
    img = torch.rand(B, H, W, C, device=dev, generator=g) * 2 - 1
    cot = torch.randn(B, H, W, C, device=dev, generator=g)
    sx, sy = coords(H, W, 24.0)
    got = fastwarp.gather(img, sx, sy, True)
    ref = fastwarp.gather_plain(img, sx, sy, True)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"gather (train shape) disagrees: {err}")
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(2 * sx + 1) / W - 1, (2 * sy + 1) / H - 1], -1)
    px = B * H * W
    results["gather"]["train_shape"] = row(
        lambda: fastwarp.gather(img, sx, sy, True),
        lambda: fastwarp.gather_plain(img, sx, sy, True),
        lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=False),
        4 * (2 * px * C + 2 * px), px * (7 * C + 12),
        shape=f"img {B}x{H}x{W}x{C} f32, mask on", max_abs_err=err)

    got = fastwarp.gather_grad(img, sx, sy, cot, True)
    ref = fastwarp.gather_grad_plain(img, sx, sy, cot, True)
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
    if not max(excess(a, b) for a, b in zip(got, ref)) <= 0:
        raise AssertionError(f"gather_grad disagrees with its plain version: "
                             f"max abs {errs}")
    results["gather_grad"] = dict(
        name="gather_grad", route="cuda", source="fldrx_torch/csrc/warp.cu",
        replaces="fldrx/ops/fastwarp.py:1569",
        max_abs_err=max(errs),
        library_call="torch.ops.aten.grid_sampler_2d_backward (no mask)",
        **row(lambda: fastwarp.gather_grad(img, sx, sy, cot, True),
              lambda: fastwarp.gather_grad_plain(img, sx, sy, cot, True),
              lambda: torch.ops.aten.grid_sampler_2d_backward(
                  cot_nchw, img_nchw, grid, 0, 0, False, [True, True]),
              4 * (3 * px * C + 4 * px), px * (24 * C + 20),
              shape=f"img {B}x{H}x{W}x{C} f32, mask on"))
    del img, cot, sx, sy, got, ref, img_nchw, cot_nchw, grid

    # splat and its VJP: the level-0 softmax splats (C=4) and the coarse
    # feature splats (C=49 at the 64×64 level-0 feature grid)
    splat_rows, grad_rows = [], []
    for (H, W, C) in ((512, 512, 4), (64, 64, 49)):
        px = B * H * W
        vals = torch.rand(B, H, W, C, device=dev, generator=g)
        cot = torch.randn(B, H, W, C, device=dev, generator=g)
        tx, ty = coords(H, W, 24.0 * H / 512)
        got = fastwarp.splat(vals, tx, ty)
        ref = fastwarp.splat_plain(vals, tx, ty)
        torch.cuda.synchronize()
        if not excess(got, ref) <= 0:
            raise AssertionError(f"splat {B}x{H}x{W}x{C} disagrees")
        splat_rows.append(row(
            lambda: fastwarp.splat(vals, tx, ty),
            lambda: fastwarp.splat_plain(vals, tx, ty),
            index_add_yardstick(vals, tx, ty),
            4 * (2 * px * C + 2 * px), px * (8 * C + 10),
            shape=f"vals {B}x{H}x{W}x{C} f32",
            max_abs_err=(got - ref).abs().max().item()))
        got = fastwarp.splat_grad(vals, tx, ty, cot)
        ref = fastwarp.splat_grad_plain(vals, tx, ty, cot)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        if not (errs[0] <= 1e-5 and excess(got[1], ref[1]) <= 0
                and excess(got[2], ref[2]) <= 0):
            raise AssertionError(f"splat_grad {B}x{H}x{W}x{C} disagrees with "
                                 f"its plain version: max abs {errs}")
        grad_rows.append(row(
            lambda: fastwarp.splat_grad(vals, tx, ty, cot),
            lambda: fastwarp.splat_grad_plain(vals, tx, ty, cot),
            None, 4 * (3 * px * C + 4 * px), px * (23 * C + 12),
            shape=f"vals {B}x{H}x{W}x{C} f32", max_abs_err=max(errs)))
        del vals, cot, tx, ty, got, ref
    results["splat"]["train_shapes"] = splat_rows
    results["splat_grad"] = dict(
        name="splat_grad", route="cuda", source="fldrx_torch/csrc/warp.cu",
        replaces="fldrx/ops/fastwarp.py:1529",
        library_call="none: no single PyTorch call computes it",
        **grad_rows[0])
    results["splat_grad"]["max_abs_err"] = max(r["max_abs_err"]
                                               for r in grad_rows)
    results["splat_grad"]["checks"] = grad_rows[1:]
    torch.cuda.empty_cache()
    for name in ("gather_grad", "splat_grad"):
        r = results[name]
        print(f"kernel {name}: err {r['max_abs_err']:.3g}, {r['ms']:.3f} ms "
              f"(plain {r['plain_ms']:.3f}, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.3f} by {r['bound_by']}) at {r['shape']}",
              flush=True)


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

# the kernels each path must launch
INFER_KERNELS = ("gather", "splat", "conv3x3")
TRAIN_KERNELS = ("gather", "splat", "gather_grad", "splat_grad")


def launches():
    from fldrx_torch.ops import fastconv, fastwarp
    return {**fastwarp.LAUNCHES, **fastconv.LAUNCHES}


def require_launched(seen, kernels, where):
    missing = [k for k in kernels if seen[k] == 0]
    if missing:
        raise AssertionError(f"{where}: kernels not launched: {missing} "
                             f"({seen})")


def reset_launches():
    from fldrx_torch.ops import fastconv, fastwarp
    for d in (fastwarp.LAUNCHES, fastconv.LAUNCHES):
        for k in d:
            d[k] = 0


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
    import torch

    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import bench_frames, deploy_config

    cfg = deploy_config()
    interp, _, _ = prepare_model(cfg=cfg, device="cuda")
    H, W = 2160, 4096
    frames = torch.as_tensor(bench_frames(H, W)).cuda()
    t_values = list(np.linspace(1 / 8, 1 - 1 / 8, 7))
    chunk = cfg.t_chunk

    def pair(stats):
        flow, padded, extras = interp.precompute_flow(frames)
        for k in range(0, len(t_values), chunk):
            out = interp.synthesize_multi_at(flow, padded,
                                             t_values[k:k + chunk], (H, W),
                                             extras)
            stats.append(torch.stack([out.amin(), out.amax(),
                                      (~torch.isfinite(out)).sum().float()]))
        return out

    stats = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pair(stats)                                   # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if tuple(out.shape) != (chunk - 1, 1, H, W, 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    iters = 3
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        pair(stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen = launches()
    st = torch.stack(stats).cpu().numpy()
    lo, hi, nonfinite = float(st[:, 0].min()), float(st[:, 1].max()), \
        int(st[:, 2].sum())
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"phase": "main_path_4k", "hw": [H, W], "multiple": 8,
                      "pairs": iters, "fps": iters * len(t_values) / dt,
                      "s_per_pair": dt / iters, "warmup_s": warm_s,
                      "peak_mem_gib": peak_gb, "launches": seen,
                      "out_min": lo, "out_max": hi, "nonfinite": nonfinite,
                      "card": card}), flush=True)
    if nonfinite or lo < -1.1 or hi > 1.1:
        raise AssertionError(f"outputs out of range: [{lo}, {hi}], "
                             f"{nonfinite} non-finite")
    require_launched(seen, INFER_KERNELS, "inference at 4K")
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
                      "checkpoint_exact": exact, "card": card}), flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    require_launched(seen, TRAIN_KERNELS, "training at full size")
    if not exact:
        raise AssertionError("checkpoint round trip did not restore the "
                             "parameters and optimiser state exactly")
    return seen


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import fldrx_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    variant, peaks = peaks_for(card)
    print(f"card: {card} ({variant} peaks); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    results = check_kernels("cuda", peaks)
    check_train_kernels("cuda", peaks, results)
    main_path_held()
    seen = main_path_4k(card)
    train_step_held()
    seen_train = train_full(card)
    for k, r in results.items():
        # launches: the count of the path the row is timed for (the 4K
        # pairs for the forward kernels, the timed train steps for the VJP
        # kernels); launches_train: over the 5 timed train steps
        r["launches"] = seen[k] if k in INFER_KERNELS else seen_train[k]
        r["launches_train"] = seen_train[k]
    print(json.dumps({"kernels": list(results.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
