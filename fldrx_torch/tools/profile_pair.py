"""Where one 4K ×8 pair's time goes on the card, one training step's, or
one call of the PWC-Net teacher's.

    python -m fldrx_torch.tools.profile_pair [--out profile_pair.txt]
    python -m fldrx_torch.tools.profile_pair --train [--out profile_train.txt]
    python -m fldrx_torch.tools.profile_pair --teacher [--out profile_teacher.txt]

Default: chip_smoke.py's inference path (papermodel_test5, f32 flow, bf16
UNet, t chunks of 4, bench.py's 2160×4096 uint8 texture frames) on cuda: a
warm-up pair, then one pair with the stages fenced by
`torch.cuda.synchronize()` (flow and extras once, synthesis per chunk),
then one pair under `torch.profiler`.

--train: chip_smoke.py's full-size training step (papermodel, S_trn=3,
batch 8, 512×512 bench texture with a per-sample pan, fresh parameters
with the PCA fitted on the first batch): a warm-up step, one step with its
stages fenced (forward, loss, backward, optimiser update), then one step
under `torch.profiler`.

--teacher: chip_smoke.py's full-width teacher call (seeded random weights
at the published widths, 8 pairs of 512×512 bench texture,
get_bidirectional_flow): a warm-up call, one call with one direction's
stages fenced (extractor, each decoder, refiner and resize; each with the
peak memory it reached) and the other direction whole, then one call under
`torch.profiler`.

Each prints one JSON line with the stage times, the device's busy time (the
sum of kernel self times) and idle share over the profiled wall time, the
profiled run's peak memory, the top device kernels, and every kernel of
csrc/warp.cu (the gather, the splat and their VJPs) and of
csrc/correlation.cu with its launches and device ms; the full table goes
to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..bench_inputs import bench_frames, deploy_config, train_batch


def _marker(fence: bool):
    marks = []

    def mark(name):
        if fence:
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    def stages():
        torch.cuda.synchronize()
        return {n: (t - p) * 1e3 for (_, p), (n, t) in zip(marks, marks[1:])}

    return mark, stages


def pair_runner():
    """The 4K ×8 pair: run(fence) → stage times in ms."""
    from ..api import prepare_model

    cfg = deploy_config()
    interp, _, _ = prepare_model(cfg=cfg, device="cuda")
    H, W = 2160, 4096
    frames = torch.as_tensor(bench_frames(H, W)).cuda()
    t_values = list(np.linspace(1 / 8, 1 - 1 / 8, 7))

    def run(fence: bool):
        mark, stages = _marker(fence)
        mark("start")
        flow, padded, extras = interp.precompute_flow(frames)
        mark("flow_and_extras")
        for k in range(0, len(t_values), cfg.t_chunk):
            interp.synthesize_multi_at(flow, padded,
                                       t_values[k:k + cfg.t_chunk], (H, W),
                                       extras)
            mark(f"synthesis_{len(t_values[k:k + cfg.t_chunk])}t")
        return stages()

    return run


def train_runner():
    """One full-size train step: run(fence) → stage times in ms."""
    from ..bench_inputs import train_config
    from ..eval.pipeline import build_pyramid
    from ..model.fldrnet import forward_train, init_params
    from ..train.loop import assign_params, fit_pca_from_batch
    from ..train.losses import total_loss
    from ..train.trainer import TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config()
    B = cfg.batch_size
    t = 1 / 32 + (30 / 32) * torch.rand(
        B, 1, generator=torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v).cuda() for k, v in train_batch(
        cfg.patch_size, t.numpy(), seed=100).items()}
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    assign_params(params, fit_pca_from_batch(
        batch["frames"].cpu().numpy(), cfg, "cuda"))
    state = TrainState.create(params, cfg)

    def run(fence: bool):
        mark, stages = _marker(fence)
        mark("start")
        state.optimizer.zero_grad(set_to_none=True)
        frames, target, tt = batch["frames"], batch["target"], batch["t"]
        out = forward_train(state.params, cfg,
                            build_pyramid(frames, cfg, cfg.S_trn + 1), tt)
        mark("forward")
        loss, _ = total_loss(cfg, out, target, frames, tt,
                             params=state.params)
        mark("loss")
        loss.backward()
        mark("backward")
        state.apply_gradients()
        mark("update")
        return stages()

    return run


def teacher_runner():
    """One bidirectional teacher call: run(fence) → stage times in ms; the
    fenced run also records each stage's peak memory in GiB."""
    from ..model import pwcnet
    from ..ops.resize import resize_2d

    torch.backends.cudnn.allow_tf32 = False
    params = pwcnet.init_pwc_params(torch.Generator().manual_seed(0), "cuda")
    fr = train_batch(512, np.full((8, 1), 0.5, np.float32), 7)["frames"]
    fr = torch.as_tensor(np.clip((fr + 1.0) / 2.0, 0.0, 1.0)).cuda()
    im0, im1 = fr[:, 0], fr[:, 1]

    def run(fence: bool):
        mark, stages = _marker(fence)
        peaks = {}

        def stage(name):
            mark(name)
            if fence:
                peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
                torch.cuda.reset_peak_memory_stats()

        with torch.inference_mode():
            stage("start")
            mean = torch.tensor(pwcnet._MEAN, device="cuda")
            f1 = pwcnet.extractor(params["extractor"], im0 - mean)
            f2 = pwcnet.extractor(params["extractor"], im1 - mean)
            stage("extractor_01")
            est = None
            for level in (6, 5, 4, 3, 2):
                est = pwcnet.decoder(params[f"dec{level}"], level,
                                     f1[level - 1], f2[level - 1], est)
                stage(f"decoder{level}_01")
            flow = est["flow"] + pwcnet.refiner(params["refiner"],
                                                est["feat"])
            stage("refiner_01")
            20.0 * resize_2d(flow, (512, 512), "bilinear")
            stage("resize_01")
            pwcnet.pwc_forward(params, im1, im0)
            stage("forward_10")
        out = stages()
        if fence:
            out["peak_mem_gib"] = {k: v for k, v in peaks.items()
                                   if k != "start"}
        return out

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--train", action="store_true",
                    help="profile a full-size training step")
    ap.add_argument("--teacher", action="store_true",
                    help="profile a full-width PWC-Net teacher call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_pair: no CUDA device", file=sys.stderr)
        return 1
    what = ("teacher_call" if args.teacher else "train_step" if args.train
            else "pair_4k_x8")
    out_path = args.out or {"teacher_call": "profile_teacher.txt",
                            "train_step": "profile_train.txt",
                            "pair_4k_x8": "profile_pair.txt"}[what]
    run = (teacher_runner() if args.teacher else train_runner() if args.train
           else pair_runner())
    run(False)                                          # warm-up
    stages = run(True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()          # peak of the profiled run
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(False)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only: kernels and copies, not the CPU ops that
    # launched them (whose device columns repeat the same time)
    avgs = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    avgs.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
    top = [{"name": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3} for e in avgs]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=80))
    print(json.dumps({
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(),
        "what": what,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "stages_ms": stages, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "top_kernels": top[:25],
        "warp_kernels": [r for r in top if "namespace)::" in r["name"]
                         and ("gather" in r["name"] or "splat" in r["name"])],
        "correlation_kernels": [r for r in top
                                if "correlation_kernel" in r["name"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
