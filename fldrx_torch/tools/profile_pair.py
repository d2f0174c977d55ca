"""Where one 4K ×8 pair's time goes on the card, or one training step's.

    python -m fldrx_torch.tools.profile_pair [--out profile_pair.txt]
    python -m fldrx_torch.tools.profile_pair --train [--out profile_train.txt]

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

Both print one JSON line with the stage times, the device's busy time (the
sum of kernel self times) and idle share over the profiled wall time, and
the top device kernels; the full table goes to --out.
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

from ..bench_inputs import bench_frames, deploy_config


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
    from ..bench_inputs import train_batch, train_config
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--train", action="store_true",
                    help="profile a full-size training step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_pair: no CUDA device", file=sys.stderr)
        return 1
    out_path = args.out or ("profile_train.txt" if args.train
                            else "profile_pair.txt")
    run = train_runner() if args.train else pair_runner()
    run(False)                                          # warm-up
    stages = run(True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
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
        "what": "train_step" if args.train else "pair_4k_x8",
        "stages_ms": stages, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "top_kernels": top[:25]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
