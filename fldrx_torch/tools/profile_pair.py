"""Where one 4K pair's time goes on the card, one training step's, or one
call of the PWC-Net teacher's.

    python -m fldrx_torch.tools.profile_pair [--multiple N] [--out FILE]
    python -m fldrx_torch.tools.profile_pair --train [--out profile_train.txt]
    python -m fldrx_torch.tools.profile_pair --teacher [--out profile_teacher.txt]

Default: chip_smoke.py's inference path (papermodel_test5, f32 flow, bf16
UNet, t chunks of 4, plain rows out) on bench.py's 2160×4096 uint8
texture pair, handed over from pinned host memory as a decoder hands it;
`--multiple` N makes the N − 1 frames between the two (8: X-Test, 2:
Xiph). A warm-up pair, then one pair under `torch.profiler`.

--train: the papermodel training step (`make_train_step`: S_trn=3, batch
8, 512×512 bench texture with a per-sample pan, from pinned host memory,
fresh parameters with the PCA fitted on the first batch): a warm-up step,
then one step profiled.

--teacher: chip_smoke.py's full-width teacher call (seeded random weights
at the published widths, 8 pairs of 512×512 bench texture, TF32 off),
`get_bidirectional_flow` with the program's own spans (`teacher` ⊃
`extractor`, `decoders` ⊃ `corr`, `warp`, `refiner`, `resize`): a warm-up
call, then one call profiled.

Stage times come from the port's spans (utils/trace.py), recorded in the
profiled run with nothing fenced: each span path's calls, device ms, device
self ms, host ms and kernel launches. The run is inside `trace.ranges()`,
so the spans are ranges of the profile as well, and each idle gap of the
card (no kernel or copy running) is labelled by the spans the host was in
at its middle, outermost first, and by the host operation that covers the
most of it (a synchronisation, a copy, the profiler's own buffer set-up). One JSON line: the stages, the profiled
wall time, the device's busy time (the union of its operations'
intervals, so overlapping kernels count once) and idle share, the ten
longest idle gaps, the run's peak memory, the top device kernels, and
every kernel of csrc/warp.cu and csrc/correlation.cu with its launches
and device ms; the full table goes to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..bench_inputs import bench_frames, deploy_config, train_batch
from ..utils import trace

WINDOW = "profile_pair.window"
TOP_GAPS = 10

Interval = Tuple[str, float, float]           # (name, start µs, end µs)


def events(prof, span_names):
    """(device operations, host spans, host operations) of a finished
    profile: every operation on the card (kernels, copies, sets), the
    host's copy of each range named in span_names or WINDOW, and every
    other host event. The profiler also draws each range on the device's
    timeline; those copies are none of them."""
    from torch.autograd import DeviceType

    names = set(span_names) | {WINDOW}
    ops, spans, host = [], [], []
    for e in prof.events():
        tr = e.time_range
        on_card = e.device_type == DeviceType.CUDA
        if e.name in names:
            if not on_card:
                spans.append((e.name, tr.start, tr.end))
        else:
            (ops if on_card else host).append((e.name, tr.start, tr.end))
    return ops, spans, host


def union(intervals: Sequence[Tuple[float, float]]):
    """The intervals merged where they overlap or touch, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(ops: Sequence[Interval]) -> float:
    """The time at least one operation ran: overlaps count once."""
    return sum(b - a for a, b in union([(a, b) for _, a, b in ops]))


def idle_gaps(ops: Sequence[Interval], spans: Sequence[Interval],
              host: Sequence[Interval] = (),
              top: int = TOP_GAPS) -> List[list]:
    """The `top` longest stretches of the WINDOW span with no operation
    on the card, longest first: [label, ms, host operation], the label the
    spans the host was in at the gap's middle, outermost first
    ("flow/ingest"), or "between spans"; the host operation the one that
    overlaps the gap most (the shorter on a tie), or "" where none does."""
    win = [(a, b) for n, a, b in spans if n == WINDOW]
    if not win:
        raise ValueError("the profile holds no window span")
    w0, w1 = win[0]
    held = union([(max(a, w0), min(b, w1)) for _, a, b in ops
                  if b > w0 and a < w1])
    edges = [w0] + [x for iv in held for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    inner = [s for s in spans if s[0] != WINDOW]

    def label(a, b):
        mid = 0.5 * (a + b)
        around = sorted((s for s in inner if s[1] <= mid <= s[2]),
                        key=lambda s: (s[1], -s[2]))
        return "/".join(n for n, _, _ in around) or "between spans"

    def holder(a, b):
        over = [(min(e, b) - max(s, a), -(e - s), n) for n, s, e in host
                if min(e, b) > max(s, a)]
        return max(over)[2] if over else ""

    longest = sorted(gaps, key=lambda g: -(g[1] - g[0]))[:top]
    return [[label(a, b), (b - a) * 1e-3, holder(a, b)] for a, b in longest]


def pair_runner(multiple: int = 8):
    """One 4K pair at ×multiple: run()."""
    from ..api import prepare_model

    cfg = deploy_config()
    interp, _, _ = prepare_model(cfg=cfg, device="cuda")
    H, W = 2160, 4096
    frames = torch.as_tensor(bench_frames(H, W)).pin_memory()
    t_values = [k / multiple for k in range(1, multiple)]

    def run():
        flow, padded, extras = interp.precompute_flow(frames)
        for k in range(0, len(t_values), cfg.t_chunk):
            interp.synthesize_multi_at(flow, padded,
                                       t_values[k:k + cfg.t_chunk], (H, W),
                                       extras)

    return run


def train_runner():
    """One full-size train step: run()."""
    from ..bench_inputs import train_config
    from ..model.fldrnet import init_params
    from ..train.loop import assign_params, fit_pca_from_batch
    from ..train.trainer import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config()
    B = cfg.batch_size
    t = 1 / 32 + (30 / 32) * torch.rand(
        B, 1, generator=torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v).pin_memory() for k, v in train_batch(
        cfg.patch_size, t.numpy(), seed=100).items()}
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    assign_params(params, fit_pca_from_batch(
        batch["frames"].numpy(), cfg, "cuda"))
    state = TrainState.create(params, cfg)
    step = make_train_step(cfg)

    def run():
        step(state, batch)

    return run


def teacher_runner():
    """One bidirectional teacher call, `get_bidirectional_flow`: run()."""
    from ..model import pwcnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = pwcnet.init_pwc_params(torch.Generator().manual_seed(0), "cuda")
    fr = train_batch(512, np.full((8, 1), 0.5, np.float32), 7)["frames"]
    fr = torch.as_tensor(np.clip((fr + 1.0) / 2.0, 0.0, 1.0)).cuda()
    im0, im1 = fr[:, 0], fr[:, 1]

    def run():
        pwcnet.get_bidirectional_flow(params, im0, im1)

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--multiple", type=int, default=8,
                    help="the pair's frames: multiple − 1 t values")
    ap.add_argument("--train", action="store_true",
                    help="profile a full-size training step")
    ap.add_argument("--teacher", action="store_true",
                    help="profile a full-width PWC-Net teacher call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_pair: no CUDA device", file=sys.stderr)
        return 1
    what = ("teacher_call" if args.teacher else "train_step" if args.train
            else f"pair_4k_x{args.multiple}")
    out_path = args.out or {"teacher_call": "profile_teacher.txt",
                            "train_step": "profile_train.txt"}.get(
                                what, "profile_pair.txt")
    run = (teacher_runner() if args.teacher else train_runner() if args.train
           else pair_runner(args.multiple))
    run()                                               # warm-up
    torch.cuda.synchronize()
    trace.clear()
    torch.cuda.reset_peak_memory_stats()          # peak of the profiled run
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, trace.ranges():
        # the profiler sets up its device buffers (≈3 ms) at the first CUDA
        # call it sees: here, not in the window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            run()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    snap = trace.snapshot()
    stages = {p: {k: r[k] for k in ("calls", "device_ms", "self_device_ms",
                                    "host_ms", "launches")}
              for p, r in snap.items()}
    ops, spans, host = events(prof, {p.split("/")[-1] for p in snap})
    busy_ms = busy_us(ops) / 1e3
    # device-side rows only: kernels and copies, not the CPU ops that
    # launched them (whose device columns repeat the same time), nor the
    # spans' own annotations
    avgs = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in {n for n, _, _ in spans}]
    avgs.sort(key=lambda e: -e.self_device_time_total)
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
        "what": what, "peak_mem_gib": peak,
        "stages": stages, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "idle_gaps": idle_gaps(ops, spans, host),
        "top_kernels": top[:25],
        "warp_kernels": [r for r in top if "namespace)::" in r["name"]
                         and ("gather" in r["name"] or "splat" in r["name"])],
        "correlation_kernels": [r for r in top
                                if "correlation_kernel" in r["name"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
