"""The port's benchmark (counterpart of the repository's bench.py):
interpolated 4K frames per second on one card with the papermodel
test5scales pipeline at ×8.

    python -m fldrx_torch.bench

The deploy mix (`bench_inputs.deploy_config`: float32 flow, bfloat16
refine UNet, t chunks of 4, the synthesis returned as u-planes), uint8
frames of bench.py's texture with a camera pan at 2160×4096, the
checkpoint in the repository; one warm-up pair, then 3 timed pairs at ×8,
fenced by torch.cuda.synchronize().
Prints one JSON line {"metric", "value", "unit", "card"}; the card is
nvidia-smi's name and power limit. There is no vs_baseline: bench.py
divides by a TPU figure. Without a GPU it exits with code 3.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from .bench_inputs import bench_frames, deploy_config

H, W = 2160, 4096
MULTIPLE = 8
ITERS = 3
METRIC = "4K interpolated frames/sec/card (papermodel test5scales, x8)"


def t_values(multiple: int = MULTIPLE):
    """The ×N protocol's multiple − 1 interpolation times."""
    return list(np.linspace(1 / multiple, 1 - 1 / multiple, multiple - 1))


def run_pair(interp, frames, ts, on_chunk: Optional[Callable] = None):
    """One pair: the flow once, then the synthesis in chunks of
    cfg.t_chunk; returns the last chunk's output (not synchronised).
    on_chunk(out), if given, sees every chunk's output."""
    Hf, Wf = frames.shape[2], frames.shape[3]
    chunk = max(1, interp.cfg.t_chunk)
    flow, padded, extras = interp.precompute_flow(frames)
    for k in range(0, len(ts), chunk):
        out = interp.synthesize_multi_at(flow, padded, ts[k:k + chunk],
                                         (Hf, Wf), extras)
        if on_chunk is not None:
            on_chunk(out)
    return out


def timed_pairs(interp, frames, ts, iters: int = ITERS,
                on_chunk: Optional[Callable] = None,
                before_timed: Optional[Callable] = None) -> dict:
    """One warm-up pair, then `iters` timed pairs, each fenced by
    torch.cuda.synchronize(). before_timed(), if given, runs between the
    two (a caller zeroes its launch counts there). Returns {"fps",
    "s_per_pair", "warmup_s", "out"}: frames/s over the timed pairs, and
    the last pair's last output."""
    t0 = time.perf_counter()
    out = run_pair(interp, frames, ts, on_chunk)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if before_timed is not None:
        before_timed()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run_pair(interp, frames, ts, on_chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"fps": iters * len(ts) / dt, "s_per_pair": dt / iters,
            "warmup_s": warm_s, "out": out}


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(device=None) -> dict:
    """The benchmark on `device` (default cuda): its JSON record."""
    from .api import prepare_model
    from .device import resolve_device

    dev = resolve_device(device)
    interp, _, _ = prepare_model(cfg=deploy_config(), device=dev)
    frames = torch.as_tensor(bench_frames(H, W)).to(dev)
    res = timed_pairs(interp, frames, t_values())
    return {"metric": METRIC, "value": res["fps"], "unit": "frames/sec",
            "card": card_line()}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 3
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
