"""Profiling (counterpart of fldrx/eval/profiling.py): a `torch.profiler`
trace around a block, written as a Chrome trace; a frames/s meter fenced
by `torch.cuda.synchronize()`; and per-level times from the forward cut at
each pyramid depth, the counterpart of the reference's --timetest.

`tools/profile_pair.py` breaks one 4K pair or train step down by stage and
kernel; these are the lighter tools fldrx offers its users.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("log_dir", "trace")):
    """Profile the enclosed block (the host, and the card where there is
    one) and write its Chrome trace to `log_dir`/trace.json, viewable in
    ui.perfetto.dev or chrome://tracing. Yields the path the trace will
    have."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def _fence(out) -> None:
    """Wait for the work that produced `out`: a card's queue runs behind the
    host."""
    if torch.is_tensor(out) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def fps_meter(fn: Callable, *args, iters: int = 8, warmup: int = 1) -> float:
    """Calls per second of fn(*args), one frame batch a call: `warmup`
    calls, then `iters` calls timed on the host clock up to the fence after
    the last."""
    for _ in range(warmup):
        _fence(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    _fence(out)
    return iters / (time.perf_counter() - t0)


def time_levels(interp, frames: np.ndarray, t) -> dict:
    """Seconds of the forward cut at each pyramid depth S_tst = 1 … the
    interpolator's, and each level's difference from the one above:
    {"S_tst=s total_s", "level_s_delta_s"}. frames [B, 2, H, W, 3]; t
    [B, 1]; frames may already lie on the interpolator's device."""
    from .pipeline import Interpolator

    cfg = interp.cfg
    frames = torch.as_tensor(frames).to(interp.device)
    results, prev = {}, None
    for s in range(1, cfg.S_tst + 1):
        sub = Interpolator(interp.params, cfg.replace(S_tst=s),
                           interp.device)
        total = 1.0 / fps_meter(sub, frames, t, iters=3)
        results[f"S_tst={s} total_s"] = total
        if prev is not None:
            results[f"level_{s}_delta_s"] = total - prev
        prev = total
    return results
