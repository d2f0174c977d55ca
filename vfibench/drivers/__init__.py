"""The benchmark's drivers, one per kind of traffic, found by the name a
traffic file gives under "driver". Each module has `Driver(cell, device,
seed)` with:

- setup(): builds the program's object for the cell, makes the inputs
  from the seed, warms up every shape the traffic uses;
- window(seconds, marks): the measured window, a closed loop of the
  traffic's requests; returns {"requests", "window_s", "e2e": {name:
  value}, "layers": {...}};
- traced(n): n more requests under the profiler, each call in a span;
- release(): frees the program's state, keeping what the check needs;
- check(): the comparison with the plain reference: {name: (value,
  limit)} for the cell's limits.
"""

from __future__ import annotations

import importlib
import time

import torch


def load(name: str):
    """The driver module `drivers/<name>.py`."""
    return importlib.import_module(f"{__name__}.{name}")


class Marks:
    """Device-time marks on the current stream (CUDA events), or host
    times where the device is the CPU (the harness's own tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def segments(ends, window_s: float, n: int = 5) -> dict:
    """The request rate in each of n equal parts of the window (`ends`:
    each request's end, seconds into the window; a part's rate is its
    requests after the first over the time from the first's end to the
    last's) and their spread, the interquartile range over the median in
    % (statistics.quantiles): the noise within one run, to set beside the
    spread between runs."""
    import statistics

    parts = [[] for _ in range(n)]
    for e in ends:
        parts[min(n - 1, int(e / window_s * n))].append(e)
    rates = [(len(p) - 1) / (p[-1] - p[0]) for p in parts
             if len(p) > 1 and p[-1] > p[0]]
    if len(rates) < 2:
        return {"segment_rates": rates, "segment_spread_pct": None}
    q = statistics.quantiles(rates, n=4)
    return {"segment_rates": rates, "segment_spread_pct":
            100.0 * (q[2] - q[0]) / statistics.median(rates)}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pinned(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t` in pinned memory (plain host memory where there
    is no card), as a decoder or a data loader hands frames over."""
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


def fields_to_config(fields: dict):
    """The program's FLDRConfig from a configuration file's fields (lists
    become the tuples the dataclass holds)."""
    from fldrx_torch.config import FLDRConfig

    return FLDRConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in fields.items()})
