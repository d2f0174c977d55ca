"""Spans and counters of the port's stages, kept in memory.

    from fldrx_torch.utils import trace

    with trace.span("pyramid"):
        ...

A span records only while it is asked to: while a `torch.profiler`
profile runs (the benchmark's traced runs, tools/profile_pair.py,
`eval.profiling.trace()`) or inside `recording()`. Otherwise `span()`
checks that flag and returns a shared no-op context: no allocation, no
event, no profiler range.

A recorded span keeps its name and attributes, its parent, the request it
belongs to (a span opened with `request=True` starts a new one:
`Interpolator.precompute_flow` and the train step; the spans after it take
its id until the next), its host interval (`time.perf_counter_ns`) and,
where CUDA is initialised, a pair of CUDA events: the device interval, on
the device's clock (on the CPU the device interval is the host interval).
The events go on the stream that was current when the outermost open span
began (asking for the current stream costs several µs a call). Nothing
synchronises while recording; the events are resolved by `snapshot()`.
At most CAP spans are kept; later ones are counted in `dropped()`.

Counters: `counters(group, d)` registers a module's dict of kernel
launches (`ops/fastwarp.py`'s LAUNCHES and the others); a span with no
parent keeps the launches made inside it.

`snapshot()` gives, for each span path ("flow/extras/z"): calls, host ms,
device ms, device self ms (the duration less what its child spans
cover), launches, the number of requests, the t values its `n_t`
attributes add up to, and the same per request. Inside `ranges()` each
recorded span is also a `record_function` range, so it sits on the
profiler's timeline beside the kernels (Perfetto, idle-gap labels).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch

CAP = 1 << 16

_profiling = torch.autograd._profiler_enabled
_forced = 0                     # recording() blocks open


class _Off:
    """The context a span is when nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recorder:
    """The spans recorded in this process, and the launch counters."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.spans = []
        self.dropped = 0
        self.groups: Dict[str, Dict[str, int]] = {}
        self.ranges = 0
        self.request: Optional[int] = None
        self._requests = 0
        self._ids = 0
        self._local = threading.local()

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def launches(self) -> Dict[str, int]:
        return {f"{g}.{k}": v for g, d in self.groups.items()
                for k, v in d.items()}

    def clear(self) -> None:
        self.spans = []
        self.dropped = 0
        self.request = None


RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "attrs", "new_request", "path", "id", "parent",
                 "request", "t0", "t1", "stream", "e0", "e1", "counts",
                 "range")

    def __init__(self, name: str, new_request: bool, attrs: dict):
        self.name, self.new_request, self.attrs = name, new_request, attrs

    def __enter__(self):
        rec = RECORDER
        st = rec.stack()
        parent = st[-1] if st else None
        if self.new_request:
            rec.request = rec._requests
            rec._requests += 1
        self.request = rec.request
        self.path = (parent.path + (self.name,)) if parent else (self.name,)
        self.parent = parent.id if parent else None
        self.id = rec._ids
        rec._ids += 1
        self.counts = None if parent else rec.launches()
        self.range = None
        if rec.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.stream = self.e0 = self.e1 = None
        if torch.cuda.is_initialized():
            self.stream = (parent and parent.stream) or \
                torch.cuda.current_stream()
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.stream.record_event(self.e0)
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        rec = RECORDER
        if self.e0 is not None:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.stream.record_event(self.e1)
        rec.stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        if self.counts is not None:
            now = rec.launches()
            self.counts = {k: v - self.counts.get(k, 0)
                           for k, v in now.items()
                           if v != self.counts.get(k, 0)}
        if len(rec.spans) < rec.cap:
            rec.spans.append(self)
        else:
            rec.dropped += 1
        return False


def span(name: str, request: bool = False, **attrs):
    """A context that records the enclosed stage as a span named `name`
    while recording is on (a profiler runs, or inside `recording()`);
    request=True starts a new request. Attributes: `n_t`, the t values the
    span synthesises."""
    if not (_forced or _profiling()):
        return _OFF
    return _Span(name, request, attrs)


@contextlib.contextmanager
def recording():
    """Record spans inside the block with no profiler running."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


@contextlib.contextmanager
def ranges():
    """Inside the block a recorded span is also a `record_function` range
    of the same name, on the profiler's timeline."""
    RECORDER.ranges += 1
    try:
        yield
    finally:
        RECORDER.ranges -= 1


def counters(group: str, launches: Dict[str, int]) -> Dict[str, int]:
    """Register a module's launch counter dict (returned as given): spans
    with no parent keep the launches made inside them as `group.kernel`."""
    RECORDER.groups[group] = launches
    return launches


def clear() -> None:
    """Forget the spans recorded so far (the counters keep counting)."""
    RECORDER.clear()


def dropped() -> int:
    """Spans not kept since the last clear(): the store held CAP."""
    return RECORDER.dropped


def _row() -> dict:
    return {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
            "self_device_ms": 0.0, "launches": 0, "launches_by_kernel": {},
            "requests": 0, "n_t": 0, "by_request": {}}


def snapshot() -> Dict[str, dict]:
    """{span path: {calls, host_ms, device_ms, self_device_ms, launches,
    launches_by_kernel, requests, n_t, by_request: {request id: {calls,
    host_ms, device_ms, self_device_ms, launches, n_t}}}} over the spans
    recorded since the last clear(), totals over their calls. Waits for
    the device where a span recorded CUDA events."""
    spans = list(RECORDER.spans)
    if any(s.e1 is not None for s in spans):
        torch.cuda.synchronize()
    dur = {}
    for s in spans:
        host = (s.t1 - s.t0) * 1e-6
        dev = s.e0.elapsed_time(s.e1) if s.e1 is not None else host
        dur[s.id] = (host, dev)
    covered: Dict[int, float] = {}
    for s in spans:
        if s.parent in dur:
            covered[s.parent] = covered.get(s.parent, 0.0) + dur[s.id][1]
    out: Dict[str, dict] = {}
    for s in spans:
        host, dev = dur[s.id]
        row = out.setdefault("/".join(s.path), _row())
        req = row["by_request"].setdefault(s.request, {
            "calls": 0, "host_ms": 0.0, "device_ms": 0.0,
            "self_device_ms": 0.0, "launches": 0, "n_t": 0})
        n = sum((s.counts or {}).values())
        for r in (row, req):
            r["calls"] += 1
            r["host_ms"] += host
            r["device_ms"] += dev
            r["self_device_ms"] += dev - covered.get(s.id, 0.0)
            r["launches"] += n
            r["n_t"] += int(s.attrs.get("n_t", 0))
        for k, v in (s.counts or {}).items():
            row["launches_by_kernel"][k] = \
                row["launches_by_kernel"].get(k, 0) + v
    for row in out.values():
        row["requests"] = len([r for r in row["by_request"] if r is not None])
    return out
