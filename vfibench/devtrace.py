"""What `torch.profiler` traces of the traced window say.

Two traces, so that the profiler's own cost does not land in the idle
share: the first records the device alone (no host operations, so the
host runs as fast as untraced) and gives the busy time, the union of the
device operations' intervals (overlapping kernels count once), and the
operations that took most time; the window's length is the host clock's
from one synchronisation to the next. The second, shorter, records the
host too and labels the longest idle gaps by the benchmark's own span that
the host was in: the traced window is wrapped in a span named WINDOW and
each call into the program in a span of its own (`record_function`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

WINDOW = "vfibench.window"
TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def events(prof, span_names: Sequence[str] = ()):
    """(device_ops, spans) of a finished profile: (name, start, end) in
    microseconds of every device operation, and of the host's spans named
    in span_names or WINDOW."""
    from torch.autograd import DeviceType

    device_ops, spans = [], []
    names = set(span_names) | {WINDOW}
    for e in prof.events():
        tr = e.time_range
        if e.name in names:
            # the profiler also draws each span on the device's timeline
            # (a user annotation): only the host's copy is a span
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CUDA:
            device_ops.append((e.name, tr.start, tr.end))
    return device_ops, spans


def busy(device_ops: Sequence[Tuple[str, float, float]]) -> Dict:
    """busy_s, the union of the operations' intervals, and the top
    operations by total seconds."""
    total_us = sum(b - a for a, b in _union([(a, b) for _, a, b in device_ops]))
    totals: Dict[str, float] = {}
    for n, a, b in device_ops:
        totals[n] = totals.get(n, 0.0) + (b - a)
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": total_us * 1e-6,
            "device_ops": [[n[:120], v * 1e-6] for n, v in ops]}


def idle_gaps(device_ops: Sequence[Tuple[str, float, float]],
              spans: Sequence[Tuple[str, float, float]]) -> List:
    """The longest idle gaps of the WINDOW span, each labelled by the
    innermost of the other spans the host was in at the gap's middle."""
    win = [(a, b) for n, a, b in spans if n == WINDOW]
    if not win:
        raise ValueError("the trace holds no window span")
    w0, w1 = win[0]
    held = _union([(max(a, w0), min(b, w1)) for _, a, b in device_ops
                   if b > w0 and a < w1])
    edges = [w0] + [x for iv in held for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    inner = sorted(((n, a, b) for n, a, b in spans if n != WINDOW),
                   key=lambda s: s[2] - s[1])

    def label(a, b):
        mid = 0.5 * (a + b)
        for n, s0, s1 in inner:             # the innermost span first
            if s0 <= mid <= s1:
                return n
        return "between calls"

    longest = sorted(gaps, key=lambda g: -(g[1] - g[0]))[:TOP]
    return [[label(a, b), (b - a) * 1e-6] for a, b in longest]
