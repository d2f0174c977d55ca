"""What the readers of the program's own spans and counters share: the
recorder's snapshot (fldrx_torch/utils/trace.py) after the traced run,
reduced to one number a request. A program without the recorder, or a
run that recorded none of the spans asked for, gives None."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence


def snapshot() -> Optional[dict]:
    try:
        from fldrx_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot() or None


def per_request(rec: dict, kind: str, top: str, paths: Sequence[str],
                field: str = "device_ms", per_t: bool = False):
    """The median, over the requests that the `top` spans began, of
    `field` summed over the spans at `paths` in the request; with per_t,
    over the t values the request's `synth` spans made. The median keeps
    the few requests of the traced run that the profiler also records on
    the host (and so slows) from moving the number."""
    if rec["kind"] != kind:
        return None
    snap = snapshot()
    if not snap or top not in snap or not any(p in snap for p in paths):
        return None
    values = []
    for r in snap[top]["by_request"]:
        if r is None:
            continue
        v = sum(snap[p]["by_request"].get(r, {}).get(field, 0)
                for p in paths if p in snap)
        if per_t:
            n_t = snap.get("synth", {}).get("by_request", {}).get(
                r, {}).get("n_t", 0)
            if not n_t:
                continue
            v /= n_t
        values.append(v)
    return float(statistics.median(values)) if values else None
