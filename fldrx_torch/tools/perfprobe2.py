"""In-context stage times of the 4K ×8 pair (counterpart of
fldrx/tools/perfprobe2.py): the flow precompute and the chunked synthesis
timed whole, then with one stage stubbed out at a time; the difference is
what the stage costs inside the real pipeline.

    python -m fldrx_torch.tools.perfprobe2 [--hw H W] [--n N] [--out FILE]

The deploy mix (bench_inputs.deploy_config) on the repository's
checkpoint and bench.py's uint8 texture pair (2160×4096 by default), as
the bench runs it: the flow once, then the 7 t values in chunks of 4; the
synthesis returns plain rows (planes_out off, as evaluate() asks when it
scores on the card).

A stub swaps a function of the model's modules, inside a context manager,
for one that returns zeros of the shapes and dtypes the real function
returned at that call, made on an untimed first pass; leaving the block
restores the function. The model has no switch for this. Flow stages:
pyramid (build_pyramid's resizes), features (extract_features), levels
(level_flow), z (z_metrics and the resizes to half resolution), pack (the
resizes to full resolution). Synthesis stages: splat (fastwarp.splat),
flowback (the unmasked gathers and the resizes), gather (the masked
gathers), unet (refine_unet_s2d_core), blend (blend6_out).

Timing: on the card by CUDA events around each run, on the CPU
(device="cpu", for tests) by the host clock; one untimed pass per variant,
then n rounds, each running every variant once; a variant's ms is its
median, its delta the median over rounds of the whole minus the variant,
with the quartile spread of those differences. The whole runs with the
port's stage spans recording (utils/trace.py, SPANS): a stage's span is
the card's time inside its span, summed over its calls (the median over
rounds). A delta is what the pipeline pays for the stage (less than its
kernels' time where the card waits for the host anyway); a span is at
least the stage's device time, so a floor above it is a miscount. One
JSON object goes to stdout (and --out), the input of
`python -m fldrx_torch.tools.roofline --measured`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bench_inputs import bench_frames, deploy_config
from ..eval import pipeline
from ..model import fldrnet
from ..ops import fastwarp
from ..utils import trace

# stage → [(module, function name, predicate on the sizes or None)]; a
# predicate takes (frame hw, args, kwargs) and says whether to stub the call
Target = Tuple[object, str, Optional[Callable]]


def _resize_to(which: str) -> Callable:
    def when(hw, args, kw):
        out = tuple(int(v) for v in (args[1] if len(args) > 1
                                     else kw["out_hw"]))
        full = (hw[0], hw[1])
        return out == (full if which == "full" else (hw[0] // 2, hw[1] // 2))
    return when


def _masked(want: bool) -> Callable:
    def when(hw, args, kw):
        return bool(args[3] if len(args) > 3 else kw.get("mask", False)) \
            == want
    return when


FLOW_STUBS: Dict[str, List[Target]] = {
    "pyramid": [(pipeline, "resize_2d", None)],
    "features": [(fldrnet, "extract_features", None)],
    "levels": [(fldrnet, "level_flow", None)],
    "z": [(fldrnet, "z_metrics", None),
          (fldrnet, "resize_2d", _resize_to("half"))],
    "pack": [(fldrnet, "resize_2d", _resize_to("full"))],
}
SYNTH_STUBS: Dict[str, List[Target]] = {
    "splat": [(fastwarp, "splat", None)],
    "flowback": [(fastwarp, "gather", _masked(False)),
                 (fldrnet, "resize_2d", None)],
    "gather": [(fastwarp, "gather", _masked(True))],
    "unet": [(fldrnet, "refine_unet_s2d_core", None)],
    "blend": [(fldrnet, "blend6_out", None)],
}
# stage → the path of its span (utils/trace.py)
SPANS = {"pyramid": "flow/pyramid", "features": "flow/features",
         "levels": "flow/levels", "z": "flow/extras/z",
         "pack": "flow/extras/pack",
         **{k: f"synth/{k}" for k in SYNTH_STUBS}}


def _zeros(x):
    if torch.is_tensor(x):
        return torch.zeros_like(x)
    return type(x)(_zeros(v) for v in x)


class Stubbed:
    """Inside the block, each target of one stage returns zeros of its
    output at that call (by call order), recorded from the real function
    on the first pass, where the predicate holds; leaving the block
    restores the targets. Reusable: the zeros stay made."""

    def __init__(self, stage: str, targets: Sequence[Target],
                 hw: Tuple[int, int]):
        self.stage, self.targets = stage, list(targets)
        self.hw = hw
        self.zeros: List[List] = [[] for _ in targets]
        self.recorded = False
        self.calls: List[int] = [0] * len(targets)
        self.saved: List[Tuple[object, str, Callable]] = []

    def wrap(self, i, real, when):
        def stub(*args, **kw):
            if when is not None and not when(self.hw, args, kw):
                return real(*args, **kw)
            k = self.calls[i]
            self.calls[i] += 1
            if not self.recorded:
                self.zeros[i].append(_zeros(real(*args, **kw)))
            return self.zeros[i][k]
        return stub

    def __enter__(self):
        self.calls = [0] * len(self.calls)
        self.saved = []
        for i, (m, name, when) in enumerate(self.targets):
            real = getattr(m, name)
            self.saved.append((m, name, real))
            setattr(m, name, self.wrap(i, real, when))
        return self

    def __exit__(self, *exc):
        # in reverse order: two targets may wrap one function
        for m, name, real in reversed(self.saved):
            setattr(m, name, real)
        if exc[0] is None:
            idle = [name for (_, name, _), n in zip(self.targets, self.calls)
                    if n == 0]
            if idle:
                raise RuntimeError(f"stubs never called on this path: {idle}")
            self.recorded = True
        return False


class Spans:
    """Inside the block the port's spans record (a fresh store each time);
    `take()` gives each stage's device ms in its span, summed over its
    calls (on the CPU, host ms)."""

    def __init__(self, stages: Sequence[str]):
        self.paths = {k: SPANS[k] for k in stages}
        self._rec = None

    def __enter__(self):
        trace.clear()
        self._rec = trace.recording()
        self._rec.__enter__()
        return self

    def __exit__(self, *exc):
        return self._rec.__exit__(*exc)

    def take(self) -> Dict[str, float]:
        snap = trace.snapshot()
        return {k: snap[p]["device_ms"] if p in snap else 0.0
                for k, p in self.paths.items()}


def timer_for(dev: torch.device) -> Callable[[Callable], float]:
    """ms of one call: CUDA events on a card, the host clock on the CPU."""
    if dev.type == "cuda":
        def run(fn):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
    else:
        def run(fn):
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
    return run


def ablate(fn: Callable, stubs: Dict[str, List[Target]],
           hw: Tuple[int, int], n: int, dev: torch.device) -> dict:
    """fn whole (with each stage's span) and with each stage stubbed: one
    untimed pass each, then n rounds of all of them."""
    timer = timer_for(dev)
    spans = Spans(list(stubs))
    variants = {"whole": spans}
    variants.update({k: Stubbed(k, t, hw) for k, t in stubs.items()})
    for ctx in variants.values():
        with ctx:
            fn()
    spans.take()
    times: Dict[str, List[float]] = {k: [] for k in variants}
    span_runs: Dict[str, List[float]] = {k: [] for k in stubs}
    for _ in range(n):
        for k, ctx in variants.items():
            with ctx:
                times[k].append(timer(fn))
        for k, v in spans.take().items():
            span_runs[k].append(v)
    whole = np.asarray(times["whole"])
    out = {"whole_ms": float(np.median(whole)),
           "whole_runs_ms": times["whole"], "variants": {}}
    for k in stubs:
        d = whole - np.asarray(times[k])
        q1, q3 = np.percentile(d, [25, 75])
        out["variants"][k] = {"ms": float(np.median(times[k])),
                              "delta_ms": float(np.median(d)),
                              "delta_spread_ms": float(q3 - q1),
                              "span_ms": float(np.median(span_runs[k]))}
    return out


def run(device=None, hw: Tuple[int, int] = (2160, 4096), n: int = 7,
        t_values: Optional[Sequence[float]] = None) -> dict:
    """The probe on `device` (default cuda); returns its JSON record."""
    from ..api import prepare_model
    from ..bench import card_line, t_values as bench_ts
    from ..device import resolve_device

    dev = resolve_device(device)
    cfg = deploy_config()
    interp = prepare_model(cfg=cfg, device=dev)[0]
    frames = torch.as_tensor(bench_frames(*hw)).to(dev)
    ts = list(bench_ts() if t_values is None else t_values)
    flow, padded, extras = interp.precompute_flow(frames)
    Hp, Wp = padded.shape[2], padded.shape[3]
    chunk = max(1, cfg.t_chunk)

    def flow_pass():
        interp.precompute_flow(frames)

    def synth_pass():
        for k in range(0, len(ts), chunk):
            interp.synthesize_multi_at(flow, padded, ts[k:k + chunk], hw,
                                       extras, planes_out=False)

    return {"tool": "perfprobe2", "device": dev.type,
            "card": card_line() if dev.type == "cuda" else "cpu",
            "hw": list(hw), "padded": [Hp, Wp], "t_per_pair": len(ts),
            "t_chunk": chunk, "n": n,
            "flow": ablate(flow_pass, FLOW_STUBS, (Hp, Wp), n, dev),
            "synthesis": ablate(synth_pass, SYNTH_STUBS, (Hp, Wp), n, dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", nargs=2, type=int, default=(2160, 4096),
                    metavar=("H", "W"))
    ap.add_argument("--n", type=int, default=7, help="timed rounds")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    rec = run(hw=tuple(args.hw), n=args.n)
    for part in ("flow", "synthesis"):
        r = rec[part]
        print(f"{part}: whole {r['whole_ms']:.3f} ms a pair", flush=True)
        for k, v in r["variants"].items():
            print(f"  -{k:11s} {v['ms']:9.3f} ms  (delta {v['delta_ms']:+.3f}"
                  f" ± {v['delta_spread_ms']:.3f}; span {v['span_ms']:.3f})",
                  flush=True)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
