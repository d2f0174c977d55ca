"""Run one cell of the benchmark on the machine's card and print its result.

    python3 vfibench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed from the start of this process to the first timed request):
the program's object for the cell, the inputs made from the seed on the
card, and warm-up requests of every shape the traffic uses. Then the
window: the traffic's requests one after another for `--seconds`. With
--trace 1 the window also records CUDA events around each call, and a few
more requests run under torch.profiler. After the window the peak memory
is read, the program's state is freed, and what the window produced is
compared with the plain reference (vfibench/reference/).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 breakdown, and last the
numbers compared with their limits, which also end standard error. Without
a CUDA card, or with fewer cards than the cell asks for, it prints no
result and exits 2; if jax, jaxlib, flax or fldrx has been imported by the
end of the window, 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if __package__ in (None, ""):
    # run as a script: the repository root on the path, not vfibench/
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != HERE]
    sys.path.insert(0, os.path.dirname(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "fldrx")


def forbidden_modules():
    """The forbidden top-level packages in sys.modules, compared by whole
    top-level name (fldrx_torch is not fldrx)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", here: str = None, control=None,
             t0: float = None) -> dict:
    """One run of cell `name`; returns the result object (without printing).
    `control`, the configuration's "control", runs the control in the
    program's place; `here` is the vfibench directory to read parts
    from."""
    import torch

    from vfibench import catalog, drivers, peaks

    t0 = _T0 if t0 is None else t0
    cell = catalog.load_cell(name, here or catalog.HERE)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mod = drivers.load(cell["traffic"]["driver"])
    drv = mod.Driver(cell, dev, seed, control=control)
    start_s = time.perf_counter() - t0
    drv.setup()
    setup_s = time.perf_counter() - t0
    marks = drivers.Marks(dev) if trace else None
    win = drv.window(seconds, marks)
    mem = torch.cuda.max_memory_allocated(dev) if on_card else 0
    tr = None
    if trace:
        tr = _traced(drv, dev)
    drv.release()
    t_check = time.perf_counter()
    checks = drv.check()
    check_s = time.perf_counter() - t_check
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    pk = peaks.peaks(kind) if on_card else None
    metrics = {}
    if not trace:
        values = dict(win["e2e"], setup_s=setup_s,
                      peak_mem_gib=mem / 2 ** 30)
        for m, d in cell["e2e"].items():
            # a metric may name the quantity a driver measures, where cells
            # of different noise report it under names (and bounds) of
            # their own
            metrics[m] = {"value": values[d.get("quantity", m)],
                          "unit": d["unit"]}
    else:
        rec = {"kind": drv.kind, "layers": win["layers"],
               "work": drv.work(pk) if pk else None,
               "trace": tr if tr["busy_s"] > 0 else None}
        for m, reader in cell["layers"].items():
            v = reader.read(rec)
            if v is not None:
                metrics[m] = {"value": v, "unit": reader.UNIT}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": win["requests"], "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": 1 if on_card else 0,
                         "memory_peak_bytes": mem}}
    if tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    # a comparison that could not be made reads as the largest float
    result["checks"] = {k: {"value": v if math.isfinite(v) else 1e308,
                            "limit": lim} for k, (v, lim) in checks.items()}
    result["_notes"] = dict(win.get("notes", {}), setup_s=setup_s,
                            start_s=start_s, check_s=check_s,
                            check_notes=getattr(drv, "check_notes", None),
                            setup_parts=getattr(drv, "setup_parts", None),
                            window_s=win["window_s"],
                            peaks=pk and pk["part"])
    return result


def _traced(drv, dev) -> dict:
    """The traced window: drv.trace_requests() requests with the device
    alone recorded (busy_s, window_s by the host clock, the top device
    operations), then a quarter as many with the host's spans (the
    labelled idle gaps)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vfibench import devtrace, drivers

    on_card = dev.type == "cuda"
    n = drv.trace_requests()
    drivers.sync(dev)
    with profile(activities=[ProfilerActivity.CUDA] if on_card
                 else [ProfilerActivity.CPU]) as prof:
        # the window from one synchronisation to the next, inside the
        # profiler's start and stop
        t = time.perf_counter()
        drv.traced(n)
        drivers.sync(dev)
        window_s = time.perf_counter() - t
    ops, _ = devtrace.events(prof)
    out = dict(devtrace.busy(ops), window_s=window_s)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            drv.traced(max(1, n // 4))
            drivers.sync(dev)
    ops, spans = devtrace.events(prof, drv.SPANS)
    out["idle_gaps"] = devtrace.idle_gaps(ops, spans)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from vfibench import catalog, peaks

    if not torch.cuda.is_available():
        print("vfibench: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    chips = catalog.load_json("cells", args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"vfibench: {args.workload} needs {chips} cards, the machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"vfibench: the process imported {found}", file=sys.stderr)
        return 3
    notes = res.pop("_notes")
    print(f"vfibench: {args.workload} seed {args.seed} on {peaks.power_limit()}"
          f" ({notes.pop('peaks')} peaks): {json.dumps(notes)}",
          file=sys.stderr)
    for k, c in res["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"{k} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
