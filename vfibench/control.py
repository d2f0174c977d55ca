"""The readings that a cell's limits are set from: the program's on many
seeds, and the control's, the next precision below the one the
configuration states (its "control": the program's own lower-precision
path where it has one, TF32 on, or the reference with an int8 refine
UNet in the program's synthesis), at the cell's own size, in one process.

    python3 -m vfibench.control --workload x8_4k --seconds 3 \\
        --seeds 1 2 3 ... --control-seeds 101 102 103

Prints one JSON line a run: {"side", "seed", "checks": {name: value}}.
With --fault, also each named fault of vfibench/faults.py, planted in the
program, on the control seeds. The benchmark's own runs never run the
control or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from vfibench import catalog, drivers, faults
from vfibench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", action="append", default=[],
                    help="a fault of vfibench/faults.py to read on the "
                    "control seeds (repeatable)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = catalog.load_cell(args.workload)
    control = cell["config"]["control"]
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, control) for s in args.control_seeds]
    runs += [(f"fault:{f}", s, None) for f in args.fault
             for s in args.control_seeds]
    kind = drivers.load(cell["traffic"]["driver"]).Driver.kind
    for side, seed, ctl in runs:
        t = time.perf_counter()
        plant = (faults.planted(kind, side[6:]) if side.startswith("fault:")
                 else contextlib.nullcontext())
        with plant:
            res = run_cell(args.workload, seed, args.seconds, False,
                           control=ctl, t0=t)
        print(json.dumps({"side": side, "seed": seed,
                          "checks": {k: c["value"]
                                     for k, c in res["checks"].items()},
                          "attempted": res["attempted"],
                          "notes": res["_notes"].get("check_notes"),
                          "s": time.perf_counter() - t}), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
