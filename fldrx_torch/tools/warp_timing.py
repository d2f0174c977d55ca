"""The warp kernels' and the correlation's rows of chip_smoke.py phase 2 —
the gather, the splat, gather_grad, splat_grad and the correlation, each
checked against its plain version, then timed through the wrapper, as the
bare launch, as the plain version and as the library call — for the
fldrx_torch package of any checkout, so that two checkouts can be timed
in one run on one card:

    python fldrx_torch/tools/warp_timing.py [--root DIR] [--out FILE]
        [--kernels gather,splat,gather_grad,splat_grad,correlation]

--root is the checkout whose fldrx_torch is timed (default: this one); its
gather and splat entry points must take the `route` argument that
`fastwarp._route` picks (the correlation's entry point has kept its
arguments). --kernels times only the kernels named (default: the four
warp kernels). The rows and their timing are always this checkout's
chip_smoke.py. Prints one JSON line: the card, the root and the rows;
--out also writes it to a file. Needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--out")
    ap.add_argument("--kernels", default="gather,splat,gather_grad,splat_grad")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("warp_timing: no CUDA device", file=sys.stderr)
        return 1
    import fldrx_torch
    if os.path.dirname(os.path.dirname(fldrx_torch.__file__)) != root:
        raise RuntimeError(f"fldrx_torch came from {fldrx_torch.__file__}, "
                           f"not from {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = smoke.card_line()
    peaks = smoke.peaks_for(card)[1]
    kernels = tuple(args.kernels.split(","))
    unknown = set(kernels) - set(smoke.WARP_KERNELS) - {"correlation"}
    if unknown:
        raise SystemExit(f"warp_timing: unknown kernels {sorted(unknown)}")
    rows = smoke.warp_rows(peaks, kernels)
    if "correlation" in kernels:
        rows["correlation"] = smoke.correlation_rows(peaks)
    line = json.dumps({"card": card, "root": root, "rows": rows})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
