"""Single operations of the 4K synthesis timed on the card (counterpart of
fldrx/tools/perfprobe.py).

    python -m fldrx_torch.tools.perfprobe [--hw H W] [--n N]

On the repository's checkpoint in the deploy mix, at the padded frame of
H×W (2304×4096 for the default 2160×4096): the softmax splat of 3 channels
plus z (values, splat kernel, normalisation), the bwarp of 3 channels
(gather kernel with the mask), the refine UNet in its s2d form in bf16 on
26 channels, the flow precompute of bench.py's texture pair, and
synthesize_at at one t. Each is timed by CUDA events (on the CPU, for
tests, by the host clock), one untimed call first, the median of n.
Prints a line per operation and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Tuple

import numpy as np
import torch

from ..bench_inputs import bench_frames, deploy_config
from ..model.fldrnet import refine_unet_s2d
from ..ops import fastwarp
from ..ops.pad import pad_amount
from ..ops.splat import softsplat_norm, softsplat_vals
from .perfprobe2 import timer_for


def run(device=None, hw: Tuple[int, int] = (2160, 4096), n: int = 5) -> dict:
    """The probe on `device` (default cuda); returns its JSON record."""
    from ..api import prepare_model
    from ..bench import card_line
    from ..device import resolve_device

    dev = resolve_device(device)
    cfg = deploy_config()
    interp = prepare_model(cfg=cfg, device=dev)[0]
    H = hw[0] + pad_amount(hw[0], cfg.div_pad)
    W = hw[1] + pad_amount(hw[1], cfg.div_pad)
    g = torch.Generator().manual_seed(0)
    img3 = (torch.rand(1, H, W, 3, generator=g) * 2 - 1).to(dev)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    flow = torch.as_tensor(np.stack([30 * np.sin(yy / 400),
                                     18 * np.cos(xx / 500)], -1)[None]).to(dev)
    z = torch.rand(1, H, W, 1, generator=g).to(dev)
    x26 = torch.rand(1, H, W, 26, generator=g).to(dev, torch.bfloat16)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    rp = interp.params["vfinet"]["refine"]
    frames = torch.as_tensor(bench_frames(*hw)).to(dev)
    flow_l, padded, extras = interp.precompute_flow(frames)
    timer = timer_for(dev)

    def median(fn):
        with torch.inference_mode():
            fn()
            return float(np.median([timer(fn) for _ in range(n)]))

    ops = {
        "softsplat 3ch+z": lambda: softsplat_norm(fastwarp.splat(
            softsplat_vals(img3, z), xs + flow[..., 0], ys + flow[..., 1])),
        "bwarp 3ch": lambda: fastwarp.bwarp_diff(img3, flow),
        "s2d UNet bf16": lambda: refine_unet_s2d(rp, x26),
        "flow precompute": lambda: interp.precompute_flow(frames),
        "synthesize_at": lambda: interp.synthesize_at(
            flow_l, padded, [[0.5]], hw, extras),
    }
    return {"tool": "perfprobe", "device": dev.type,
            "card": card_line() if dev.type == "cuda" else "cpu",
            "hw": list(hw), "padded": [H, W], "n": n,
            "ms": {k: median(f) for k, f in ops.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", nargs=2, type=int, default=(2160, 4096),
                    metavar=("H", "W"))
    ap.add_argument("--n", type=int, default=5)
    args = ap.parse_args(argv)
    rec = run(hw=tuple(args.hw), n=args.n)
    for k, v in rec["ms"].items():
        print(f"{k:18s} {v:9.3f} ms", flush=True)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
