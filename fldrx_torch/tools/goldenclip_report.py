"""Golden-clip quality report (counterpart of
fldrx/tools/goldenclip_report.py): the ×8 protocol on the deterministic
golden scene (large motion, occlusion, analytic ground truth) for each
deployable configuration, beside the naive frame-average baseline.

Usage:
    python -m fldrx_torch.tools.goldenclip_report [--deploy-only]
        [--families] [--hw 2160 4096] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Sequence

import numpy as np

from ..api import DEFAULT_NPZ, prepare_model
from ..config import papermodel_test5
from ..eval.goldenclip import GOLDEN_FAMILIES, golden_pair, golden_psnrs
from ..ops import metrics

# f32 configurations synthesise one t at a time, as fldrx runs them
CONFIGS = (
    ("strict (fast_warp=False, f32)",
     dict(fast_warp=False, compute_dtype="float32", t_chunk=1)),
    ("fast-f32",
     dict(fast_warp=True, packed_synth=True, compute_dtype="float32",
          t_chunk=1)),
    ("fast mixed (f32 flow + bf16 UNet)",
     dict(fast_warp=True, packed_synth=True, compute_dtype="bfloat16",
          flow_dtype="float32")),
    ("fast-bf16 (all-bf16)",
     dict(fast_warp=True, packed_synth=True, compute_dtype="bfloat16")),
)
DEPLOY = 2          # the deploy mix, bench.py's configuration


def naive_baseline(H: int, W: int, multiple: int = 8) -> float:
    """Mean PSNR of the average of the two input frames at every t."""
    frames, _, gts = golden_pair(H, W, multiple)
    avg = 0.5 * (frames[0, 0] + frames[0, 1])
    return float(np.mean([metrics.psnr(metrics.denorm255(g),
                                       metrics.denorm255(avg))
                          for g in gts]))


def main(deploy_only: bool = False, families: bool = False,
         hw: Sequence[int] = (2160, 4096), device=None) -> Dict[str, float]:
    """{"naive frame-average baseline": dB, configuration name: mean dB,
    …}: the deploy mix alone with `deploy_only`; with `families` also the
    other scene families for the strict and deploy configurations, as
    "name [family]"."""
    H, W = hw
    res = {"naive frame-average baseline": naive_baseline(H, W)}
    print(f"naive frame-average baseline: "
          f"{res['naive frame-average baseline']:.3f} dB", flush=True)
    configs = [CONFIGS[DEPLOY]] if deploy_only else list(CONFIGS)
    for name, over in configs:
        interp, _, _ = prepare_model(DEFAULT_NPZ,
                                     papermodel_test5().replace(**over),
                                     device)
        ps, res[name] = golden_psnrs(interp, H, W, 8)
        print(f"{name}: mean {res[name]:.4f} dB  per-t "
              f"{np.round(ps, 3).tolist()}", flush=True)
    if families:
        for name, over in (CONFIGS[0], CONFIGS[DEPLOY]):
            interp, _, _ = prepare_model(DEFAULT_NPZ,
                                         papermodel_test5().replace(**over),
                                         device)
            for fam in GOLDEN_FAMILIES[1:]:
                ps, mean = golden_psnrs(interp, H, W, 8, family=fam)
                res[f"{name} [{fam}]"] = mean
                print(f"{name} [{fam}]: mean {mean:.4f} dB  per-t "
                      f"{np.round(ps, 3).tolist()}", flush=True)
    return res


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fldrx_torch.tools.goldenclip_report")
    ap.add_argument("--deploy-only", action="store_true",
                    help="only the deploy mix (f32 flow, bf16 UNet)")
    ap.add_argument("--families", action="store_true",
                    help="also the affine, thin and flat scene families")
    ap.add_argument("--hw", type=int, nargs=2, default=(2160, 4096))
    ap.add_argument("--device", default=None, help="default cuda")
    a = ap.parse_args(argv)
    main(a.deploy_only, a.families, a.hw, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
