"""Demo, the reference's run_on_your_images.py main() (counterpart of
fldrx/eval/demo.py): walk an X-Test folder, interpolate 7 t values per
scene and report the running PSNR; without a dataset, interpolate a
translating synthetic pattern at 512×768.

Usage:
    python -m fldrx_torch.eval.demo [--device cpu] [X_test_dir] [out_dir]

Both functions run on `device` (default cuda) and write each prediction
as a PNG into `out_dir`, or none where `out_dir` is None.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from ..api import load_trans_frames, prepare_model, run_on_images

T_VALUES = [0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875]
SYNTHETIC_T = (0.25, 0.5, 0.75)
DEFAULT_OUT = os.path.join("GenFrames", "temptest")


def run_folder(x_test_dir: str, out_dir: Optional[str] = DEFAULT_OUT,
               device=None) -> float:
    """Mean PSNR over every scene of an X-Test-layout folder
    (TYPE/SCENE/0000.png … 0032.png) at the 7 t values."""
    model, cfg, dev = prepare_model(device=device)
    psnrs = []
    for type_dir in sorted(os.listdir(x_test_dir)):
        tpath = os.path.join(x_test_dir, type_dir)
        if not os.path.isdir(tpath):
            continue
        for scene in sorted(os.listdir(tpath)):
            spath = os.path.join(tpath, scene)
            imgs = sorted(os.listdir(spath),
                          key=lambda x: int(x.split(".")[0]))
            for t_val in T_VALUES:
                frames = load_trans_frames(
                    os.path.join(spath, imgs[0]),
                    os.path.join(spath, imgs[-1]),
                    os.path.join(spath, imgs[int(t_val * 32)]))
                psnrs.append(run_on_images(model, cfg, dev, frames,
                                           [[t_val]], out_dir, evalit=True))
                print(f"PSNR: {np.mean(psnrs):.4f}")
    return float(np.mean(psnrs)) if psnrs else 0.0


def synthetic_frames(t_val: float) -> np.ndarray:
    """[1, 3, 512, 768, 3]: the pattern, the pattern moved 16 px, and the
    pattern moved 16·t px (the target)."""
    H, W = 512, 768
    yy, xx = np.mgrid[0:H, 0:W]

    def img(sh):
        return np.stack([np.sin((xx + sh) / 23) + 0.3 * np.cos(yy / 17),
                         np.cos((xx + sh) / 31) * np.sin(yy / 13),
                         np.sin((xx + sh + yy) / 29)], -1).astype(
                             np.float32) * 0.5

    return np.stack([img(0), img(16), img(16 * t_val)], 0)[None]


def run_synthetic(out_dir: Optional[str] = DEFAULT_OUT,
                  device=None) -> List[float]:
    """The PSNR at each t of SYNTHETIC_T on the translating pattern (their
    mean is what fldrx's run_synthetic returns)."""
    model, cfg, dev = prepare_model(device=device)
    psnrs = []
    for t_val in SYNTHETIC_T:
        p = run_on_images(model, cfg, dev, synthetic_frames(t_val),
                          [[t_val]], out_dir, evalit=True)
        psnrs.append(float(p))
        print(f"t={t_val}: PSNR {p:.2f} dB")
    return psnrs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fldrx_torch.eval.demo")
    ap.add_argument("--device", default=None, help="default cuda")
    ap.add_argument("x_test_dir", nargs="?")
    ap.add_argument("out_dir", nargs="?", default=DEFAULT_OUT)
    a = ap.parse_args(argv)
    if a.x_test_dir and os.path.isdir(a.x_test_dir):
        run_folder(a.x_test_dir, a.out_dir, a.device)
    else:
        print("no X_test dir given — running the synthetic demo")
        run_synthetic(a.out_dir, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
