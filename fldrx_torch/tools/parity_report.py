"""Parity evidence (counterpart of fldrx/tools/parity_report.py): how far
the fast configurations move the 4K output from the strict float32 path.

  2. the fast warps and the packed synthesis's values in float32 against
     the strict path, on naturalistic moving content at 2160×4096;
  3. bf16 compute (flow path and refine UNet) on top of them, against the
     strict path and against fast float32.

Measurement 1 of fldrx's report, the strict path against a torch oracle
of the reference on its own checkpoint, needs the reference .pt, which
is not in the repository: `--oracle SRC.pt` refuses while the file is
absent.

Writes the readings as markdown to `--out` (default PARITY_gen.md).

Usage:
    python -m fldrx_torch.tools.parity_report [--hw 2160 4096]
        [--device cpu] [--out PARITY_gen.md] [--oracle SRC.pt]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Sequence

import numpy as np

from ..api import DEFAULT_NPZ, prepare_model
from ..config import papermodel_test5


def natural_frames(H: int, W: int, shift: float = 18) -> np.ndarray:
    """[1, 2, H, W, 3] float32: band-limited texture and the same texture
    panned by (shift, 0.6·shift) px."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    def tex(px, py):
        return (np.sin((xx + px) / 17) * np.cos((yy + py) / 23)
                + 0.5 * np.sin((xx + px) / 5.3) * np.sin((yy + py) / 7.1)
                + 0.3 * np.sin((xx - px) / 61) * np.cos((yy + py) / 47))

    f0 = np.stack([tex(0, 0), tex(9, 4), tex(3, 11)], -1)
    f1 = np.stack([tex(shift, shift * 0.6), tex(9 + shift, 4 + shift * 0.6),
                   tex(3 + shift, 11 + shift * 0.6)], -1)
    return np.stack([f0, f1], 0)[None].astype(np.float32) * 0.6


def psnr_between(a, b) -> float:
    """PSNR of two outputs in [-1, 1], mapped to [0, 1]."""
    mse = np.mean((np.asarray(a, np.float64) / 2
                   - np.asarray(b, np.float64) / 2) ** 2)
    return float(-10 * np.log10(max(mse, 1e-12)))


def fast_path_outputs(hw: Sequence[int] = (2160, 4096), t: float = 0.375,
                      device=None) -> Dict[str, np.ndarray]:
    """{"strict", "fast_f32", "fast_bf16": the output [1, H, W, 3]} of the
    checkpoint on natural_frames, one t, flow once per configuration."""
    H, W = hw
    frames = natural_frames(H, W)
    configs = {
        "strict": dict(compute_dtype="float32", fast_warp=False),
        "fast_f32": dict(compute_dtype="float32", fast_warp=True),
        "fast_bf16": dict(compute_dtype="bfloat16", fast_warp=True),
    }
    out = {}
    for name, over in configs.items():
        interp, _, _ = prepare_model(
            DEFAULT_NPZ, papermodel_test5().replace(**over), device)
        flow, padded, extras = interp.precompute_flow(frames)
        out[name] = interp.synthesize_at(flow, padded, [[t]], (H, W),
                                         extras).float().cpu().numpy()
        del interp, flow, padded, extras
    return out


def measure(hw: Sequence[int] = (2160, 4096), device=None) -> Dict[str, float]:
    """Measurements 2 and 3: {"fast_f32_vs_strict", "bf16_vs_strict",
    "bf16_vs_fast_f32"} in dB."""
    o = fast_path_outputs(hw, device=device)
    return {"fast_f32_vs_strict": psnr_between(o["fast_f32"], o["strict"]),
            "bf16_vs_strict": psnr_between(o["fast_bf16"], o["strict"]),
            "bf16_vs_fast_f32": psnr_between(o["fast_bf16"], o["fast_f32"])}


def report(p: Dict[str, float], hw: Sequence[int], card: str) -> str:
    H, W = hw
    return "\n".join([
        "# PARITY — the port's fast configurations against its strict path",
        "",
        f"Naturalistic band-limited moving content (a pan of about 18 px), "
        f"{H}×{W}, t = 0.375, the checkpoints/fldrnet_best.npz weights, "
        f"papermodel test5scales; {card}.",
        "",
        f"## 2. Fast warps and packed synthesis (float32) against the "
        f"strict path",
        "",
        f"- PSNR(fast-f32, strict-f32): **{p['fast_f32_vs_strict']:.2f} dB**",
        "",
        "## 3. bf16 compute (flow path and s2d UNet) on top of them",
        "",
        f"- PSNR(fast-bf16, strict-f32): **{p['bf16_vs_strict']:.2f} dB**",
        f"- PSNR(fast-bf16, fast-f32): {p['bf16_vs_fast_f32']:.2f} dB",
        "",
        "PSNR here is between two model outputs ([-1, 1] mapped to [0, 1]):",
        "a deviation of X dB moves a benchmark PSNR by about 10^(-X/10) in",
        "MSE terms.",
        ""])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fldrx_torch.tools.parity_report")
    ap.add_argument("--hw", type=int, nargs=2, default=(2160, 4096))
    ap.add_argument("--device", default=None, help="default cuda")
    ap.add_argument("--out", default="PARITY_gen.md")
    ap.add_argument("--oracle", metavar="SRC.pt", default=None,
                    help="measurement 1 against the reference checkpoint")
    a = ap.parse_args(argv)
    if a.oracle is not None:
        if not os.path.exists(a.oracle):
            raise FileNotFoundError(
                f"measurement 1 needs the reference checkpoint; {a.oracle} "
                "is absent")
        raise NotImplementedError(
            "measurement 1 (the oracle of the reference) is not ported")
    p = measure(a.hw, a.device)
    card = "the CPU"
    import torch
    if torch.device(a.device or "cuda").type == "cuda":
        card = torch.cuda.get_device_name(0)
    for k, v in p.items():
        print(f"{k}: {v:.2f} dB")
    with open(a.out, "w") as f:
        f.write(report(p, a.hw, card))
    print(f"{a.out} written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
