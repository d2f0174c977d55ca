"""Parity evidence (counterpart of fldrx/tools/parity_report.py):

  1. the strict path (float32, fast_warp off) against a torch oracle of
     the reference (tools/reference_oracle.py, on the CPU) at 768×1280,
     S_tst = 5, t = 0.375, both on one pyramid. The oracle reads the
     reference state dict: of `--oracle SRC.pt`, or by default of
     checkpoints/fldrnet_best.npz through convert_ckpt.params_to_state_dict;
  2. the fast warps and the packed synthesis's values in float32 against
     the strict path, on naturalistic moving content at 2160×4096;
  3. bf16 compute (flow path and refine UNet) on top of them, against the
     strict path and against fast float32.

Writes the readings as markdown to `--out` (default PARITY_gen.md).

Usage:
    python -m fldrx_torch.tools.parity_report [--hw 2160 4096]
        [--device cpu] [--out PARITY_gen.md] [--skip-oracle]
        [--oracle SRC.pt]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from ..api import DEFAULT_NPZ, prepare_model
from ..config import FLDRConfig, papermodel_test5

# measurement 1's setting, PARITY.md §1's
ORACLE_HW = (768, 1280)
ORACLE_T = 0.375


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


def strict_config() -> FLDRConfig:
    """The strict path: papermodel_test5 in float32 with the exact warps."""
    return papermodel_test5().replace(compute_dtype="float32",
                                      fast_warp=False)


def oracle_state_dict(src: Optional[str] = None):
    """(the reference state dict as CPU tensors, the name of its source):
    a reference .pt through load_reference_state_dict, or with `src` None
    the in-repo .npz through params_to_state_dict."""
    import torch

    from .convert_ckpt import load_reference_state_dict, params_to_state_dict
    from ..weights import load_npz

    if src is not None:
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"measurement 1 needs the reference checkpoint; {src} is "
                "absent")
        sd, _ = load_reference_state_dict(src)
        name = src
    else:
        tree, extras, _ = load_npz(DEFAULT_NPZ)
        sd = params_to_state_dict(tree, extras)
        name = os.path.join("checkpoints", os.path.basename(DEFAULT_NPZ))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, name


def measure_oracle(configs: Optional[Mapping[str, FLDRConfig]] = None,
                   device=None, src: Optional[str] = None) -> Dict:
    """Measurement 1: each configuration of `configs` (default the strict
    path; all at papermodel_test5's S_tst = 5) on `device` against the
    reference's oracle on the CPU, on one pyramid of natural_frames(768,
    1280, shift=10) at t = 0.375. Returns
    {"source", "hw", "S_tst", "oracle_s", name: {"max_abs", "mean_abs",
    "psnr_db", "s"}}: differences of the [-1, 1] outputs, the seconds of
    each run (its output on the host)."""
    import torch

    from ..eval.pipeline import build_pyramid
    from ..model.fldrnet import dtype_of, forward_test
    from .reference_oracle import oracle_forward_test

    configs = dict(configs or {"strict": strict_config()})
    sd, source = oracle_state_dict(src)
    # through prepare_model: its Interpolator turns TF32 off on the card
    # before the pyramid's resizes and the forward run (by PyTorch's
    # default cuDNN runs float32 convs in TF32, which rounds their inputs
    # to 10 mantissa bits)
    models = {name: prepare_model(DEFAULT_NPZ, cfg, device)[0]
              for name, cfg in configs.items()}
    first = next(iter(models.values()))
    S_tst = first.cfg.S_tst
    frames = natural_frames(*ORACLE_HW, shift=10)
    t = np.full((1, 1), ORACLE_T, np.float32)
    with torch.inference_mode():
        pyr = build_pyramid(torch.from_numpy(frames).to(first.device),
                            first.cfg, S_tst + 1)
        tdev = torch.from_numpy(t).to(first.device)
        out = {"source": source, "hw": list(ORACLE_HW), "S_tst": S_tst}
        t0 = time.time()
        ref = oracle_forward_test(
            sd, [p.permute(0, 4, 1, 2, 3).cpu().numpy() for p in pyr], t,
            S_tst)                                     # NCTHW, as the oracle
        out["oracle_s"] = time.time() - t0
        for name, interp in models.items():
            t0 = time.time()
            got = forward_test(interp.params, interp.cfg, pyr, tdev,
                               compute_dtype=dtype_of(interp.cfg.compute_dtype))
            got = np.moveaxis(got.float().cpu().numpy(), -1, 1)
            d = np.abs(got - ref)
            out[name] = {"max_abs": float(d.max()),
                         "mean_abs": float(d.mean()),
                         "psnr_db": psnr_between(got, ref),
                         "s": time.time() - t0}
    return out


def report(p: Dict[str, float], hw: Sequence[int], card: str,
           oracle: Optional[Dict] = None) -> str:
    H, W = hw
    lines = [
        "# PARITY — the port against the reference's oracle and its fast "
        "configurations against its strict path",
        ""]
    if oracle is not None:
        oh, ow = oracle["hw"]
        r = oracle["strict"]
        lines += [
            f"## 1. Strict path against the torch oracle of the reference "
            f"({oh}×{ow}, S_tst = {oracle['S_tst']}, t = {ORACLE_T})",
            "",
            f"The reference state dict of {oracle['source']}; the oracle "
            f"(tools/reference_oracle.py) on the CPU, the port on {card}, "
            f"one pyramid of the same content panned by 10 px.",
            "",
            f"- max abs diff: **{r['max_abs']:.2e}**, mean abs diff: "
            f"{r['mean_abs']:.2e}",
            f"- PSNR(port strict, oracle): **{r['psnr_db']:.2f} dB**",
            ""]
    return "\n".join(lines + [
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
    ap.add_argument("--skip-oracle", action="store_true",
                    help="skip measurement 1")
    ap.add_argument("--oracle", metavar="SRC.pt", default=None,
                    help="measurement 1 on the reference checkpoint's state "
                         "dict (default: the in-repo .npz's)")
    a = ap.parse_args(argv)
    oracle = None
    if not a.skip_oracle:
        oracle = measure_oracle(device=a.device, src=a.oracle)
        r = oracle["strict"]
        print(f"oracle ({oracle['source']}): max {r['max_abs']:.3e} mean "
              f"{r['mean_abs']:.3e} psnr {r['psnr_db']:.2f} dB")
    p = measure(a.hw, a.device)
    card = "the CPU"
    import torch
    if torch.device(a.device or "cuda").type == "cuda":
        card = torch.cuda.get_device_name(0)
    for k, v in p.items():
        print(f"{k}: {v:.2f} dB")
    with open(a.out, "w") as f:
        f.write(report(p, a.hw, card, oracle))
    print(f"{a.out} written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
