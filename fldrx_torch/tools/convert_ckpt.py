"""Convert the reference PyTorch checkpoints to the .npz parameter files
that the port (`weights.load_npz`, `weights.load_pwc_npz`) and fldrx read
(counterpart of fldrx/tools/convert_ckpt.py).

fLDRnet: the reference's `save_manager` dict (a torch .pt whose pickle
names the reference's `pca_comp.DCTParams` and `useful.MYPCA` classes,
stubbed here so that no reference code is imported). Conv weights
[O, I, kh, kw] become HWIO, float64 scalars and PCA tensors float32; the
per-scale PCA fits go under `pca_multi` and, flat, under `__extra__/`; the
training record under `__meta__/`. `params_to_state_dict` goes back, from
a converted tree to the state dict the reference's oracle reads.

PWC-Net (`--pwc`): the teacher's state dict through
`weights.convert_pwc_state_dict`, written in fldrx's layout (conv weights
HWIO, deconv weights flipped HWIO).

Usage:
    python -m fldrx_torch.tools.convert_ckpt SRC.pt [DST.npz]
    python -m fldrx_torch.tools.convert_ckpt --pwc SRC.pt [DST.npz]
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np
import torch

from ..weights import (convert_pwc_state_dict, flatten_params,
                       params_to_numpy)

DEFAULT_DST = os.path.join("checkpoints", "fldrnet_best.npz")
DEFAULT_PWC_DST = os.path.join("checkpoints", "pwc_teacher.npz")
META_KEYS = ("last_epoch", "best_PSNR", "trainLoss", "testLoss", "testPSNR")


def _stub_reference_modules() -> None:
    """Register stand-ins for the classes the .pt pickle names, so that
    torch.load works without the reference's code."""
    if "pca_comp" not in sys.modules:
        pm = types.ModuleType("pca_comp")

        class DCTParams:           # noqa: N801 - the pickle's name
            pass

        class DCTParamsAdap:       # noqa: N801
            pass

        pm.DCTParams = DCTParams
        pm.DCTParamsAdap = DCTParamsAdap
        sys.modules["pca_comp"] = pm
    if "useful" not in sys.modules:
        um = types.ModuleType("useful")

        class MYPCA:               # noqa: N801
            pass

        um.MYPCA = MYPCA
        sys.modules["useful"] = um


def load_reference_state_dict(path: str):
    """(state dict {name: numpy array}, meta {name: value}) of a reference
    `save_manager` checkpoint."""
    _stub_reference_modules()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().numpy() for k, v in ckpt["state_dict_Model"].items()}
    return sd, {k: ckpt[k] for k in META_KEYS}


def _conv(sd, name, dtype):
    return {"w": np.transpose(sd[f"{name}.weight"].astype(dtype),
                              (2, 3, 1, 0)),              # OIHW → HWIO
            "b": sd[f"{name}.bias"].astype(dtype)}


def state_dict_to_params(sd, dtype=np.float32):
    """(numpy parameter tree in fldrx's layout, extras) from the reference
    state dict. The checkpoint holds every tensor twice (vfinet.* and
    base_modules.1.*); the vfinet.* names are read."""
    def pca(s):
        return {"mean": sd[f"Mean{s}"].astype(dtype),
                "ev": sd[f"EV{s}"].astype(dtype),
                "mean_vec": sd[f"meanVec{s}"].astype(dtype)}

    p = {
        "pca": pca(8),
        "rec_ctx": {"conv0": _conv(sd, "rec_ctx_ds.0", dtype),
                    "conv1": _conv(sd, "rec_ctx_ds.2", dtype)},
        "vfinet": {
            "T_param": sd["vfinet.T_param"].astype(dtype),
            "z_alpha": sd["vfinet.z_alpha"].astype(dtype),
            "flow_bottom": [_conv(sd, f"vfinet.conv_flow_bottom.{i}", dtype)
                            for i in (0, 2, 4, 6, 8)],
            "conv_flow1": _conv(sd, "vfinet.conv_flow1", dtype),
            "conv_flow2": [_conv(sd, f"vfinet.conv_flow2.{i}", dtype)
                           for i in (0, 2, 4, 6, 8)],
            "refine": {k: _conv(sd, f"vfinet.refine_unet.{k}", dtype)
                       for k in ("enc1", "enc2", "enc3", "dec0", "dec1",
                                 "dec2", "dec3")},
        },
    }
    # the per-scale fits, read when cfg.exac_one_ev is false; s8 is pca's
    p["pca_multi"] = {f"s{s}": pca(s) for s in (8, 16, 32, 64)}
    p["pca_multi"]["s8"] = dict(p["pca"])
    extras = {}
    for s in (16, 32, 64):
        for k, v in zip(("Mean", "EV", "meanVec"),
                        (p["pca_multi"][f"s{s}"][n]
                         for n in ("mean", "ev", "mean_vec"))):
            extras[f"{k}{s}"] = v
    return p, extras


def params_to_state_dict(tree, extras):
    """The reference state dict {name: numpy array} of a numpy parameter
    tree and its extras, as `weights.load_npz` returns them: the inverse of
    `state_dict_to_params` on the names it reads (vfinet.*, rec_ctx_ds.*,
    Mean/EV/meanVec at 8, 16, 32 and 64; not the base_modules.1.* copies).
    Conv weights go from HWIO back to OIHW."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = np.ascontiguousarray(
            np.transpose(p["w"], (3, 2, 0, 1)))           # HWIO → OIHW
        sd[f"{name}.bias"] = np.asarray(p["b"])

    conv("rec_ctx_ds.0", tree["rec_ctx"]["conv0"])
    conv("rec_ctx_ds.2", tree["rec_ctx"]["conv1"])
    v = tree["vfinet"]
    sd["vfinet.T_param"] = np.asarray(v["T_param"])
    sd["vfinet.z_alpha"] = np.asarray(v["z_alpha"])
    for i, p in zip((0, 2, 4, 6, 8), v["flow_bottom"]):
        conv(f"vfinet.conv_flow_bottom.{i}", p)
    conv("vfinet.conv_flow1", v["conv_flow1"])
    for i, p in zip((0, 2, 4, 6, 8), v["conv_flow2"]):
        conv(f"vfinet.conv_flow2.{i}", p)
    for k, p in v["refine"].items():
        conv(f"vfinet.refine_unet.{k}", p)
    for k, n in (("Mean", "mean"), ("EV", "ev"), ("meanVec", "mean_vec")):
        sd[f"{k}8"] = np.asarray(tree["pca"][n])
        for s in (16, 32, 64):
            sd[f"{k}{s}"] = np.asarray(extras[f"{k}{s}"])
    return sd


def save_npz(path: str, tree, extras=None, meta=None) -> None:
    """Write a numpy parameter tree as the flat .npz that `weights.load_npz`
    reads: slash-joined names, `__extra__/` and `__meta__/` prefixes."""
    flat = flatten_params(tree)
    flat.update({f"__extra__/{k}": v for k, v in (extras or {}).items()})
    flat.update({f"__meta__/{k}": np.asarray(v)
                 for k, v in (meta or {}).items()})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def convert(src: str, dst: str = DEFAULT_DST) -> str:
    """The reference fLDRnet checkpoint `src` → `dst`."""
    sd, meta = load_reference_state_dict(src)
    params, extras = state_dict_to_params(sd)
    save_npz(dst, params, extras, meta)
    return dst


def pwc_tree_to_numpy(tree):
    """The port's teacher tree → fldrx's numpy layout: conv weights HWIO,
    the decoders' deconv weights flipped HWIO (the inverse of
    `weights.pwc_params_from_numpy`)."""
    out = params_to_numpy(tree)
    for name, dec in tree.items():
        if not name.startswith("dec"):
            continue
        for k in ("upflow", "upfeat"):
            if k in dec:
                w = dec[k]["w"].detach().cpu().numpy()    # [in, out, kh, kw]
                out[name][k]["w"] = np.flip(w, (2, 3)).transpose(
                    2, 3, 0, 1).copy()
    return out


def convert_pwc(src: str, dst: str = DEFAULT_PWC_DST) -> str:
    """The reference PWC-Net checkpoint `src` (a state dict, or a module
    with one) → `dst`."""
    sd = torch.load(src, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    save_npz(dst, pwc_tree_to_numpy(convert_pwc_state_dict(sd, "cpu")))
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fldrx_torch.tools.convert_ckpt",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--pwc", action="store_true",
                    help="convert the PWC-Net teacher checkpoint")
    ap.add_argument("src")
    ap.add_argument("dst", nargs="?")
    a = ap.parse_args(argv)
    if a.pwc:
        out = convert_pwc(a.src, a.dst or DEFAULT_PWC_DST)
    else:
        out = convert(a.src, a.dst or DEFAULT_DST)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
