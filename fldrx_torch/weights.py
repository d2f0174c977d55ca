"""Checkpoint loading for the port.

`checkpoints/fldrnet_best.npz` holds 59 flat keys ("vfinet/refine/enc1/w",
"__extra__/EV16", "__meta__/best_PSNR", ...): a slash-joined parameter tree
whose conv weights are HWIO. `load_npz` reads it with numpy and rebuilds the
tree; `params_from_numpy` turns any such tree (the checkpoint's, or a JAX
`init_params` tree carried across as numpy) into the port's parameters:
the same nested dict of torch tensors, with every conv weight transposed to
the OIHW layout that `F.conv2d` consumes. `params_to_numpy` is its inverse,
and `flatten_params`/`unflatten_params` map a tree to and from the flat
slash-joined names, so the port writes checkpoints that fldrx reads.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .device import resolve_device


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(flat name, leaf) pairs of a nested dict/list tree, in tree order;
    names are slash-joined keys and list indices ("vfinet/refine/enc1/w")."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def flatten_params(tree) -> Dict[str, np.ndarray]:
    """Tree → {flat name: numpy array}."""
    return {k: np.asarray(v) for k, v in named_leaves(tree)}


def unflatten_params(flat: Dict[str, np.ndarray]):
    """{flat name: array} → nested dict/list tree (inverse of
    `flatten_params`)."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for pt in parts[:-1]:
            node = node.setdefault(pt, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def load_npz(path: str) -> Tuple[Any, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Returns (numpy parameter tree, extras, meta) from a flat .npz."""
    flat, extras, meta = {}, {}, {}
    with np.load(path) as z:
        for k in z.files:
            if k.startswith("__extra__/"):
                extras[k[len("__extra__/"):]] = z[k]
            elif k.startswith("__meta__/"):
                meta[k[len("__meta__/"):]] = z[k]
            else:
                flat[k] = z[k]
    return unflatten_params(flat), extras, meta


def params_from_numpy(tree, device=None, dtype=torch.float32):
    """Numpy parameter tree → the port's tree of tensors on `device` (None
    means cuda, `resolve_device`).

    A dict with a 4-D "w" is a conv: its HWIO weight becomes OIHW."""
    return _tensors(tree, resolve_device(device), dtype)


def _tensors(tree, device, dtype):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            a = np.asarray(v) if not isinstance(v, (dict, list, tuple)) else None
            if k == "w" and a is not None and a.ndim == 4:
                out[k] = torch.tensor(np.transpose(a, (3, 2, 0, 1)),
                                      dtype=dtype, device=device)
            else:
                out[k] = _tensors(v, device, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, dtype) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


_PWC_DECONVS = ("upflow", "upfeat")


def pwc_params_from_numpy(tree, device=None):
    """fldrx's PWC-Net tree as numpy (conv weights HWIO, deconv weights
    fldrx's flipped HWIO, see fldrx/model/pwcnet.py
    deconv_weight_from_torch) → the port's teacher tree: conv weights OIHW,
    deconv weights torch's ConvTranspose2d [in, out, kh, kw] (the flip and
    transpose undone). `device` None means cuda (`resolve_device`)."""
    device = resolve_device(device)
    out = params_from_numpy(tree, device)
    for name, dec in out.items():
        for k in _PWC_DECONVS:
            if name.startswith("dec") and k in dec:
                w = np.asarray(tree[name][k]["w"])
                dec[k]["w"] = torch.tensor(
                    np.flip(w.transpose(2, 3, 0, 1), (2, 3)).copy(),
                    dtype=torch.float32, device=device)
    return out


def load_pwc_npz(path: str, device=None):
    """The teacher's weights from the npz that fldrx's converter writes
    (`python -m fldrx.tools.convert_ckpt --pwc`), read by its flat names;
    `device` None means cuda."""
    return pwc_params_from_numpy(load_npz(path)[0], device)


def convert_pwc_state_dict(sd, device=None):
    """The reference PWCNet state dict (OpticalFlow/PWCNet.py; values torch
    tensors or numpy arrays) → the port's teacher tree, with the key map of
    fldrx's convert_pwc_checkpoint. Conv and deconv weights keep torch's own
    layouts, which are the port's. `device` None means cuda."""
    device = resolve_device(device)

    def t(name):
        v = sd[name]
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        return torch.tensor(v, dtype=torch.float32, device=device)

    def cv(name):
        return {"w": t(f"{name}.weight"), "b": t(f"{name}.bias")}

    p = {"extractor": {}}
    names = ("One", "Two", "Thr", "Fou", "Fiv", "Six")
    for lv, nm in enumerate(names):
        p["extractor"][f"level{lv}"] = [
            cv(f"moduleExtractor.module{nm}.{i}") for i in (0, 2, 4)]
    for nm, level in (("Two", 2), ("Thr", 3), ("Fou", 4), ("Fiv", 5),
                      ("Six", 6)):
        base = f"module{nm}"
        d = {}
        if level < 6:
            d["upflow"] = cv(f"{base}.moduleUpflow")
            d["upfeat"] = cv(f"{base}.moduleUpfeat")
        for sub in ("One", "Two", "Thr", "Fou", "Fiv"):
            d[sub.lower()[:3]] = cv(f"{base}.module{sub}.0")
        d["six"] = cv(f"{base}.moduleSix.0")
        p[f"dec{level}"] = d
    p["refiner"] = [cv(f"moduleRefiner.moduleMain.{i}")
                    for i in (0, 2, 4, 6, 8, 10, 12)]
    return p


def params_to_numpy(tree):
    """The port's tree of tensors → a numpy tree in fldrx's layout (conv
    weights HWIO): the inverse of `params_from_numpy`."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "w" and torch.is_tensor(v) and v.dim() == 4:
                out[k] = v.detach().cpu().numpy().transpose(2, 3, 1, 0).copy()
            else:
                out[k] = params_to_numpy(v)
        return out
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy().copy()
