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


def params_from_numpy(tree, device="cpu", dtype=torch.float32):
    """Numpy parameter tree → the port's tree of tensors on `device`.

    A dict with a 4-D "w" is a conv: its HWIO weight becomes OIHW."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            a = np.asarray(v) if not isinstance(v, (dict, list, tuple)) else None
            if k == "w" and a is not None and a.ndim == 4:
                out[k] = torch.tensor(np.transpose(a, (3, 2, 0, 1)),
                                      dtype=dtype, device=device)
            else:
                out[k] = params_from_numpy(v, device, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


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
