"""The device mesh and the batch layout over it (counterpart of
fldrx/parallel/mesh.py).

A `Mesh` is a (dp, sp) grid of torch devices: axis "dp" splits the batch,
axis "sp" the image width. A device may stand at more than one place of the
grid, so one card (or the CPU) can hold a 1×2 or 2×2 mesh; work placed on
two places of one device runs there one after the other.

fldrx places arrays with PartitionSpecs and lets XLA move them. Here a spec
is a plain tuple with one entry per dimension ("dp", "sp" or None), and
`shard_of` cuts the piece of a host batch that one place of the grid holds.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..weights import named_leaves, unflatten_params

Spec = Tuple[Optional[str], ...]


class Mesh:
    """Devices on a (dp, sp) grid: `devices[i, j]` holds batch shard i and
    width shard j; `shape` is {"dp": dp, "sp": sp}."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid, got shape "
                             f"{devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def unique_devices(self):
        """The distinct devices of the grid, in grid order."""
        seen = {}
        for d in self.devices.reshape(-1):
            seen.setdefault(str(d), d)
        return list(seen.values())

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices.reshape(-1).tolist()})"


def visible_devices():
    """Every visible CUDA device; raises without a GPU."""
    resolve_device(None)
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None,
              dp: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """A (dp, sp) mesh over `devices` (default: every visible CUDA device),
    in row-major order. With neither dp nor sp given: as much dp as
    possible, and sp 2 when the count is even and at least 4."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else visible_devices())]
    n = len(devices)
    if dp is None and sp is None:
        sp = 2 if n % 2 == 0 and n >= 4 else 1
        dp = n // sp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, sp))


def batch_specs() -> Dict[str, Spec]:
    """The layout of a training batch: batch over dp, width over sp."""
    return {
        "frames": ("dp", None, None, "sp", None),   # [B,2,H,W,C]
        "target": ("dp", None, "sp", None),          # [B,H,W,C]
        "t": ("dp", None),                           # [B,1]
    }


def frames_spec() -> Spec:
    """The layout of evaluation frames [B,2,H,W,C]: batch over dp, width
    over sp."""
    return ("dp", None, None, "sp", None)


def _cut(x, spec: Spec, index: Dict[str, int], sizes: Dict[str, int]):
    """The block of x at `index` along the axes that `spec` names."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, k = sizes[axis], index[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not split into {n} shards over {axis!r}")
        step = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(k * step, (k + 1) * step),)]
    return x


def _piece(mesh: Mesh, batch: Dict, i: int, j: int,
           specs: Dict[str, Spec]) -> Dict:
    index, sizes = {"dp": i, "sp": j}, mesh.shape
    dev = mesh.devices[i, j]
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        spec = specs.get(k, ("dp",) if v.dim() else ())
        out[k] = _cut(v, spec, index, sizes).to(dev)
    return out


def shard_of(mesh: Mesh, batch: Dict, i: int, j: int) -> Dict:
    """The piece of a host batch that mesh place (i, j) holds, as tensors
    on its device: keys of `batch_specs` by their spec, any other array
    split over dp along its first dimension, scalars whole."""
    return _piece(mesh, batch, i, j, batch_specs())


def dp_shard_of(mesh: Mesh, batch: Dict, i: int, j: int) -> Dict:
    """What mesh place (i, j) takes of a host batch in width-sharded
    training, which splits the width inside the step: batch shard i at the
    full width (every array split over dp along its first dimension,
    scalars whole), as tensors on the place's device."""
    return _piece(mesh, batch, i, j, {})


def shard_batch(mesh: Mesh, batch: Dict) -> Dict[Tuple[int, int], Dict]:
    """{(i, j): the piece mesh place (i, j) holds} for every place."""
    dp, sp = mesh.devices.shape
    return {(i, j): shard_of(mesh, batch, i, j)
            for i in range(dp) for j in range(sp)}


def tree_to(tree, device):
    """A tensor tree (weights.named_leaves) on `device`; leaves already
    there are not copied."""
    return unflatten_params({n: torch.as_tensor(v).to(device)
                             for n, v in named_leaves(tree)})


def replicate(mesh: Mesh, tree) -> Dict[str, object]:
    """{str(device): the tree on that device} for each distinct device of
    the mesh."""
    return {str(d): tree_to(tree, d) for d in mesh.unique_devices()}
