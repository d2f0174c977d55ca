"""Data-parallel and width-sharded training on `torch.distributed`: one
process per place (i, j) of a (dp, sp) mesh, world rank i·sp + j (the
counterpart of fldrx's `make_train_step(cfg, mesh)`, where XLA's
partitioner splits the step).

Every process takes dp shard i of the global batch at its full width. The
pyramid, the PCA features, the flow recurrence, the coarse levels'
synthesis and level 0's warps run alike on the sp processes of a shard;
level 0's refine UNet, six-way blend and reconstruction loss run on width
slab j (`slab_columns`) plus the UNet's halo (model/fldrnet.py
`UNET_HALO`). Each process's loss is its part (train/losses.py
`LossShard`): the level-0 slab's share, and the other terms on process
j = 0 alone, so that they enter once.

What couples the processes, each reduction an `all_reduce` over the world
(gloo serves only broadcast and all_reduce for CUDA tensors, and two ranks
on one card need gloo):

- the block-PCA min and max are the whole batch's (`group_minmax`);
- the PSNR's squared error and pixel count are summed before the log;
- the gradients and the metrics are summed and divided by dp: summed over
  a width group's parts, averaged over the batch shards.

`spawn` starts the ranks on one machine (`tcp://localhost:<free port>`);
`init_from_env` joins a group that torchrun started.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from ..model.fldrnet import UNET_GRID
from ..weights import named_leaves


def mesh_place(mesh) -> Tuple[int, int]:
    """This process's place (i, j) on the mesh: world rank i·sp + j.
    Raises unless the process group has one rank per place."""
    if not dist.is_initialized():
        raise RuntimeError("data-parallel training needs a process group: "
                           "torch.distributed.init_process_group (or spawn "
                           "/ torchrun)")
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if dist.get_world_size() != dp * sp:
        raise ValueError(f"{dist.get_world_size()} ranks for a mesh of dp "
                         f"{dp} × sp {sp}")
    return divmod(dist.get_rank(), sp)


def slab_columns(W: int, sp: int, j: int) -> Tuple[int, int]:
    """The level-0 columns [lo, hi) that width shard j of sp makes; the
    slabs are equal and start on the refine UNet's grid."""
    if W % (sp * UNET_GRID):
        raise ValueError(f"width {W} does not split into {sp} slabs of a "
                         f"multiple of {UNET_GRID} columns")
    w = W // sp
    return j * w, (j + 1) * w


class _GroupExtremum(torch.autograd.Function):
    """The group's min or max of x; the backward sums the cotangent over the
    ranks and splits it evenly among the elements, on any rank, that equal
    the extremum.

    The sp processes of a batch shard hold the same elements, so the count
    is sp times the batch's; but each routes its share into its own copy
    of the features, and the gradients are summed over those copies, so
    each element of the batch receives cotangent / (the batch's count), as
    in one process."""

    @staticmethod
    def forward(ctx, x, op):
        m = (x.amin() if op == "min" else x.amax()).detach().clone()
        dist.all_reduce(m, dist.ReduceOp.MIN if op == "min"
                        else dist.ReduceOp.MAX)
        at = x == m
        count = at.sum().to(torch.float64)
        dist.all_reduce(count)
        ctx.save_for_backward(at, count)
        return m

    @staticmethod
    def backward(ctx, g):
        at, count = ctx.saved_tensors
        g = g.detach().clone()
        dist.all_reduce(g)
        return at * (g / count.to(g.dtype)), None


def group_minmax(feat: torch.Tensor, level: int):
    """The min and max of `feat` over the whole group (the hook of
    model.fldrnet.extract_features)."""
    return _GroupExtremum.apply(feat, "min"), _GroupExtremum.apply(feat, "max")


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a tensor over the group (no gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def reduce_metrics(d, dp: int):
    """{k: the group sum of d[k] / dp} for scalar tensors, in one
    all_reduce."""
    keys = list(d)
    v = group_sum(torch.stack([d[k].detach().float() for k in keys])) / dp
    return {k: v[i] for i, k in enumerate(keys)}


def reduce_gradients(params, dp: int) -> None:
    """Replace each .grad of `params` by its group sum / dp, in one
    all_reduce."""
    grads = [p.grad for _, p in named_leaves(params) if p.grad is not None]
    if not grads:
        return
    flat = group_sum(torch.cat([g.reshape(-1) for g in grads])) / dp
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def broadcast_params(params, src: int = 0) -> None:
    """Copy rank `src`'s parameter values to every rank, in place."""
    with torch.no_grad():
        for _, p in named_leaves(params):
            dist.broadcast(p.data, src)


def backend_for(devices) -> str:
    """nccl where each rank has a card of its own, else gloo (a CPU rank, or
    two ranks on one card, which nccl refuses)."""
    names = [str(d) for d in devices]
    if all(torch.device(d).type == "cuda" for d in devices) \
            and len(set(names)) == len(names):
        return "nccl"
    return "gloo"


def init_from_env(backend: str) -> bool:
    """Join the process group torchrun describes in the environment
    (WORLD_SIZE > 1); returns whether there is one."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(fn, rank, world_size, backend, port, results, args):
    try:
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                world_size=world_size, rank=rank)
        try:
            value = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world_size: int, *args, backend: str = "gloo",
          timeout: float = 900.0) -> List:
    """Run fn(rank, world_size, *args) in `world_size` fresh processes
    joined in one process group; returns their return values in rank
    order. fn and args are pickled (fn by its import path). Raises if a
    rank fails or the run outlasts `timeout` seconds; every process is
    ended before it returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_run_rank, args=(
        fn, r, world_size, backend, port, results, args))
        for r in range(world_size)]
    for p in procs:
        p.start()
    values, errors = {}, {}
    deadline = time.time() + timeout
    try:
        while len(values) + len(errors) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in values and r not in errors]
                for r in dead:
                    errors[r] = f"exited with code {procs[r].exitcode}"
                if time.time() > deadline:
                    errors[-1] = f"timed out after {timeout} s"
                if errors:
                    break
                continue
            (values if ok else errors)[rank] = value
            if errors:
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("data-parallel run failed:\n" + "\n".join(
            f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [values[r] for r in range(world_size)]
