"""The rank function of tests/test_torch_dp.py's data-parallel runs. It
lives in a module that imports no JAX: each rank is a fresh process that
imports it by name."""


def dp_step(rank, world_size, cfg, tree, batch, sp=1):
    """One train step on the CPU at dp world_size/sp × sp from the numpy
    parameter tree `tree` on the global `batch`. Returns (metrics, {name:
    the step's gradient}, {name: updated parameter in fldrx's layout},
    [the width of each refine UNet input at level 0's size])."""
    import torch

    from fldrx_torch.model import fldrnet
    from fldrx_torch.parallel.mesh import make_mesh
    from fldrx_torch.train.trainer import TrainState, make_train_step
    from fldrx_torch.weights import (flatten_params, named_leaves,
                                     params_from_numpy, params_to_numpy)

    torch.set_num_threads(1)
    params = params_from_numpy(tree, "cpu")
    state = TrainState.create(params, cfg)
    mesh = make_mesh(["cpu"] * world_size, dp=world_size // sp, sp=sp)
    widths, unet = [], fldrnet.refine_unet_s2d

    def recording(p, x):
        if x.shape[1] == batch["frames"].shape[2]:
            widths.append(x.shape[2])
        return unet(p, x)

    fldrnet.refine_unet_s2d = recording
    try:
        m = make_train_step(cfg, mesh)(state, batch)
    finally:
        fldrnet.refine_unet_s2d = unet
    grads = {n: p.grad.numpy().copy() for n, p in named_leaves(params)
             if p.grad is not None}
    return ({k: float(v) for k, v in m.items()}, grads,
            flatten_params(params_to_numpy(params)), widths)


def dp_train(rank, world_size, cfg, seed, sp=1):
    """train(mesh=) over CPU ranks at dp world_size/sp × sp, no
    validation; returns the rank's final parameters in fldrx's layout."""
    import torch

    from fldrx_torch.parallel.mesh import make_mesh
    from fldrx_torch.train.loop import train
    from fldrx_torch.weights import flatten_params, params_to_numpy

    torch.set_num_threads(1)
    params, _ = train(cfg, mesh=make_mesh(["cpu"] * world_size,
                                          dp=world_size // sp, sp=sp),
                      seed=seed, no_validation=True, verbose=False)
    return flatten_params(params_to_numpy(params))
