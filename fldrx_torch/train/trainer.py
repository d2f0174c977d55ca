"""The optimiser with fldrx's two learning-rate groups, its MultiStep
schedule, the train step and the T-optimisation freeze (counterpart of
fldrx/train/trainer.py).

- Adam, betas (0.9, 0.999), eps 1e-8; PCA mean and eigenvectors at
  `evlr`·lr; meanVec frozen; under T-optimisation only vfinet/T_param
  trains. Frozen leaves get `requires_grad_(False)` and stay out of the
  optimiser. With `weight_decay` the decay is decoupled and scaled by the
  learning rate (optax's add_decayed_weights after scale_by_adam, which is
  AdamW's form), not an L2 term on the gradient.
- The schedule multiplies the rate by `lr_dec_fac` at each milestone
  epoch, counted in steps: update k (0-based) runs at the rate for step k,
  so the first step of epoch m already has the reduced rate, as optax's
  piecewise_constant_schedule does with its count taken before the
  increment.
- One step: pyramid → `forward_train` → `total_loss` → backward → update.
  PyTorch runs eagerly, so the state is updated in place.
- Sharded: `make_train_step(cfg, mesh)` runs in one process per place of
  a (dp, sp) mesh (parallel/distributed.py): each takes its batch shard,
  and where sp > 1 makes level 0's refine UNet, blend and reconstruction
  loss over its width slab; the PCA min/max and the PSNR's MSE are the
  whole batch's, and the gradients and metrics the whole step's, so the
  step gives what the single-process step gives on the global batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import FLDRConfig
from ..eval.pipeline import build_pyramid
from ..model.fldrnet import forward_train
from ..weights import named_leaves, unflatten_params
from .losses import LossShard, total_loss


def param_labels(params, cfg: FLDRConfig):
    """A tree of labels beside `params`: "ev" (PCA mean and eigenvectors,
    the evlr group), "frozen" (meanVec; under T-optimisation everything but
    vfinet/T_param) or "base"."""
    def label(name):
        keys = name.split("/")
        if cfg.t_optimization:
            return "base" if keys[:2] == ["vfinet", "T_param"] else "frozen"
        if keys[0] in ("pca", "pca_multi"):
            return "frozen" if keys[-1] == "mean_vec" else "ev"
        return "base"

    return unflatten_params({n: label(n) for n, _ in named_leaves(params)})


def lr_schedule(cfg: FLDRConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """step → factor on the groups' base rates: lr_dec_fac for each
    milestone epoch m with m·steps_per_epoch ≤ step."""
    boundaries = [m * steps_per_epoch for m in cfg.lr_milestones]

    def factor(step: int) -> float:
        f = 1.0
        for b in boundaries:
            if step >= b:
                f *= cfg.lr_dec_fac
        return f

    return factor


def make_optimizer(cfg: FLDRConfig, params, steps_per_epoch: int = 1):
    """Returns (optimizer, scheduler) for `params`, whose frozen leaves are
    set to requires_grad=False and the others to True."""
    labels = dict(named_leaves(param_labels(params, cfg)))
    groups: Dict[str, list] = {"base": [], "ev": []}
    for name, p in named_leaves(params):
        frozen = labels[name] == "frozen"
        p.requires_grad_(not frozen)
        if not frozen:
            groups[labels[name]].append(p)
    rates = {"base": cfg.init_lr, "ev": cfg.evlr * cfg.init_lr}
    param_groups = [{"params": ps, "lr": rates[k], "group": k}
                    for k, ps in groups.items() if ps]
    # AdamW with weight_decay 0 is Adam; with decay it is optax's form
    opt = torch.optim.AdamW(param_groups, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lr_schedule(cfg, steps_per_epoch))
    return opt, sched


class TrainState:
    """Parameters, optimiser, scheduler and the count of updates taken."""

    def __init__(self, params, optimizer, scheduler, step: int = 0):
        self.params = params
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.step = step

    @classmethod
    def create(cls, params, cfg: FLDRConfig, steps_per_epoch: int = 1):
        opt, sched = make_optimizer(cfg, params, steps_per_epoch)
        return cls(params, opt, sched)

    def apply_gradients(self) -> None:
        """One update from the gradients in each parameter's .grad."""
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1

    def optimizer_tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{flat parameter name: {"exp_avg", "exp_avg_sq", "step"}}: the
        optimiser's own tensors (not copies; the next update changes them
        in place) for each parameter that has optimiser state."""
        out = {}
        for name, p in named_leaves(self.params):
            st = self.optimizer.state.get(p)
            if st:
                out[name] = {k: v for k, v in st.items() if torch.is_tensor(v)}
        return out

    def optimizer_state(self) -> Dict[str, Dict[str, np.ndarray]]:
        """`optimizer_tensors` copied to numpy."""
        return {name: {k: v.detach().cpu().numpy().copy()
                       for k, v in st.items()}
                for name, st in self.optimizer_tensors().items()}

    def load_optimizer_state(
            self, flat: Optional[Dict[str, Dict[str, np.ndarray]]],
            step: Optional[int]) -> None:
        """Restore what `optimizer_state` gave (unless None) and the
        schedule position (unless None); raises if the parameters the state
        names differ from the optimiser's."""
        trained = {name: p for name, p in named_leaves(self.params)
                   if p.requires_grad}
        if flat is not None and set(flat) != set(trained):
            raise ValueError("optimizer state does not match the trained "
                             f"parameters: {sorted(set(flat) ^ set(trained))}")
        for name, st in (flat or {}).items():
            p = trained[name]
            self.optimizer.state[p] = {
                "step": torch.tensor(float(st["step"]), dtype=torch.float32),
                "exp_avg": torch.as_tensor(st["exp_avg"]).to(p.device),
                "exp_avg_sq": torch.as_tensor(st["exp_avg_sq"]).to(p.device)}
        if step is not None:
            # a scheduler resumed at the step sets each group's rate for it
            self.step = int(step)
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, self.scheduler.lr_lambdas[0],
                last_epoch=self.step - 1)


def _device_of(params) -> torch.device:
    return next(iter(named_leaves(params)))[1].device


def train_loss(cfg: FLDRConfig, params, batch: Dict[str, Any],
               minmax=None, shard: Optional[LossShard] = None):
    """(loss, metrics) of one batch {frames [B,2,H,W,3], target [B,H,W,3],
    t [B,1], optional epoch}, on the parameters' device. `minmax` makes a
    shard's PCA extremes the whole batch's (forward_train); `shard` makes
    the loss one process's part of a sharded step's (total_loss), and
    level 0 cover shard.cols."""
    dev = _device_of(params)
    frames = torch.as_tensor(batch["frames"]).to(dev, torch.float32)
    target = torch.as_tensor(batch["target"]).to(dev, torch.float32)
    t = torch.as_tensor(batch["t"]).to(dev, torch.float32)
    pyr = build_pyramid(frames, cfg, cfg.S_trn + 1)
    out = forward_train(params, cfg, pyr, t, minmax=minmax,
                        cols=None if shard is None else shard.cols)
    return total_loss(cfg, out, target, frames, t, params=params,
                      epoch=batch.get("epoch"), shard=shard)


def make_train_step(cfg: FLDRConfig, mesh=None):
    """Returns step(state, batch) → metrics (detached tensors): zero the
    gradients, compute the loss, backward, update `state` in place. The
    gradients stay in each parameter's .grad until the next step.

    With `mesh` (parallel.mesh.Mesh) the step is one process's part of a
    sharded step, at mesh place (i, j) = divmod(world rank, sp): `batch` is
    the global batch, the process takes dp shard i at its full width and,
    where sp > 1, makes level 0 over width slab j (parallel/distributed.py);
    the gradients left in .grad and the metrics returned are the whole
    step's, so every process ends where the single-process step on the
    global batch ends."""
    if mesh is None:
        def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
            state.optimizer.zero_grad(set_to_none=True)
            loss, metrics = train_loss(cfg, state.params, batch)
            loss.backward()
            state.apply_gradients()
            return {k: v.detach() for k, v in metrics.items()}

        return step

    from ..parallel import distributed as D
    from ..parallel.mesh import dp_shard_of

    i, j = D.mesh_place(mesh)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    def mesh_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        local = dp_shard_of(mesh, batch, i, j)
        cols = (D.slab_columns(local["frames"].shape[3], sp, j)
                if sp > 1 else None)
        shard = LossShard(cols=cols, own=1.0 if j == 0 else 0.0,
                          group_sum=D.group_sum)
        loss, metrics = train_loss(cfg, state.params, local,
                                   minmax=D.group_minmax, shard=shard)
        loss.backward()
        D.reduce_gradients(state.params, dp)
        state.apply_gradients()
        psnr = metrics.pop("psnr").detach()
        out = D.reduce_metrics(metrics, dp)
        out["psnr"] = psnr
        return out

    return mesh_step
