"""Training steps of the papermodel recipe, one after another: the
program's `make_train_step(cfg)(state, batch)` on one TrainState, fed from
a pool of batches in pinned host memory, cycled (the step copies each
batch to the device itself, as from a data loader).

Set-up builds the one TrainState from the checkpoint with a fresh
optimiser and drives it through its first steps on the pool's first
batches, through the window's own call and feed; those steps are also the
warm-up. It keeps the loss of each, the first gradient as the optimiser got
it (worked out from Adam's first moment after one step) and the change of
the parameters over them. The window then goes on with the same object.

Traffic parameters: pool (batches), phase_px, pan_px, t_range, checked_steps,
trace_steps. The batch size and crop size are the configuration's.
"""

from __future__ import annotations

import math
import os
import statistics
import time

import torch

from .. import inputs, work
from . import Marks, fields_to_config, pinned, segments, sync


class Driver:
    kind = "train"
    SPANS = ("train_step", "sync")

    def __init__(self, cell: dict, device, seed: int, control=None):
        """control: the configuration's "control" (None for the recipe as
        configured): "tf32" turns TF32 on, the step below float32."""
        self.cell, self.seed = cell, int(seed)
        self.dev = torch.device(device)
        control = control or {}
        self.fields = dict(cell["config"]["fldr_config"],
                           **control.get("overrides", {}))
        self.cfg = fields_to_config(self.fields)
        self.tf32 = bool(control.get("tf32", False))
        self.B, self.size = self.cfg.batch_size, self.cfg.patch_size

    def setup(self) -> None:
        from fldrx_torch.train.trainer import TrainState, make_train_step
        from fldrx_torch.weights import load_npz, named_leaves, params_from_numpy

        # the recipe is float32 with TF32 off; the control turns it on
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        tr = self.cell["traffic"]
        t_start = time.perf_counter()
        n = int(tr["pool"])
        phase, pan, t = inputs.train_specs(self.seed, n * self.B,
                                           tr["phase_px"], tr["pan_px"],
                                           tr["t_range"])
        self.pool = []
        for i in range(n):
            s = slice(i * self.B, (i + 1) * self.B)
            b = inputs.train_batch(phase[s], pan[s], t[s], self.size, self.dev)
            self.pool.append({k: pinned(v) for k, v in b.items()})
        parts = {"inputs_s": time.perf_counter() - t_start}
        ckpt = os.path.join(self.cell["root"], self.cell["config"]["checkpoint"])
        self.params = params_from_numpy(load_npz(ckpt)[0], self.dev)
        self.state = TrainState.create(self.params, self.cfg)
        self.step = make_train_step(self.cfg)
        leaves = dict(named_leaves(self.params))
        start = {k: p.detach().clone() for k, p in leaves.items()}
        self.losses, self.grad1 = [], {}
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        for i in range(int(tr["checked_steps"])):
            m = self.step(self.state, self.pool[i % n])
            self.losses.append(float(m["loss"]))
            parts[f"step{i}_s"] = (time.perf_counter() - t_start
                                   - sum(parts.values()))
            if i == 0:
                for name, p in leaves.items():
                    st = self.state.optimizer.state.get(p)
                    if st:
                        self.grad1[name] = st["exp_avg"].detach() / (1 - beta1)
        self.delta = {k: p.detach() - start[k] for k, p in leaves.items()}
        self.done = int(tr["checked_steps"])
        sync(self.dev)
        self.setup_parts = parts

    def window(self, seconds: float, marks: Marks = None) -> dict:
        n = len(self.pool)
        sync(self.dev)
        steps, ends = 0, []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step(self.state, self.pool[(self.done + steps) % n])
            steps += 1
            # the host's clock as each step's call returns (the device
            # runs behind it by the queue the step leaves)
            ends.append(time.perf_counter() - t0)
        sync(self.dev)
        window_s = time.perf_counter() - t0
        self.done += steps
        res = {"requests": steps, "window_s": window_s,
               "e2e": {"samples_per_s": steps * self.B / window_s},
               "notes": dict(segments(ends, window_s), steps=steps,
                             step_ms=window_s * 1e3 / steps)}
        if marks:
            res["layers"] = {"step_wall_ms": window_s * 1e3 / steps}
        return res

    def traced(self, n: int) -> None:
        from torch.profiler import record_function

        for i in range(n):
            with record_function("train_step"):
                self.step(self.state, self.pool[(self.done + i) % len(self.pool)])
        with record_function("sync"):
            sync(self.dev)
        self.done += n

    def trace_requests(self) -> int:
        return int(self.cell["traffic"]["trace_steps"])

    def work(self, peaks: dict) -> dict:
        g = work.geometry(self.fields)
        flops = work.train_step_flops(g, self.size, self.B)
        return {"compute_ms_per_request": work.compute_ms(flops, peaks)}

    def release(self) -> None:
        del self.state, self.params, self.step
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The first steps against the plain reference's from the same
        checkpoint on the same batches; the cell's limits name which of
        these numbers are compared (the rest go to the notes):

        - loss_gap: each step's loss, relative, the worst step;
        - grad_gap: the first gradient's norm per leaf, its gap over the
          larger of the reference's norm of the leaf and of the median
          leaf, the worst leaf;
        - delta_gap_median, delta_gap: the change's norm per leaf, gapped
          so, the median leaf and the worst leaf. Leaves whose reference
          gradient is under a thousandth of the median leaf's are left out
          of the change: Adam moves them by round-off alone. Adam moves
          every element about as far, so the elements of a small leaf
          whose gradients are nought to rounding make the worst leaf's gap
          swing (the flow path's biases, 3e-4 to 8e-3): the median leaf is
          steady enough to see TF32, and the worst leaf, with a loose
          limit, sees one leaf or group stepped at a wrong rate."""
        from ..reference import convert, pipeline

        ckpt = os.path.join(self.cell["root"], self.cell["config"]["checkpoint"])
        sd = convert.state_dict(ckpt, self.dev, requires_grad=True)
        k = len(self.losses)
        batches = [{n: v.to(self.dev) for n, v in self.pool[i % len(self.pool)]
                    .items()} for i in range(k)]
        geom = work.geometry(self.fields)
        geom.update(smoothness=self.cfg.smoothness,
                    warp_alpha=self.cfg.warp_alpha)
        lr, ev_lr = self.cfg.init_lr, self.cfg.evlr * self.cfg.init_lr
        lrs = {n: ev_lr if n in ("Mean8", "EV8") else lr for n in sd}
        ref = pipeline.train_steps(sd, batches, geom, lrs)
        got = {"loss_gap": max(abs(a - b) / abs(b)
                               for a, b in zip(self.losses, ref["loss"]))}
        names = {convert.checkpoint_name(n): n for n in ref["grad1"]}
        if set(names) != set(self.grad1):
            got.update(grad_gap=math.inf, delta_gap=math.inf,
                       delta_gap_median=math.inf)
        else:
            g_ref = {n: float(ref["grad1"][names[n]].norm()) for n in names}
            d_ref = {n: float(ref["delta"][names[n]].norm()) for n in names}
            g_med = statistics.median(g_ref.values())
            d_med = statistics.median(d_ref.values())
            gg = {n: abs(float(self.grad1[n].norm()) - g_ref[n])
                  / max(g_ref[n], g_med) for n in names}
            moved = [n for n in names if g_ref[n] >= 1e-3 * g_med]
            dg = {n: abs(float(self.delta[n].norm()) - d_ref[n])
                  / max(d_ref[n], d_med) for n in moved}
            got.update(grad_gap=max(gg.values()), delta_gap=max(dg.values()),
                       delta_gap_median=statistics.median(dg.values()))
            self.check_notes = dict(
                got, grad_worst=max(gg, key=gg.get),
                delta_worst=max(dg, key=dg.get),
                left_out=sorted(set(names) - set(moved)))
        return {n: (_finite(got[n]), lim)
                for n, lim in self.cell["limits"].items()}


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf
