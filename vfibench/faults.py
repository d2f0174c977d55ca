"""Faults planted in the program under a run, for the check that the
comparison deciding `correct` catches each fault a cell can have. Nothing
in the benchmark's own runs plants them: the tests do
(vfibench/tests/test_vfibench_faults.py), and `python -m vfibench.control
--fault <name>` reads them on the card at a cell's own size.

Pairs: `state_unchanged` (the synthesis hands back its input frame),
`half_batch` (a chunk computes half its t values and repeats them),
`answer_altered` (a chunk's last frame made at a t one sixteenth off),
`flow_strip` (the flow half a pixel off in one strip of a sixteenth of
its rows, as a fault of a tile, a border or a halo leaves it).
Training: `state_unchanged` (the step updates nothing), `half_batch` (the
loss over the first half of the batch), `answer_altered` (one leaf's
gradient doubled where the backward pass produces it), `evlr_dropped`
(the eigenvector group stepped at the base rate, not evlr times it). A
single card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

PAIRS = ("state_unchanged", "half_batch", "answer_altered", "flow_strip")
TRAIN = ("state_unchanged", "half_batch", "answer_altered", "evlr_dropped")


def _pairs_patch(name: str):
    from fldrx_torch.eval.pipeline import Interpolator

    if name == "flow_strip":
        orig_flow = Interpolator.precompute_flow

        def flow_strip(self, frames):
            flow, padded, extras = orig_flow(self, frames)
            h = flow.shape[1]
            flow = flow.clone()
            flow[:, h // 2:h // 2 + max(1, h // 16)] += 0.5
            return flow, padded, extras
        return mock.patch.object(Interpolator, "precompute_flow", flow_strip)
    orig = Interpolator.synthesize_multi_at

    def state_unchanged(self, flow, padded, t_values, orig_hw, extras=None,
                        planes_out=None):
        x0 = padded[:, 0, :orig_hw[0], :orig_hw[1]].float()
        return torch.stack([x0] * len(t_values), 0)

    def half_batch(self, flow, padded, t_values, orig_hw, extras=None,
                   planes_out=None):
        half = list(t_values[:max(1, len(t_values) // 2)])
        out = orig(self, flow, padded, half, orig_hw, extras, planes_out)
        return torch.cat([out] * (len(t_values) // len(half) + 1),
                         0)[:len(t_values)]

    def answer_altered(self, flow, padded, t_values, orig_hw, extras=None,
                       planes_out=None):
        ts = list(t_values)
        ts[-1] = ts[-1] + 1 / 16
        return orig(self, flow, padded, ts, orig_hw, extras, planes_out)

    fn = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}[name]
    return mock.patch.object(Interpolator, "synthesize_multi_at", fn)


def _train_patch(name: str):
    from fldrx_torch.train import trainer
    from fldrx_torch.weights import named_leaves

    if name == "state_unchanged":
        return mock.patch.object(trainer.TrainState, "apply_gradients",
                                 lambda self: None)
    if name == "half_batch":
        orig_loss = trainer.train_loss

        def half_loss(cfg, params, batch, **kw):
            n = batch["frames"].shape[0] // 2
            return orig_loss(cfg, params,
                             {k: v[:n] for k, v in batch.items()}, **kw)
        return mock.patch.object(trainer, "train_loss", half_loss)
    if name == "evlr_dropped":
        import dataclasses

        orig_opt = trainer.make_optimizer

        def base_rate(cfg, params, *a, **kw):
            return orig_opt(dataclasses.replace(cfg, evlr=1.0), params,
                            *a, **kw)
        return mock.patch.object(trainer, "make_optimizer", base_rate)
    if name != "answer_altered":
        raise KeyError(name)
    orig_apply = trainer.TrainState.apply_gradients

    def apply_altered(self):
        leaf = dict(named_leaves(self.params))["vfinet/refine/dec3/w"]
        leaf.grad.mul_(2.0)
        orig_apply(self)
    return mock.patch.object(trainer.TrainState, "apply_gradients",
                             apply_altered)


@contextlib.contextmanager
def planted(kind: str, name: str):
    """The fault `name` planted in the program for a driver of `kind`
    ("infer" or "train") while the block runs."""
    patch = _pairs_patch(name) if kind == "infer" else _train_patch(name)
    with patch:
        yield
