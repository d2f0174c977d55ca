"""The port's training forward, losses and gradients held against fldrx on
the CPU with the real checkpoint.

References are fldrx with no FLDRX_* overrides and fast_warp_train=True:
off the TPU its fast warps are the exact forward plus its custom VJPs,
which the port's plain versions of the kernels match
(tests/test_torch_warp_grad.py).

Inputs: `bench_inputs.train_batch`, bench.py's texture with a per-sample
pan, at S_trn=2, B=2, 128×128, t = (0.3, 0.7), seed 0. The level-0
synthesis has thresholds — a softmax-splat target that receives no weight
(norm 0 → 1) and the bwarp 0.999 mask — that a flow change of 1e-6
relative can cross: at 6 of 8 seeds fldrx itself moves by 6e-5 to 0.09
when its level-0 flow is scaled by 1 ± 1e-6, and on test_torch_model's
texture at t = 0.5 its jitted and eager runs differ by 0.048 on 880 pixels
(ROADMAP.md queue 3). Seed 0 moves by at most 2.2e-5 under flow changes up
to 1e-5 relative, so it measures the port, not that conditioning.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fldrx import api as japi
from fldrx import config as jcfg
from fldrx.eval import pipeline as jpipe
from fldrx.model import fldrnet as jf
from fldrx.tools.convert_ckpt import flatten_params as jflatten
from fldrx.tools.convert_ckpt import load_params_npz
from fldrx.train import losses as jl
from fldrx_torch import config as tcfg
from fldrx_torch.api import DEFAULT_NPZ
from fldrx_torch.bench_inputs import train_batch
from fldrx_torch.eval import pipeline as tpipe
from fldrx_torch.model import fldrnet as tf
from fldrx_torch.train import losses as tl
from fldrx_torch.weights import (flatten_params, load_npz, named_leaves,
                                 params_from_numpy, params_to_numpy)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _exact_reference():
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("FLDRX_")}
    from fldrx.ops import fastconv as jfc
    from fldrx.ops import fastwarp as jfw
    importlib.reload(jfw)
    importlib.reload(jfc)
    yield
    os.environ.update(saved)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


@pytest.fixture(scope="module")
def train_pair():
    """fldrx and the port on the same batch: fldrx's jitted value_and_grad
    of its loss_fn (make_train_step's), and the port's forward_train +
    total_loss + backward."""
    batch = train_batch(128, np.array([[0.3], [0.7]]), seed=0)
    jc = jcfg.papermodel().replace(S_trn=2, phase="train")
    tc = tcfg.papermodel().replace(S_trn=2, phase="train")
    assert jc.fast_warp_train and tc.fast_warp_train
    jtree, _, _ = load_params_npz(japi.DEFAULT_NPZ)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jtree)
    frames, target, t = (jnp.asarray(batch[k])
                         for k in ("frames", "target", "t"))

    def loss_fn(params):
        pyr = jpipe.build_pyramid(frames, jc, jc.S_trn + 1)
        out = jf.forward_train(params, jc, pyr, t)
        loss, metrics = jl.total_loss(jc, out, target, frames, t,
                                      params=params)
        return loss, (metrics, out["out_pyramid"])

    (_, (jm, jouts)), jg = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)

    tp = params_from_numpy(load_npz(DEFAULT_NPZ)[0])
    for _, p in named_leaves(tp):
        p.requires_grad_(True)
    tframes, ttarget, tt = (torch.as_tensor(batch[k])
                            for k in ("frames", "target", "t"))
    pyr = tpipe.build_pyramid(tframes, tc, tc.S_trn + 1)
    out = tf.forward_train(tp, tc, pyr, tt)
    loss, tm = tl.total_loss(tc, out, ttarget, tframes, tt, params=tp)
    loss.backward()
    return {"jm": jm, "jouts": jouts, "jgrads": jflatten(
                jax.tree.map(np.asarray, jg)),
            "tm": {k: v.detach() for k, v in tm.items()}, "tout": out,
            "tgrads": flatten_params(
                params_to_numpy(_grad_tree(tp)))}


def test_forward_train_matches_fldrx(train_pair):
    """Out pyramid (3 levels, fine → coarse) ≤ 1e-4 max abs (measured
    1.2e-6); the flow pyramids agree too."""
    jouts, tout = train_pair["jouts"], train_pair["tout"]
    assert [tuple(o.shape) for o in tout["out_pyramid"]] == \
        [(2, 128, 128, 3), (2, 64, 64, 3), (2, 32, 32, 3)]
    for a, b in zip(jouts, tout["out_pyramid"]):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=1e-4, rtol=0)
    assert tuple(tout["occ_0"].shape) == (2, 128, 128, 1)
    assert len(tout["endflow_pyramid"]) == 3


def test_forward_train_validation_crop_matches_fldrx():
    """validation=True crops every level's frames and full-resolution
    flows to validation_patch_size before the warps (96 here: level 0 of
    the 128×128 batch is cropped, the coarser levels are smaller than the
    crop); forward only, against fldrx eager, ≤ 1e-4 max abs."""
    batch = train_batch(128, np.array([[0.3], [0.7]]), seed=0)
    kw = dict(S_trn=1, phase="train", validation_patch_size=96)
    jc = jcfg.papermodel().replace(**kw)
    tc = tcfg.papermodel().replace(**kw)
    jtree, _, _ = load_params_npz(japi.DEFAULT_NPZ)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jtree)
    frames, t = batch["frames"], batch["t"]
    ref = jf.forward_train(jp, jc, jpipe.build_pyramid(
        jnp.asarray(frames), jc, 2), jnp.asarray(t), validation=True)
    with torch.no_grad():
        got = tf.forward_train(
            params_from_numpy(load_npz(DEFAULT_NPZ)[0]), tc,
            tpipe.build_pyramid(torch.as_tensor(frames), tc, 2),
            torch.as_tensor(t), validation=True)
    assert [tuple(o.shape) for o in got["out_pyramid"]] == \
        [(2, 96, 96, 3), (2, 64, 64, 3)]
    for a, b in zip(ref["out_pyramid"], got["out_pyramid"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=0)


def test_total_loss_and_metrics_match_fldrx(train_pair):
    """total_loss to 1e-5 relative (measured 8.7e-8), each metric too (the
    smoothness term is ~5e-7 here, so it gets 1e-9 absolute)."""
    jm, tm = train_pair["jm"], train_pair["tm"]
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)


def test_gradients_match_fldrx(train_pair):
    """Every gradient leaf from torch.autograd against jax.grad of fldrx's
    loss: relative L2 ≤ 1e-3 (measured ≤ 5.8e-5, conv_flow1/b). Conv
    weight gradients are compared in fldrx's HWIO layout."""
    jg, tg = train_pair["jgrads"], train_pair["tgrads"]
    assert set(jg) == set(tg)
    for k in sorted(jg):
        a = jg[k].astype(np.float64)
        b = tg[k].astype(np.float64)
        assert a.shape == b.shape, k
        denom = max(np.linalg.norm(a), 1e-30)
        assert np.linalg.norm(a - b) / denom <= 1e-3, k


# -- losses ---------------------------------------------------------------------

def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _both(name, jargs, targs=None):
    targs = jargs if targs is None else targs
    ref = getattr(jl, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in jargs])
    got = getattr(tl, name)(*[torch.as_tensor(a) if isinstance(a, np.ndarray)
                              else a for a in targs])
    return float(got), float(ref)


def _flows(seed, B=2, H=32, W=48, scale=1.5):
    """Smooth flows [B,H,W,4] (coarse random vectors, bilinear)."""
    (c,) = _rng_arrays(seed, (B, 4, 6, 4), scale=scale)
    return np.asarray(torch.nn.functional.interpolate(
        torch.as_tensor(c).permute(0, 3, 1, 2), size=(H, W),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1))


LOSS_CASES = ["charbonnier", "rec_loss_fn", "pyramid_rec_loss",
              "smoothness_forward_loss", "endflow_forward_warp_loss",
              "smoothness_loss", "warping_loss", "warping_loss_endflow",
              "orthogonality_loss", "distillation_loss"]


@pytest.mark.parametrize("name", LOSS_CASES)
def test_loss_matches_fldrx(name):
    """Each loss of fldrx.train.losses against the port's on the same
    inputs, rtol 1e-5."""
    B, H, W = 2, 32, 48
    x, y = _rng_arrays(1, (B, H, W, 3), (B, H, W, 3), scale=0.5)
    if name == "charbonnier":
        pairs = [_both(name, (x, y))]
    elif name == "rec_loss_fn":
        pairs = []
        for kw in ({}, {"loss_type": "MSE"},
                   {"loss_type": "L1_Charbonnier_loss"},
                   {"t_optimization": True}):
            jf_ = jl.rec_loss_fn(jcfg.papermodel().replace(**kw))
            tf_ = tl.rec_loss_fn(tcfg.papermodel().replace(**kw))
            pairs.append((float(tf_(torch.as_tensor(x), torch.as_tensor(y))),
                          float(jf_(jnp.asarray(x), jnp.asarray(y)))))
    elif name == "pyramid_rec_loss":
        outs = [x, x[:, ::2, ::2].copy(), x[:, ::4, ::4].copy()]
        pairs = [(float(tl.pyramid_rec_loss(
            tcfg.papermodel(), [torch.as_tensor(o) for o in outs],
            torch.as_tensor(y))), float(jl.pyramid_rec_loss(
                jcfg.papermodel(), [jnp.asarray(o) for o in outs],
                jnp.asarray(y))))]
    elif name == "smoothness_forward_loss":
        img0, img1 = (np.tanh(a) for a in _rng_arrays(
            2, (B, H, W, 3), (B, H, W, 3), scale=0.02))
        pairs = [_both(name, (_flows(3), img0, img1))]
    elif name == "endflow_forward_warp_loss":
        fl = _flows(4)
        t = np.array([[0.4], [0.6]], np.float32)
        endflow = (fl[..., 0:2] * t[:, None, None], fl[..., 2:4]
                   * (1 - t[:, None, None]))
        ref = jl.endflow_forward_warp_loss(
            tuple(jnp.asarray(e) for e in endflow), jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(t))
        got = tl.endflow_forward_warp_loss(
            tuple(torch.as_tensor(e) for e in endflow), torch.as_tensor(x),
            torch.as_tensor(y), torch.as_tensor(t))
        pairs = [(float(got), float(ref))]
    elif name == "smoothness_loss":
        fl = _flows(5)[..., :2]
        img = np.tanh(_rng_arrays(6, (B, H, W, 3), scale=0.02)[0])
        pairs = [_both(name, (fl, img, 150.0, ea)) for ea in (True, False)]
    elif name == "warping_loss":
        frames = np.stack([x, y], 1)
        pairs = [_both(name, (frames, _flows(7)))]
    elif name == "warping_loss_endflow":
        frames = np.stack([x, y], 1)
        fl = _flows(8)
        ref = jl.warping_loss_endflow(
            jnp.asarray(frames), jnp.asarray(x),
            (jnp.asarray(fl[..., :2]), jnp.asarray(fl[..., 2:])))
        got = tl.warping_loss_endflow(
            torch.as_tensor(frames), torch.as_tensor(x),
            (torch.as_tensor(fl[..., :2]), torch.as_tensor(fl[..., 2:])))
        pairs = [(float(got), float(ref))]
    elif name == "orthogonality_loss":
        ev1, ev2 = _rng_arrays(9, (16, 64), (16, 64), scale=0.1)
        pairs = [_both(name, (ev1, ev2))]
    else:
        pyr = [_flows(10, H=8, W=12), _flows(11, H=4, W=6),
               _flows(12, H=2, W=3)]
        gt = _flows(13, H=64, W=96)
        ref = jl.distillation_loss([jnp.asarray(f) for f in pyr],
                                   jnp.asarray(gt))
        got = tl.distillation_loss([torch.as_tensor(f) for f in pyr],
                                   torch.as_tensor(gt))
        pairs = [(float(got), float(ref))]
    for got, ref in pairs:
        assert np.isfinite(ref) and ref != 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("switches", [{}, {"warping_loss": True,
                                           "orth_loss": True}])
def test_total_loss_switches_match_fldrx(switches):
    """total_loss and its metrics on a synthetic forward output, with the
    optional warping and orthogonality terms off and on (epoch 3 of 200:
    annealing weight > 0; EVs far from orthogonal, so orth ≥ 0.1 is added),
    rtol 1e-5."""
    B, H, W = 2, 64, 64
    rng = np.random.RandomState(14)
    out_pyr = [(rng.rand(B, H >> i, W >> i, 3) * 2 - 1).astype(np.float32)
               for i in range(3)]
    target = (rng.rand(B, H, W, 3) * 2 - 1).astype(np.float32)
    frames = (rng.rand(B, 2, H, W, 3) * 2 - 1).astype(np.float32)
    t = np.array([[0.25], [0.5]], np.float32)
    fr = _flows(15, B, H // 8, W // 8, 0.5)
    ef = _flows(16, B, H, W, 1.0)
    unref = [_flows(17 + i, B, H >> (3 + i), W >> (3 + i), 0.5)
             for i in range(3)]
    ev = (rng.randn(16, 64) * 0.3).astype(np.float32)
    out = {"out_pyramid": out_pyr, "flow_refine_pyramid": [fr],
           "endflow_pyramid": [(ef[..., :2], ef[..., 2:])],
           "unrefined_flow_pyramid": unref}

    def conv(tree, f):
        if isinstance(tree, dict):
            return {k: conv(v, f) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(conv(v, f) for v in tree)
        return f(tree)

    jc = jcfg.papermodel().replace(**switches)
    tc = tcfg.papermodel().replace(**switches)
    jtot, jm = jl.total_loss(jc, conv(out, jnp.asarray), jnp.asarray(target),
                             jnp.asarray(frames), jnp.asarray(t),
                             params={"pca": {"ev": jnp.asarray(ev)}},
                             epoch=3)
    ttot, tm = tl.total_loss(tc, conv(out, torch.as_tensor),
                             torch.as_tensor(target), torch.as_tensor(frames),
                             torch.as_tensor(t),
                             params={"pca": {"ev": torch.as_tensor(ev)}},
                             epoch=3)
    if switches:
        assert float(jm["orth"]) >= 0.1
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-5)
