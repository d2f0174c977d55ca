"""The port's optimiser, parameter groups, fresh parameters, PCA fit,
checkpoints, resume and training loop held against fldrx on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fldrx import config as jcfg
from fldrx.model.fldrnet import init_params as j_init_params
from fldrx.ops.block_pca import fit_block_pca as j_fit_block_pca
from fldrx.tools.convert_ckpt import flatten_params as jflatten
from fldrx.train import trainer as jtrainer
from fldrx.train.checkpoint import SaveManager as JSaveManager
from fldrx.train.loop import fit_pca_from_batch as j_fit_pca_from_batch
from fldrx.utils.tbevents import read_events as j_read_events
from fldrx_torch import config as tcfg
from fldrx_torch.bench_inputs import train_batch
from fldrx_torch.model.fldrnet import init_params
from fldrx_torch.ops.block_pca import fit_block_pca
from fldrx_torch.train import loop as tloop
from fldrx_torch.train.checkpoint import SaveManager
from fldrx_torch.train.trainer import (TrainState, make_train_step,
                                       param_labels)
from fldrx_torch.utils.tbevents import EventWriter
from fldrx_torch.weights import (flatten_params, named_leaves,
                                 params_from_numpy, params_to_numpy)

torch.set_num_threads(1)


def _port_params(cfg, seed=0):
    return init_params(torch.Generator().manual_seed(seed), cfg)


def _flat_np(tree):
    return flatten_params(params_to_numpy(tree))


# -- parameters -----------------------------------------------------------------

@pytest.mark.parametrize("exac_one_ev", [True, False])
def test_init_params_tree_matches_fldrx(exac_one_ev):
    """init_params has fldrx's tree and shapes (in fldrx's HWIO layout
    after params_to_numpy), zero biases, fldrx's PCA placeholders and a
    xavier-normal spread."""
    jc = jcfg.papermodel().replace(exac_one_ev=exac_one_ev)
    tc = tcfg.papermodel().replace(exac_one_ev=exac_one_ev)
    ref = jflatten(jax.tree.map(np.asarray,
                                j_init_params(jax.random.PRNGKey(0), jc)))
    got = _flat_np(_port_params(tc))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32, k
        if not k.endswith("/w"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    w = got["vfinet/conv_flow1/w"]                # 3×3, 96 → 48
    assert abs(w.std() / np.sqrt(2.0 / (9 * 96 + 9 * 48)) - 1) < 0.02


def test_param_labels_match_fldrx():
    for kw in ({}, {"t_optimization": True}, {"exac_one_ev": False}):
        jc = jcfg.papermodel().replace(**kw)
        tc = tcfg.papermodel().replace(**kw)
        ref = jflatten(jtrainer.param_labels(
            j_init_params(jax.random.PRNGKey(0), jc), jc))
        got = dict(named_leaves(param_labels(_port_params(tc), tc)))
        assert got == {k: str(v) for k, v in ref.items()}, kw


def test_fit_block_pca_matches_fldrx_bitwise():
    rng = np.random.RandomState(0)
    imgs = rng.rand(6, 64, 48) * 2 - 1
    a, b = fit_block_pca(imgs, 16), j_fit_block_pca(imgs, 16)
    for f in ("mean", "eigenvectors", "mean_vec", "eigenvalues"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    frames = train_batch(64, np.array([[0.5], [0.5]]), seed=1)["frames"]
    cfg = tcfg.papermodel()
    got = tloop.fit_pca_from_batch(frames, cfg)["pca"]
    ref = j_fit_pca_from_batch(frames, jcfg.papermodel())["pca"]
    for k in ("mean", "ev", "mean_vec"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


# -- optimiser --------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_matches_optax(weight_decay):
    """The same 6 synthetic gradient trees through the port's optimiser
    and fldrx's optax chain, steps_per_epoch=2 and milestone epoch 2 (the
    rate drops from update 4): every parameter agrees to 1e-6 after each
    update; meanVec never moves. With weight_decay the decay is optax's
    decoupled form."""
    kw = dict(init_lr=1e-2, lr_milestones=(2,), lr_dec_fac=0.25,
              weight_decay=weight_decay)
    jc = jcfg.papermodel().replace(**kw)
    tc = tcfg.papermodel().replace(**kw)
    jparams = j_init_params(jax.random.PRNGKey(0), jc)
    jstate = jtrainer.TrainState.create(jparams, jc, steps_per_epoch=2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tstate = TrainState.create(tparams, tc, steps_per_epoch=2)
    rng = np.random.RandomState(0)
    for _ in range(6):
        grads = jax.tree.map(
            lambda a: rng.randn(*a.shape).astype(np.float32), jparams)
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, grads))
        for (_, p), (_, g) in zip(named_leaves(tparams),
                                  named_leaves(params_from_numpy(grads))):
            p.grad = g if p.requires_grad else None
        tstate.apply_gradients()
        ref = jflatten(jax.tree.map(np.asarray, jstate.params))
        got = _flat_np(tparams)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0,
                                       err_msg=k)
    assert tstate.step == 6 and int(jstate.step) == 6
    np.testing.assert_array_equal(got["pca/mean_vec"],
                                  np.asarray(jparams["pca"]["mean_vec"]))


def _tiny_batch(B=2, size=64, seed=0):
    return train_batch(size, np.full((B, 1), 0.5, np.float32), seed)


def test_toptim_moves_only_T_param():
    """Under T-optimisation one train step moves vfinet/T_param and no
    other parameter."""
    cfg = tcfg.papermodel().replace(S_trn=1, phase="train",
                                    t_optimization=True, init_lr=1e-2)
    state = TrainState.create(_port_params(cfg), cfg)
    before = _flat_np(state.params)
    m = make_train_step(cfg)(state, _tiny_batch())
    assert np.isfinite(float(m["loss"]))
    after = _flat_np(state.params)
    moved = [k for k in before if not np.array_equal(before[k], after[k])]
    assert moved == ["vfinet/T_param"]


def test_train_step_after_inference():
    """Inference (under torch.inference_mode) and then a train step in one
    process: nothing that inference caches may reach the backward pass."""
    from fldrx_torch.eval.pipeline import Interpolator
    cfg = tcfg.papermodel().replace(S_trn=1, S_tst=1, phase="train")
    params = _port_params(cfg)
    frames = _tiny_batch(B=1)["frames"]
    out = Interpolator(params, cfg.replace(phase="test"), device="cpu") \
        .interpolate_np(frames, [[0.5]])
    assert out.shape == (1, 64, 64, 3)
    state = TrainState.create(params, cfg)
    m = make_train_step(cfg)(state, _tiny_batch())
    assert np.isfinite(float(m["loss"])) and state.step == 1


def test_train_step_decreases_loss():
    cfg = tcfg.papermodel().replace(S_trn=1, phase="train", init_lr=1e-3)
    state = TrainState.create(_port_params(cfg), cfg)
    step = make_train_step(cfg)
    batch = _tiny_batch()
    losses = [float(step(state, batch)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert state.step == 6


# -- checkpoints, logs and the loop --------------------------------------------------

def _trained_state(cfg):
    state = TrainState.create(_port_params(cfg), cfg)
    make_train_step(cfg)(state, _tiny_batch())
    return state


def test_checkpoint_loads_in_fldrx(tmp_path):
    """A checkpoint the port writes loads in fldrx's SaveManager with equal
    params (fldrx names, HWIO), and back in the port with its optimiser
    state, step and meta."""
    kw = dict(S_trn=1, phase="train", checkpoint_dir=str(tmp_path / "ck"),
              text_dir=str(tmp_path / "tx"))
    tc = tcfg.papermodel().replace(**kw)
    state = _trained_state(tc)
    sm = SaveManager(tc)
    sm.save(state.params, {"last_epoch": 9, "best_PSNR": 25.5},
            opt_state=state.optimizer_state(), step=state.step, best=True,
            epoch=9)
    assert sm.exists() and sm.exists(take_best=True)
    jparams, jmeta, _ = JSaveManager(jcfg.papermodel().replace(**kw)).load(
        take_best=True)
    assert int(jmeta["last_epoch"]) == 9 and int(jmeta["step"]) == 1
    ref = _flat_np(state.params)
    got = jflatten(jparams)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    tree, meta, opt = sm.load(specific_epoch=9)
    fresh = TrainState.create(params_from_numpy(tree), tc)
    fresh.load_optimizer_state(opt, int(meta["step"]))
    assert fresh.step == 1 and float(meta["best_PSNR"]) == 25.5
    a, b = state.optimizer_state(), fresh.optimizer_state()
    assert set(a) == set(b) and len(a) == 44     # all but meanVec
    for k in a:
        for f in ("exp_avg", "exp_avg_sq", "step"):
            np.testing.assert_array_equal(a[k][f], b[k][f])
    sm.write_info("hello")
    assert "hello" in open(sm.text_path).read()


def test_event_file_reads_in_fldrx(tmp_path):
    w = EventWriter(str(tmp_path))
    w.add_scalars({"Loss/train": 0.25, "PSNR/val": 31.5}, step=7)
    w.add_scalar("Loss/warp", 0.125, step=8)
    w.close()
    assert j_read_events(w.path) == [(7, {"Loss/train": 0.25,
                                          "PSNR/val": 31.5}),
                                     (8, {"Loss/warp": 0.125})]


def _toy_xtrain(tmp_path, n_frames=65, hw=(96, 128)):
    from PIL import Image
    root = str(tmp_path / "xtrain")
    rng = np.random.RandomState(7)
    d = os.path.join(root, "s1", "clip1")
    os.makedirs(d, exist_ok=True)
    for i in range(n_frames):
        Image.fromarray(rng.randint(0, 255, (*hw, 3), np.uint8)).save(
            os.path.join(d, f"{i:04d}.png"))
    return root


def test_resume_matches_uninterrupted(tmp_path):
    """Training stopped after 2 epochs and resumed for 2 more reproduces 4
    epochs straight: the optimiser moments, the step and the schedule
    position (the rate drops inside the run) survive the restart."""
    base = tcfg.papermodel().replace(
        S_trn=1, phase="train", batch_size=1, patch_size=64, init_lr=1e-3,
        lr_milestones=(1,), lr_dec_fac=0.25,
        x_train_data_path=_toy_xtrain(tmp_path),
        checkpoint_dir=str(tmp_path / "ckA"), text_dir=str(tmp_path / "txA"),
        log_dir=str(tmp_path / "lgA"))
    kw = dict(max_steps_per_epoch=2, no_validation=True, verbose=False,
              seed=3, device="cpu")
    p_full, _ = tloop.train(base.replace(epochs=4), **kw)
    cfg_b = base.replace(epochs=2, checkpoint_dir=str(tmp_path / "ckB"),
                         text_dir=str(tmp_path / "txB"),
                         log_dir=str(tmp_path / "lgB"))
    tloop.train(cfg_b, **kw)
    p_res, _ = tloop.train(cfg_b.replace(epochs=4), continue_training=True,
                           **kw)
    a, b = _flat_np(p_full), _flat_np(p_res)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    lines = open(os.path.join(str(tmp_path / "txB"),
                              f"{cfg_b.model_dir}_scalars.jsonl")).readlines()
    assert len(lines) == 4 and '"step": 4' in lines[-1]


def test_train_refuses_what_is_not_ported(tmp_path):
    cfg = tcfg.papermodel().replace(checkpoint_dir=str(tmp_path / "ck"),
                                    text_dir=str(tmp_path / "tx"))
    with pytest.raises(NotImplementedError, match="evaluator"):
        tloop.train(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="visualiser"):
        tloop.train(cfg.replace(save_images=True), no_validation=True,
                    device="cpu")
    with pytest.raises(NotImplementedError, match="Orbax"):
        tloop.train(cfg.replace(use_orbax=True), no_validation=True,
                    device="cpu")
