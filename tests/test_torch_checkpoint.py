"""The asynchronous checkpoints (fldrx_torch/train/checkpoint.py
AsyncSaveManager, the counterpart of fldrx's OrbaxSaveManager): the same
files as SaveManager array by array, a snapshot that the next step's
in-place update cannot reach, writes that overlap the caller, failures
raised at the next call, files fldrx's SaveManager reads, and train() with
use_orbax equal to the synchronous run bit for bit."""

import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fldrx import config as jcfg
from fldrx.tools.convert_ckpt import flatten_params as jflatten
from fldrx.train.checkpoint import SaveManager as JSaveManager
from fldrx_torch import config as tcfg
from fldrx_torch.bench_inputs import train_batch
from fldrx_torch.model.fldrnet import init_params
from fldrx_torch.train import loop as tloop
from fldrx_torch.train.checkpoint import AsyncSaveManager, SaveManager
from fldrx_torch.train.trainer import TrainState, make_train_step
from fldrx_torch.weights import flatten_params, params_to_numpy

torch.set_num_threads(1)

TAGS = ("latest", "best_PSNR", "epc9")


def _cfg(tmp_path, name):
    return tcfg.papermodel().replace(
        S_trn=1, phase="train", checkpoint_dir=str(tmp_path / name / "ck"),
        text_dir=str(tmp_path / name / "tx"))


def _trained_state(cfg):
    """Parameters and Adam moments after one step on a 2×64² batch."""
    state = TrainState.create(
        init_params(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    batch = train_batch(64, np.array([[0.25], [0.5]], np.float32), seed=1)
    make_train_step(cfg)(state, batch)
    return state


def _save(sm, state):
    sm.save(state.params, {"last_epoch": 9, "best_PSNR": 25.5},
            opt_state=state.optimizer_state(), step=state.step, best=True,
            epoch=9)


def _arrays(sm, tag):
    with np.load(sm._path(tag)) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    return _trained_state(_cfg(tmp_path_factory.mktemp("s"), "s"))


@pytest.fixture
def gated_savez(monkeypatch):
    """np.savez waits for the returned Event before it writes."""
    gate = threading.Event()
    real = np.savez

    def savez(*args, **kw):
        assert gate.wait(timeout=60)
        return real(*args, **kw)

    monkeypatch.setattr(np, "savez", savez)
    return gate


def test_files_equal_sync_array_by_array(tmp_path, state):
    sync = SaveManager(_cfg(tmp_path, "sync"))
    _save(sync, state)
    asy = AsyncSaveManager(_cfg(tmp_path, "async"))
    _save(asy, state)
    asy.close()
    for tag in TAGS:
        a, b = _arrays(sync, tag), _arrays(asy, tag)
        assert set(a) == set(b) and len(a) > 100
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not [f for f in os.listdir(asy.ckpt_dir) if f.endswith(".tmp")]


def test_save_returns_before_the_write_ends(tmp_path, state, gated_savez):
    sm = AsyncSaveManager(_cfg(tmp_path, "a"))
    _save(sm, state)                   # returns while np.savez waits
    assert not os.path.exists(sm._path("latest"))
    gated_savez.set()
    assert sm.exists(take_best=True)   # waits for the write in flight
    sm.close()


def test_in_place_update_after_save_leaves_the_file(tmp_path, gated_savez):
    """AdamW updates the parameters and moments in place on the next step:
    the file holds the values at save(), not after."""
    cfg = _cfg(tmp_path, "a")
    st = _trained_state(cfg)
    want = {f"params/{k}": v for k, v in
            flatten_params(params_to_numpy(st.params)).items()}
    moments = st.optimizer_state()
    sm = AsyncSaveManager(cfg)
    _save(sm, st)
    make_train_step(cfg)(st, train_batch(
        64, np.array([[0.75], [0.5]], np.float32), seed=2))
    with torch.no_grad():
        for p in st.optimizer.state:
            st.optimizer.state[p]["exp_avg"].add_(1.0)
    gated_savez.set()
    sm.close()
    got = _arrays(sm, "latest")
    changed = 0
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for name, st_np in moments.items():
        for f, v in st_np.items():
            np.testing.assert_array_equal(got[f"opt/{name}/{f}"], v)
    for k, v in flatten_params(params_to_numpy(st.params)).items():
        changed += not np.array_equal(v, want[f"params/{k}"])
    assert changed > 40                # the step did move them in place
    assert int(got["meta/step"]) == 1


def test_writer_failure_raised_at_the_next_call(tmp_path, state,
                                                monkeypatch):
    def fail(*args, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "savez", fail)
    sm = AsyncSaveManager(_cfg(tmp_path, "a"))
    _save(sm, state)                   # the failure is in the writer
    with pytest.raises(OSError, match="no space left"):
        sm.close()
    assert not os.path.exists(sm._path("latest"))
    sm2 = AsyncSaveManager(_cfg(tmp_path, "b"))
    _save(sm2, state)
    with pytest.raises(OSError, match="no space left"):
        sm2.load()
    sm2.close()                        # raised once, not again


def test_fldrx_loads_the_files(tmp_path, state):
    cfg = _cfg(tmp_path, "a")
    sm = AsyncSaveManager(cfg)
    _save(sm, state)
    sm.close()
    jparams, jmeta, _ = JSaveManager(jcfg.papermodel().replace(
        checkpoint_dir=cfg.checkpoint_dir, text_dir=cfg.text_dir)).load(
            take_best=True)
    assert int(jmeta["last_epoch"]) == 9 and int(jmeta["step"]) == 1
    ref = flatten_params(params_to_numpy(state.params))
    got = jflatten(jparams)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _toy_xtrain(root, n_frames=65, hw=(80, 96)):
    rng = np.random.RandomState(7)
    d = os.path.join(root, "s1", "clip1")
    os.makedirs(d)
    for i in range(n_frames):
        Image.fromarray(rng.randint(0, 255, (*hw, 3), np.uint8)).save(
            os.path.join(d, f"{i:04d}.png"))
    return root


def test_train_use_orbax_equals_the_sync_run(tmp_path):
    """One epoch, then a resume for a second, with the asynchronous
    checkpoints: the parameters, the files and the resumed run equal the
    synchronous run's bit for bit; train() has written the files when it
    returns."""
    data = _toy_xtrain(str(tmp_path / "xtrain"))
    kw = dict(max_steps_per_epoch=1, no_validation=True, verbose=False,
              seed=3, device="cpu")
    out = {}
    for name, orbax in (("sync", False), ("async", True)):
        cfg = tcfg.papermodel().replace(
            S_trn=1, phase="train", batch_size=1, patch_size=64,
            x_train_data_path=data, use_orbax=orbax,
            checkpoint_dir=str(tmp_path / name / "ck"),
            text_dir=str(tmp_path / name / "tx"),
            log_dir=str(tmp_path / name / "lg"))
        tloop.train(cfg.replace(epochs=1), **kw)
        first = _arrays(SaveManager(cfg), "latest")
        params, _ = tloop.train(cfg.replace(epochs=2),
                                continue_training=True, **kw)
        out[name] = (first, flatten_params(params_to_numpy(params)),
                     _arrays(SaveManager(cfg), "latest"))
    for a, b in zip(out["sync"], out["async"]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(out["async"][2]["meta/step"]) == 2
