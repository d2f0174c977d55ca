"""fldrx_torch configuration, checkpoint loading and import hygiene, held
against the JAX package on the CPU."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from fldrx import config as jcfg
from fldrx.model.fldrnet import init_params
from fldrx.tools.convert_ckpt import flatten_params, load_params_npz
from fldrx_torch import config as tcfg
from fldrx_torch.api import DEFAULT_NPZ, prepare_model
from fldrx_torch.weights import load_npz, params_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hwio(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy_tree(v) for v in tree]
    return _hwio(tree.numpy())


@pytest.mark.parametrize("preset", ["papermodel", "papermodel_test5"])
def test_config_presets_match_fldrx(preset):
    a = dataclasses.asdict(getattr(jcfg, preset)())
    b = dataclasses.asdict(getattr(tcfg, preset)())
    assert a == b
    for n in (3, 4, 5, 6, 7):
        ja = jcfg.apply_test_scales(jcfg.papermodel(), n)
        ta = tcfg.apply_test_scales(tcfg.papermodel(), n)
        assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
        assert (ja.nf, ja.dctvfi_nf, ja.div_pad) == (ta.nf, ta.dctvfi_nf,
                                                     ta.div_pad)


def test_load_npz_matches_fldrx_tree():
    """Every checkpoint tensor equals fldrx's load_params_npz tree after
    the OIHW → HWIO transpose; extras and meta come through unchanged."""
    jtree, jextras, jmeta = load_params_npz(DEFAULT_NPZ)
    ttree, textras, tmeta = load_npz(DEFAULT_NPZ)
    params = params_from_numpy(ttree, "cpu")
    jflat = flatten_params(jtree)
    tflat = flatten_params(_to_numpy_tree(params))
    assert len(jflat) + len(jextras) + len(jmeta) == 59
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        assert tflat[k].dtype == np.float32
        np.testing.assert_array_equal(tflat[k], v, err_msg=k)
    assert sorted(textras) == sorted(jextras)
    assert sorted(tmeta) == sorted(jmeta)
    for k in jextras:
        np.testing.assert_array_equal(textras[k], jextras[k])
    w = params["vfinet"]["refine"]["enc1"]["w"]
    assert tuple(w.shape) == (16, 26, 4, 4)            # OIHW


def test_params_from_numpy_defaults_to_the_card():
    """With no device, the weights go to cuda: without a GPU the loader
    raises rather than fall back to the CPU; `device="cpu"` loads there."""
    tree = {"conv": {"w": np.ones((3, 3, 2, 4), np.float32),
                     "b": np.zeros(4, np.float32)}}
    assert params_from_numpy(tree, "cpu")["conv"]["w"].is_cpu
    if torch.cuda.is_available():
        assert params_from_numpy(tree)["conv"]["w"].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree)


def test_params_from_numpy_roundtrips_init_params():
    cfg = jcfg.papermodel().replace(exac_one_ev=False)
    tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(3), cfg))
    back = flatten_params(_to_numpy_tree(params_from_numpy(tree, "cpu")))
    ref = flatten_params(tree)
    assert sorted(back) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_prepare_model_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_model()
    interp, cfg, dev = prepare_model(device="cpu")
    assert dev.type == "cpu" and interp.device.type == "cpu"
    assert cfg == tcfg.papermodel_test5()


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "fldrx_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_fldrx():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    optax, orbax or any part of the JAX package fldrx (AST scan of every
    import)."""
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "orbax", "fldrx"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {m}")
    assert not bad, bad
