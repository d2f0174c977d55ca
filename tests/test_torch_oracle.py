"""Measurement 1 of the parity report on the CPU: the inverse of the
checkpoint converter, the port's JAX-free copy of the reference's torch
oracle against tests/reference_oracle.py, the port's and fldrx's strict
paths against it on the in-repo checkpoint, and the report's CLI.

fldrx runs with no FLDRX_* overrides, so its strict path's resizes take
their default precision. Inputs are made from seeds with numpy.
"""

import importlib
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fldrx.tools import convert_ckpt as jconv
from fldrx_torch.api import DEFAULT_NPZ
from fldrx_torch.eval.pipeline import build_pyramid
from fldrx_torch.tools import convert_ckpt as tconv
from fldrx_torch.tools import parity_report as tparity
from fldrx_torch.tools import reference_oracle as toracle
from fldrx_torch.weights import flatten_params, load_npz
from reference_oracle import oracle_forward_test

torch.set_num_threads(1)

# the strict path against the oracle: ROADMAP's North star bar
STRICT_BAR = 1e-4


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


def _npz_state_dict():
    tree, extras, _ = load_npz(DEFAULT_NPZ)
    return tree, extras, tconv.params_to_state_dict(tree, extras)


def test_params_to_state_dict_inverts_state_dict_to_params():
    """The npz's parameters and extras come back array by array, through
    the port's state_dict_to_params and fldrx's; the round trip adds only
    the per-scale `pca_multi` fits, made of `pca` and the extras. Conv
    weights are OIHW."""
    tree, extras, sd = _npz_state_dict()
    assert sd["vfinet.refine_unet.enc1.weight"].shape == (16, 26, 4, 4)
    assert sd["rec_ctx_ds.0.weight"].shape == (96, 96, 3, 3)
    flat = flatten_params(tree)
    for conv in (tconv, jconv):
        p, e = conv.state_dict_to_params(sd)
        back = flatten_params(p)
        assert {k for k in back if k not in flat} == {
            f"pca_multi/s{s}/{n}" for s in (8, 16, 32, 64)
            for n in ("mean", "ev", "mean_vec")}
        for k, v in flat.items():
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert set(e) == set(extras)
        for k, v in extras.items():
            np.testing.assert_array_equal(e[k], v, err_msg=k)
        for n, k in (("mean", "Mean"), ("ev", "EV"), ("mean_vec", "meanVec")):
            np.testing.assert_array_equal(back[f"pca_multi/s8/{n}"],
                                          flat[f"pca/{n}"])
            np.testing.assert_array_equal(back[f"pca_multi/s32/{n}"],
                                          extras[f"{k}32"])


def _random_state_dict(like, seed=0):
    """Seeded random weights of the checkpoint's shapes: convs scaled by
    their fan-in, a positive PCA normaliser, T and z_alpha of order 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in like.items():
        if k.endswith(".weight"):
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[1:]))
        elif k.startswith("meanVec") or k in ("vfinet.T_param",
                                               "vfinet.z_alpha"):
            a = rng.uniform(0.5, 2.0, v.shape)
        else:
            a = rng.randn(*v.shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def _small_pyramid(H=128, W=192, S_tst=2):
    cfg = tparity.strict_config().replace(S_tst=S_tst)
    frames = torch.from_numpy(tparity.natural_frames(H, W, shift=10))
    return [p.permute(0, 4, 1, 2, 3).numpy()
            for p in build_pyramid(frames, cfg, S_tst + 1)]


@pytest.mark.parametrize("weights", ["npz", "random"])
def test_oracle_copy_equals_the_test_oracle(weights):
    """The port's copy computes what tests/reference_oracle.py computes,
    bit for bit, at 128×192 with S_tst = 2."""
    sd = _npz_state_dict()[2]
    if weights == "random":
        sd = _random_state_dict(sd)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    pyr = _small_pyramid()
    t = np.full((1, 1), 0.375, np.float32)
    got = toracle.oracle_forward_test(sd, pyr, t, 2)
    ref = oracle_forward_test(sd, pyr, t, 2)
    assert got.shape == (1, 3, 128, 192) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_strict_path_against_the_oracle():
    """PARITY.md §1's setting (768×1280, S_tst = 5, t = 0.375) on the
    in-repo checkpoint: the port's strict path within 1e-4 max abs of the
    oracle (7.42e-6 on the CPU)."""
    r = tparity.measure_oracle(device="cpu")
    assert r["source"] == os.path.join("checkpoints", "fldrnet_best.npz")
    assert r["hw"] == [768, 1280] and r["S_tst"] == 5
    assert r["strict"]["max_abs"] <= STRICT_BAR, r


def test_fldrx_strict_path_against_the_oracle():
    """fldrx's strict forward_test on the npz against the same oracle at
    128×192, S_tst = 2, within the same bar: the npz oracle reproduces
    fldrx's own §1 comparison."""
    from fldrx.api import prepare_model as j_prepare_model
    from fldrx.config import papermodel_test5 as j_test5
    from fldrx.eval.pipeline import build_pyramid as j_build_pyramid
    from fldrx.model.fldrnet import forward_test as j_forward_test

    cfg = j_test5().replace(compute_dtype="float32", fast_warp=False,
                            S_tst=2)
    params = j_prepare_model(DEFAULT_NPZ, cfg)[0].params
    frames = jnp.asarray(tparity.natural_frames(128, 192, shift=10))
    pyr = j_build_pyramid(frames, cfg, 3)
    t = np.full((1, 1), 0.375, np.float32)
    fwd = jax.jit(j_forward_test, static_argnums=1)
    got = np.moveaxis(np.asarray(fwd(params, cfg, pyr, jnp.asarray(t))),
                      -1, 1)
    sd = {k: torch.from_numpy(v) for k, v in _npz_state_dict()[2].items()}
    ref = toracle.oracle_forward_test(
        sd, [np.array(p, np.float32).transpose(0, 4, 1, 2, 3) for p in pyr],
        t, 2)
    assert np.abs(got - ref).max() <= STRICT_BAR


def test_report_cli_writes_measurement_1(tmp_path):
    """The CLI writes §1 on the npz ahead of §2-3 by default, omits it with
    --skip-oracle, and refuses a reference .pt that is absent."""
    out = tmp_path / "parity.md"
    assert tparity.main(["--device", "cpu", "--hw", "64", "64",
                         "--out", str(out)]) == 0
    text = out.read_text()
    assert text.index("## 1. Strict path") < text.index("## 2.") \
        < text.index("## 3.")
    assert "checkpoints/fldrnet_best.npz" in text
    max_abs = float(re.search(r"max abs diff: \*\*([0-9.e+-]+)\*\*",
                              text).group(1))
    assert max_abs <= STRICT_BAR
    assert tparity.main(["--device", "cpu", "--hw", "64", "64",
                         "--out", str(out), "--skip-oracle"]) == 0
    assert "## 1." not in out.read_text() and "## 2." in out.read_text()
    with pytest.raises(FileNotFoundError, match="missing.pt"):
        tparity.main(["--device", "cpu", "--oracle",
                      str(tmp_path / "missing.pt")])
