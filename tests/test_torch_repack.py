"""fldrx_torch's u-plane layout held against the JAX package on the CPU:
the interleave (the plain version against fldrx's Pallas kernel in
interpret mode, bit-exact), the deinterleave (against fldrx's
extract_planes through its XLA fallback and through its Pallas kernels in
interpret mode, bit-exact, and its refusals), and the packed synthesis's
planes_out return against fldrx's (≤ 1e-4 max abs) and against its own
plain rows (bit-exact).
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fldrx.model import fldrnet as jf
from fldrx.ops import repack as jrepack
from fldrx_torch import config as tcfg
from fldrx_torch.model import fldrnet as tf
from fldrx_torch.ops import repack
from fldrx_torch.weights import params_from_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _exact_reference():
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("FLDRX_")}
    yield
    os.environ.update(saved)


@pytest.mark.parametrize("shape,dtype", [
    ((4, 32, 384), "float32"),      # fldrx's one-hot matmul kernel
    ((4, 32, 384), "bfloat16"),
    ((4, 5, 21), "float32"),        # too small for a kernel: XLA's stack
])
def test_interleave_matches_fldrx(shape, dtype):
    """interleave_planes on CPU tensors (the plain version, no launch)
    against fldrx's interleave_planes in interpret mode, bit for bit."""
    rng = np.random.RandomState(1)
    a = rng.randn(*shape).astype(np.float32)
    ja = jnp.asarray(a).astype(dtype)
    os.environ["FLDRX_PALLAS_INTERPRET"] = "1"
    try:
        ref = np.asarray(importlib.reload(jrepack).interleave_planes(ja)
                         .astype(jnp.float32))
    finally:
        del os.environ["FLDRX_PALLAS_INTERPRET"]
        importlib.reload(jrepack)
    before = dict(repack.LAUNCHES)
    ta = torch.tensor(a).to(getattr(torch, dtype))
    got = repack.interleave_planes(ta[None])[0].float().numpy()
    assert repack.LAUNCHES == before
    assert got.shape == (4 * shape[1], shape[2])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        repack.interleave_planes_plain(ta[None].expand(2, -1, -1, -1))[1]
        .float().numpy(), ref)


def test_interleave_refuses_bad_shapes():
    with pytest.raises(ValueError, match="interleave_planes"):
        repack.interleave_planes(torch.zeros(1, 3, 2, 6))


def _fldrx_extract_planes(img, interpret: bool) -> np.ndarray:
    """fldrx's extract_planes on [H, W, C], as float32 numpy; with
    `interpret` its module is reloaded under FLDRX_PALLAS_INTERPRET=1 so
    that its Pallas kernels run in interpret mode."""
    if not interpret:
        return np.asarray(jrepack.extract_planes(img).astype(jnp.float32))
    os.environ["FLDRX_PALLAS_INTERPRET"] = "1"
    try:
        return np.asarray(importlib.reload(jrepack).extract_planes(img)
                          .astype(jnp.float32))
    finally:
        del os.environ["FLDRX_PALLAS_INTERPRET"]
        importlib.reload(jrepack)


@pytest.mark.parametrize("case,hwc,dtype", [
    # fldrx's XLA fallback (strided row slices)
    ("xla", (128, 128, 3), "float32"),
    ("xla", (128, 128, 3), "bfloat16"),
    ("xla", (20, 7, 3), "float32"),
    # interpret mode: H a multiple of 128 reaches the one-hot matmul kernel
    # _deinterleave_kernel2; 96 rows of 1024 elements the row-DMA kernel
    # _deinterleave_kernel
    ("interpret", (128, 128, 3), "float32"),
    ("interpret", (256, 128, 3), "bfloat16"),
    ("interpret", (96, 256, 4), "float32"),
    ("interpret", (20, 7, 3), "bfloat16"),
    # interleave_planes(extract_planes(x)) == x
    ("round_trip", (36, 10, 3), "float32"),
    ("round_trip", (128, 128, 3), "bfloat16"),
    # refusals: H not a multiple of 4, a dtype the kernel does not take
    ("refuse_shape", (6, 8, 3), "float32"),
    ("refuse_dtype", (8, 8, 3), "float64"),
])
def test_extract_planes(case, hwc, dtype):
    """extract_planes on CPU tensors (the plain version, no launch) against
    fldrx's extract_planes, its round trip through interleave_planes, and
    its refusals; every comparison bit for bit."""
    H, W, C = hwc
    a = np.random.RandomState(H + W).randn(H, W, C).astype(np.float32)
    rows = torch.tensor(a.reshape(1, H, W * C)).to(getattr(torch, dtype))
    if case == "refuse_shape":
        with pytest.raises(ValueError, match="extract_planes"):
            repack.extract_planes(rows)
        return
    if case == "refuse_dtype":
        with pytest.raises(TypeError, match="extract_planes"):
            repack.extract_planes(rows)
        return
    before = dict(repack.LAUNCHES)
    got = repack.extract_planes(rows)
    assert repack.LAUNCHES == before
    assert got.shape == (1, 4, H // 4, W * C) and got.dtype == rows.dtype
    if case == "round_trip":
        assert torch.equal(repack.interleave_planes(got), rows)
        return
    ref = _fldrx_extract_planes(jnp.asarray(a).astype(dtype),
                                case == "interpret")
    np.testing.assert_array_equal(got[0].float().numpy(), ref)
    np.testing.assert_array_equal(
        repack.extract_planes_plain(rows.expand(2, -1, -1))[1].float()
        .numpy(), ref)


def test_synthesize_packed_planes_out_matches_fldrx():
    """The packed synthesis with planes_out against fldrx's (the setup of
    tests/test_model_parity.py, fldrx's random weights carried across):
    max abs ≤ 1e-4; its host unpack equals the port's plain rows bit for
    bit, as the interleave is a permutation."""
    cfg = tcfg.papermodel().replace(fast_warp=True, packed_synth=True)
    from fldrx.config import papermodel
    jparams = jf.init_params(jax.random.PRNGKey(3),
                             papermodel().replace(fast_warp=True,
                                                  packed_synth=True))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.RandomState(9)
    B, H, W = 1, 256, 320
    images = (rng.rand(B, 2, H, W, 3) * 2 - 1).astype(np.float32)
    flow_l = (rng.rand(B, H // 8, W // 8, 4) * 6 - 3).astype(np.float32)
    tv = (0.25, 0.875)
    jex = jf.flow_extras(jparams, papermodel().replace(
        fast_warp=True, packed_synth=True), jnp.asarray(flow_l),
        jnp.asarray(images))
    ref = jf.synthesize_packed_multi(
        jparams["vfinet"], jnp.asarray(flow_l), jnp.asarray(images),
        [jnp.full((B, 1), t, jnp.float32) for t in tv], precomputed=jex,
        planes_out=True)
    with torch.inference_mode():
        fl, im = torch.tensor(flow_l), torch.tensor(images)
        ex = tf.flow_extras(params, cfg, fl, im)
        ts = [torch.full((B, 1), t) for t in tv]
        planes = tf.synthesize_packed_multi(params["vfinet"], fl, im, ts,
                                            precomputed=ex, planes_out=True)
        plain = tf.synthesize_packed_multi(params["vfinet"], fl, im, ts,
                                           precomputed=ex)
    for (r, _, _, _), p, q in zip(ref, planes, plain):
        assert p.shape == (B, 4, H // 4, W * 3) and q.shape == (B, H, W, 3)
        np.testing.assert_array_equal(repack.planes_to_plain_np(p.numpy()),
                                      q.numpy())
        assert np.abs(p.numpy() - np.asarray(r)).max() <= 1e-4
