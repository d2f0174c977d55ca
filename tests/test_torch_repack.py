"""fldrx_torch's packed-synthesis layouts on the CPU: the refine UNet's
s2d4 input (`pack_s2d4`'s plain version against the cell-major index
formula written out and against s2d of the concatenation, and its
refusals); and the u-plane layout held against the JAX package: the
interleave (the plain version against fldrx's Pallas kernel in
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


TEN = (3, 3, 3, 3, 2, 2, 2, 2, 3, 3)      # the packed synthesis's sources


def _pack_sources(widths, B: int, H: int, W: int, seed: int):
    """float32 sources [B, H, W, c] of `widths`; the first two, where they
    are 3 wide, batch-strided views images[:, 0] and images[:, 1] of one
    [B, 2, H, W, 3] tensor, as the packed synthesis's x0 and x1 are."""
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(B, 2, H, W, 3, generator=g)
    parts = [torch.randn(B, H, W, c, generator=g) for c in widths]
    for k in range(2):
        if widths[k] == 3:
            parts[k] = images[:, k]
    return parts


def _pack_by_index(parts, dtype) -> torch.Tensor:
    """out[b, y, x, (u·4 + v)·C + offset_i + c] = source_i[b, 4y + u,
    4x + v, c], element by element."""
    B, H, W = parts[0].shape[:3]
    C = sum(x.shape[3] for x in parts)
    out = torch.empty(B, H // 4, W // 4, 16 * C, dtype=dtype)
    off = 0
    for x in parts:
        for u in range(4):
            for v in range(4):
                for c in range(x.shape[3]):
                    out[..., (u * 4 + v) * C + off + c] = \
                        x[:, u::4, v::4, c].to(dtype)
        off += x.shape[3]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("widths,B,H,W", [
    (TEN, 2, 8, 12),
    (TEN, 1, 12, 20),
    ((3, 3, 1, 4, 7), 2, 4, 8),             # another mix, C = 18
    ((3, 3, 26), 1, 8, 4),                  # C = 32, the most it takes
])
def test_pack_s2d4_plain(widths, B, H, W, dtype):
    """pack_s2d4 on CPU tensors (the plain version, no launch) against
    the index formula and against s2d of the concatenation in `dtype`, bit
    for bit, with x0 and x1 read as batch-strided views."""
    parts = _pack_sources(widths, B, H, W, seed=H + W + len(widths))
    assert parts[0].stride(0) == 2 * H * W * 3
    before = dict(repack.LAUNCHES)
    got = repack.pack_s2d4(parts, dtype)
    assert repack.LAUNCHES == before
    C = sum(widths)
    assert got.shape == (B, H // 4, W // 4, 16 * C) and got.dtype == dtype
    assert torch.equal(got, _pack_by_index(parts, dtype))
    assert torch.equal(got, tf.s2d(torch.cat(parts, -1).to(dtype), 4))
    assert torch.equal(repack.pack_s2d4_plain(parts, dtype), got)


@pytest.mark.parametrize("case,error", [
    ("h_not_4", ValueError),
    ("w_not_4", ValueError),
    ("b_differs", ValueError),
    ("h_differs", ValueError),
    ("w_differs", ValueError),
    ("out_float16", TypeError),
    ("out_int8", TypeError),
    ("source_float64", TypeError),
    ("over_32_channels", ValueError),
    ("no_sources", ValueError),
    ("over_12_sources", ValueError),
])
def test_pack_s2d4_refuses(case, error):
    """pack_s2d4 refuses, on the CPU as on the card: H or W not a
    multiple of 4, sources of other B, H or W, an output other than
    bfloat16 or float32, a source not float32, more than 32 channels, and
    a source list the kernel's table cannot hold."""
    def src(B=1, H=8, W=8, c=3, dtype=torch.float32):
        return torch.zeros(B, H, W, c, dtype=dtype)
    parts, dtype = [src(), src(c=2)], torch.bfloat16
    if case == "h_not_4":
        parts = [src(H=6), src(H=6, c=2)]
    elif case == "w_not_4":
        parts = [src(W=10), src(W=10, c=2)]
    elif case == "b_differs":
        parts[1] = src(B=2, c=2)
    elif case == "h_differs":
        parts[1] = src(H=4, c=2)
    elif case == "w_differs":
        parts[1] = src(W=4, c=2)
    elif case == "out_float16":
        dtype = torch.float16
    elif case == "out_int8":
        dtype = torch.int8
    elif case == "source_float64":
        parts[1] = src(c=2, dtype=torch.float64)
    elif case == "over_32_channels":
        parts = [src(c=3)] * 10 + [src(c=3)]
    elif case == "no_sources":
        parts = []
    elif case == "over_12_sources":
        parts = [src(c=1)] * 13
    with pytest.raises(error, match="pack_s2d4"):
        repack.pack_s2d4(parts, dtype)


def test_the_pair_reaches_the_synthesis_dense():
    """precompute_flow hands the synthesis dense NHWC frames, whatever
    layout padding leaves (channel-planar on the card), so pack_s2d4 and
    the gathers read x0 = images[:, 0] and x1 in place, with no copy a
    t."""
    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import deploy_config

    interp = prepare_model(cfg=deploy_config(), device="cpu")[0]
    frames = torch.as_tensor((np.random.RandomState(4).rand(
        1, 2, 200, 300, 3) * 255).astype(np.uint8))
    _, padded, _ = interp.precompute_flow(frames)
    assert padded.shape == (1, 2, 256, 512, 3)
    assert padded[:, 0].is_contiguous() and padded[:, 1].is_contiguous()


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
