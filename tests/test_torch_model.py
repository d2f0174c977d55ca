"""fldrx_torch model, pipeline and API held against the JAX package on the
CPU with the real checkpoint.

References are fldrx with no FLDRX_* overrides; off the TPU its fast warps
and convs fall back to the exact XLA ops, so the fast-path tests compare
the port's plain versions with those, not with the Pallas interpreter.

Frames are the benchmark's synthetic content (bench.py: band-limited
texture with a camera pan) with phases drawn from a seeded RandomState.
The model is ill-conditioned at a few places — the bwarp 0.999 mask
threshold and softmax-splat pixels that receive almost no weight — where
float32 summation-order differences in the flow (~3e-5 px) flip a pixel.
On uniform-noise frames fldrx itself moves by up to 2e-4 (strict) and to
89.4 dB (fast path) when its input is scaled by 1 + 2^-23, so such frames
measure that conditioning, not the port; ROADMAP.md queue 3 records the
readings.
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
from fldrx.tools.convert_ckpt import load_params_npz
from fldrx_torch import api as tapi
from fldrx_torch import config as tcfg
from fldrx_torch.eval import pipeline as tpipe
from fldrx_torch.model import fldrnet as tf
from fldrx_torch.ops import fastconv, fastwarp
from fldrx_torch.weights import load_npz, params_from_numpy

torch.set_num_threads(1)
T_VALUES = [0.25, 0.5, 0.75]


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


def bench_frames(seed: int, H: int, W: int, n: int = 2) -> np.ndarray:
    """[1, n, H, W, 3] float32: bench.py's texture, random phases, the
    third frame (n=3) half way along the pan."""
    rng = np.random.RandomState(seed)
    ph = rng.uniform(0, 60, size=2).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    def tex(px, py):
        px, py = px + ph[0], py + ph[1]
        return (np.sin((xx + px) / 17) * np.cos((yy + py) / 23)
                + 0.5 * np.sin((xx + py) / 5.3) * np.sin((yy + px) / 7.1)
                + 0.3 * np.sin((xx - px) / 61) * np.cos((yy + py) / 47))

    shifts = [((0, 0), (9, 4), (3, 11)), ((22, 13), (31, 17), (25, 24)),
              ((11, 6.5), (20, 10.5), (14, 17.5))][:n]
    fr = [np.stack([tex(*s) for s in f], -1) for f in shifts]
    return (np.stack(fr, 0)[None] * 0.6).astype(np.float32)


def psnr(a, b, peak=2.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


@pytest.fixture(scope="module")
def weights():
    jtree, _, _ = load_params_npz(japi.DEFAULT_NPZ)
    return (jax.tree.map(jnp.asarray, jtree),
            params_from_numpy(load_npz(tapi.DEFAULT_NPZ)[0], "cpu"))


# -- refine UNet ------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_input():
    rng = np.random.RandomState(0)
    return (rng.rand(1, 16, 24, 416) * 2 - 1).astype(np.float32)


def test_refine_unet_s2d_core_f32_matches_fldrx(weights, unet_input):
    jp, tp = weights
    ref = jf.refine_unet_s2d_core(jp["vfinet"]["refine"],
                                  jnp.asarray(unet_input))
    got = tf.refine_unet_s2d_core(tp["vfinet"]["refine"],
                                  torch.as_tensor(unet_input))
    assert tuple(got.shape) == (1, 16, 24, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    # the packed form is the plain UNet, weight for weight
    x = tf.d2s(torch.as_tensor(unet_input), 4)
    np.testing.assert_allclose(
        tf.refine_unet_s2d(tp["vfinet"]["refine"], x).numpy(),
        tf.refine_unet(tp["vfinet"]["refine"], x).numpy(), atol=1e-4, rtol=0)


def test_refine_unet_s2d_core_bf16_psnr(weights, unet_input, monkeypatch):
    """bf16 UNet against fldrx's TPU conv kernel run in interpret mode (its
    arithmetic: bf16 operands, f32 sums, f32 bias added before the one
    rounding to bf16, as in the port's kernel and plain version); PSNR over
    the reference's value range ≥ 65 dB (measured 67.1). fldrx's XLA
    fallback rounds before adding the bias and differs from its own kernel
    by 61.8 dB on this input, so it is not the yardstick here."""
    from fldrx.ops import fastconv as jfc
    jp, tp = weights
    monkeypatch.setenv("FLDRX_PALLAS_INTERPRET", "1")
    importlib.reload(jfc)
    try:
        ref = np.asarray(jf.refine_unet_s2d_core(
            jp["vfinet"]["refine"], jnp.asarray(unet_input, jnp.bfloat16)
        ).astype(jnp.float32))
    finally:
        monkeypatch.delenv("FLDRX_PALLAS_INTERPRET")
        importlib.reload(jfc)
    got = tf.refine_unet_s2d_core(
        tp["vfinet"]["refine"],
        torch.as_tensor(unet_input).to(torch.bfloat16)).float().numpy()
    assert psnr(ref, got, peak=ref.max() - ref.min()) >= 65.0


# -- strict forward -----------------------------------------------------------

STRICT_HW = (256, 384)


@pytest.fixture(scope="module")
def strict(weights):
    jp, tp = weights
    jc = jcfg.apply_test_scales(jcfg.papermodel(), 5).replace(
        S_tst=2, fast_warp=False)
    tc = tcfg.apply_test_scales(tcfg.papermodel(), 5).replace(
        S_tst=2, fast_warp=False)
    fr = bench_frames(0, *STRICT_HW)
    jpyr = jpipe.build_pyramid(jnp.asarray(fr), jc, jc.S_tst + 1)
    tpyr = tpipe.build_pyramid(torch.as_tensor(fr), tc, tc.S_tst + 1)
    return jp, tp, jc, tc, fr, jpyr, tpyr


def test_build_pyramid_matches_fldrx(strict):
    *_, jpyr, tpyr = strict
    assert len(tpyr) == 3
    for a, b in zip(jpyr, tpyr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("t", [0.25, 0.5])
def test_forward_test_strict_matches_fldrx(strict, t):
    """forward_test, fast_warp=False, real weights, test5 scales at
    S_tst=2, 256×384: max abs ≤ 1e-4 (measured 2.1e-6 and 1.8e-6)."""
    jp, tp, jc, tc, _, jpyr, tpyr = strict
    tt = np.array([[t]], np.float32)
    ref = jf.forward_test(jp, jc, jpyr, jnp.asarray(tt))
    with torch.inference_mode():
        got = tf.forward_test(tp, tc, tpyr, torch.as_tensor(tt))
    assert tuple(got.shape) == (1, *STRICT_HW, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_strict_synthesis_from_fldrx_flow_on_noise(strict):
    """On uniform-noise frames: the flow recurrences agree to float32
    summation order, and synthesis from fldrx's own flow agrees to 1e-5."""
    jp, tp, jc, tc, *_ = strict
    rng = np.random.RandomState(1)
    fr = (rng.rand(1, 2, *STRICT_HW, 3) * 2 - 1).astype(np.float32)
    jpyr = jpipe.build_pyramid(jnp.asarray(fr), jc, jc.S_tst + 1)
    tpyr = tpipe.build_pyramid(torch.as_tensor(fr), tc, tc.S_tst + 1)
    jflow = jf.forward_flow(jp, jc, jpyr)
    with torch.inference_mode():
        tflow = tf.forward_flow(tp, tc, tpyr)
        assert np.abs(tflow.numpy() - np.asarray(jflow)).max() <= 1e-4
        tt = np.array([[0.375]], np.float32)
        ref = jf.forward_synthesis(jp, jc, jflow, jpyr[0], jnp.asarray(tt))
        got = tf.forward_synthesis(tp, tc, torch.tensor(np.asarray(jflow)),
                                   tpyr[0], torch.as_tensor(tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


# -- fast packed path -----------------------------------------------------------

FAST_HW = (768, 768)


@pytest.fixture(scope="module")
def fast_frames():
    return bench_frames(2, *FAST_HW)


def _fast_pair(fast_frames, unet_dtype):
    jc = jcfg.papermodel_test5().replace(S_tst=1, unet_dtype=unet_dtype)
    tc = tcfg.papermodel_test5().replace(S_tst=1, unet_dtype=unet_dtype)
    ji, _, _ = japi.prepare_model(cfg=jc)
    ti, _, _ = tapi.prepare_model(cfg=tc, device="cpu")
    assert tf.can_use_packed(torch.zeros(1, 96, 96, 4),
                             torch.zeros(1, 2, *FAST_HW, 3))
    ref = ji.interpolate_multi_np(fast_frames, T_VALUES)
    got = ti.interpolate_multi_np(fast_frames, T_VALUES)
    assert got.shape == ref.shape == (3, 1, *FAST_HW, 3)
    return ref, got


def test_fast_packed_path_f32_matches_fldrx(fast_frames):
    """Interpolator.interpolate_multi_np, fast_warp + packed_synth, f32,
    real weights, S_tst=1, 768×768, three t values: PSNR ≥ 90 dB.
    Measured: 141.2 dB, max abs 6.9e-6."""
    before = (dict(fastwarp.LAUNCHES), dict(fastconv.LAUNCHES))
    ref, got = _fast_pair(fast_frames, "")
    assert (dict(fastwarp.LAUNCHES), dict(fastconv.LAUNCHES)) == before
    assert psnr(ref, got) >= 90.0
    assert np.abs(ref - got).max() <= 1e-4


def test_fast_packed_path_bf16_unet_matches_fldrx(fast_frames):
    """The same with unet_dtype=bfloat16 (the bench's deploy mix):
    ≥ 65 dB (measured 81.0 dB, max abs 5.5e-3)."""
    ref, got = _fast_pair(fast_frames, "bfloat16")
    assert psnr(ref, got) >= 65.0


# -- pipeline and API -------------------------------------------------------------

def test_uint8_frames_match_host_normalised(strict):
    _, tp, _, tc, *_ = strict
    interp = tpipe.Interpolator(tp, tc.replace(S_tst=1), device="cpu")
    rng = np.random.RandomState(2)
    u8 = rng.randint(0, 256, size=(1, 2, 48, 72, 3)).astype(np.uint8)
    host = (u8.astype(np.float32) / 255.0 - 0.5) * 2.0
    a = interp.interpolate_np(u8, [[0.5]])
    b = interp.interpolate_np(host, [[0.5]])
    assert a.shape == (1, 48, 72, 3)                  # padded, then cropped
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["BTHWC", "BCTHW"])
def test_run_on_images_psnr_matches_fldrx(strict, layout):
    jp, tp, jc, tc, *_ = strict
    fr = bench_frames(3, *STRICT_HW, n=3)              # I0, I1, ground truth
    if layout == "BCTHW":
        fr = np.transpose(fr, (0, 4, 1, 2, 3))
    t = [[0.5]]
    ref = japi.run_on_images(jpipe.Interpolator(jp, jc), jc, None, fr, t)
    ti = tpipe.Interpolator(tp, tc, device="cpu")
    got = tapi.run_on_images(ti, tc, "cpu", fr, t)
    assert 20.0 < got < 100.0
    assert abs(got - ref) <= 0.01
    with pytest.raises(ValueError):
        tapi.run_on_images(ti, tc, "cuda", fr, t)
