"""The port's differentiable warps held against fldrx's custom VJPs on the
CPU: `jax.vjp` of fldrx splat_sum_diff, bwarp_diff and softsplat_diff
against torch.autograd through splat_sum_diff, bwarp_diff and
softsplat_diff, with random cotangents, B=2, 40×56, C=3 and C=49.

On CPU tensors the port's Functions run the plain versions of the forward
and backward kernels, and fldrx (no FLDRX_* overrides) runs its exact
forward plus its custom VJP; the CUDA kernels are held against these plain
versions by tests/test_torch_kernels.py and chip_smoke.py.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fldrx.ops import resize as jresize
from fldrx_torch.ops import fastwarp

torch.set_num_threads(1)
B, H, W = 2, 40, 56


@pytest.fixture(scope="module")
def jfw():
    """fldrx's fastwarp with no FLDRX_* overrides: off the TPU its fast
    warps are the exact ops with the custom VJPs."""
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("FLDRX_")}
    from fldrx.ops import fastwarp as mod
    importlib.reload(mod)
    yield mod
    os.environ.update(saved)


def smooth_flow(rng, scale):
    """A smooth flow [B,H,W,2]: random coarse vectors on a 5×7 grid,
    bilinearly upsampled."""
    coarse = (rng.randn(B, 5, 7, 2) * scale).astype(np.float32)
    return np.asarray(jresize.resize_2d(jnp.asarray(coarse), (H, W),
                                        "bilinear"), np.float32)


def leaf(a):
    return torch.tensor(a, requires_grad=True)


def assert_close(got, ref, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("C", [3, 49])
def test_splat_sum_diff_vjp_matches_fldrx(jfw, C):
    """dvals and dflow ≤ 1e-5 abs (measured 0 and ≤ 4e-6); the port's
    Function takes absolute targets xs + flow, so autograd carries dtx to
    the flow."""
    rng = np.random.RandomState(C)
    vals = rng.rand(B, H, W, C).astype(np.float32)
    flow = smooth_flow(rng, 4.0)
    g = rng.randn(B, H, W, C).astype(np.float32)
    out, vjp = jax.vjp(jfw.splat_sum_diff, jnp.asarray(vals),
                       jnp.asarray(flow))
    dvals, dflow = vjp(jnp.asarray(g))
    tv, tfl = leaf(vals), leaf(flow)
    xs = torch.arange(W, dtype=torch.float32)
    ys = torch.arange(H, dtype=torch.float32)[:, None]
    got = fastwarp.splat_sum_diff(tv, xs + tfl[..., 0], ys + tfl[..., 1])
    got.backward(torch.tensor(g))
    assert_close(got, out)
    assert_close(tv.grad, dvals)
    assert_close(tfl.grad, dflow)


@pytest.mark.parametrize("C", [3, 49])
@pytest.mark.parametrize("with_mask", [True, False])
def test_bwarp_diff_vjp_matches_fldrx(jfw, C, with_mask):
    """dx and dflow ≤ 1e-5 abs (measured ≤ 9e-7 and ≤ 6e-6). fldrx writes
    the S/(S−1) factor of the sampling coords into its VJP; the port's
    autograd takes it from sample_coords."""
    rng = np.random.RandomState(10 + C)
    x = rng.randn(B, H, W, C).astype(np.float32)
    flow = smooth_flow(rng, 4.0)
    g = rng.randn(B, H, W, C).astype(np.float32)
    out, vjp = jax.vjp(lambda a, f: jfw.bwarp_diff(a, f, with_mask),
                       jnp.asarray(x), jnp.asarray(flow))
    dx, dflow = vjp(jnp.asarray(g))
    tx, tfl = leaf(x), leaf(flow)
    got = fastwarp.bwarp_diff(tx, tfl, with_mask)
    got.backward(torch.tensor(g))
    assert_close(got, out)
    assert_close(tx.grad, dx)
    assert_close(tfl.grad, dflow)


@pytest.mark.parametrize("C", [3, 48])
def test_softsplat_diff_vjp_matches_fldrx(jfw, C):
    """d/dimg, d/dflow and d/dz, with a small smooth flow (≤ 1.5 px) so
    that every target pixel receives splat weight; d/dimg and d/dz ≤ 1e-5
    abs. d/dflow: at C=3 ≤ 1e-5 abs (measured ≤ 3.8e-6 over 8 seeds). At
    C=48 (+1 importance channel) the normalisation's cotangent is a sum
    over all 49 channels whose terms cancel in d/dflow, so float32
    summation order (the port's and XLA's differ) leaves an error that
    scales with the whole field, not each element: held at 2e-5 of
    max |d/dflow| (measured ≤ 1.2e-5 of it over 8 seeds, up to 1.1e-3 abs
    at a max of 87; ROADMAP.md queue 3)."""
    rng = np.random.RandomState(20 + C)
    img = (rng.rand(B, H, W, C) * 2 - 1).astype(np.float32)
    flow = smooth_flow(rng, 0.5)
    z = (rng.randn(B, H, W, 1) * 0.3).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    out, vjp = jax.vjp(jfw.softsplat_diff, jnp.asarray(img),
                       jnp.asarray(flow), jnp.asarray(z))
    dimg, dflow, dz = vjp(jnp.asarray(g))
    ti, tfl, tz = leaf(img), leaf(flow), leaf(z)
    got = fastwarp.softsplat_diff(ti, tfl, tz)
    got.backward(torch.tensor(g))
    assert_close(got, out)
    assert_close(ti.grad, dimg)
    assert_close(tz.grad, dz)
    scale = 1.0 if C == 3 else 2.0 * float(np.abs(np.asarray(dflow)).max())
    assert_close(tfl.grad, dflow, atol=1e-5 * scale)


def test_vjp_plain_versions_are_the_function_backward():
    """On the CPU the Functions' backward passes are the kernels' plain
    versions, and no kernel launches."""
    rng = np.random.RandomState(30)
    img = torch.tensor(rng.randn(B, H, W, 4).astype(np.float32))
    sx = torch.tensor(rng.rand(B, H, W).astype(np.float32) * (W + 2) - 1)
    sy = torch.tensor(rng.rand(B, H, W).astype(np.float32) * (H + 2) - 1)
    g = torch.tensor(rng.randn(B, H, W, 4).astype(np.float32))
    before = dict(fastwarp.LAUNCHES)
    ti, tsx, tsy = leaf(img.numpy()), leaf(sx.numpy()), leaf(sy.numpy())
    fastwarp.gather_diff(ti, tsx, tsy, True).backward(g)
    ref = fastwarp.gather_grad_plain(img, sx, sy, g, mask=True)
    for a, b in zip((ti.grad, tsx.grad, tsy.grad), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    tv, ttx, tty = leaf(img.numpy()), leaf(sx.numpy()), leaf(sy.numpy())
    fastwarp.splat_sum_diff(tv, ttx, tty).backward(g)
    ref = fastwarp.splat_grad_plain(img, sx, sy, g)
    for a, b in zip((tv.grad, ttx.grad, tty.grad), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert fastwarp.LAUNCHES == before
