"""fldrx_torch ops held against the JAX package on the CPU (max abs 1e-5).
The kernels themselves are held against these plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py."""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fldrx.ops import block_pca as jpca
from fldrx.ops import metrics as jmetrics
from fldrx.ops import pad as jpad
from fldrx.ops import resize as jresize
from fldrx.ops import splat as jsplat
from fldrx.ops import warp as jwarp
from fldrx_torch.ops import _build, fastconv, fastwarp
from fldrx_torch.ops import block_pca as tpca
from fldrx_torch.ops import metrics as tmetrics
from fldrx_torch.ops import pad as tpad
from fldrx_torch.ops import resize as tresize
from fldrx_torch.ops import splat as tsplat
from fldrx_torch.ops import warp as twarp

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _exact_reference():
    """fldrx references with no FLDRX_* overrides and its exact fallbacks
    (not the Pallas interpreter)."""
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("FLDRX_")}
    from fldrx.ops import fastconv as jfc
    from fldrx.ops import fastwarp as jfw
    importlib.reload(jfw)
    importlib.reload(jfc)
    yield
    os.environ.update(saved)


def _close(got, ref, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def _flow(rng, shape, scale):
    return (rng.randn(*shape) * scale).astype(np.float32)


# -- pad / resize -----------------------------------------------------------

@pytest.mark.parametrize("hw,div", [((37, 50), 16), ((64, 48), 32),
                                    ((32, 32), 32), ((64, 64), 256),
                                    ((5, 40), 32)])
def test_pad_matches_fldrx(hw, div):
    rng = np.random.RandomState(0)
    x = rng.rand(2, 2, *hw, 3).astype(np.float32)
    ref, _ = jpad.pad_to_divisible(jnp.asarray(x), div)
    got = tpad.pad_frames(torch.as_tensor(x), div)
    assert tpad.pad_amount(hw[0], div) == jpad.pad_amount(hw[0], div)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("src,dst", [((24, 40), (48, 80)), ((64, 96), (8, 12)),
                                     ((32, 32), (20, 44))])
def test_resize_matches_fldrx(mode, src, dst):
    rng = np.random.RandomState(1)
    x = rng.randn(2, *src, 3).astype(np.float32)
    ref = jresize.resize_2d(jnp.asarray(x), dst, mode)
    _close(tresize.resize_2d(torch.as_tensor(x), dst, mode), ref)


# the tap form (csrc/resize.cu and its plain version): downscales by 2 to
# 32, upscales by 2 to 8, odd sizes, one axis unchanged, clamped edges
TAP_SIZES = [((64, 128), (32, 64)), ((96, 80), (24, 20)),
             ((128, 64), (16, 8)), ((64, 96), (4, 6)), ((128, 256), (4, 8)),
             ((10, 14), (20, 28)), ((9, 11), (36, 44)), ((8, 12), (64, 96)),
             ((37, 50), (13, 29)), ((21, 17), (50, 41)),
             ((24, 40), (24, 13)), ((24, 40), (70, 40)), ((3, 5), (17, 2))]
TAP_MODES = [("bicubic", 4), ("bilinear", 2), ("nearest", 1)]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode,most", TAP_MODES)
@pytest.mark.parametrize("src,dst", TAP_SIZES)
def test_resize_tap_tables_are_the_dense_nonzeros(src, dst, mode, most,
                                                  align_corners):
    """Each axis's tap table holds its dense matrix's nonzeros, ascending,
    at most 4, 2 and 1 a row, padded with weight 0; rebuilt as a dense
    matrix it equals the float32 matrix the dense form multiplies by."""
    for n, m in zip(src, dst):
        idx, w = tresize._taps_np(n, m, mode, align_corners)
        M = tresize._resize_matrix_np(n, m, mode,
                                      align_corners).astype(np.float32)
        assert idx.dtype == np.int32 and w.dtype == np.float32
        assert idx.shape == w.shape and idx.shape[0] == m
        assert idx.shape[1] <= (1 if n == m else most)
        assert (np.diff(idx, axis=1) >= 0).all()
        assert ((idx >= 0) & (idx < n)).all()
        nz = (M != 0).sum(1)
        assert (nz <= most).all()
        assert ((w != 0).sum(1) == nz).all()
        dense = np.zeros_like(M)
        np.add.at(dense, (np.arange(m)[:, None], idx), w)
        np.testing.assert_array_equal(dense, M)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode", [m for m, _ in TAP_MODES])
@pytest.mark.parametrize("src,dst", TAP_SIZES)
def test_resize_taps_plain_matches_the_dense_form(src, dst, mode,
                                                  align_corners):
    """The kernel's arithmetic in PyTorch against the dense form within
    2e-6·max|x|, at C = 1 to 4 and with leading batch dims."""
    g = torch.Generator().manual_seed(src[0] * 97 + dst[1])
    for C, lead in ((1, (2,)), (2, (1,)), (3, (2, 2)), (4, ())):
        x = torch.randn(*lead, *src, C, generator=g) * 3
        got = tresize.resize_taps_plain(x, dst, mode, align_corners)
        ref = tresize.resize_2d(x, dst, mode, align_corners)
        assert got.shape == ref.shape == (*lead, *dst, C)
        assert (got - ref).abs().max() <= 2e-6 * x.abs().max()


def test_resize_cpu_is_the_dense_form_bit_for_bit():
    """On the CPU resize_2d is the two dense einsums, unchanged, and
    launches nothing; identity sizes return the input."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 2, 40, 56, 3, generator=g)
    before = dict(tresize.LAUNCHES)
    for mode, dst, ac in (("bicubic", (20, 28), False),
                          ("bilinear", (80, 112), True),
                          ("nearest", (13, 56), False)):
        Wh = torch.as_tensor(tresize._resize_matrix_np(
            40, dst[0], mode, ac).astype(np.float32))
        Ww = torch.as_tensor(tresize._resize_matrix_np(
            56, dst[1], mode, ac).astype(np.float32))
        y = torch.einsum("oh,...hwc->...owc", Wh, x)
        want = torch.einsum("pw,...owc->...opc", Ww, y)
        assert torch.equal(tresize.resize_2d(x, dst, mode, ac), want)
    assert tresize.resize_2d(x, (40, 56)) is x
    assert tresize.resize_taps_plain(x, (40, 56)) is x
    assert tresize.LAUNCHES == before


class _Stand:
    """What the dispatch rule reads of a tensor."""

    def __init__(self, is_cuda, requires_grad):
        self.is_cuda, self.requires_grad = is_cuda, requires_grad


@pytest.mark.parametrize("is_cuda,requires_grad,grad_mode,kernel", [
    (False, False, "grad", False),      # a CPU tensor: dense
    (False, True, "no_grad", False),
    (True, True, "grad", False),        # recorded by autograd: dense
    (True, False, "grad", False),       # a training step's other resizes
    (True, True, "no_grad", True),      # grad mode off
    (True, True, "inference", True),
    (True, False, "inference", True),
])
def test_resize_dispatch_rule(is_cuda, requires_grad, grad_mode, kernel):
    """The tap kernel takes a CUDA tensor while grad mode is off; every
    other tensor the dense form."""
    modes = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
             "inference": torch.inference_mode}
    with modes[grad_mode]():
        assert tresize._takes_kernel(_Stand(is_cuda, requires_grad)) is kernel


def test_resize_recorded_by_autograd_takes_the_dense_form():
    """A tensor that requires grad gets the dense form's gradient and
    launches nothing."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 12, 20, 2, generator=g, requires_grad=True)
    before = dict(tresize.LAUNCHES)
    y = tresize.resize_2d(x, (24, 40), "bilinear")
    y.sum().backward()
    assert y.grad_fn is not None and x.grad is not None
    assert tresize.LAUNCHES == before


# -- warps --------------------------------------------------------------------

@pytest.fixture(scope="module")
def warp_data():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 40, 56, 3).astype(np.float32)
    flow = _flow(rng, (2, 40, 56, 2), 6.0)
    return x, flow


def test_grid_sample_and_bwarp_match_fldrx(warp_data):
    from fldrx.ops.fastwarp import _sample_coords
    x, flow = warp_data
    sx, sy = twarp.sample_coords(torch.as_tensor(flow))
    for b in range(2):
        rsx, rsy = _sample_coords(jnp.asarray(flow[b]), 40, 56)
        np.testing.assert_array_equal(sx[b].numpy(), np.asarray(rsx))
        np.testing.assert_array_equal(sy[b].numpy(), np.asarray(rsy))
    out, ones = twarp.grid_sample_bilinear(torch.as_tensor(x), sx, sy,
                                           with_ones_mask=True)
    rout, rones = jwarp.grid_sample_bilinear(
        jnp.asarray(x), jnp.asarray(sx.numpy()), jnp.asarray(sy.numpy()),
        with_ones_mask=True)
    _close(out, rout)
    _close(ones, rones)
    for with_mask in (True, False):
        _close(twarp.bwarp(torch.as_tensor(x), torch.as_tensor(flow),
                           with_mask),
               jwarp.bwarp(jnp.asarray(x), jnp.asarray(flow), with_mask))


def test_ones_mask_sep_matches_fldrx(warp_data):
    from fldrx.ops.fastwarp import ones_mask_sep
    _, flow = warp_data
    sx, sy = twarp.sample_coords(torch.as_tensor(flow))
    ref = ones_mask_sep(jnp.asarray(sx.numpy()), jnp.asarray(sy.numpy()),
                        40, 56)
    got = twarp.ones_mask_sep(sx, sy, 40, 56)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.sum() < got.numel()


@pytest.mark.parametrize("mask", [False, True])
def test_gather_cpu_matches_fldrx_gather_at(warp_data, mask):
    """On CPU tensors `gather` is its plain version, held against fldrx's
    gather_at (which falls back to its exact ops off the TPU)."""
    from fldrx.ops.fastwarp import gather_at
    x, flow = warp_data
    sx, sy = twarp.sample_coords(torch.as_tensor(flow))
    before = dict(fastwarp.LAUNCHES)
    got = fastwarp.gather(torch.as_tensor(x), sx, sy, mask=mask)
    assert fastwarp.LAUNCHES == before               # no kernel launch
    for b in range(2):
        ref = gather_at(jnp.asarray(x[b]), jnp.asarray(sx[b].numpy()),
                        jnp.asarray(sy[b].numpy()), bwarp_mask=mask)
        _close(got[b], ref)


@pytest.mark.parametrize("C", [4, 49])
def test_splat_sum_matches_fldrx(C):
    rng = np.random.RandomState(3)
    vals = rng.rand(2, 24, 32, C).astype(np.float32)
    flow = _flow(rng, (2, 24, 32, 2), 4.0)
    ref = jsplat.splat_sum(jnp.asarray(vals), jnp.asarray(flow))
    _close(tsplat.splat_sum(torch.as_tensor(vals), torch.as_tensor(flow)),
           ref)
    # the kernel wrapper's plain version on absolute targets
    tx = np.arange(32, dtype=np.float32) + flow[..., 0]
    ty = np.arange(24, dtype=np.float32)[:, None] + flow[..., 1]
    before = dict(fastwarp.LAUNCHES)
    got = fastwarp.splat(torch.as_tensor(vals), torch.as_tensor(tx),
                         torch.as_tensor(ty))
    assert fastwarp.LAUNCHES == before
    _close(got, ref)


@pytest.mark.parametrize("C,with_z", [(3, True), (48, False)])
def test_softsplat_matches_fldrx(C, with_z):
    """C=3 (+1 importance channel → the level-0 splat's 4) and C=48 (the
    coarse feature splats' 49)."""
    rng = np.random.RandomState(4)
    img = (rng.rand(2, 24, 32, C) * 2 - 1).astype(np.float32)
    flow = _flow(rng, (2, 24, 32, 2), 3.0)
    z = rng.randn(2, 24, 32, 1).astype(np.float32) if with_z else None
    ref = jsplat.softsplat(jnp.asarray(img), jnp.asarray(flow),
                           None if z is None else jnp.asarray(z))
    tz = None if z is None else torch.as_tensor(z)
    _close(tsplat.softsplat(torch.as_tensor(img), torch.as_tensor(flow), tz),
           ref)
    _close(fastwarp.softsplat_diff(torch.as_tensor(img),
                                   torch.as_tensor(flow), tz), ref)


# -- block PCA / metrics / conv ------------------------------------------------

@pytest.mark.parametrize("per_item", [False, True])
def test_block_pca_matches_fldrx(per_item):
    rng = np.random.RandomState(5)
    frames = (rng.rand(2, 2, 32, 48, 3) * 2 - 1).astype(np.float32)
    mean = rng.randn(64).astype(np.float32) * 0.1
    ev = rng.randn(16, 64).astype(np.float32) * 0.2
    mvec = (rng.rand(16) + 0.5).astype(np.float32)
    ref = jpca.block_pca_features(jnp.asarray(frames), jnp.asarray(mean),
                                  jnp.asarray(ev), jnp.asarray(mvec),
                                  per_item_minmax=per_item)
    got = tpca.block_pca_features(torch.as_tensor(frames),
                                  torch.as_tensor(mean), torch.as_tensor(ev),
                                  torch.as_tensor(mvec),
                                  per_item_minmax=per_item)
    assert tuple(got.shape) == (2, 4, 6, 96)
    _close(got, ref)


def test_metrics_match_fldrx():
    rng = np.random.RandomState(6)
    a = (rng.rand(16, 24, 3) * 2.2 - 1.1).astype(np.float32)
    b = np.clip(a + rng.randn(16, 24, 3).astype(np.float32) * 0.05, -1, 1)
    np.testing.assert_array_equal(tmetrics.denorm255(a.copy()),
                                  jmetrics.denorm255(a.copy()))
    ra, rb = np.around(jmetrics.denorm255(a.copy())), jmetrics.denorm255(b.copy())
    assert tmetrics.psnr(ra, rb) == jmetrics.psnr(ra, rb)
    assert tmetrics.psnr(ra, ra) == float("inf")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_cpu_matches_fldrx(dtype):
    """On CPU tensors conv3x3 is F.conv2d in float32 on operands rounded to
    the input dtype; fldrx's conv3x3_pixrows falls back to the XLA conv."""
    from fldrx.ops.fastconv import conv3x3_pixrows
    rng = np.random.RandomState(7)
    x = rng.randn(2, 16, 24, 20).astype(np.float32)
    w = (rng.randn(3, 3, 20, 12) * 0.1).astype(np.float32)        # HWIO
    b = rng.randn(12).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = conv3x3_pixrows(jnp.asarray(x).astype(jd), jnp.asarray(w),
                          jnp.asarray(b)).astype(jnp.float32)
    before = dict(fastconv.LAUNCHES)
    got = fastconv.conv3x3(torch.as_tensor(x).to(td),
                           torch.as_tensor(w).permute(3, 2, 0, 1),
                           torch.as_tensor(b))
    assert fastconv.LAUNCHES == before and got.dtype == td
    # bf16: both round a float32 sum to bf16; 1 bf16 ulp at |y| < 8
    _close(got.float(), ref, atol=ATOL if dtype == "float32" else 0.07)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("warp")
    _build.library.cache_clear()


def test_mixed_devices_raise():
    cpu = torch.zeros(1, 4, 4, 1)
    meta = torch.zeros(1, 4, 4, device="meta")
    with pytest.raises(ValueError):
        fastwarp.gather(cpu, meta, meta)
