"""The hand-written CUDA kernels held against their plain versions on the
card. Marked `cuda`: without a GPU they skip (a CUDA kernel has no CPU
mode). This file imports neither jax nor fldrx, so it also runs where only
the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py configures JAX). chip_smoke.py holds the
same kernels at the main path's 4K shapes and the training shapes.

Tolerances: gather and splat_grad's dvals are summed term for term as their
plain versions (≤ 1e-5, expected 0); sums over channels and the atomicAdd
accumulations (splat, gather_grad's dimg) change order, so those are held
at 1e-4·(1 + |ref|).
"""

import ctypes

import numpy as np
import pytest
import torch

from fldrx_torch.ops import _build, fastconv, fastwarp
from fldrx_torch.ops import warp as twarp

torch.set_num_threads(1)

_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.mark.parametrize("name,expected", [
    ("warp", {
        # img, sx, sy, out, B, H, W, C, Ho, Wo, mask, stream
        "fldrx_gather_f32": [_P] * 4 + [_I] * 7 + [_P],
        # vals, tx, ty, out, B, H, W, C, stream
        "fldrx_splat_f32": [_P] * 4 + [_I] * 4 + [_P],
        # vals, tx, ty, g, dvals, dtx, dty, B, H, W, C, stream
        "fldrx_splat_grad_f32": [_P] * 7 + [_I] * 4 + [_P],
        # img, sx, sy, g, dimg, dsx, dsy, B, H, W, C, Ho, Wo, mask, stream
        "fldrx_gather_grad_f32": [_P] * 7 + [_I] * 7 + [_P],
    }),
    ("conv3x3", {
        # x, w (HWIO), bias, out, B, H, W, Cin, K, stream
        "fldrx_conv3x3_bf16": [_P] * 4 + [_I] * 5 + [_P],
    }),
])
def test_entry_point_prototypes(name, expected):
    """The ctypes binding read from each source's extern "C" prototypes
    has the arguments the wrappers in fastwarp/fastconv pass."""
    assert _build.prototypes(name) == expected


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_gather_kernel_matches_plain(card):
    g = torch.Generator(device="cpu").manual_seed(0)
    img = torch.rand(1, 96, 160, 3, generator=g).to(card)
    flow = (torch.randn(1, 96, 160, 2, generator=g) * 20).to(card)
    sx, sy = twarp.sample_coords(flow)
    for mask in (False, True):
        got = fastwarp.gather(img, sx, sy, mask=mask)
        ref = fastwarp.gather_plain(img, sx, sy, mask=mask)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 49])
def test_splat_kernel_matches_plain(card, C):
    g = torch.Generator(device="cpu").manual_seed(1)
    vals = torch.rand(1, 64, 96, C, generator=g).to(card)
    tx = (torch.arange(96.0) + torch.randn(1, 64, 96, generator=g) * 5).to(card)
    ty = (torch.arange(64.0)[:, None]
          + torch.randn(1, 64, 96, generator=g) * 5).to(card)
    got = fastwarp.splat(vals, tx, ty)
    ref = fastwarp.splat_plain(vals, tx, ty)
    torch.cuda.synchronize()
    assert ((got - ref).abs() <= 1e-4 * (1 + ref.abs())).all()


@pytest.mark.cuda
def test_conv3x3_kernel_matches_plain(card):
    g = torch.Generator(device="cpu").manual_seed(2)
    x = (torch.rand(1, 40, 72, 48, generator=g) * 2 - 1).to(card, torch.bfloat16)
    w = (torch.randn(40, 48, 3, 3, generator=g) * 0.05).to(card, torch.bfloat16)
    b = torch.randn(40, generator=g).to(card)
    got = fastconv.conv3x3(x, w, b).float()
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).float(), w.float(),
                                     b, padding=1).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 2e-2
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2


def _close(got, ref, rel=1e-4):
    assert ((got - ref).abs() <= rel * (1 + ref.abs())).all(), \
        (got - ref).abs().max().item()


def _coords(g, B, H, W, scale, card):
    """Absolute target/sample coords of a smooth flow of ±scale px."""
    coarse = torch.randn(B, 2, 4, 6, generator=g) * scale
    flow = torch.nn.functional.interpolate(coarse, size=(H, W),
                                           mode="bilinear").permute(0, 2, 3, 1)
    xs = torch.arange(W, dtype=torch.float32)
    ys = torch.arange(H, dtype=torch.float32)[:, None]
    return (xs + flow[..., 0]).to(card), (ys + flow[..., 1]).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 49])
def test_splat_grad_kernel_matches_plain(card, C):
    g = torch.Generator(device="cpu").manual_seed(3)
    B, H, W = 2, 64, 96
    vals = torch.rand(B, H, W, C, generator=g).to(card)
    cot = torch.randn(B, H, W, C, generator=g).to(card)
    tx, ty = _coords(g, B, H, W, 8.0, card)
    for coords in (True, False):
        got = fastwarp.splat_grad(vals, tx, ty, cot, coords)
        ref = fastwarp.splat_grad_plain(vals, tx, ty, cot, coords)
        torch.cuda.synchronize()
        assert (got[0] - ref[0]).abs().max().item() <= 1e-5
        if coords:
            _close(got[1], ref[1])
            _close(got[2], ref[2])
        else:
            assert got[1] is None and got[2] is None


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [True, False])
def test_gather_grad_kernel_matches_plain(card, mask):
    g = torch.Generator(device="cpu").manual_seed(4)
    B, H, W, C = 2, 64, 96, 3
    img = torch.randn(B, H, W, C, generator=g).to(card)
    cot = torch.randn(B, H, W, C, generator=g).to(card)
    sx, sy = _coords(g, B, H, W, 8.0, card)
    got = fastwarp.gather_grad(img, sx, sy, cot, mask)
    ref = fastwarp.gather_grad_plain(img, sx, sy, cot, mask)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _close(a, b)
    dimg, dsx, dsy = fastwarp.gather_grad(img, sx, sy, cot, mask,
                                          want_coords=False)
    assert dsx is None and dsy is None
    _close(dimg, ref[0])


def _grads_on(dev, fn, inputs, cot):
    leaves = [torch.tensor(a, device=dev, requires_grad=True) for a in inputs]
    fn(*leaves).backward(torch.tensor(cot, device=dev))
    return [x.grad.cpu() for x in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["splat_sum_diff", "bwarp_diff",
                                   "softsplat_diff"])
def test_autograd_functions_card_match_cpu(card, which):
    """Each differentiable form's gradients on the card (the VJP kernels)
    against the same Function on the CPU (the plain versions), same
    inputs, 1e-4·(1 + |ref|)."""
    rng = np.random.RandomState(5)
    B, H, W, C = 2, 48, 64, 4
    flow = np.asarray(torch.nn.functional.interpolate(
        torch.tensor(rng.randn(B, 2, 4, 5).astype(np.float32)) * 2.0,
        size=(H, W), mode="bilinear").permute(0, 2, 3, 1))
    x = rng.rand(B, H, W, C).astype(np.float32)
    cot = rng.randn(B, H, W, C).astype(np.float32)
    if which == "splat_sum_diff":
        def fn(v, f):
            xs = torch.arange(W, dtype=torch.float32, device=v.device)
            ys = torch.arange(H, dtype=torch.float32, device=v.device)[:, None]
            return fastwarp.splat_sum_diff(v, xs + f[..., 0], ys + f[..., 1])
    elif which == "bwarp_diff":
        fn = fastwarp.bwarp_diff
    else:
        x = x[..., :3] * 2 - 1
        cot = cot[..., :3]
        fn = fastwarp.softsplat_diff
    before = dict(fastwarp.LAUNCHES)
    on_card = _grads_on(card, fn, (x, flow), cot)
    assert fastwarp.LAUNCHES != before
    on_cpu = _grads_on("cpu", fn, (x, flow), cot)
    for a, b in zip(on_card, on_cpu):
        _close(a, b)


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(card):
    """A kernel's output carries no gradient, so with grad mode on and an
    input that requires grad the wrappers raise; under no_grad they run."""
    img = torch.rand(1, 16, 24, 3, device=card, requires_grad=True)
    sx = torch.rand(1, 16, 24, device=card) * 20
    sy = torch.rand(1, 16, 24, device=card) * 12
    with pytest.raises(RuntimeError, match="gather_diff"):
        fastwarp.gather(img, sx, sy)
    with pytest.raises(RuntimeError, match="splat_sum_diff"):
        fastwarp.splat(img, sx, sy)
    x = torch.rand(1, 8, 8, 16, device=card).to(torch.bfloat16)
    w = torch.rand(8, 16, 3, 3, device=card, requires_grad=True)
    b = torch.zeros(8, device=card)
    with pytest.raises(RuntimeError, match="F.conv2d"):
        fastconv.conv3x3(x, w, b)
    with torch.no_grad():
        fastwarp.gather(img, sx, sy)
        fastwarp.splat(img, sx, sy)
        fastconv.conv3x3(x, w, b)
    torch.cuda.synchronize()
