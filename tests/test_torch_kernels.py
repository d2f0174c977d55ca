"""The hand-written CUDA kernels held against their plain versions on the
card. Marked `cuda`: without a GPU they skip (a CUDA kernel has no CPU
mode). This file imports neither jax nor fldrx, so it also runs where only
the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py configures JAX). chip_smoke.py holds the
same kernels at the main path's 4K shapes and the training shapes.

Tolerances: the gather is summed term for term as its plain version (≤
1e-5, expected 0), and splat_grad's dvals too (max abs 0); sums over
channels and the atomicAdd accumulations (splat, gather_grad's dimg)
change order, so those are held at 1e-4·(1 + |ref|); the correlation
kernel sums its C products in channel order within each channel group and
adds the groups in a fixed order, where torch.mean does not, held at
1e-5·(1 + |ref|); the resize sums its taps in the order and with the
roundings of its plain version (bit for bit) and is held within 2e-6·max|x|
of the dense form; the interleave, the deinterleave and pack_s2d4 move
values (pack_s2d4 rounds each once, as `.to` does), held bit for bit; the
blend computes in the order and with the roundings of its plain version,
but with CUDA's expf and logf where its plain version runs torch's exp and
log, held within 1e-6 max abs; conv3x3 rounds its
output to bf16 (one ulp is 1/128 relative), held at 2e-2 max abs and 1e-2
relative L2 against float32 F.conv2d.

The layout of conv3x3's packed weights, the route and frame limit the
gather and splat wrappers pick, and the correlation geometries that
tools/corr_geometry.py times, are held on the CPU as well.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from fldrx_torch.ops import (_build, blend, correlation, fastconv, fastwarp,
                             repack, resize)
from fldrx_torch.ops import warp as twarp

torch.set_num_threads(1)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


@pytest.mark.parametrize("name,expected", [
    ("warp", {
        # img, sx, sy, out, B, H, W, C, Ho, Wo, mask, route, stream
        "fldrx_gather_f32": [_P] * 4 + [_I] * 8 + [_P],
        # vals, tx, ty, out, B, H, W, C, route, stream
        "fldrx_splat_f32": [_P] * 4 + [_I] * 5 + [_P],
        # vals, tx, ty, g, dvals, dtx, dty, B, H, W, C, stream
        "fldrx_splat_grad_f32": [_P] * 7 + [_I] * 4 + [_P],
        # img, sx, sy, g, dimg, dsx, dsy, B, H, W, C, Ho, Wo, mask, stream
        "fldrx_gather_grad_f32": [_P] * 7 + [_I] * 7 + [_P],
    }),
    ("conv3x3", {
        # x, w (packed), bias, out, B, H, W, Cin, K, block_n, stream
        "fldrx_conv3x3_bf16": [_P] * 4 + [_I] * 6 + [_P],
    }),
    ("correlation", {
        # f1, f2, out, B, H, W, C, stream
        "fldrx_correlation_f32": [_P] * 3 + [_I] * 4 + [_P],
    }),
    ("repack", {
        # planes, out, B, H, row_bytes, stream
        "fldrx_interleave_planes": [_P] * 2 + [_I] * 3 + [_P],
        # rows, out, B, H, row_bytes, stream
        "fldrx_extract_planes": [_P] * 2 + [_I] * 3 + [_P],
        # ptrs, strides, chans, n, out, B, H, W, out_bf16, stream
        "fldrx_pack_s2d4": [_P] * 3 + [_I, _P] + [_I] * 4 + [_P],
    }),
    ("resize", {
        # x, strides, N, H, W, C, iy, wy, ky, ix, wx, kx, OH, OW, tw, spans,
        # smem_floats, out, stream
        "fldrx_resize_taps_f32": [_P] * 2 + [_I] * 4 + [_P] * 2 + [_I]
        + [_P] * 2 + [_I] * 4 + [_P, _I, _P, _P],
    }),
    ("blend", {
        # logits, logits_bf16, cands, strides, t, T, out, planes, B, H, W,
        # stream
        "fldrx_blend6": [_P, _I] + [_P] * 5 + [_I] * 4 + [_P],
    }),
    ("decoder", {
        # path, w, h
        "fldrx_png_probe": [_P] * 3,
        # path, out, w, h
        "fldrx_png_decode": [_P] * 2 + [_U] * 2,
        # paths, n, outs, w, h, threads
        "fldrx_png_decode_batch": [_P, _I, _P, _U, _U, _I],
    }),
])
def test_entry_point_prototypes(name, expected):
    """The ctypes binding read from each source's extern "C" prototypes
    has the arguments the wrappers in fastwarp/fastconv/repack/correlation/
    resize/blend and data/native pass."""
    assert _build.prototypes(name) == expected


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _at_offset(shape, offset: int, g, dev="cpu"):
    """A contiguous float32 tensor of `shape` (uniform in [0, 1)) starting
    `offset` floats into its storage: offset 1 puts its data pointer off
    every 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + offset, device=dev)
    flat[offset:] = torch.rand(n, generator=g).to(dev)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("shape,offset,route", [
    ((1, 8, 8, 4), 0, fastwarp.VEC4),
    ((2, 5, 7, 32), 0, fastwarp.VEC4),
    ((1, 3, 5, 128), 4, fastwarp.VEC4),       # 16 bytes in: still aligned
    ((1, 8, 8, 4), 1, fastwarp.SCALAR),        # 4 bytes in
    ((1, 8, 8, 64), 2, fastwarp.SCALAR),       # 8 bytes in
    ((1, 8, 8, 3), 0, fastwarp.SCALAR),
    ((1, 8, 8, 2), 0, fastwarp.SCALAR),
    ((1, 8, 8, 49), 0, fastwarp.SCALAR),
    ((1, 8, 8, 1), 0, fastwarp.SCALAR),
])
def test_warp_route(shape, offset, route):
    """The gather and splat wrappers' route: VEC4 only where C is a
    multiple of 4 and both the input's and the output's data pointers are
    16-byte aligned (a contiguous view can start anywhere in its
    storage)."""
    x = _at_offset(shape, offset, torch.Generator().manual_seed(0))
    out = torch.empty(shape)
    assert x.is_contiguous()
    assert fastwarp._route(shape[-1], x.data_ptr(), out.data_ptr()) == route
    assert fastwarp._route(shape[-1], out.data_ptr(), x.data_ptr()) == route
    # a batch slice x[1:] of C = 4 rows keeps its storage's alignment:
    # VEC4 from an aligned tensor, SCALAR from one that starts one float in
    aligned = torch.empty(16)
    for offset, want in ((0, fastwarp.VEC4), (1, fastwarp.SCALAR)):
        sl = _at_offset((3, 5, 7, 4), offset, torch.Generator())[1:]
        assert sl.is_contiguous()
        assert (sl.data_ptr() % 16 == 0) == (want == fastwarp.VEC4)
        assert fastwarp._route(4, sl.data_ptr(), aligned.data_ptr()) == want


def test_warp_frame_limit():
    """The kernels index one frame in 32 bits: the wrappers refuse a frame
    of 2^31 elements or more before any launch."""
    fastwarp._check_frame("gather", fastwarp.MAX_FRAME_ELEMS)
    with pytest.raises(ValueError, match="at most 2147483647"):
        fastwarp._check_frame("splat", fastwarp.MAX_FRAME_ELEMS + 1)


def test_correlation_geometries_are_timed():
    """tools/corr_geometry.py, which times the correlation kernel's
    geometries, covers each geometry the entry point launches, and each of
    its source variants still applies to csrc/correlation.cu."""
    import re

    from fldrx_torch.tools import corr_geometry

    with open(os.path.join(_build.SRC_DIR, "correlation.cu")) as f:
        src = f.read()
    entry = src[src.index('extern "C" int fldrx_correlation_f32'):]
    picked = {tuple(int(v) for v in m) for m in
              re.findall(r"launch<(\d+), (\d+), (\d+)>", entry)}
    assert len(picked) == 3
    assert picked <= set(corr_geometry.GEOMETRIES)
    for name, old, new in corr_geometry.VARIANTS:
        assert src.count(old) == 1, name
    assert "corr_geometry(" in corr_geometry.entry_point()


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("C", [2, 3, 4, 32, 49, 128])
def test_gather_kernel_matches_plain(card, C, mask):
    """Both routes, bit for bit: a ragged 37×45 frame (W no multiple of 4
    or 32) sampled on a 29×51 grid, with taps in and out of frame; from an
    aligned tensor, from a batch slice img[1:] and from a contiguous view
    that starts one float into its storage (off every 16-byte boundary, so
    SCALAR where C % 4 == 0 would allow VEC4)."""
    g = torch.Generator(device="cpu").manual_seed(C)
    B, H, W, Ho, Wo = 2, 37, 45, 29, 51
    full = _at_offset((B + 1, H, W, C), 0, g, card)
    sx = (torch.rand(B, Ho, Wo, generator=g) * (W + 6) - 3).to(card)
    sy = (torch.rand(B, Ho, Wo, generator=g) * (H + 6) - 3).to(card)
    cases = {"aligned": full[:B], "batch slice": full[1:],
             "one float in": _at_offset((B, H, W, C), 1, g, card)}
    for name, img in cases.items():
        before = fastwarp.LAUNCHES["gather"]
        got = fastwarp.gather(img, sx, sy, mask=mask)
        ref = fastwarp.gather_plain(img, sx, sy, mask=mask)
        torch.cuda.synchronize()
        assert fastwarp.LAUNCHES["gather"] == before + 1
        assert got.shape == ref.shape == (B, Ho, Wo, C)
        assert (got - ref).abs().max().item() <= 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("flow", ["smooth", "wide", "out of frame",
                                  "one float in"])
@pytest.mark.parametrize("C", [1, 3, 4, 49, 64])
def test_splat_kernel_matches_plain(card, C, flow):
    """Both routes at a ragged 37×45 frame, batch 2: a smooth flow of ±5
    px; a wide random flow (σ 50 px, most targets far apart and many out of
    frame); every target out of frame (the result is all zero); and vals
    from a view one float into its storage (SCALAR where C % 4 == 0 would
    allow VEC4)."""
    g = torch.Generator(device="cpu").manual_seed(C)
    B, H, W = 2, 37, 45
    vals = _at_offset((B, H, W, C), 1 if flow == "one float in" else 0, g,
                      card)
    xs = torch.arange(W, dtype=torch.float32)
    ys = torch.arange(H, dtype=torch.float32)[:, None]
    if flow == "wide":
        fx, fy = (torch.randn(B, H, W, generator=g) * 50 for _ in range(2))
    elif flow == "out of frame":
        fx, fy = torch.full((B, H, W), W + 1.5), torch.zeros(B, H, W)
    else:
        fx, fy = (torch.nn.functional.interpolate(
            torch.randn(B, 1, 4, 6, generator=g) * 5, size=(H, W),
            mode="bilinear")[:, 0] for _ in range(2))
    tx, ty = (xs + fx).to(card), (ys + fy).to(card)
    before = fastwarp.LAUNCHES["splat"]
    got = fastwarp.splat(vals, tx, ty)
    ref = fastwarp.splat_plain(vals, tx, ty)
    torch.cuda.synchronize()
    assert fastwarp.LAUNCHES["splat"] == before + 1
    assert got.shape == ref.shape == (B, H, W, C)
    if flow == "out of frame":
        assert not got.any() and not ref.any()
    _close(got, ref)


@pytest.mark.parametrize("K,Cin", [(32, 16), (40, 48), (96, 24), (130, 13)])
def test_conv3x3_weight_layout(K, Cin):
    """pack_weights puts weight [k, c, ky, kx] where the kernel reads it:
    chunk c // 16, block k // nb, tap ky·3 + kx, row k % nb, lane c % 16;
    zeros past K and Cin."""
    g = torch.Generator().manual_seed(K)
    w = torch.randn(K, Cin, 3, 3, generator=g)
    nb = fastconv.block_n(K)
    wp = fastconv.pack_weights(w, nb)
    nch, nkb = -(-Cin // 16), -(-K // nb)
    assert wp.shape == (nch, nkb, 9, nb, 16) and wp.dtype == torch.bfloat16
    assert wp.is_contiguous()
    flat = wp.reshape(-1)
    k, c, ky, kx = np.meshgrid(np.arange(K), np.arange(Cin), np.arange(3),
                               np.arange(3), indexing="ij")
    idx = (((((c // 16) * nkb + k // nb) * 9 + ky * 3 + kx) * nb + k % nb)
           * 16 + c % 16)
    assert torch.equal(flat[torch.tensor(idx)], w.to(torch.bfloat16))
    rest = torch.ones(flat.numel(), dtype=torch.bool)
    rest[torch.tensor(idx.reshape(-1))] = False
    assert not flat[rest].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Cin,K", [
    (1, 40, 72, 48, 40),      # a ragged K: 40 of block_n 64
    (1, 37, 45, 64, 32),      # H, W no multiple of the tile; block_n 32
    (2, 21, 50, 48, 64),      # block_n 64, two frames
    (1, 19, 33, 32, 96),      # block_n 96 (16-row tiles)
    (1, 23, 17, 13, 5),       # Cin padded to 16 in the wrapper, odd K
    (1, 10, 70, 40, 130),     # K over 96: three blocks of 64
])
def test_conv3x3_kernel_matches_plain(card, B, H, W, Cin, K):
    g = torch.Generator(device="cpu").manual_seed(Cin + K)
    x = (torch.rand(B, H, W, Cin, generator=g) * 2 - 1).to(card, torch.bfloat16)
    # outputs stay under 8, where half a bf16 ulp is below the 2e-2 bound
    w = (torch.randn(K, Cin, 3, 3, generator=g) * 0.05).to(card, torch.bfloat16)
    b = torch.randn(K, generator=g).to(card)
    before = fastconv.LAUNCHES["conv3x3"]
    got = fastconv.conv3x3(x, w, b).float()
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).float(), w.float(),
                                     b, padding=1).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert fastconv.LAUNCHES["conv3x3"] == before + 1
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 2e-2
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2
    assert torch.equal(fastconv.conv3x3(x, w, b).float(), got)   # deterministic


def _close(got, ref, rel=1e-4):
    assert ((got - ref).abs() <= rel * (1 + ref.abs())).all(), \
        (got - ref).abs().max().item()


def _flow_targets(flow, g, B, H, W, Ho, Wo):
    """Absolute coords [B, Ho, Wo] into an H×W frame, on the CPU: a
    smooth ±5 px flow over a grid stretched from Ho×Wo onto H×W; a wide
    random flow (σ 50 px, many targets out of frame); or every target out
    of frame."""
    xs = torch.arange(Wo, dtype=torch.float32) * (W / Wo)
    ys = torch.arange(Ho, dtype=torch.float32)[:, None] * (H / Ho)
    if flow == "wide":
        fx, fy = (torch.randn(B, Ho, Wo, generator=g) * 50 for _ in range(2))
    elif flow == "out of frame":
        return torch.full((B, Ho, Wo), W + 1.5), torch.zeros(B, Ho, Wo)
    else:
        fx, fy = (torch.nn.functional.interpolate(
            torch.randn(B, 1, 4, 6, generator=g) * 5, size=(Ho, Wo),
            mode="bilinear")[:, 0] for _ in range(2))
    return xs + fx, ys + fy


# a ragged 37×45 frame, batch 2; "batch slice one float in" takes frames
# 1: of a tensor whose storage starts one float in, so at even C its data
# pointer is off every 8-byte boundary (37·45 ≡ 1 mod 4): the scalar
# layout, where a vector access would fault (odd C takes it anyway)
VJP_CS = [1, 2, 3, 4, 5, 32, 49, 64]
VJP_FLOWS = ["smooth", "wide", "out of frame", "batch slice one float in"]


def _vjp_inputs(flow, g, B, H, W, C, card):
    """img/vals and the cotangent's storage for a VJP test: aligned, or a
    batch slice that starts off every 8-byte boundary."""
    if flow != "batch slice one float in":
        return _at_offset((B, H, W, C), 0, g, card)
    x = _at_offset((B + 1, H, W, C), 1, g, card)[1:]
    assert x.is_contiguous() and (C % 2 or x.data_ptr() % 8 != 0)
    return x


@pytest.mark.parametrize("flow", VJP_FLOWS[:3])
@pytest.mark.parametrize("C", [1, 3, 4, 49])
def test_splat_grad_dvals_is_the_gather(C, flow):
    """splat_grad's dvals is the gather of the cotangent at the targets
    with no mask, term for term: the plain versions agree bit for bit,
    which is why the dvals-only form runs on the gather's kernels."""
    g = torch.Generator().manual_seed(300 + C)
    B, H, W = 2, 37, 45
    cot = torch.randn(B, H, W, C, generator=g)
    tx, ty = _flow_targets(flow, g, B, H, W, H, W)
    dvals, dtx, dty = fastwarp.splat_grad_plain(cot, tx, ty, cot, False)
    assert dtx is None and dty is None
    assert (dvals - fastwarp.gather_plain(cot, tx, ty)).abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("flow", VJP_FLOWS)
@pytest.mark.parametrize("C", VJP_CS)
def test_splat_grad_kernel_matches_plain(card, C, flow):
    """Both forms: dvals only (the gather's routes) and dvals with dtx/dty
    (lane groups, 16-byte at C % 4 == 0, 8-byte at even C, where the
    pointers allow). dvals bit for bit (max abs 0), dtx/dty within
    1e-4·(1+|ref|); all zero when every target is out of frame."""
    g = torch.Generator(device="cpu").manual_seed(100 + C)
    B, H, W = 2, 37, 45
    vals = _vjp_inputs(flow, g, B, H, W, C, card)
    cot = (_vjp_inputs(flow, g, B, H, W, C, card) - 0.5) * 4
    tx, ty = (t.to(card) for t in _flow_targets(flow, g, B, H, W, H, W))
    for coords in (True, False):
        before = fastwarp.LAUNCHES["splat_grad"]
        got = fastwarp.splat_grad(vals, tx, ty, cot, coords)
        ref = fastwarp.splat_grad_plain(vals, tx, ty, cot, coords)
        torch.cuda.synchronize()
        assert fastwarp.LAUNCHES["splat_grad"] == before + 1
        assert got[0].shape == (B, H, W, C)
        assert (got[0] - ref[0]).abs().max().item() == 0, coords
        if coords:
            _close(got[1], ref[1])
            _close(got[2], ref[2])
        else:
            assert got[1] is None and got[2] is None
        if flow == "out of frame":
            assert not any(x.any() for x in got if x is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("flow", VJP_FLOWS)
@pytest.mark.parametrize("C", VJP_CS)
def test_gather_grad_kernel_matches_plain(card, C, flow, mask):
    """Every form — coords only (a thread per pixel at C = 2, 3, else lane
    groups), dimg with coords, dimg only — on a 37×45 frame sampled on a
    29×51 grid, within 1e-4·(1+|ref|); asking for nothing launches
    nothing."""
    g = torch.Generator(device="cpu").manual_seed(200 + C)
    B, H, W, Ho, Wo = 2, 37, 45, 29, 51
    img = (_vjp_inputs(flow, g, B, H, W, C, card) - 0.5) * 2
    cot = (_at_offset((B, Ho, Wo, C), 1 if flow.endswith("in") else 0, g,
                      card) - 0.5) * 4
    sx, sy = (t.to(card) for t in _flow_targets(flow, g, B, H, W, Ho, Wo))
    for want_img, want_coords in ((False, True), (True, True), (True, False)):
        before = fastwarp.LAUNCHES["gather_grad"]
        got = fastwarp.gather_grad(img, sx, sy, cot, mask, want_img,
                                   want_coords)
        ref = fastwarp.gather_grad_plain(img, sx, sy, cot, mask, want_img,
                                         want_coords)
        torch.cuda.synchronize()
        assert fastwarp.LAUNCHES["gather_grad"] == before + 1
        for a, b in zip(got, ref):
            assert (a is None) == (b is None)
            if b is not None:
                _close(a, b)
        if want_img:
            assert got[0].shape == (B, H, W, C)
        if flow == "out of frame":
            assert not any(x.any() for x in got if x is not None)
    before = dict(fastwarp.LAUNCHES)
    assert fastwarp.gather_grad(img, sx, sy, cot, mask, False, False) == \
        (None, None, None)
    assert fastwarp.LAUNCHES == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [
    ((2, 24, 40, 32), 0), ((1, 13, 37, 12), 0), ((3, 8, 8, 81), 0),
    # the teacher's channel counts, dec2 to dec6, at small frames
    ((2, 20, 24, 32), 0), ((2, 12, 20, 64), 0), ((2, 10, 12, 96), 0),
    ((1, 9, 14, 128), 0), ((2, 8, 8, 196), 0),
    # frames smaller than the ±4 displacement window
    ((2, 3, 5, 32), 0), ((1, 3, 5, 196), 0),
    # each geometry the entry point picks (by 16×4 tiles: 512 or more,
    # 128 or more, fewer) on a frame no multiple of its tile (16×4, 8×2)
    ((2, 130, 150, 32), 0), ((3, 70, 45, 64), 0), ((2, 19, 37, 96), 0),
    # scalar staging: a C that is no multiple of 4, inputs one float into
    # their storage (off every 16-byte boundary)
    ((2, 17, 21, 7), 0), ((2, 20, 28, 32), 1), ((1, 6, 9, 196), 1),
])
def test_correlation_kernel_matches_plain(card, shape, offset):
    """The kernel against its plain version, one launch per call: tiles
    cut by the frame edge, channel chunks cut by C, every geometry, the
    16-byte and the scalar staging and output paths."""
    g = torch.Generator(device="cpu").manual_seed(6)
    if offset:
        f1, f2 = (_at_offset(shape, offset, g, card) for _ in range(2))
        assert f1.data_ptr() % 16 and f2.data_ptr() % 16
    else:
        f1 = torch.randn(*shape, generator=g).to(card)
        f2 = torch.randn(*shape, generator=g).to(card)
    before = correlation.LAUNCHES["correlation"]
    got = correlation.correlation(f1, f2)
    ref = correlation.correlation_cost_volume(f1, f2)
    torch.cuda.synchronize()
    assert correlation.LAUNCHES["correlation"] == before + 1
    assert got.shape == ref.shape == (*shape[:3], 81)
    _close(got, ref, 1e-5)


@pytest.mark.cuda
def test_correlation_diff_card_matches_cpu(card):
    """correlation_diff's gradients on the card (kernel forward, plain
    VJP) against the CPU, and the forward wrapper's refusal of inputs
    that require grad."""
    rng = np.random.RandomState(7)
    a = rng.randn(2, 12, 20, 16).astype(np.float32)
    b = rng.randn(2, 12, 20, 16).astype(np.float32)
    cot = rng.randn(2, 12, 20, 81).astype(np.float32)
    on_card = _grads_on(card, correlation.correlation_diff, (a, b), cot)
    on_cpu = _grads_on("cpu", correlation.correlation_diff, (a, b), cot)
    for x, y in zip(on_card, on_cpu):
        _close(x, y)
    f = torch.tensor(a, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="correlation_diff"):
        correlation.correlation(f, f)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 24, 40 * 3), torch.float32),     # 16-byte rows
    ((1, 4, 5, 7 * 3), torch.float32),       # 4-byte rows
    ((1, 4, 6, 7 * 3), torch.bfloat16),      # 2-byte rows
])
def test_interleave_kernel_matches_plain(card, shape, dtype):
    g = torch.Generator(device="cpu").manual_seed(8)
    planes = torch.randn(*shape, generator=g).to(dtype).to(card)
    before = repack.LAUNCHES["interleave"]
    got = repack.interleave_planes(planes)
    ref = repack.interleave_planes_plain(planes)
    torch.cuda.synchronize()
    assert repack.LAUNCHES["interleave"] == before + 1
    assert got.shape == ref.shape == (shape[0], 4 * shape[2], shape[3])
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 24, 40 * 3), torch.float32),        # 16-byte rows
    ((1, 20, 7 * 3), torch.float32),         # 4-byte rows
    ((1, 24, 7 * 3), torch.bfloat16),        # 2-byte rows
])
def test_deinterleave_kernel_matches_plain(card, shape, dtype):
    g = torch.Generator(device="cpu").manual_seed(9)
    rows = torch.randn(*shape, generator=g).to(dtype).to(card)
    before = repack.LAUNCHES["deinterleave"]
    got = repack.extract_planes(rows)
    ref = repack.extract_planes_plain(rows)
    torch.cuda.synchronize()
    assert repack.LAUNCHES["deinterleave"] == before + 1
    assert got.shape == ref.shape == (shape[0], 4, shape[1] // 4, shape[2])
    assert torch.equal(got, ref)
    assert torch.equal(repack.interleave_planes(got), rows)
    with pytest.raises(RuntimeError, match="inference only"):
        repack.extract_planes(rows.float().requires_grad_())


TEN = (3, 3, 3, 3, 2, 2, 2, 2, 3, 3)      # the packed synthesis's sources


def _pack_parts(B, H, W, layout, g, dev):
    """The packed synthesis's ten sources (26 channels): x0 and x1
    batch-strided views of one [B, 2, H, W, 3] tensor, the four 2-channel
    flow fields as the layout says (dense rows; "columns": W-major, as a
    resize leaves them; "offset": rows one float into their storage, off
    every 16-byte boundary; "planar": channels last in memory, which the
    wrapper copies)."""
    offset = int(layout == "offset")

    def flow():
        if layout == "columns":
            return _at_offset((B, W, H, 2), 0, g, dev).transpose(1, 2)
        if layout == "planar":
            return _at_offset((B, 2, H, W), 0, g, dev).permute(0, 2, 3, 1)
        return _at_offset((B, H, W, 2), offset, g, dev)

    images = _at_offset((B, 2, H, W, 3), offset, g, dev)
    return ([images[:, 0], images[:, 1]]
            + [_at_offset((B, H, W, 3), offset, g, dev) for _ in range(2)]
            + [flow() for _ in range(4)]
            + [_at_offset((B, H, W, 3), offset, g, dev) for _ in range(2)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,layout", [
    (1, 2304, 4096, "columns"),   # the padded 4K frame, as the path has it
    (2, 8, 4 * 69, "rows"),       # 69 cells a row: no multiple of 32 or 16
    (2, 12, 4 * 37, "columns"),
    (2, 12, 4 * 37, "offset"),    # the 4-byte loads
    (1, 8, 4 * 5, "planar"),
])
def test_pack_s2d4_kernel_matches_plain(card, B, H, W, layout, dtype):
    """pack_s2d4's kernel against its plain version, bit for bit, one
    launch a call, with x0 and x1 read in place as batch-strided views."""
    g = torch.Generator().manual_seed(H + W)
    parts = _pack_parts(B, H, W, layout, g, card)
    before = repack.LAUNCHES["pack_s2d4"]
    got = repack.pack_s2d4(parts, dtype)
    ref = repack.pack_s2d4_plain(parts, dtype)
    torch.cuda.synchronize()
    assert repack.LAUNCHES["pack_s2d4"] == before + 1
    assert got.shape == ref.shape == (B, H // 4, W // 4, 16 * 26)
    assert got.dtype == dtype
    assert torch.equal(got, ref)
    with pytest.raises(RuntimeError, match="inference only"):
        repack.pack_s2d4([parts[2].requires_grad_()], dtype)


@pytest.mark.cuda
def test_pack_s2d4_launches_once_a_t(card):
    """One packed synthesis over a chunk of 4 t values launches pack_s2d4
    exactly 4 times."""
    from fldrx_torch.config import papermodel
    from fldrx_torch.model import fldrnet

    cfg = papermodel().replace(fast_warp=True, packed_synth=True)
    params = fldrnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=card)
    g = torch.Generator().manual_seed(1)
    B, H, W = 1, 384, 384
    images = (torch.rand(B, 2, H, W, 3, generator=g) * 2 - 1).to(card)
    flow_l = (torch.rand(B, H // 4, W // 4, 4, generator=g) * 6 - 3).to(card)
    assert fldrnet.can_use_packed(flow_l, images)
    ts = [torch.full((B, 1), t, device=card) for t in (0.2, 0.4, 0.6, 0.8)]
    before = repack.LAUNCHES["pack_s2d4"]
    with torch.inference_mode():
        out = fldrnet.synthesize_packed_multi(
            params["vfinet"], flow_l, images, ts,
            compute_dtype=torch.bfloat16, planes_out=True)
    torch.cuda.synchronize()
    assert len(out) == 4
    assert repack.LAUNCHES["pack_s2d4"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.125, 0.5, 0.875])
@pytest.mark.parametrize("H,W", [(64, 128), (2304, 512)])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_blend6_kernel_matches_plain(card, dtype, planes, B, H, W, t):
    """The blend kernel against `blend6_plain` run on the card, one launch
    a call, into plain rows and into u-planes, with x0 and x1 batch-strided
    views of one [B, 2, H, W, 3] tensor: within 1e-6 max abs (the kernel's
    expf and logf against torch's exp and log, and its sum of the six
    exponentials in order against torch.sum's)."""
    g = torch.Generator().manual_seed(H + W + B)
    logits = (torch.randn(B, H // 4, W // 4, 96, generator=g) * 4).to(
        dtype).to(card)
    images = (torch.rand(B, 2, H, W, 3, generator=g) * 2 - 1).to(card)
    cands = [(torch.rand(B, H, W, 3, generator=g) * 2 - 1).to(card)
             for _ in range(4)] + [images[:, 0], images[:, 1]]
    tb = torch.full((B, 1, 1, 1), t, device=card)
    T = torch.tensor([0.8], device=card)
    shape = (B, 4, H // 4, W * 3) if planes else (B, H, W, 3)
    got = torch.full(shape, float("nan"), device=card)
    want = torch.full(shape, float("nan"), device=card)
    before = blend.LAUNCHES["blend6"]
    with torch.inference_mode():
        blend.blend6_out(logits, cands, tb, T, got)
    blend.blend6_plain(logits, cands, tb, T, want)
    torch.cuda.synchronize()
    assert blend.LAUNCHES["blend6"] == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("planes_out", [False, True])
def test_blend6_launches_once_a_t(card, planes_out):
    """One packed synthesis over a chunk of 4 t values launches the blend
    exactly 4 times and the interleave never, in either layout."""
    from fldrx_torch.config import papermodel
    from fldrx_torch.model import fldrnet

    cfg = papermodel().replace(fast_warp=True, packed_synth=True)
    params = fldrnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=card)
    g = torch.Generator().manual_seed(1)
    B, H, W = 1, 384, 384
    images = (torch.rand(B, 2, H, W, 3, generator=g) * 2 - 1).to(card)
    flow_l = (torch.rand(B, H // 4, W // 4, 4, generator=g) * 6 - 3).to(card)
    ts = [torch.full((B, 1), t, device=card) for t in (0.2, 0.4, 0.6, 0.8)]
    before = blend.LAUNCHES["blend6"], repack.LAUNCHES["interleave"]
    with torch.inference_mode():
        out = fldrnet.synthesize_packed_multi(
            params["vfinet"], flow_l, images, ts,
            compute_dtype=torch.bfloat16, planes_out=planes_out)
    torch.cuda.synchronize()
    assert out.shape == ((4, B, 4, H // 4, W * 3) if planes_out
                         else (4, B, H, W, 3))
    assert torch.isfinite(out).all()
    assert (blend.LAUNCHES["blend6"], repack.LAUNCHES["interleave"]) == (
        before[0] + 4, before[1])


# the main path's resizes at 4K (the padded 2304×4096 frame): the pyramid's
# five bicubic levels of both frames, flow_extras' frames, flows and z maps,
# a flowback's ×8 upsample, a level's flow upsample; then small shapes:
# align_corners, one axis unchanged, batch dims, an exact sample's taps
# inside its neighbours'
RESIZE_CASES = [
    ((2, 2304, 4096, 3), (1152, 2048), "bicubic", False),
    ((2, 2304, 4096, 3), (72, 128), "bicubic", False),
    ((2, 2304, 4096, 3), (1152, 2048), "bilinear", False),
    ((1, 288, 512, 2), (2304, 4096), "bilinear", False),
    ((1, 288, 512, 2), (1152, 2048), "bilinear", False),
    ((1, 1152, 2048, 1), (2304, 4096), "bilinear", False),
    ((1, 144, 256, 4), (288, 512), "bilinear", False),
    ((2, 3, 37, 50, 4), (13, 29), "bicubic", True),
    ((8, 12, 3), (64, 96), "bicubic", True),
    ((2, 24, 40, 2), (24, 13), "bilinear", False),
    ((1, 21, 17, 2), (50, 41), "nearest", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dst,mode,align_corners", RESIZE_CASES)
def test_resize_kernel_matches_plain_and_dense(card, shape, dst, mode,
                                               align_corners):
    """The tap kernel bit for bit against its plain version and within
    2e-6·max|x| of the dense form; one launch, a fresh row-major
    output."""
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) * 4).to(card)
    before = resize.LAUNCHES["resize"]
    with torch.inference_mode():
        got = resize.resize_2d(x, dst, mode, align_corners)
    assert resize.LAUNCHES["resize"] == before + 1
    plain = resize.resize_taps_plain(x, dst, mode, align_corners)
    dense = resize._resize_dense(x, *dst, mode, align_corners)
    torch.cuda.synchronize()
    assert got.shape == (*shape[:-3], *dst, shape[-1])
    assert got.is_contiguous()
    assert torch.equal(got, plain)
    assert (got - dense).abs().max() <= 2e-6 * x.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channel slice", "W-major", "planar",
                                    "offset"])
def test_resize_kernel_reads_strided_inputs(card, layout):
    """Non-dense inputs are read in place at their strides: a channel
    slice of a flow field, a W-major field, channel-planar frames, a view
    one float into its storage."""
    g = torch.Generator().manual_seed(9)
    B, H, W = 2, 36, 64
    if layout == "channel slice":
        x = torch.randn(B, H, W, 4, generator=g).to(card)[..., 2:4]
    elif layout == "W-major":
        x = torch.randn(B, W, H, 2, generator=g).to(card).transpose(1, 2)
    elif layout == "planar":
        x = torch.randn(B, 3, H, W, generator=g).to(card).permute(0, 2, 3, 1)
    else:
        x = _at_offset((B, H, W, 3), 1, g, card)
    for dst, mode in (((288, 512), "bilinear"), ((18, 16), "bicubic")):
        with torch.inference_mode():
            got = resize.resize_2d(x, dst, mode)
        want = resize.resize_taps_plain(x.contiguous(), dst, mode)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.cuda
def test_resize_in_grad_mode_stays_dense(card):
    """With grad mode on a CUDA tensor takes the dense form, whether it
    requires grad (a gradient) or not, and launches nothing; with grad
    mode off the kernel, which refuses more than 4 channels."""
    x = torch.randn(1, 18, 32, 2, device=card, requires_grad=True)
    before = resize.LAUNCHES["resize"]
    y = resize.resize_2d(x, (144, 256), "bilinear")
    y.sum().backward()
    assert y.grad_fn is not None and x.grad is not None
    z = resize.resize_2d(x.detach(), (144, 256), "bilinear")
    assert torch.equal(z, resize._resize_dense(x.detach(), 144, 256,
                                               "bilinear", False))
    assert resize.LAUNCHES["resize"] == before
    with torch.no_grad():
        resize.resize_2d(x, (144, 256), "bilinear")
        with pytest.raises(ValueError, match="1 to 4"):
            resize.resize_2d(torch.zeros(1, 8, 8, 5, device=card), (4, 4))
    assert resize.LAUNCHES["resize"] == before + 1


@pytest.mark.cuda
def test_resize_launches_a_4k_pair(card, monkeypatch):
    """One precompute_flow and a 4-t synthesize_multi_at at 4K launch the
    resize exactly 5 (pyramid) + 5 (the levels' flow upsamples) + 7
    (extras) + 2 a t (the flowbacks) times; in the synthesis the warps'
    coordinates, made from the resizes' row-major flows, need no copy."""
    from fldrx_torch.api import prepare_model
    from fldrx_torch.bench_inputs import bench_frames, deploy_config

    copied = []
    f32 = fastwarp._f32

    def recording(t, name):
        if not t.is_contiguous():
            copied.append(name)
        return f32(t, name)

    monkeypatch.setattr(fastwarp, "_f32", recording)
    interp = prepare_model(cfg=deploy_config(), device=card)[0]
    frames = bench_frames(2160, 4096)
    before = resize.LAUNCHES["resize"]
    flow, padded, extras = interp.precompute_flow(frames)
    del copied[:]
    interp.synthesize_multi_at(flow, padded, [0.2, 0.4, 0.6, 0.8],
                               (2160, 4096), extras)
    torch.cuda.synchronize()
    assert resize.LAUNCHES["resize"] == before + 5 + 5 + 7 + 2 * 4
    assert copied == []
