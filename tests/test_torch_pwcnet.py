"""The port's PWC-Net teacher and correlation cost volume held against
fldrx on the CPU.

References are fldrx with no FLDRX_* overrides (the XLA cost volume), and
its Pallas cost-volume kernel in interpret mode where a test names it. The
teacher runs on fldrx's `init_pwc_params(PRNGKey(0))` carried across with
`pwc_params_from_numpy` (the trained checkpoint is not in the repository).

Tolerances: the cost volume sums C float32 products in another order than
XLA (rtol 1e-5, atol 1e-6); the teacher is a deep float32 conv stack
(relative L2 1e-5, max abs 1e-4·(1 + max|ref|)).
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fldrx.model import pwcnet as jp
from fldrx.ops import correlation as jcorr
from fldrx_torch.model import pwcnet as tp
from fldrx_torch.ops import correlation as tcorr
from fldrx_torch.ops.warp import grid_sample_bilinear, ones_mask_sep
from fldrx_torch.weights import (convert_pwc_state_dict, load_pwc_npz,
                                 named_leaves, pwc_params_from_numpy)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _exact_reference():
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("FLDRX_")}
    importlib.reload(jcorr)
    yield
    os.environ.update(saved)


@pytest.fixture(scope="module")
def fldrx_params():
    return jp.init_pwc_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_params(fldrx_params):
    return pwc_params_from_numpy(jax.tree.map(np.asarray, fldrx_params),
                                 device="cpu")


def _pair(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# -- the cost volume ------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (2, 12, 14, 8), (2, 16, 24, 12),
    # the teacher's channel counts, dec2 to dec6, at small frames
    (2, 9, 10, 32), (1, 8, 9, 64), (1, 6, 7, 96), (1, 5, 6, 128),
    (2, 5, 5, 196),
    # a frame smaller than the ±4 displacement window
    (1, 3, 5, 32),
])
def test_cost_volume_matches_fldrx(shape):
    """The plain version against fldrx's XLA formula and against its Pallas
    kernel in interpret mode; `correlation` on CPU tensors is the plain
    version and launches nothing."""
    f1, f2 = _pair(shape, 5)
    got = tcorr.correlation_cost_volume(torch.tensor(f1),
                                        torch.tensor(f2)).numpy()
    assert got.shape == shape[:3] + (81,)
    ref = np.asarray(jcorr.correlation_cost_volume(jnp.asarray(f1),
                                                   jnp.asarray(f2)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    os.environ["FLDRX_PALLAS_INTERPRET"] = "1"
    try:
        corr = importlib.reload(jcorr)
        ker = np.asarray(corr.correlation_cost_volume_pallas(
            jnp.asarray(f1), jnp.asarray(f2)))
    finally:
        del os.environ["FLDRX_PALLAS_INTERPRET"]
        importlib.reload(jcorr)
    np.testing.assert_allclose(got, ker, rtol=1e-5, atol=1e-6)
    before = dict(tcorr.LAUNCHES)
    disp = tcorr.correlation(torch.tensor(f1), torch.tensor(f2)).numpy()
    np.testing.assert_array_equal(disp, got)
    assert tcorr.LAUNCHES == before


def test_cost_volume_grad_matches_jax():
    """correlation_diff's gradients (the plain formula's VJP) against
    jax.grad of fldrx's XLA formula, which is also the VJP fldrx gives its
    Pallas kernel (`_corr_vjp_bwd`): rtol 1e-4."""
    f1, f2 = _pair((2, 10, 12, 6), 6)
    a = torch.tensor(f1, requires_grad=True)
    b = torch.tensor(f2, requires_grad=True)
    (tcorr.correlation_diff(a, b) ** 2).sum().backward()
    g1, g2 = jax.grad(lambda x, y: jnp.sum(
        jcorr.correlation_cost_volume(x, y) ** 2), argnums=(0, 1))(
            jnp.asarray(f1), jnp.asarray(f2))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g1), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(g2), rtol=1e-4,
                               atol=1e-6)


# -- the teacher's parts -----------------------------------------------------------

def test_deconv_matches_fldrx():
    """deconv on torch's ConvTranspose2d weight against fldrx's dilated-conv
    form on the flipped HWIO weight; pwc_params_from_numpy undoes the flip."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 10, 5).astype(np.float32)
    w_t = rng.randn(5, 3, 4, 4).astype(np.float32)   # torch [in,out,kh,kw]
    b = rng.randn(3).astype(np.float32)
    w_j = jp.deconv_weight_from_torch(w_t)
    ref = np.asarray(jp._deconv4x4s2({"w": jnp.asarray(w_j),
                                      "b": jnp.asarray(b)}, jnp.asarray(x)))
    carried = pwc_params_from_numpy({"dec2": {"upfeat": {"w": w_j, "b": b}}},
                                    device="cpu")
    np.testing.assert_array_equal(carried["dec2"]["upfeat"]["w"].numpy(), w_t)
    got = tp.deconv({"w": torch.tensor(w_t), "b": torch.tensor(b)},
                    torch.tensor(x)).numpy()
    assert got.shape == (2, 16, 20, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 2.0, 6.0])
def test_backward_warp_matches_fldrx(scale):
    """The port builds its [-1, 1] grid with torch.linspace, as the
    reference does, where fldrx's jnp.linspace rounds a few entries 1 ulp
    apart: a sample position moves by ~1e-6 px, so atol 1e-5 on randn
    images."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 10, 12, 4).astype(np.float32)
    flow = (rng.randn(2, 10, 12, 2) * scale).astype(np.float32)
    ref = np.asarray(jp._backward_warp_pwc(jnp.asarray(x), jnp.asarray(flow)))
    got = tp.backward_warp_pwc(torch.tensor(x), torch.tensor(flow)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _mask_flips(x, flow):
    """Pixels where the gather's closed-form mask (gx·gy >= 0.999) and
    fldrx's strict corner-sum mask (sampled ones > 0.999) disagree, at the
    sample positions backward_warp_pwc builds."""
    B, H, W, _ = x.shape
    xs = torch.linspace(-1.0, 1.0, W)
    ys = torch.linspace(-1.0, 1.0, H)
    px = ((xs + flow[..., 0] / ((W - 1.0) / 2.0) + 1.0) * W - 1.0) / 2.0
    py = ((ys[:, None] + flow[..., 1] / ((H - 1.0) / 2.0) + 1.0) * H
          - 1.0) / 2.0
    _, ones = grid_sample_bilinear(x[..., :1], px, py, with_ones_mask=True)
    strict = ones[..., 0] > 0.999
    closed = ones_mask_sep(px, py, H, W) > 0
    return int((strict != closed).sum()), strict.numel()


# -- the whole teacher ----------------------------------------------------------------

@pytest.mark.parametrize("hw", [(96, 128), (100, 150)])
def test_teacher_matches_fldrx(hw, fldrx_params, port_params, monkeypatch):
    """get_bidirectional_flow and pwc_forward against fldrx on the same
    weights and frames (100×150 takes the resize to 128×192 and back).
    The warps are recorded on the way: at these shapes the gather's
    closed-form mask flips no pixel against fldrx's strict threshold."""
    rng = np.random.RandomState(3)
    im0 = rng.rand(1, *hw, 3).astype(np.float32)
    im1 = rng.rand(1, *hw, 3).astype(np.float32)
    ref = np.asarray(jp.get_bidirectional_flow(
        fldrx_params, jnp.asarray(im0), jnp.asarray(im1)))
    warps = []
    warp = tp.backward_warp_pwc

    def recording(x, flow):
        warps.append((x, flow))
        return warp(x, flow)

    monkeypatch.setattr(tp, "backward_warp_pwc", recording)
    got = tp.get_bidirectional_flow(port_params, torch.tensor(im0),
                                    torch.tensor(im1))
    assert not got.requires_grad and got.shape == (1, *hw, 4)
    got = got.numpy()
    tol = 1e-4 * (1 + np.abs(ref).max())
    assert _rel_l2(got, ref) <= 1e-5, _rel_l2(got, ref)
    assert np.abs(got - ref).max() <= tol
    assert len(warps) == 8             # 4 warped decoders × 2 directions
    flips = [_mask_flips(x, f) for x, f in warps]
    assert sum(n for n, _ in flips) == 0, flips
    one = tp.pwc_forward(port_params, torch.tensor(im0), torch.tensor(im1))
    np.testing.assert_array_equal(one.detach().numpy(), got[..., 2:4])


def test_teacher_gradients_reach_inputs(port_params):
    """Outside get_bidirectional_flow the teacher keeps the autograd route:
    the cost volume's VJP and the gather's carry a gradient to the
    frames."""
    rng = np.random.RandomState(4)
    im0 = torch.tensor(rng.rand(1, 64, 64, 3).astype(np.float32),
                       requires_grad=True)
    im1 = torch.tensor(rng.rand(1, 64, 64, 3).astype(np.float32))
    tp.pwc_forward(port_params, im0, im1).square().sum().backward()
    assert im0.grad is not None and torch.isfinite(im0.grad).all()
    assert im0.grad.abs().sum() > 0


# -- weights ---------------------------------------------------------------------------

def test_init_pwc_params_tree_matches_fldrx(fldrx_params, port_params):
    """init_pwc_params builds fldrx's tree and shapes, zero biases and the
    normal/sqrt(fan_in) spread; one seed gives the same weights twice."""
    got = init = tp.init_pwc_params(torch.Generator().manual_seed(0),
                                    device="cpu")
    again = tp.init_pwc_params(torch.Generator().manual_seed(0), device="cpu")
    ref = dict(named_leaves(port_params))
    got = dict(named_leaves(got))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == torch.float32
        if k.endswith("/b"):
            assert not got[k].any(), k
    for k, v in named_leaves(again):
        assert torch.equal(v, got[k]), k
    w = init["dec2"]["one"]["w"]
    assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1) < 0.02
    u = init["dec3"]["upfeat"]["w"]                # [in, out, 4, 4]
    assert abs(u.std().item() * np.sqrt(u.shape[0] * 16) - 1) < 0.05


def _synth_pwc_state_dict(rng):
    """A torch state dict shaped like the reference PWCNet
    (OpticalFlow/PWCNet.py:24-252), fan-in scaled."""
    sd = {}

    def add(name, shape, fan_in, co):
        sd[f"{name}.weight"] = torch.from_numpy(
            (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            (rng.randn(co) * 0.01).astype(np.float32))

    def conv(name, ci, co):
        add(name, (co, ci, 3, 3), ci * 9, co)

    def deconv(name, ci, co):
        add(name, (ci, co, 4, 4), ci * 16, co)

    cin = 3
    for nm, cout in zip(("One", "Two", "Thr", "Fou", "Fiv", "Six"),
                        (16, 32, 64, 96, 128, 196)):
        for i, ci in ((0, cin), (2, cout), (4, cout)):
            conv(f"moduleExtractor.module{nm}.{i}", ci, cout)
        cin = cout
    dec_in = {2: 117, 3: 149, 4: 181, 5: 213, 6: 81}
    for nm, level in (("Two", 2), ("Thr", 3), ("Fou", 4), ("Fiv", 5),
                      ("Six", 6)):
        cur = dec_in[level]
        if level < 6:
            deconv(f"module{nm}.moduleUpflow", 2, 2)
            deconv(f"module{nm}.moduleUpfeat", dec_in[level + 1] + 448, 2)
        for sub, (ci, co) in zip(
                ("One", "Two", "Thr", "Fou", "Fiv", "Six"),
                [(cur, 128), (cur + 128, 128), (cur + 256, 96),
                 (cur + 352, 64), (cur + 416, 32), (cur + 448, 2)]):
            conv(f"module{nm}.module{sub}.0", ci, co)
    for i, (ci, co) in zip((0, 2, 4, 6, 8, 10, 12),
                           [(565, 128), (128, 128), (128, 128), (128, 96),
                            (96, 64), (64, 32), (32, 2)]):
        conv(f"moduleRefiner.moduleMain.{i}", ci, co)
    return sd


def test_convert_pwc_state_dict_matches_fldrx(tmp_path):
    """convert_pwc_state_dict on a synthetic reference state dict equals
    fldrx's convert_pwc_checkpoint carried across by pwc_params_from_numpy,
    leaf for leaf; the npz of fldrx's converter loads to the same tree."""
    from fldrx.tools.convert_ckpt import convert_pwc

    sd = _synth_pwc_state_dict(np.random.RandomState(0))
    src = str(tmp_path / "pwc-synth.pt")
    torch.save(sd, src)
    got = dict(named_leaves(convert_pwc_state_dict(sd, device="cpu")))
    ref = dict(named_leaves(pwc_params_from_numpy(
        jp.convert_pwc_checkpoint(src), device="cpu")))
    assert sorted(got) == sorted(ref) and len(got) == 2 * (18 + 38 + 7)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(got["dec2/upflow/w"],
                       sd["moduleTwo.moduleUpflow.weight"])
    npz = dict(named_leaves(load_pwc_npz(convert_pwc(
        src, str(tmp_path / "pwc.npz")), device="cpu")))
    assert sorted(npz) == sorted(ref)
    for k in ref:
        assert torch.equal(npz[k], ref[k]), k


def test_pwc_loaders_default_to_the_card(tmp_path):
    """The teacher's loaders put the weights on cuda when no device is
    given: without a GPU they raise rather than fall back to the CPU, and
    with `device="cpu"` they load there."""
    rng = np.random.RandomState(2)
    path = str(tmp_path / "pwc.npz")
    np.savez(path, **{"dec2/upfeat/w": rng.randn(4, 4, 3, 5).astype(np.float32),
                      "dec2/upfeat/b": rng.randn(3).astype(np.float32)})
    sd = _synth_pwc_state_dict(rng)
    assert load_pwc_npz(path, device="cpu")["dec2"]["upfeat"]["w"].is_cpu
    assert convert_pwc_state_dict(sd, device="cpu")["refiner"][0]["w"].is_cpu
    if torch.cuda.is_available():
        assert load_pwc_npz(path)["dec2"]["upfeat"]["w"].is_cuda
        assert convert_pwc_state_dict(sd)["refiner"][0]["w"].is_cuda
        return
    for load in (lambda: load_pwc_npz(path),
                 lambda: convert_pwc_state_dict(sd),
                 lambda: pwc_params_from_numpy({"dec2": {}})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()
