"""The port's evaluation path held against fldrx on the CPU: host metrics,
PSNR/SSIM on the device, the golden clip, the test sets, the visualiser and
the evaluator.

References are fldrx with no FLDRX_* overrides (so its evaluator takes its
defaults: uint8 frames to the device, metrics on the device where they
apply). Frames and images are made from seeds with numpy.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fldrx import config as jcfg
from fldrx.api import prepare_model as j_prepare_model
from fldrx.data import datasets as jds
from fldrx.eval import evaluator as jev
from fldrx.eval import goldenclip as jgold
from fldrx.eval import visualize as jvis
from fldrx.ops import metrics as jm
from fldrx.ops import metrics_jax as jmj
from fldrx.ops.repack import planes_to_plain_np as j_planes_to_plain_np
from fldrx_torch import config as tcfg
from fldrx_torch.api import prepare_model
from fldrx_torch.data import datasets as tds
from fldrx_torch.eval import evaluator as tev
from fldrx_torch.eval import goldenclip as tgold
from fldrx_torch.eval import visualize as tvis
from fldrx_torch.ops import metrics as tm
from fldrx_torch.ops import metrics_torch as tmt
from fldrx_torch.ops.repack import planes_to_plain_np

torch.set_num_threads(1)


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


def _images(seed, T=3, H=64, W=96):
    """Predictions in [-1, 1] (float32, a little outside to exercise the
    clip) and uint8 targets near them."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, 256, (T, H, W, 3)).astype(np.uint8)
    pred = (tgt / 255.0 - 0.5) * 2 + rng.randn(T, H, W, 3) * 0.05
    return pred.astype(np.float32), tgt


# -- host metrics -------------------------------------------------------------

def test_host_metrics_match_fldrx_bitwise():
    pred, tgt = _images(0, T=1)
    a = jds.frames_to_tensor(tgt)[0]
    p = pred[0]
    np.testing.assert_array_equal(tm.denorm255(p), jm.denorm255(p))
    np.testing.assert_array_equal(tm.to_uint8(p, -1, 1),
                                  jm.to_uint8(p, -1, 1))
    out_img = np.around(tm.denorm255(p))
    tgt_img = tm.denorm255(a)
    assert tm.psnr(tgt_img, out_img) == jm.psnr(tgt_img, out_img)
    assert tm.psnr_xvfi(tgt_img, out_img) == jm.psnr_xvfi(tgt_img, out_img)
    assert tm.ssim_bgr(tgt_img, out_img) == jm.ssim_bgr(tgt_img, out_img)
    y1, y2 = tgt_img[..., 0].astype(np.float64), out_img[..., 1]
    assert tm.ssim_gray(y1, y2, 255.0) == jm.ssim_gray(y1, y2, 255.0)
    np.testing.assert_array_equal(tm.rgb2ycbcr(tgt_img),
                                  jm.rgb2ycbcr(tgt_img))
    np.testing.assert_array_equal(tm.rgb2ycbcr(tgt_img / 255, 1),
                                  jm.rgb2ycbcr(tgt_img / 255, 1))


# -- metrics on the device -------------------------------------------------------

@pytest.mark.parametrize("xvfi", [False, True])
@pytest.mark.parametrize("target_kind", ["uint8", "float"])
def test_metrics_torch_matches_fldrx_and_host(xvfi, target_kind):
    """metrics_torch against fldrx's metrics_jax and against the host chain
    (round(denorm255(pred)) against denorm255(target), ssim_bgr) at 64×96:
    ≤ 1e-5 dB and ≤ 1e-6 SSIM."""
    pred, tgt = _images(1)
    tgt_in = tgt if target_kind == "uint8" else jds.frames_to_tensor(tgt)
    ps, ss = tmt.make_chunk_metrics(xvfi)(torch.tensor(pred),
                                          torch.tensor(tgt_in))
    assert ps.shape == ss.shape == (3,)
    jp, js = jmj.make_chunk_metrics(xvfi)(jnp.asarray(pred),
                                          jnp.asarray(tgt_in))
    np.testing.assert_allclose(ps.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ss.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    f = jds.frames_to_tensor(tgt)
    for i in range(3):
        out_img = np.around(tm.denorm255(pred[i]))
        tgt_img = tm.denorm255(f[i])
        hp = (tm.psnr_xvfi if xvfi else tm.psnr)(tgt_img, out_img)
        assert abs(ps[i].item() - hp) <= 1e-5
        assert abs(ss[i].item() - tm.ssim_bgr(tgt_img, out_img)) <= 1e-6
        p1, s1 = tmt.psnr_ssim_frame(torch.tensor(pred[i]),
                                     torch.tensor(tgt_in[i]), xvfi)
        assert (p1.item(), s1.item()) == (ps[i].item(), ss[i].item())


# -- the golden clip ----------------------------------------------------------------

@pytest.mark.parametrize("family", ["pan", "affine", "thin", "flat"])
def test_render_golden_matches_fldrx(family):
    np.testing.assert_array_equal(tgold.render_golden(64, 96, 0.375, family),
                                  jgold.render_golden(64, 96, 0.375, family))
    a, b = tgold.golden_pair(32, 48, 4, family), \
        jgold.golden_pair(32, 48, 4, family)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# tests/test_goldenclip.py's pins (fldrx on the CPU, f32, fast path)
GOLDEN_PINS = {"pan": 44.828, "affine": 47.125, "thin": 36.169,
               "flat": 57.999}


@pytest.fixture(scope="module")
def golden_interp():
    cfg = tcfg.papermodel().replace(S_tst=3, fast_warp=True,
                                    compute_dtype="float32")
    return prepare_model(cfg=cfg, device="cpu")[0]


@pytest.mark.parametrize("family", sorted(GOLDEN_PINS))
def test_golden_clip_pinned(family, golden_interp):
    """The port's golden clip at 512×768, papermodel S_tst=3, f32, fast
    path: each family's mean within 0.05 dB of fldrx's pin; the edge t
    values of the pan are the easiest."""
    ps, mean = tgold.golden_psnrs(golden_interp, 512, 768, 8, family=family)
    assert abs(mean - GOLDEN_PINS[family]) < 0.05, (mean, ps)
    if family == "pan":
        assert ps[0] > ps[3] and ps[6] > ps[3]


# -- test sets, repack, visualiser ----------------------------------------------------

def _write_xtest_layout(root, H=96, W=128):
    """One 33-frame scene in the X-Test layout, rendered from the port's
    golden-clip scene model."""
    from PIL import Image
    d = os.path.join(root, "Type1", "TEST00")
    os.makedirs(d)
    for i in range(33):
        img = tgold.render_golden(H, W, i / 32.0)
        u8 = np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)
        Image.fromarray(u8).save(os.path.join(d, f"{i:04d}.png"))
    return root


@pytest.fixture(scope="module")
def xtest_dir(tmp_path_factory):
    return _write_xtest_layout(str(tmp_path_factory.mktemp("xtest")))


def test_test_items_match_fldrx(xtest_dir):
    """X-Test items, the loaded frames (float and raw), a centre crop and
    the half-resolution mode equal fldrx's."""
    for m in (2, 4, 8):
        a, b = tds.make_x_test_items(xtest_dir, m), \
            jds.make_x_test_items(xtest_dir, m)
        assert [(i.paths, i.t, i.scene) for i in a] == \
            [(i.paths, i.t, i.scene) for i in b]
    tc = tcfg.papermodel().replace(x_test_data_path=xtest_dir)
    jc = jcfg.papermodel().replace(x_test_data_path=xtest_dir)
    for kw in (dict(), dict(half_res=True)):
        t_ds = tds.get_test_dataset(tc, "X4K1000FPS", 8, **kw)
        j_ds = jds.get_test_dataset(jc, "X4K1000FPS", 8, **kw)
        assert len(t_ds) == len(j_ds) == 7
        for idx, patch, raw in ((0, -1, False), (3, 64, True), (6, 32, False)):
            x, y = t_ds.load(idx, patch, raw), j_ds.load(idx, patch, raw)
            assert x[1:] == y[1:] and x[0].dtype == y[0].dtype
            np.testing.assert_allclose(x[0], y[0], rtol=0, atol=1e-6)
    with pytest.raises(FileNotFoundError):
        tds.get_test_dataset(tc.replace(x_test_data_path=xtest_dir + "/none"),
                             "X4K1000FPS", 8)
    assert tds.TEST_MULTIPLES == jds.TEST_MULTIPLES


def test_planes_to_plain_matches_fldrx():
    a = np.random.RandomState(2).rand(2, 1, 4, 5, 7 * 3).astype(np.float32)
    np.testing.assert_array_equal(planes_to_plain_np(a),
                                  j_planes_to_plain_np(a))
    assert planes_to_plain_np(a).shape == (2, 1, 20, 7, 3)


def test_visualize_matches_fldrx(tmp_path):
    rng = np.random.RandomState(3)
    np.testing.assert_array_equal(tvis.make_color_wheel(),
                                  jvis.make_color_wheel())
    flow = (rng.randn(24, 32, 2) * 4).astype(np.float32)
    for mf in (None, 10.0):
        np.testing.assert_array_equal(tvis.flow_to_image(flow, mf),
                                      jvis.flow_to_image(flow, mf))
    preds = [rng.rand(2, 32 // s, 48 // s, 3).astype(np.float32) * 2 - 1
             for s in (1, 2, 4)]
    flows = [rng.randn(2, 32 // s, 48 // s, 4).astype(np.float32)
             for s in (1, 2, 4)]
    tgt = rng.rand(2, 32, 48, 3).astype(np.float32) * 2 - 1
    got = tvis.pyramid_grid(preds, flows, tgt, tgt * 0.5, n_rows=2)
    ref = jvis.pyramid_grid(preds, flows, tgt, tgt * 0.5, n_rows=2)
    assert got.shape == ref.shape == (64, 48 * 8, 3)
    # bicubic upscales in another float order: a value may truncate 1 apart
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    tvis.save_image(str(tmp_path / "g" / "grid.png"), got)
    from PIL import Image
    back = np.asarray(Image.open(tmp_path / "g" / "grid.png"))[..., ::-1]
    np.testing.assert_array_equal(back, got)


# -- the evaluator ------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_models(xtest_dir):
    tc = tcfg.papermodel().replace(phase="test", x_test_data_path=xtest_dir,
                                   x_val_data_path=xtest_dir)
    jc = jcfg.papermodel().replace(phase="test", x_test_data_path=xtest_dir,
                                   x_val_data_path=xtest_dir)
    return (prepare_model(cfg=tc, device="cpu")[0], tc,
            j_prepare_model(cfg=jc)[0], jc)


@pytest.mark.parametrize("mode", ["device_metrics", "host_metrics",
                                  "validation"])
def test_evaluate_matches_fldrx(mode, eval_models):
    """evaluate on a 33-frame X-Test directory at 96×128 (×8: 7 targets)
    against fldrx's evaluate on the same directory: mean PSNR within 0.01
    dB and SSIM within 1e-4, with the metrics on the device, on the host,
    and in validation (host metrics, rec_loss within 1e-4)."""
    interp, tc, jinterp, jc = eval_models
    kw = dict(validation=True) if mode == "validation" else {}
    got = tev.evaluate(interp, tc, "X4K1000FPS", verbose=False,
                       device_metrics=mode == "device_metrics", **kw)
    ref = jev.evaluate(jinterp, jc, "X4K1000FPS", verbose=False, **kw)
    assert got.n_samples == ref.n_samples == 7
    assert abs(got.psnr - ref.psnr) <= 0.01, (got.psnr, ref.psnr)
    assert abs(got.ssim - ref.ssim) <= 1e-4, (got.ssim, ref.ssim)
    assert 20 < got.psnr < 60 and got.frames_per_sec > 0
    if mode == "validation":
        assert got.rec_loss > 0
        assert abs(got.rec_loss - ref.rec_loss) <= 1e-4


def test_evaluate_options(eval_models, tmp_path):
    """stop_at, jump_to, the prediction and flow dumps, test_custom (no
    metrics), the per-t meters of a ×N set, and a multi-device bridge
    (parallel_eval) in place of the pair's synthesis."""
    interp, tc, _, _ = eval_models
    base = tev.evaluate(interp, tc, "X4K1000FPS", verbose=False)
    res = tev.evaluate(interp, tc, "X4K1000FPS", verbose=False, stop_at=2,
                       save_dir=str(tmp_path), save_flow=True)
    assert res.n_samples == 4 and len(res.per_t_psnr) == 7
    d = tmp_path / "X4K1000FPS"
    assert len(list(d.glob("Type1_TEST00*/*.png"))) == 4
    dumps = sorted(p.name for p in d.glob("Test_flow_preds/*/*.png"))
    assert len(dumps) == 8 and dumps[0].startswith("diff")
    assert dumps[-1].startswith("flow")
    jumped = tev.evaluate(interp, tc, "X4K1000FPS", verbose=False, jump_to=3)
    assert jumped.n_samples == 4
    custom = tev.evaluate(interp, tc, "X4K1000FPS", verbose=False,
                          compute_metrics=False, save_dir=str(tmp_path / "c"))
    assert custom.n_samples == 0
    assert len(list((tmp_path / "c").rglob("*.png"))) == 7
    assert base.n_samples == 7
    bridged = tev.evaluate(
        interp, tc, "X4K1000FPS", verbose=False,
        parallel_eval=lambda fr, ts: interp.interpolate_multi_np(fr, ts)[:, 0])
    assert bridged.n_samples == 7
    assert abs(bridged.psnr - base.psnr) <= 1e-4


@pytest.fixture(scope="module")
def golden_set_768():
    """The pan golden pair at 768×768 as an 8-bit test set: large enough
    for the packed synthesis (flow grid ≥ 96), so its blend into u-planes
    and into plain rows is on the path."""
    return tgold.GoldenTestSet(*tgold.golden_pair(768, 768, 8))


def test_golden_test_set(golden_set_768):
    ds = golden_set_768
    assert len(ds) == 7 and len({it.paths[:2] for it in ds.items}) == 1
    raw, t, scene = ds.load(3, raw=True)
    assert raw.dtype == np.uint8 and raw.shape == (3, 768, 768, 3)
    assert t == 0.5 and scene == "golden_pan"
    f, _, _ = ds.load(3, patch=64)
    np.testing.assert_array_equal(f, jds.frames_to_tensor(
        raw[:, 352:416, 352:416]))


def test_evaluate_golden_set_matches_fldrx(golden_set_768, monkeypatch):
    """evaluate(dataset=) on the 8-bit golden set, papermodel_test5 S_tst=1
    on the packed path: with the metrics on the device (plain rows written
    by the blend) and on the host (u-planes unpacked on the workers) the
    two agree to 1e-4 dB and 1e-5 SSIM, and fldrx's evaluate on the same
    items agrees to 0.01 dB and 1e-4 SSIM."""
    tc = tcfg.papermodel_test5().replace(S_tst=1)
    jc = jcfg.papermodel_test5().replace(S_tst=1)
    interp = prepare_model(cfg=tc, device="cpu")[0]
    on = tev.evaluate(interp, tc, "golden", multiple=8, verbose=False,
                      dataset=golden_set_768)
    off = tev.evaluate(interp, tc, "golden", multiple=8, verbose=False,
                       dataset=golden_set_768, device_metrics=False)
    assert on.n_samples == off.n_samples == 7
    assert abs(on.psnr - off.psnr) <= 1e-4 and abs(on.ssim - off.ssim) <= 1e-5
    monkeypatch.setattr(jev, "get_test_dataset",
                        lambda *a, **k: golden_set_768)
    ref = jev.evaluate(j_prepare_model(cfg=jc)[0], jc, "golden", multiple=8,
                       verbose=False)
    assert ref.n_samples == 7
    assert abs(on.psnr - ref.psnr) <= 0.01, (on.psnr, ref.psnr)
    assert abs(on.ssim - ref.ssim) <= 1e-4, (on.ssim, ref.ssim)
