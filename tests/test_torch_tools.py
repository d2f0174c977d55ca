"""The port's tools held against fldrx's on the CPU: pca_inverse, the
fLDRnet and PWC-Net checkpoint converters, the PCA diagnostics, the
profiling helpers, the demo, and the golden-clip and parity reports.

fldrx runs with no FLDRX_* overrides, so its fast warps are its exact
fallback. Inputs are made from seeds with numpy.
"""

import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fldrx.eval import demo as jdemo
from fldrx.eval import profiling as jprof
from fldrx.ops import block_pca as jbp
from fldrx.tools import convert_ckpt as jconv
from fldrx.tools import parity_report as jparity
from fldrx.tools import pca_diagnostics as jdiag
from fldrx_torch.api import DEFAULT_NPZ, prepare_model
from fldrx_torch.eval import demo as tdemo
from fldrx_torch.eval import profiling as tprof
from fldrx_torch.ops import block_pca as tbp
from fldrx_torch.tools import convert_ckpt as tconv
from fldrx_torch.tools import goldenclip_report as tgr
from fldrx_torch.tools import parity_report as tparity
from fldrx_torch.tools import pca_diagnostics as tdiag
from fldrx_torch.weights import load_npz

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


# ---------------------------------------------------------------------------
# pca_inverse
# ---------------------------------------------------------------------------

def _pca_case(name):
    """(feats, mean, ev, mean_vec, minmax, wiS): tests/test_extras.py's two
    inputs, and one that undoes the normalisation and the min-max."""
    if name in ("roundtrip", "lossy"):
        seed, hw, nc, scale = ((0, (64, 96), 64, 1.0) if name == "roundtrip"
                               else (1, (32, 48), 16, 0.2))
        img = np.random.RandomState(seed).randn(*hw) * scale
        st = jbp.fit_block_pca(img[None], nc)
        blocks = np.asarray(jbp.blocks_from_images(jnp.asarray(img), 8))
        t = (blocks.reshape(-1, 64) - st.mean) @ st.eigenvectors.T
        feats = t.reshape(hw[0] // 8, hw[1] // 8, nc)
        return feats, st.mean, st.eigenvectors, None, None, 8
    rng = np.random.RandomState(2)
    feats = rng.uniform(-1, 1, (2, 3, 5, 7, 12))
    ev = rng.randn(12, 16)
    return (feats, rng.randn(16), ev, rng.uniform(0.5, 2.0, 12),
            (-3.25, 4.5), 4)


@pytest.mark.parametrize("case", ["roundtrip", "lossy", "normalised"])
def test_pca_inverse_matches_fldrx(case):
    feats, mean, ev, mean_vec, minmax, wiS = _pca_case(case)
    f32 = [None if a is None else np.asarray(a, np.float32)
           for a in (feats, mean, ev, mean_vec)]
    ref = np.asarray(jbp.pca_inverse(
        jnp.asarray(f32[0]), jnp.asarray(f32[1]), jnp.asarray(f32[2]),
        None if f32[3] is None else jnp.asarray(f32[3]), wiS=wiS,
        minmax=minmax))
    got = tbp.pca_inverse(*(None if a is None else torch.from_numpy(a)
                            for a in f32), wiS=wiS, minmax=minmax)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoint converters
# ---------------------------------------------------------------------------

def _reference_state_dict(rng):
    """A save_manager-format state dict of random values in the reference's
    names and shapes (conv weights OIHW, PCA tensors float64), built from
    the checkpoint's tree."""
    tree, extras, _ = load_npz(DEFAULT_NPZ)

    def conv(name, p):
        w = np.transpose(p["w"], (3, 2, 0, 1))
        return {f"{name}.weight": rng.randn(*w.shape).astype(np.float32),
                f"{name}.bias": rng.randn(*p["b"].shape).astype(np.float32)}

    sd = {}
    for s in (8, 16, 32, 64):
        ev = tree["pca"]["ev"] if s == 8 else extras[f"EV{s}"]
        sd[f"EV{s}"] = rng.randn(*ev.shape)
        sd[f"Mean{s}"] = rng.randn(ev.shape[1])
        sd[f"meanVec{s}"] = rng.uniform(0.5, 2, ev.shape[0])
    sd.update(conv("rec_ctx_ds.0", tree["rec_ctx"]["conv0"]))
    sd.update(conv("rec_ctx_ds.2", tree["rec_ctx"]["conv1"]))
    v = tree["vfinet"]
    sd["vfinet.T_param"] = rng.uniform(0.5, 2, np.shape(v["T_param"]))
    sd["vfinet.z_alpha"] = rng.randn(*np.shape(v["z_alpha"]))
    for key, idx in (("flow_bottom", (0, 2, 4, 6, 8)),
                     ("conv_flow2", (0, 2, 4, 6, 8))):
        name = "conv_flow_bottom" if key == "flow_bottom" else key
        for i, p in zip(idx, v[key]):
            sd.update(conv(f"vfinet.{name}.{i}", p))
    sd.update(conv("vfinet.conv_flow1", v["conv_flow1"]))
    for k, p in v["refine"].items():
        sd.update(conv(f"vfinet.refine_unet.{k}", p))
    # the base_modules.1.* aliases the checkpoint also holds
    sd.update({f"base_modules.1.{k[len('vfinet.'):]}": x
               for k, x in list(sd.items()) if k.startswith("vfinet.")})
    return {k: torch.from_numpy(np.asarray(x)) for k, x in sd.items()}


def test_fldrnet_converter_matches_fldrx(tmp_path, monkeypatch):
    """A save_manager .pt whose pickle names the reference's pca_comp and
    useful classes goes through both converters to identical npz files;
    the port loads its own."""
    for mod, cls in (("pca_comp", "DCTParams"), ("useful", "MYPCA")):
        m = types.ModuleType(mod)
        setattr(m, cls, type(cls, (), {"__module__": mod}))
        monkeypatch.setitem(sys.modules, mod, m)
    ckpt = {"state_dict_Model": _reference_state_dict(
        np.random.RandomState(3)),
        "dct": sys.modules["pca_comp"].DCTParams(),
        "pca": sys.modules["useful"].MYPCA(),
        "last_epoch": 199, "best_PSNR": 38.25, "trainLoss": 0.0125,
        "testLoss": 0.03, "testPSNR": 37.5}
    src = str(tmp_path / "ref.pt")
    torch.save(ckpt, src)
    # the converters must load it without the classes around
    monkeypatch.delitem(sys.modules, "pca_comp")
    monkeypatch.delitem(sys.modules, "useful")
    got = tconv.convert(src, str(tmp_path / "port" / "w.npz"))
    ref = jconv.convert(src, str(tmp_path / "fldrx.npz"))
    with np.load(got) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tree, extras, meta = load_npz(got)
    assert set(extras) == {f"{k}{s}" for k in ("EV", "Mean", "meanVec")
                           for s in (16, 32, 64)}
    assert float(meta["best_PSNR"]) == 38.25
    ck = load_npz(DEFAULT_NPZ)[0]
    assert tree["vfinet"]["refine"]["enc1"]["w"].shape == \
        ck["vfinet"]["refine"]["enc1"]["w"].shape


def test_pwc_converter_matches_fldrx(tmp_path):
    """The --pwc branch writes what fldrx's convert_pwc writes."""
    from test_torch_pwcnet import _synth_pwc_state_dict

    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          _synth_pwc_state_dict(np.random.RandomState(4)).items()}
    src = str(tmp_path / "pwc.pt")
    torch.save(sd, src)
    got = tconv.main(["--pwc", src, str(tmp_path / "port.npz")])
    assert got == 0
    ref = jconv.convert_pwc(src, str(tmp_path / "fldrx.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# PCA diagnostics
# ---------------------------------------------------------------------------

def _grey_images():
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:64, 0:96]
    return [np.sin(xx / 7.0 + k) * np.cos(yy / 11.0) * 100 + 128
            + rng.randn(64, 96) * 5 for k in range(2)]


def test_pca_diagnostics_match_fldrx():
    """reconstruction_psnr and sweep within 1e-6 dB of fldrx's."""
    ims = _grey_images()
    for wiS, nc in ((8, 16), (4, 8)):
        got, st = tdiag.reconstruction_psnr(ims[0], wiS, nc, device="cpu")
        ref, _ = jdiag.reconstruction_psnr(ims[0], wiS, nc)
        assert abs(got - ref) <= 1e-6, (wiS, got, ref)
        # a fit carried to another image
        got2, _ = tdiag.reconstruction_psnr(ims[1], wiS, nc, pca=st,
                                            device="cpu")
        ref2, _ = jdiag.reconstruction_psnr(ims[1], wiS, nc, pca=st)
        assert abs(got2 - ref2) <= 1e-6
    rows = tdiag.sweep(ims, block_sizes=(4, 8), device="cpu")
    ref_rows = jdiag.sweep(ims, block_sizes=(4, 8))
    assert [r[:3] for r in rows] == [r[:3] for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        assert abs(r[3] - q[3]) <= 1e-6, (r, q)
    assert tdiag.checkpoint_ev_reconstruction(ims[:1]) == pytest.approx(
        jdiag.checkpoint_ev_reconstruction(ims[:1]), abs=1e-9)


def test_tools_default_to_the_card():
    """Without a device argument the tools run on cuda, and without a GPU
    they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    for call in (lambda: tdiag.reconstruction_psnr(_grey_images()[0], 8, 16),
                 lambda: tdemo.run_synthetic(out_dir=None),
                 lambda: tgr.main(hw=(64, 64)),
                 lambda: tparity.measure(hw=(64, 64))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_time_levels_keys_match_fldrx():
    """At S_tst=2 on 128×128 the port's per-level times carry fldrx's keys,
    each a positive number of seconds."""
    from fldrx.api import prepare_model as j_prepare_model
    from fldrx.config import papermodel_test5 as j_test5
    from fldrx_torch.config import papermodel_test5

    frames = np.random.RandomState(6).uniform(
        -1, 1, (1, 2, 128, 128, 3)).astype(np.float32)
    t = np.full((1, 1), 0.5, np.float32)
    interp, _, _ = prepare_model(cfg=papermodel_test5().replace(S_tst=2),
                                 device="cpu")
    got = tprof.time_levels(interp, frames, t)
    jinterp, _, _ = j_prepare_model(cfg=j_test5().replace(S_tst=2))
    ref = jprof.time_levels(jinterp, frames, t)
    assert list(got) == list(ref) == ["S_tst=1 total_s", "S_tst=2 total_s",
                                      "level_2_delta_s"]
    assert all(got[k] > 0 for k in got if k.endswith("total_s"))


def test_trace_and_fps_meter(tmp_path):
    """trace writes a Chrome trace naming the ops it saw; fps_meter counts
    calls per second."""
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "tr")) as path:
        torch.mm(x, x)
    assert path == str(tmp_path / "tr" / tprof.TRACE_FILE)
    with open(path) as f:
        assert "aten::mm" in f.read()
    calls = []
    fps = tprof.fps_meter(lambda: calls.append(1) or x, iters=4, warmup=2)
    assert len(calls) == 6 and fps > 0


# ---------------------------------------------------------------------------
# the demo
# ---------------------------------------------------------------------------

def test_run_synthetic_matches_fldrx(tmp_path, monkeypatch):
    """Each t's PSNR of the synthetic demo within 0.01 dB of fldrx's; no
    file written with out_dir=None."""
    seen = []

    def record(*a, **k):
        p = real(*a, **k)
        seen.append(float(p))
        return p

    real = jdemo.run_on_images
    monkeypatch.setattr(jdemo, "run_on_images", record)
    jmean = jdemo.run_synthetic(str(tmp_path / "jout"))
    monkeypatch.chdir(tmp_path)
    got = tdemo.run_synthetic(out_dir=None, device="cpu")
    assert len(got) == len(seen) == len(tdemo.SYNTHETIC_T)
    for a, b in zip(got, seen):
        assert abs(a - b) <= 0.01, (got, seen)
    assert abs(float(np.mean(got)) - jmean) <= 0.01
    assert os.listdir(tmp_path) == ["jout"]


# ---------------------------------------------------------------------------
# golden-clip and parity reports
# ---------------------------------------------------------------------------

def test_parity_helpers_match_fldrx():
    a = tparity.natural_frames(40, 56, shift=10)
    np.testing.assert_array_equal(a, jparity.natural_frames(40, 56, shift=10))
    b = a + np.random.RandomState(7).randn(*a.shape).astype(np.float32) * 0.01
    assert tparity.psnr_between(a, b) == jparity.psnr_between(a, b)


def test_parity_fast_path_departure_matches_fldrx():
    """At 768×768 (the smallest frame where the fast path composes the
    flowbacks at the flow grid and takes z at half resolution) the port's
    strict and fast float32 outputs equal fldrx's (≥ 100 dB), so the fast
    path's departure from the strict one is fldrx's within 1e-3 dB."""
    from fldrx.api import prepare_model as j_prepare_model
    from fldrx.config import papermodel_test5 as j_test5
    from fldrx.eval.pipeline import Interpolator as JInterpolator

    H = W = 768
    got = tparity.fast_path_outputs((H, W), device="cpu")
    frames = jnp.asarray(jparity.natural_frames(H, W))
    params = j_prepare_model()[0].params
    ref = {}
    for name, fast in (("strict", False), ("fast_f32", True)):
        it = JInterpolator(params, j_test5().replace(
            compute_dtype="float32", fast_warp=fast))
        flow, padded, extras = it.precompute_flow(frames)
        ref[name] = np.asarray(it.synthesize_at(flow, padded, [[0.375]],
                                                (H, W), extras))
        assert tparity.psnr_between(got[name], ref[name]) >= 100, name
    dep = tparity.psnr_between(got["fast_f32"], got["strict"])
    assert abs(dep - jparity.psnr_between(ref["fast_f32"], ref["strict"])) \
        <= 1e-3
    assert dep < 60          # the departure is the algebra's, not noise


def test_parity_oracle_needs_the_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="needs the reference "
                                                "checkpoint"):
        tparity.main(["--oracle", str(tmp_path / "absent.pt")])


def test_goldenclip_report_small():
    """All four configurations at 256×256: the baseline is fldrx's frame
    average and each configuration beats it."""
    from fldrx.eval.goldenclip import golden_pair as j_golden_pair
    from fldrx.ops import metrics as jm

    res = tgr.main(hw=(256, 256), device="cpu")
    frames, _, gts = j_golden_pair(256, 256, 8)
    avg = 0.5 * (frames[0, 0] + frames[0, 1])
    base = np.mean([jm.psnr(jm.denorm255(g), jm.denorm255(avg))
                    for g in gts])
    assert res.pop("naive frame-average baseline") == pytest.approx(base,
                                                                    abs=1e-9)
    assert list(res) == [n for n, _ in tgr.CONFIGS]
    assert all(v > base + 1.0 for v in res.values()), (res, base)
