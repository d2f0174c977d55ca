"""The port's multi-device evaluation held against fldrx's on the CPU:
the mesh and batch layout, the strict sharded forward, the width-sharded
fast path with its halo exchange and exact spill fallback, the t-parallel
path, evaluate(parallel_eval=) and `python -m fldrx_torch --mesh t`.

fldrx runs on its 8 virtual CPU devices (tests/conftest.py) with every
FLDRX_* variable cleared, so its fast warps are its exact fallback, not the
Pallas interpreter. The port's meshes repeat the CPU device; its kernels
take their plain versions there.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from fldrx import config as jcfg
from fldrx.model import fldrnet as jf
from fldrx.parallel import mesh as jmesh
from fldrx.parallel import spatial as jsp
from fldrx_torch import config as tcfg
from fldrx_torch.eval import evaluator as tev
from fldrx_torch.eval.goldenclip import GoldenTestSet, golden_pair
from fldrx_torch.eval.pipeline import Interpolator
from fldrx_torch.parallel import mesh as tmesh
from fldrx_torch.parallel import spatial as tsp
from fldrx_torch.weights import params_from_numpy

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _params(cfg_name: str, seed: int, **over):
    """fldrx's init_params(PRNGKey(seed)) and the same values in the port."""
    jc = getattr(jcfg, cfg_name)().replace(**over)
    tc = getattr(tcfg, cfg_name)().replace(**over)
    jp = jf.init_params(jax.random.PRNGKey(seed), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _texture_pair(H: int, W: int) -> np.ndarray:
    """fldrx's test_parallel texture pair, [1, 2, H, W, 3] float32."""
    yy, xx = np.mgrid[0:H, 0:W] / 32.0
    f0 = np.stack([np.sin(xx), np.cos(yy), np.sin(xx + yy)], -1)
    f1 = np.stack([np.sin(xx + 0.2), np.cos(yy + 0.1),
                   np.sin(xx + yy + 0.15)], -1)
    return np.stack([f0, f1], 0)[None].astype(np.float32) * 0.7


def _cpus(n: int):
    return ["cpu"] * n


# -- mesh -------------------------------------------------------------------

@pytest.mark.parametrize("n, dp, shape", [
    (8, None, {"dp": 4, "sp": 2}), (4, 2, {"dp": 2, "sp": 2}),
    (2, None, {"dp": 2, "sp": 1}), (6, None, {"dp": 3, "sp": 2}),
    (3, None, {"dp": 3, "sp": 1})])
def test_make_mesh_shapes(n, dp, shape):
    """The default dp/sp split and the explicit one, as fldrx makes them."""
    j = jmesh.make_mesh(jax.devices()[:n], dp=dp)
    t = tmesh.make_mesh(_cpus(n), dp=dp)
    assert dict(j.shape) == t.shape == shape
    assert t.devices.shape == (shape["dp"], shape["sp"])
    with pytest.raises(ValueError):
        tmesh.make_mesh(_cpus(n), dp=n + 1, sp=1)


def test_batch_specs_and_shard_batch():
    """The specs name fldrx's axes; each mesh place holds the block of the
    batch that fldrx's shard_batch places on the same device."""
    for k, spec in jmesh.batch_specs().items():
        assert tmesh.batch_specs()[k] == tuple(spec)
    assert tmesh.frames_spec() == tuple(jmesh.frames_spec())
    rng = np.random.RandomState(0)
    batch = {"frames": rng.rand(4, 2, 8, 16, 3).astype(np.float32),
             "target": rng.rand(4, 8, 16, 3).astype(np.float32),
             "t": rng.rand(4, 1).astype(np.float32),
             "epoch": np.float32(3)}
    jm = jmesh.make_mesh(jax.devices()[:8], dp=4, sp=2)
    tm = tmesh.make_mesh(_cpus(8), dp=4, sp=2)
    jsh = jmesh.shard_batch(jm, {k: v for k, v in batch.items()
                                 if k != "epoch"})
    tsh = tmesh.shard_batch(tm, batch)
    pos = {d.id: (i, j) for (i, j), d in np.ndenumerate(jm.devices)}
    for k, arr in jsh.items():
        for shard in arr.addressable_shards:
            np.testing.assert_array_equal(
                tsh[pos[shard.device.id]][k].numpy(), np.asarray(shard.data))
    assert all(float(p["epoch"]) == 3.0 for p in tsh.values())
    rep = tmesh.replicate(tm, {"a": [torch.ones(2)]})
    assert list(rep) == ["cpu"]


# -- strict sharded forward ---------------------------------------------------

def test_sharded_eval_matches_fldrx():
    """make_sharded_eval at dp 2, sp 2 against fldrx's, papermodel S_tst=1
    on 2×64×128 noise (test_parallel.py's case): within 2e-5. Each dp row
    holds one item, so rows that took their own PCA min/max would differ."""
    jc, jp, tc, tp = _params("papermodel", 0, S_tst=1, fast_warp=False)
    rng = np.random.RandomState(0)
    frames = (rng.rand(2, 2, 64, 128, 3) * 2 - 1).astype(np.float32)
    t = np.full((2, 1), 0.5, np.float32)
    jm = jmesh.make_mesh(jax.devices()[:4], dp=2, sp=2)
    with jm:
        ref = np.asarray(jsp.make_sharded_eval(jp, jc, jm)(frames, t))
    got = tsp.make_sharded_eval(tp, tc, tmesh.make_mesh(
        _cpus(4), dp=2, sp=2))(frames, t).numpy()
    assert got.shape == ref.shape == (2, 64, 128, 3)
    assert np.abs(got - ref).max() <= 2e-5
    per_row = tsp.make_sharded_eval(
        tp, tc.replace(per_item_minmax=True),
        tmesh.make_mesh(_cpus(4), dp=2, sp=2))(frames, t).numpy()
    assert np.abs(per_row - ref).max() > 1e-3


# -- width-sharded fast path --------------------------------------------------

@pytest.fixture(scope="module")
def fast_models():
    return _params("papermodel", 0, S_tst=1, S_trn=1, fast_warp=True)


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_fast_eval_matches_fldrx(fast_models, sp):
    """make_sharded_fast_eval at dp 1, halo 64, f32 UNet, on fldrx's 64×256
    texture pair: within 1e-4 of fldrx's unsharded fast path; against
    fldrx's sharded path within 1e-4 at least `halo` columns from the
    frame's edges and by fldrx's bulk criteria (test_parallel.py:92-101)
    over the frame, since fldrx's zero columns beyond the frame change its
    UNet there (exchange_halo_w); call.multi equals the single-t calls to
    1e-6 with one flow run, and no t spills."""
    from fldrx.eval.pipeline import Interpolator as JInterpolator

    jc, jp, tc, tp = fast_models
    frames = _texture_pair(64, 256)
    t = np.full((1, 1), 0.5, np.float32)
    whole = np.asarray(JInterpolator(jp, jc)(frames, t))
    jm = jmesh.make_mesh(jax.devices()[:sp], dp=1, sp=sp)
    with jm:
        ref = np.asarray(jsp.make_sharded_fast_eval(jp, jc, jm, halo=64)(
            frames, t))
    call = tsp.make_sharded_fast_eval(
        tp, tc, tmesh.make_mesh(_cpus(sp), dp=1, sp=sp), halo=64)
    got = call(frames, t).numpy()
    assert got.shape == ref.shape == whole.shape == (1, 64, 256, 3)
    assert np.abs(got - whole).max() <= 1e-4
    assert np.abs(got - ref)[:, :, 64:-64].max() <= 1e-4
    d = np.abs(got - ref)
    assert d.mean() < 2e-3 and np.mean(d > 5e-2) < 5e-4 and d.max() < 0.3
    ts = [0.25, 0.5, 0.75]
    multi = call.multi(frames, ts).numpy()
    assert call.counters["n_flow_runs"] == 2
    singles = np.concatenate([call(frames, [[tv]]).numpy() for tv in ts], 0)
    np.testing.assert_allclose(multi, singles, atol=1e-6)
    assert call.counters["n_spill_fallbacks"] == 0


def test_sharded_fast_eval_spill_fallback(fast_models):
    """Halo 32 leaves no motion budget: the t spills, reruns on the exact
    path, and equals fldrx's (its exact path too) within 2e-5 on uniform
    noise (test_parallel.py's case); on_spill='warn' keeps the sharded
    result."""
    jc, jp, tc, tp = fast_models
    rng = np.random.RandomState(4)
    frames = (rng.rand(1, 2, 64, 256, 3) * 2 - 1).astype(np.float32)
    t = np.full((1, 1), 0.5, np.float32)
    jm = jmesh.make_mesh(jax.devices()[:4], dp=1, sp=4)
    with jm:
        ref = np.asarray(jsp.make_sharded_fast_eval(
            jp, jc, jm, halo=32, verbose=False)(frames, t))
    mesh = tmesh.make_mesh(_cpus(4), dp=1, sp=4)
    call = tsp.make_sharded_fast_eval(tp, tc, mesh, halo=32, verbose=False)
    got = call(frames, t).numpy()
    assert call.counters == {"n_flow_runs": 1, "n_spill_fallbacks": 1}
    assert np.abs(got - ref).max() <= 2e-5
    warn = tsp.make_sharded_fast_eval(tp, tc, mesh, halo=32,
                                      on_spill="warn")
    kept = warn(frames, t).numpy()
    assert warn.counters["n_spill_fallbacks"] == 1
    assert not np.array_equal(kept, got) and np.abs(kept - got).max() < 0.3


def test_sharded_fast_eval_refuses_bad_geometry(fast_models):
    _, _, tc, tp = fast_models
    mesh = tmesh.make_mesh(_cpus(2), dp=1, sp=2)
    with pytest.raises(ValueError, match="multiple of 32"):
        tsp.make_sharded_fast_eval(tp, tc, mesh, halo=48)
    call = tsp.make_sharded_fast_eval(tp, tc, tmesh.make_mesh(
        _cpus(3), dp=1, sp=3), halo=32)
    with pytest.raises(ValueError, match="does not split"):
        call(_texture_pair(64, 256), [[0.5]])
    with pytest.raises(ValueError, match="wider than a slab"):
        tsp.exchange_halo_w([torch.zeros(1, 4, 32, 2)] * 2, 64)


def test_exchange_halo_w_extends_inside_the_frame_only():
    x = torch.arange(2 * 96, dtype=torch.float32).reshape(1, 1, 96, 2)
    ext = tsp.exchange_halo_w(list(x.split(32, dim=2)), 16)
    spans = [(0, 48), (16, 80), (48, 96)]
    for e, (a, b) in zip(ext, spans):
        torch.testing.assert_close(e, x[:, :, a:b], rtol=0, atol=0)


# -- t-parallel path ----------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
def test_t_parallel_eval_matches_fldrx(fast):
    """make_t_parallel_eval with 3 t values on 2 shards (the last t
    repeated once) against fldrx's, papermodel S_tst=1 on 64×96 noise:
    within 1e-5."""
    jc, jp, tc, tp = _params("papermodel", 3, S_tst=1, S_trn=1,
                             fast_warp=fast)
    rng = np.random.RandomState(0)
    frames = (rng.rand(1, 2, 64, 96, 3) * 2 - 1).astype(np.float32)
    ts = [0.2, 0.5, 0.9]
    jm = jmesh.make_mesh(jax.devices()[:2], dp=2, sp=1)
    with jm:
        ref = np.asarray(jsp.make_t_parallel_eval(jp, jc, jm)(frames, ts))
    got = tsp.make_t_parallel_eval(tp, tc, tmesh.make_mesh(
        _cpus(2), dp=2, sp=1))(frames, ts).numpy()
    assert got.shape == ref.shape == (3, 64, 96, 3)
    assert np.abs(got - ref).max() <= 1e-5


def test_build_parallel_eval_modes(fast_models):
    _, _, tc, tp = fast_models
    with pytest.raises(ValueError, match="mode"):
        tsp.build_parallel_eval(tp, tc, mode="dp", devices=_cpus(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsp.build_parallel_eval(tp, tc, mode="t")


# -- evaluate and the CLI -----------------------------------------------------

@pytest.fixture(scope="module")
def golden_small():
    """The pan golden pair at 128×256 as an 8-bit test set."""
    return GoldenTestSet(*golden_pair(128, 256, 8))


@pytest.mark.parametrize("mode", ["t", "sp"])
def test_evaluate_parallel_matches_single_device(golden_small, mode):
    """build_parallel_eval on two CPU shards against the single-device ×8
    path on the same golden pair, and evaluate(parallel_eval=) against the
    single-device evaluate(), metrics on the device and on the host. t mode
    runs the same synthesis: outputs within 1e-5, 1e-4 dB. sp mode's z maps
    and masks are the strict ones, whose 0.999 thresholds fall otherwise at
    a few pixels: fldrx's bulk criteria (test_parallel.py:92-101) and the
    card's 0.05 dB (chip_smoke.py phase 8c)."""
    tc = tcfg.papermodel_test5().replace(S_tst=1)
    tp = params_from_numpy(jax.tree.map(np.asarray, jf.init_params(
        jax.random.PRNGKey(0), jcfg.papermodel_test5().replace(S_tst=1))),
        "cpu")
    interp = Interpolator(tp, tc, "cpu")
    frames, ts, _ = golden_pair(128, 256, 8)
    pe = tsp.build_parallel_eval(tp, tc, mode=mode, devices=_cpus(2),
                                 halo=64)
    d = np.abs(pe(frames, list(ts)).numpy()
               - interp.interpolate_multi_np(frames, list(ts))[:, 0])
    if mode == "t":
        assert d.max() <= 1e-5
    else:
        assert d.mean() < 2e-3 and np.mean(d > 5e-2) < 5e-4
        assert d.max() < 0.3
    base = tev.evaluate(interp, tc, "golden", multiple=8,
                        dataset=golden_small, verbose=False)
    tol_db = 1e-4 if mode == "t" else 0.05
    for devmet in (True, False):
        res = tev.evaluate(interp, tc, "golden", multiple=8,
                           dataset=golden_small, verbose=False,
                           parallel_eval=pe, device_metrics=devmet)
        assert res.n_samples == base.n_samples == 7
        assert abs(res.psnr - base.psnr) <= tol_db, (res.psnr, base.psnr)
        assert abs(res.ssim - base.ssim) <= 1e-3


def test_cli_mesh_t(tmp_path):
    """python -m fldrx_torch --device cpu --mesh t --mesh_devices 2 on a
    generated X-Test scene: the sweep runs over two CPU shards and scores
    the seven targets of one pair."""
    from test_torch_cli import _write_xtest_layout

    (tmp_path / "xtest").mkdir()
    _write_xtest_layout(str(tmp_path / "xtest"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "fldrx_torch", "--device", "cpu",
           "--papermodel", "--test3scales", "--testsets", "X4K1000FPS",
           "--x_test_data_path", str(tmp_path / "xtest"),
           "--log_dir", str(tmp_path / "logs"),
           "--text_dir", str(tmp_path / "txt"),
           "--checkpoint_dir", str(tmp_path / "ck"), "--exp_num", "9",
           "--stoptestat", "5", "--mesh", "t", "--mesh_devices", "2"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "# multi-device eval: mode=t over ['cpu', 'cpu']" in out.stdout
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("Final 4k frames PSNR X4K1000FPS")]
    assert lines and 15.0 < float(lines[0].split(":")[1].split()[0]) < 100
