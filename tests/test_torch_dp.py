"""The port's sharded train step on gloo processes on the CPU, held
against fldrx's make_train_step(cfg, mesh) at the same (dp, sp) on its
virtual CPU devices — dp 2 (two processes), and width-sharded at dp 1 ×
sp 2 (two) and dp 2 × sp 2 (four) — and against the port's single-process
step on the global batch; train(mesh=) at dp 2 and at dp 1 × sp 2 against
train() in one process.

Each rank runs a function of tests/torch_dp_child.py, which imports no
JAX, in a fresh process (parallel.distributed.spawn).

papermodel, S_trn=2, a global batch of 4 at 64×64 (dp) or 64×256 (sp:
the top 64 rows of `bench_inputs.train_batch` at 256, seed 0, so that a
slab of 128 columns and the refine UNet's 32-column halo leave 96 columns
out), the real checkpoint. fldrx's fast warps are its
exact fallback (FLDRX_* cleared). On fresh init_params(PRNGKey(0)) weights
the port's single-process loss already sits 9e-4 relative from fldrx's on
this batch (the level-0 synthesis's thresholds, ROADMAP.md queue 3); on
the checkpoint the two agree to 1e-7.
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
from fldrx.parallel import mesh as jmesh
from fldrx.tools.convert_ckpt import flatten_params as jflatten
from fldrx.tools.convert_ckpt import load_params_npz
from fldrx.train import trainer as jtrainer
from fldrx_torch import config as tcfg
from fldrx_torch.bench_inputs import train_batch
from fldrx_torch.model import fldrnet as tf
from fldrx_torch.parallel.distributed import spawn
from fldrx_torch.parallel.mesh import make_mesh
from fldrx_torch.train import loop as tloop
from fldrx_torch.train.trainer import TrainState, make_train_step
from fldrx_torch.weights import (flatten_params, named_leaves,
                                 params_from_numpy, params_to_numpy)

import torch_dp_child

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


def _batches():
    """The plain batch, and one whose samples 2 and 3 (rank 1's shard) are
    a still 32-pixel ±1 checkerboard: its flat 8×8 blocks at every level
    give the PCA extremes of every level, there alone."""
    plain = train_batch(64, np.array([[0.3], [0.7], [0.4], [0.6]]), seed=0)
    yy, xx = np.mgrid[0:64, 0:64]
    board = np.where((xx // 32 + yy // 32) % 2 == 1, 1.0, -1.0)[..., None]
    edged = {k: v.copy() for k, v in plain.items()}
    edged["frames"][2:] = board
    edged["target"][2:] = board
    return {"plain": plain, "edged": edged}


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.papermodel().replace(S_trn=2, phase="train", batch_size=4,
                                   patch_size=64)
    tc = tcfg.papermodel().replace(S_trn=2, phase="train", batch_size=4,
                                   patch_size=64)
    tree = load_params_npz(japi.DEFAULT_NPZ)[0]
    jm = jmesh.make_mesh(jax.devices()[:2], dp=2, sp=1)
    # one optimiser object for every case: the step is compiled once
    tx = jtrainer.TrainState.create(jax.tree.map(jnp.asarray, tree), jc).tx
    return jc, tc, tree, tx, jtrainer.make_train_step(jc, jm)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


@pytest.mark.parametrize("case", ["plain", "edged"])
def test_dp_step_matches_fldrx_and_one_process(setup, case):
    """Loss and metrics within 1e-5 relative of fldrx's dp-2 step and
    every updated parameter within 1e-4 relative L2; the averaged
    gradients within 1e-4 relative L2 of the port's single-process step on
    the global batch; both ranks hold the same parameters. In the edged
    batch the PCA min and max of every level lie on rank 1 alone, and
    shards that took their own extremes would give another loss."""
    jc, tc, tree, tx, jstep = setup
    batch = _batches()[case]
    jparams = jax.tree.map(jnp.asarray, tree)
    state, jmet = jstep(jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams), tx=tx), batch)
    ref = jflatten(jax.tree.map(np.asarray, state.params))

    (m0, g0, p0, _), (m1, _, p1, _) = spawn(torch_dp_child.dp_step, 2, tc,
                                            tree, batch, timeout=600)
    for k in jmet:
        assert abs(m0[k] - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
        assert m1[k] == m0[k], k
    assert set(p0) == set(ref)
    for k in ref:
        assert _rel(p0[k], ref[k]) <= 1e-4, k
        np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)

    params = params_from_numpy(tree, "cpu")
    one = make_train_step(tc)(TrainState.create(params, tc), batch)
    grads = {n: p.grad.numpy() for n, p in named_leaves(params)
             if p.grad is not None}
    assert set(grads) == set(g0)
    for k in grads:
        assert _rel(g0[k], grads[k]) <= 1e-4, k
    assert abs(float(one["loss"]) - m0["loss"]) <= 1e-5 * abs(m0["loss"])

    if case == "edged":
        _extremes_on_the_second_shard(tc, tree, batch, float(jmet["loss"]))


def _extremes_on_the_second_shard(tc, tree, batch, loss):
    """Every level's PCA min and max lie in samples 2-3 alone, and shards
    that took their own extremes would give another loss."""
    from fldrx_torch.eval.pipeline import build_pyramid
    tp = params_from_numpy(tree, "cpu")
    fr = torch.as_tensor(batch["frames"])
    whole, halves = (tf.pca_extrema(tp, tc, build_pyramid(
        f, tc, tc.S_trn + 1), tc.S_trn + 1)
        for f in (fr, fr[:2]))
    for (lo, hi), (lo0, hi0) in zip(whole, halves):
        assert lo < lo0 and hi > hi0
    per_shard = np.mean([float(tloop_loss(tc, tp, {
        k: v[s] for k, v in batch.items()})) for s in (slice(0, 2),
                                                       slice(2, 4))])
    assert abs(per_shard - loss) > 1e-3 * abs(loss)


def _wide_batches():
    """The 64×256 batch, plain and with samples 2-3 (dp shard 1's) a still
    32-pixel ±1 checkerboard that holds every level's PCA extremes."""
    b = train_batch(256, np.array([[0.3], [0.7], [0.4], [0.6]]), seed=0)
    plain = {"frames": b["frames"][:, :, :64].copy(),
             "target": b["target"][:, :64].copy(), "t": b["t"]}
    yy, xx = np.mgrid[0:64, 0:256]
    board = np.where((xx // 32 + yy // 32) % 2 == 1, 1.0, -1.0)[..., None]
    edged = {k: v.copy() for k, v in plain.items()}
    edged["frames"][2:] = board
    edged["target"][2:] = board
    return {"plain": plain, "edged": edged}


@pytest.fixture(scope="module")
def sp_steps(setup):
    """fldrx's sharded step for each (dp, sp), compiled on first use."""
    jc, tx = setup[0], setup[3]
    steps = {}

    def get(dp, sp):
        if (dp, sp) not in steps:
            steps[dp, sp] = jtrainer.make_train_step(jc, jmesh.make_mesh(
                jax.devices()[:dp * sp], dp=dp, sp=sp))
        return steps[dp, sp]

    return get


@pytest.mark.parametrize("dp,sp,case", [(1, 2, "plain"), (2, 2, "plain"),
                                        (2, 2, "edged")])
def test_sp_step_matches_fldrx_and_one_process(setup, sp_steps, dp, sp,
                                               case):
    """Width-sharded: loss and metrics within 1e-5 relative of fldrx's step
    at the same (dp, sp) and every updated parameter within 1e-4 relative
    L2; the step's gradients within 1e-4 relative L2 of the port's
    single-process step on the global batch; every rank holds the same
    parameters; each rank's level-0 refine UNet reads its 128-column slab
    and the 32-column halo, 160 of the 256 columns. In the edged batch
    every level's PCA extremes lie on dp shard 1 alone."""
    jc, tc, tree, tx, _ = setup
    batch = _wide_batches()[case]
    jparams = jax.tree.map(jnp.asarray, tree)
    state, jmet = sp_steps(dp, sp)(jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams), tx=tx), batch)
    ref = jflatten(jax.tree.map(np.asarray, state.params))

    ranks = spawn(torch_dp_child.dp_step, dp * sp, tc, tree, batch, sp,
                  timeout=600)
    m0, g0, p0, _ = ranks[0]
    for k in jmet:
        assert abs(m0[k] - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    assert set(p0) == set(ref)
    for k in ref:
        assert _rel(p0[k], ref[k]) <= 1e-4, k
    for m, _, p, widths in ranks:
        assert m == m0
        assert widths == [128 + tf.UNET_HALO] and widths[0] < 256
        for k in p0:
            np.testing.assert_array_equal(p[k], p0[k], err_msg=k)

    params = params_from_numpy(tree, "cpu")
    make_train_step(tc)(TrainState.create(params, tc), batch)
    grads = {n: p.grad.numpy() for n, p in named_leaves(params)
             if p.grad is not None}
    assert set(grads) == set(g0)
    for k in grads:
        assert _rel(g0[k], grads[k]) <= 1e-4, k
    if case == "edged":
        _extremes_on_the_second_shard(tc, tree, batch, float(jmet["loss"]))


@pytest.mark.parametrize("sp", [2, 4])
def test_loss_parts_sum_to_the_whole(sp):
    """In one process: forward_train and total_loss over each of sp width
    slabs of the 64×256 batch (LossShard, the replicated terms on slab 0)
    give level 0's output of the whole frame over each slab (1e-5), and
    loss and metrics that sum over the slabs to the whole frame's (1e-6
    relative); the PSNR from the slabs' summed squared error is the whole
    frame's."""
    from fldrx_torch.eval.pipeline import build_pyramid
    from fldrx_torch.parallel.distributed import slab_columns
    from fldrx_torch.train.losses import LossShard, total_loss

    tc = tcfg.papermodel().replace(S_trn=2, phase="train")
    params = params_from_numpy(load_params_npz(japi.DEFAULT_NPZ)[0], "cpu")
    b = {k: torch.as_tensor(v) for k, v in _wide_batches()["plain"].items()}
    pyr = build_pyramid(b["frames"], tc, tc.S_trn + 1)
    with torch.no_grad():
        whole = tf.forward_train(params, tc, pyr, b["t"])
        ref = total_loss(tc, whole, b["target"], b["frames"], b["t"],
                         params=params)[1]
        parts, sums = [], []
        for j in range(sp):
            cols = slab_columns(256, sp, j)
            out = tf.forward_train(params, tc, pyr, b["t"], cols=cols)
            np.testing.assert_allclose(
                out["out_pyramid"][0].numpy(),
                whole["out_pyramid"][0][:, :, cols[0]:cols[1]].numpy(),
                rtol=0, atol=1e-5)
            shard = LossShard(cols=cols, own=float(j == 0),
                              group_sum=lambda x: sums.append(x) or x)
            parts.append(total_loss(tc, out, b["target"], b["frames"],
                                    b["t"], params=params, shard=shard)[1])
    for k in ("loss", "rec", "smooth", "warp", "orth"):
        got = sum(float(m[k]) for m in parts)
        assert abs(got - float(ref[k])) <= 1e-6 * abs(float(ref[k])), k
    sse, n = torch.stack(sums).sum(0)
    assert int(n) == b["target"].numel()
    psnr = -10 * np.log10(float(sse / n))
    assert abs(psnr - float(ref["psnr"])) <= 1e-4


def test_unet_halo_covers_its_reach():
    """UNET_HALO covers the refine UNet's reach: a change of one input
    column moves output columns at most unet_reach() away, and that far at
    some phase; slabs of the whole frame's UNet input, each with its halo,
    give the whole frame's output over the slab."""
    p = params_from_numpy(load_params_npz(japi.DEFAULT_NPZ)[0],
                          "cpu")["vfinet"]["refine"]
    x = torch.as_tensor(np.random.RandomState(8).randn(
        1, 16, 128, 26).astype(np.float32))
    base = tf.refine_unet_s2d(p, x)
    reach = 0
    for c in range(56, 64):
        y = x.clone()
        y[:, :, c] += 1.0
        moved = torch.nonzero((tf.refine_unet_s2d(p, y) - base).abs().amax(
            dim=(0, 1, 3)) > 0).flatten()
        reach = max(reach, c - int(moved.min()), int(moved.max()) - c)
    assert reach == tf.unet_reach() <= tf.UNET_HALO
    assert tf.UNET_HALO % tf.UNET_GRID == 0
    for lo, hi in ((0, 32), (32, 64), (64, 128), (40, 88)):
        a, b = tf.unet_columns((lo, hi), 128)
        got = tf.refine_unet_s2d(p, x[:, :, a:b])[:, :, lo - a:hi - a]
        np.testing.assert_allclose(got.numpy(), base[:, :, lo:hi].numpy(),
                                   rtol=0, atol=2e-5)


def tloop_loss(cfg, params, batch):
    from fldrx_torch.train.trainer import train_loss
    with torch.no_grad():
        return train_loss(cfg, params, batch)[0]


def test_dp_step_refuses_width_sharding_and_a_missing_group(setup):
    """Width sharding is ported; what is refused: a step without a process
    group, a group whose world size is not dp·sp, and a width that does not
    split into slabs on the refine UNet's grid."""
    import torch.distributed as dist

    from fldrx_torch.parallel.distributed import _free_port, slab_columns

    tc = setup[1]
    with pytest.raises(RuntimeError, match="process group"):
        make_train_step(tc, make_mesh(["cpu"] * 4, dp=2, sp=2))
    with pytest.raises(RuntimeError, match="process group"):
        make_train_step(tc, make_mesh(["cpu"] * 2, dp=2, sp=1))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="1 ranks for a mesh of dp 2 "
                                             "× sp 2"):
            make_train_step(tc, make_mesh(["cpu"] * 4, dp=2, sp=2))
        assert make_train_step(tc, make_mesh(["cpu"], dp=1, sp=1))
    finally:
        dist.destroy_process_group()
    assert slab_columns(256, 2, 1) == (128, 256)
    with pytest.raises(ValueError, match="does not split"):
        slab_columns(100, 2, 0)


def _toy_xtrain(root, n_clips=2, n_frames=65, hw=(72, 80), block=1):
    """n_clips X-Train clips of random frames, constant over block×block
    cells."""
    from PIL import Image
    rng = np.random.RandomState(7)
    cells = (hw[0] // block, hw[1] // block, 3)
    for c in range(n_clips):
        d = os.path.join(root, "s1", f"clip{c}")
        os.makedirs(d)
        for i in range(n_frames):
            img = rng.randint(0, 255, cells, np.uint8)
            img = img.repeat(block, 0).repeat(block, 1)
            Image.fromarray(img).save(os.path.join(d, f"{i:04d}.png"))
    return root


def test_dp_train_matches_one_process(tmp_path):
    """train(mesh=) over two CPU ranks, one step of batch 2 on a toy
    X-Train tree, ends where train() in one process ends (1e-4 relative
    L2 per parameter); rank 0 alone writes the checkpoint."""
    base = tcfg.papermodel().replace(
        S_trn=1, phase="train", batch_size=2, patch_size=64, epochs=1,
        x_train_data_path=_toy_xtrain(str(tmp_path / "xtrain")))
    one = base.replace(checkpoint_dir=str(tmp_path / "ck1"),
                       text_dir=str(tmp_path / "tx1"),
                       log_dir=str(tmp_path / "lg1"))
    dp = base.replace(checkpoint_dir=str(tmp_path / "ck2"),
                      text_dir=str(tmp_path / "tx2"),
                      log_dir=str(tmp_path / "lg2"))
    p_one, _ = tloop.train(one, seed=5, no_validation=True, verbose=False,
                           device="cpu")
    ref = flatten_params(params_to_numpy(p_one))
    r0, r1 = spawn(torch_dp_child.dp_train, 2, dp, 5, timeout=600)
    for k in ref:
        assert _rel(r0[k], ref[k]) <= 1e-4, k
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    assert sorted(os.listdir(tmp_path / "ck2")) == sorted(
        os.listdir(tmp_path / "ck1"))


def test_sp_train_matches_one_process(tmp_path):
    """train(mesh=) at dp 1 × sp 2, one step of batch 2 at 128×128 crops
    (slabs of 64 columns, 96 with the halo), ends where train() in one
    process ends (1e-4 relative L2 per parameter); both ranks equal; rank
    0 alone writes the checkpoint."""
    base = tcfg.papermodel().replace(
        S_trn=1, phase="train", batch_size=2, patch_size=128, epochs=1,
        x_train_data_path=_toy_xtrain(str(tmp_path / "xtrain"),
                                      hw=(136, 144)))
    one = base.replace(checkpoint_dir=str(tmp_path / "ck1"),
                       text_dir=str(tmp_path / "tx1"),
                       log_dir=str(tmp_path / "lg1"))
    sp = base.replace(checkpoint_dir=str(tmp_path / "ck2"),
                      text_dir=str(tmp_path / "tx2"),
                      log_dir=str(tmp_path / "lg2"))
    p_one, _ = tloop.train(one, seed=5, no_validation=True, verbose=False,
                           device="cpu")
    ref = flatten_params(params_to_numpy(p_one))
    r0, r1 = spawn(torch_dp_child.dp_train, 2, sp, 5, 2, timeout=600)
    for k in ref:
        assert _rel(r0[k], ref[k]) <= 1e-4, k
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    assert sorted(os.listdir(tmp_path / "ck2")) == sorted(
        os.listdir(tmp_path / "ck1"))


def test_cli_train_under_torchrun(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m fldrx_torch
    --device cpu --phase train: two gloo ranks train one step of batch 2 on
    a toy X-Train tree at the CLI's 512×512 crops; rank 0 writes the
    checkpoint."""
    import subprocess
    import sys

    from fldrx_torch.train.checkpoint import SaveManager

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = _toy_xtrain(str(tmp_path / "xtrain"), hw=(512, 512), block=16)
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "fldrx_torch", "--device", "cpu",
           "--phase", "train", "--papermodel", "--S_trn", "1",
           "--batch_size", "2", "--epochs", "1", "--no_validation",
           "--x_train_data_path", root,
           "--checkpoint_dir", str(tmp_path / "ck"),
           "--text_dir", str(tmp_path / "tx"),
           "--log_dir", str(tmp_path / "lg")]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    cfg = tcfg.papermodel().replace(checkpoint_dir=str(tmp_path / "ck"),
                                    text_dir=str(tmp_path / "tx"))
    _, meta, _ = SaveManager(cfg).load()
    assert int(meta["step"]) == 1 and int(meta["last_epoch"]) == 0
