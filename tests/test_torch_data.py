"""The port's Inter4K and Vimeo training sets against fldrx's, on tiny PNG
trees: with the same random.Random seed a sample (frames, resolution,
crop, flips, rot90 and t) is the same, and the generator is left in the
same state. train() selects the set by cfg.dataset and runs an epoch on
the Inter4K tree on the CPU."""

import os
import random

import numpy as np
import pytest
import torch

from fldrx import config as jcfg
from fldrx.data import datasets as jds
from fldrx_torch import config as tcfg
from fldrx_torch.data import datasets as tds
from fldrx_torch.train import loop as tloop
from fldrx_torch.train.checkpoint import SaveManager

torch.set_num_threads(1)


def _png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def inter4k(tmp_path_factory):
    """Two clips of 40 frame directories, each holding im1k/im2k/im4k at
    three sizes (tests/test_data.py's layout)."""
    root = tmp_path_factory.mktemp("i4k")
    rng = np.random.RandomState(0)
    for clip in ("c1", "c2"):
        for i in range(40):
            d = root / "s1" / clip / f"{i:04d}"
            d.mkdir(parents=True)
            for res, hw in (("im1k", (64, 72)), ("im2k", (72, 80)),
                            ("im4k", (96, 112))):
                _png(str(d / f"{res}.png"),
                     rng.randint(0, 255, (*hw, 3), np.uint8))
    return str(root)


@pytest.fixture(scope="module")
def vimeo(tmp_path_factory):
    """vimeo_triplet's layout: three sequences, one of them smaller than
    the patch (no crop), and a list line for a missing sequence."""
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.RandomState(1)
    names = ["00001/0001", "00001/0002", "00002/0001"]
    for name, hw in zip(names, [(48, 64), (40, 56), (24, 40)]):
        d = root / "sequences" / name
        d.mkdir(parents=True)
        for k in (1, 2, 3):
            _png(str(d / f"im{k}.png"), rng.randint(0, 255, (*hw, 3),
                                                    np.uint8))
    (root / "tri_trainlist.txt").write_text(
        "\n".join(names + ["00003/0001", ""]) + "\n")
    return str(root)


def _same_samples(jset, tset, idx):
    assert len(jset) == len(tset)
    for seed in (0, 1, 2):
        rj, rt = random.Random(seed), random.Random(seed)
        fj, tj = jset.sample(idx, rj)
        ft, tt = tset.sample(idx, rt)
        np.testing.assert_array_equal(ft, fj)
        assert ft.dtype == np.float32 and tt == tj
        assert rt.random() == rj.random()


@pytest.mark.parametrize("patch", [32, 600])
def test_inter4k_train_samples_match_fldrx(inter4k, patch):
    """patch 32 picks among all three resolutions; above 512 only im2k and
    im4k (the crop then cannot fit, and both raise alike)."""
    jc = jcfg.papermodel().replace(inter4k_data_path=inter4k,
                                   patch_size=patch)
    tc = tcfg.papermodel().replace(inter4k_data_path=inter4k,
                                   patch_size=patch)
    jset, tset = jds.Inter4KTrain(jc), tds.Inter4KTrain(tc)
    assert tset.clips == jset.clips and len(tset) == 2
    if patch > 512:
        for seed in (0, 1, 2):
            with pytest.raises(ValueError):
                jset.sample(1, random.Random(seed))
            with pytest.raises(ValueError):
                tset.sample(1, random.Random(seed))
        return
    for idx in (0, 1):
        _same_samples(jset, tset, idx)


def test_vimeo_train_samples_match_fldrx(vimeo):
    jc = jcfg.papermodel().replace(vimeo_data_path=vimeo, patch_size=32)
    tc = tcfg.papermodel().replace(vimeo_data_path=vimeo, patch_size=32)
    jset, tset = jds.VimeoTrain(jc), tds.VimeoTrain(tc)
    assert tset.clips == jset.clips and len(tset) == 3
    for idx in range(3):
        _same_samples(jset, tset, idx)


def test_train_dataset_selection(inter4k, vimeo, tmp_path):
    cfg = tcfg.papermodel().replace(inter4k_data_path=inter4k,
                                    vimeo_data_path=vimeo,
                                    x_train_data_path=str(tmp_path))
    assert type(tds.get_train_dataset(cfg.replace(
        dataset="Inter4K-S"))) is tds.Inter4KTrain
    assert type(tds.get_train_dataset(cfg.replace(
        dataset="Vimeo"))) is tds.VimeoTrain
    with pytest.raises(RuntimeError, match="Found 0 files"):
        tds.get_train_dataset(cfg)
    with pytest.raises(RuntimeError, match="Found 0 clip folders"):
        tds.Inter4KTrain(cfg.replace(inter4k_data_path=str(tmp_path)))


def test_train_epoch_on_inter4k(inter4k, tmp_path):
    """train() on the Inter4K tree: one epoch of two steps of batch 1 at
    64×64, S_trn=1, on the CPU, no validation; the checkpoint is written
    and the losses are finite."""
    cfg = tcfg.papermodel().replace(
        dataset="Inter4K-S", inter4k_data_path=inter4k, S_trn=1,
        phase="train", batch_size=1, patch_size=64, epochs=1,
        checkpoint_dir=str(tmp_path / "ck"), text_dir=str(tmp_path / "tx"),
        log_dir=str(tmp_path / "lg"))
    params, best = tloop.train(cfg, max_steps_per_epoch=2, verbose=False,
                               no_validation=True, device="cpu")
    assert best == 1.0
    _, meta, _ = SaveManager(cfg).load()
    assert int(meta["last_epoch"]) == 0 and int(meta["step"]) == 2
    assert np.isfinite(float(meta["trainLoss"]))
    assert os.path.exists(os.path.join(cfg.text_dir,
                                       f"{cfg.model_dir}_scalars.jsonl"))
