"""The port's native PNG decoder (fldrx_torch/data/native.py,
fldrx_torch/csrc/decoder.cpp) against fldrx's native decoder and PIL, bit
for bit, and the test sets' decoding through it. Where the library cannot
be built here (no C++ compiler or no libpng) the decoder tests skip, as
tests/test_native_decoder.py does; the fallback to PIL is tested either
way."""

import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fldrx.data import native as fx_native
from fldrx_torch.config import papermodel
from fldrx_torch.data import datasets, native
from fldrx_torch.data.loader import test_samples as port_test_samples
from fldrx_torch.ops import _build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("rgb8", "rgba8", "gray8", "gray_alpha", "palette_trns", "rgb_trns",
         "gray_trns")
# fldrx's decoder keeps a tRNS chunk's alpha and then refuses the file on
# its row size (None, so its callers decode with PIL); the port drops it
TRNS = ("palette_trns", "rgb_trns", "gray_trns")


def _smoke():
    """chip_smoke.py as a module (its PNG writer makes the 16-bit file)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lib():
    if native.get_lib() is None:
        pytest.skip("native decoder unavailable (no C++ compiler or libpng): "
                    f"{native.build_error()}")


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """One 37×45 PNG per colour type, and a 16-bit RGB one."""
    d = tmp_path_factory.mktemp("modes")
    rng = np.random.RandomState(0)
    H, W = 37, 45
    paths = {}

    def save(name, im, **kw):
        paths[name] = str(d / f"{name}.png")
        im.save(paths[name], **kw)

    save("rgb8", Image.fromarray(rng.randint(0, 256, (H, W, 3), np.uint8)))
    save("rgba8", Image.fromarray(rng.randint(0, 256, (H, W, 4), np.uint8),
                                  "RGBA"))
    save("gray8", Image.fromarray(rng.randint(0, 256, (H, W), np.uint8), "L"))
    save("gray_alpha", Image.fromarray(
        rng.randint(0, 256, (H, W, 2), np.uint8), "LA"))
    pal = Image.fromarray(rng.randint(0, 16, (H, W), np.uint8), "P")
    pal.putpalette(rng.randint(0, 256, 16 * 3).tolist())
    save("palette_trns", pal,
         transparency=bytes(rng.randint(0, 256, 16).tolist()))
    save("rgb_trns", Image.fromarray(
        rng.randint(0, 256, (H, W, 3), np.uint8)), transparency=(1, 2, 3))
    save("gray_trns", Image.fromarray(rng.randint(0, 256, (H, W), np.uint8),
                                      "L"), transparency=5)
    paths["rgb16"] = str(d / "rgb16.png")
    _smoke().write_png(paths["rgb16"],
                       rng.randint(0, 65536, (H, W, 3)).astype(np.uint16))
    return paths


def _pil_bgr(path):
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)[..., ::-1]


@pytest.mark.parametrize("mode", MODES + ("rgb16",))
def test_decode_matches_fldrx_and_pil(lib, pngs, mode):
    """Every colour type decodes as fldrx's decoder does (with a tRNS
    chunk: as fldrx's readers do, through PIL, since its decoder refuses
    the file), and as PIL does for the 8-bit ones (PIL does not read 16-bit
    RGB)."""
    got = native.decode_png_batch_bgr([pngs[mode]], threads=1)
    assert got is not None and got.shape == (1, 37, 45, 3)
    assert native.probe_png(pngs[mode]) == (45, 37)
    if fx_native.get_lib() is not None:
        ref = fx_native.decode_png_batch_bgr([pngs[mode]], threads=1)
        if mode in TRNS:
            assert ref is None
        else:
            np.testing.assert_array_equal(got, ref)
    if mode != "rgb16":
        np.testing.assert_array_equal(got[0], _pil_bgr(pngs[mode]))
    assert native.decoder_in_use() == "native"


@pytest.mark.parametrize("mode", MODES)
def test_imread_bgr_equals_pil(lib, pngs, mode):
    got = datasets.imread_bgr(pngs[mode])
    assert native.decoder_in_use() == "native"
    assert got.dtype == np.uint8 and got.shape == (37, 45, 3)
    np.testing.assert_array_equal(got, _pil_bgr(pngs[mode]))


def test_size_mismatch_or_missing_file_gives_none(lib, pngs, tmp_path):
    other = str(tmp_path / "other.png")
    Image.fromarray(np.zeros((10, 10, 3), np.uint8)).save(other)
    assert native.decode_png_batch_bgr([pngs["rgb8"], other]) is None
    assert native.decode_png_batch_bgr(
        [pngs["rgb8"], str(tmp_path / "missing.png")]) is None
    assert native.probe_png(str(tmp_path / "missing.png")) is None
    assert native.decode_png_batch_bgr([]) is None
    # one by one instead: each its own size, each its own array
    frames = native.read_bgr_batch([pngs["rgb8"], other, pngs["gray8"]])
    assert [f.shape for f in frames] == [(37, 45, 3), (10, 10, 3),
                                        (37, 45, 3)]
    np.testing.assert_array_equal(frames[2], _pil_bgr(pngs["gray8"]))


def test_threads_agree(lib, tmp_path):
    rng = np.random.RandomState(1)
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"f{i}.png"))
        Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(
            paths[-1])
    one = native.decode_png_batch_bgr(paths, threads=1)
    four = native.decode_png_batch_bgr(paths, threads=4)
    np.testing.assert_array_equal(one, four)
    for p, f in zip(paths, one):
        np.testing.assert_array_equal(f, _pil_bgr(p))
    # the batch reader hands out copies, not views into one array
    frames = native.read_bgr_batch(paths, threads=4)
    assert all(f.base is None for f in frames)


def _x_test_tree(root, H=40, W=56):
    """An X-Test tree of one scene, Type1/scene/0000..0032.png; at ×8 the
    test set reads files 0, 4, …, 32, the others are 1×1 placeholders.
    Returns the 9 frames (BGR) by file index."""
    rng = np.random.RandomState(2)
    d = os.path.join(root, "Type1", "scene")
    os.makedirs(d)
    frames = {}
    for i in range(33):
        if i % 4 == 0:
            frames[i] = rng.randint(0, 256, (H, W, 3), np.uint8)
            img = frames[i][..., ::-1]
        else:
            img = np.zeros((1, 1, 3), np.uint8)
        Image.fromarray(np.ascontiguousarray(img)).save(
            os.path.join(d, f"{i:04d}.png"))
    return frames


def test_x_test_decodes_nine_frames_per_pair(lib, tmp_path):
    """At ×8 a pair's 7 items share I0 and I1: through the prefetching
    loader's 8 threads, the test set decodes each of the 9 frames once, in
    native batches, and hands every item its frames."""
    frames = _x_test_tree(str(tmp_path))
    cfg = papermodel().replace(x_test_data_path=str(tmp_path))
    ds = datasets.get_test_dataset(cfg, "X-Test", 8)
    assert len(ds) == 7
    for k, (got, t, _) in enumerate(port_test_samples(ds, raw=True)):
        np.testing.assert_array_equal(got[0], frames[0])
        np.testing.assert_array_equal(got[1], frames[32])
        np.testing.assert_array_equal(got[2], frames[4 * (k + 1)])
        assert t == pytest.approx((k + 1) / 8)
    assert ds.frames_decoded == 9
    assert native.decoder_in_use() == "native"


def test_concurrent_readers_decode_each_frame_once(lib, tmp_path):
    """32 threads ask for overlapping frames at a short switch interval:
    each distinct frame (9, within the cache) is decoded once, and every
    thread gets the right pixels."""
    frames = _x_test_tree(str(tmp_path))
    cfg = papermodel().replace(x_test_data_path=str(tmp_path))
    ds = datasets.get_test_dataset(cfg, "X-Test", 8)
    errors = []

    def read(k):
        try:
            it = ds.items[k % len(ds)]
            got = ds._frames(it.paths)
            idx = [0, 32, 4 * (k % len(ds) + 1)]
            for g, i in zip(got, idx):
                np.testing.assert_array_equal(g, frames[i])
        except Exception as e:          # reported after the join
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read, args=(k,)) for k in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    assert ds.frames_decoded == 9


@pytest.fixture
def no_native(monkeypatch):
    """The decoder library as where it cannot be built."""
    def fail(name):
        raise RuntimeError("c++ failed for decoder.cpp: fatal error: png.h: "
                           "No such file or directory")

    monkeypatch.setattr(_build, "library", fail)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_in_use", None)


def test_failed_build_warns_and_falls_back_to_pil(no_native, pngs):
    with pytest.warns(RuntimeWarning, match="png.h: No such file"):
        assert native.get_lib() is None
    assert "png.h" in native.build_error()
    assert native.decode_png_batch_bgr([pngs["rgb8"]]) is None
    got = datasets.imread_bgr(pngs["rgb8"])
    assert native.decoder_in_use() == "pil"
    np.testing.assert_array_equal(got, _pil_bgr(pngs["rgb8"]))


def test_neither_decoder_raises_an_error_naming_both(no_native, pngs,
                                                     monkeypatch):
    with pytest.warns(RuntimeWarning):
        native.get_lib()
    monkeypatch.setitem(sys.modules, "PIL", None)       # import PIL fails
    with pytest.raises(native.NoPNGDecoder,
                       match="native PNG decoder.*png.h.*PIL"):
        datasets.imread_bgr(pngs["rgb8"])
