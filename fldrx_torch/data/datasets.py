"""Dataset indexers and frame decoding (counterpart of
fldrx/data/datasets.py): the training sets (X-Train, Inter4K, Vimeo
triplets) and the test sets (X-Test, Xiph, Inter4K, Vimeo) with their ×N
item layout.

Frames decode to uint8 BGR, the reference's cv2 order, through the port's
native PNG decoder (data/native.py: libpng on C++ threads, built at first
use), or through PIL where that library cannot be built.
"""

from __future__ import annotations

import collections
import glob
import os
import random
import threading
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..config import FLDRConfig
from . import native


def imread_bgr(path: str) -> np.ndarray:
    """uint8 HWC BGR, through the native decoder or else PIL."""
    return native.read_bgr(path)


def frames_to_tensor(frames: np.ndarray) -> np.ndarray:
    """[T,H,W,C] uint8 → [T,H,W,C] float32 in [-1,1], ((x/255 − 0.5)·2)
    in place on one buffer, in the reference's order of operations."""
    x = frames.astype(np.float32)
    x /= 255.0
    x -= 0.5
    x *= 2.0
    return x


def half_res_bilinear(frames: np.ndarray) -> np.ndarray:
    """×1/2 bilinear downscale with F.interpolate semantics, on the host:
    the --xiph2k/--xtest2k eval modes (utils.py:198-199, 475-476).
    frames: [T,H,W,C] float."""
    from ..ops.resize import _resize_matrix_np

    T, H, W, C = frames.shape
    Wh = _resize_matrix_np(H, H // 2, "bilinear", False).astype(np.float32)
    Ww = _resize_matrix_np(W, W // 2, "bilinear", False).astype(np.float32)
    out = np.einsum("oh,thwc->towc", Wh, frames)
    return np.einsum("pw,towc->topc", Ww, out)


# ---------------------------------------------------------------------------
# test datasets: item i = (frames [3,H,W,C] — I0, I1, It —, t, scene)
# ---------------------------------------------------------------------------

@dataclass
class TestItem:
    paths: Tuple[str, str, str]      # I0, I1, It
    t: float
    scene: str


class _Decoding:
    """A frame that one thread is decoding and others wait for."""

    def __init__(self):
        self.done = threading.Event()
        self.frame = None
        self.error = None


class TestDataset:
    """Items plus a small LRU of decoded frames: the ×N protocol's items
    share a frame pair across multiple−1 consecutive targets, so without it
    I0 and I1 would be decoded multiple−1 times each. The cache belongs to
    the dataset and is safe for the loader's threads: a frame that another
    thread is decoding is waited for, not decoded again, and a call decodes
    its misses in one native batch on 3 threads. `frames_decoded` counts
    the decodes. Subclasses call `__init__` before any thread reads."""

    items: List[TestItem]
    CACHE_FRAMES = 12      # one ×8 pair's 9 frames plus the next pair's first
    DECODE_THREADS = 3

    def __init__(self):
        self._cache = collections.OrderedDict()
        self._decoding = {}
        self._lock = threading.Lock()
        self.frames_decoded = 0

    def __len__(self):
        return len(self.items)

    def _frames(self, paths) -> np.ndarray:
        keys = []
        for p in paths:
            st = os.stat(p)
            keys.append((p, st.st_mtime_ns, st.st_size))  # rewrites re-decode
        got, waits, mine = {}, {}, {}
        with self._lock:
            for k in keys:
                if k in got or k in waits or k in mine:
                    continue
                if k in self._cache:
                    self._cache.move_to_end(k)
                    got[k] = self._cache[k]
                elif k in self._decoding:
                    waits[k] = self._decoding[k]
                else:
                    mine[k] = self._decoding[k] = _Decoding()
        if mine:
            frames, error = None, None
            try:
                frames = native.read_bgr_batch([k[0] for k in mine],
                                               self.DECODE_THREADS)
                if len(frames) != len(mine):
                    raise RuntimeError(f"the decoder returned {len(frames)} "
                                       f"frames for {len(mine)} files")
            except BaseException as e:
                error = e
                raise
            finally:
                # every entry this call registered leaves the table and
                # wakes its waiters, with its frame or with the error
                with self._lock:
                    if error is None:
                        self.frames_decoded += len(mine)
                    for i, (k, d) in enumerate(mine.items()):
                        del self._decoding[k]
                        if error is None:
                            self._cache[k] = got[k] = d.frame = frames[i]
                        else:
                            d.error = error
                        d.done.set()
                    while len(self._cache) > self.CACHE_FRAMES:
                        self._cache.popitem(last=False)
        for k, d in waits.items():
            d.done.wait()
            if d.error is not None:
                raise RuntimeError(f"decoding {k[0]} failed") from d.error
            got[k] = d.frame
        return np.stack([got[k] for k in keys], 0)

    def load(self, idx: int, patch: int = -1, raw: bool = False):
        """(frames [3,H,W,C], t, scene): float32 in [-1,1], or uint8 with
        raw=True (the device normalises them); `patch` != -1 takes a centre
        crop."""
        it = self.items[idx]
        frames = self._frames(it.paths)
        if patch != -1:
            ih, iw = frames.shape[1:3]
            ix, iy = (iw - patch) // 2, (ih - patch) // 2
            frames = frames[:, iy:iy + patch, ix:ix + patch]
        return (frames if raw else frames_to_tensor(frames)), it.t, it.scene


def make_x_test_items(root: str, multiple: int,
                      t_step_size: int = 32) -> List[TestItem]:
    """XVFI X-Test layout type/scene/*.png (make_2D_dataset_X_Test,
    utils.py:414-432)."""
    items = []
    t = np.linspace(1 / multiple, 1 - 1 / multiple, multiple - 1)
    for type_folder in sorted(glob.glob(os.path.join(root, "*", ""))):
        for scene_folder in sorted(glob.glob(os.path.join(type_folder, "*",
                                                          ""))):
            frame_folder = sorted(glob.glob(scene_folder + "*.png"))
            for idx in range(0, len(frame_folder), t_step_size):
                if idx == len(frame_folder) - 1:
                    break
                for mul in range(multiple - 1):
                    items.append(TestItem(
                        paths=(frame_folder[idx],
                               frame_folder[idx + t_step_size],
                               frame_folder[idx + (t_step_size // multiple)
                                            * (mul + 1)]),
                        t=float(t[mul]),
                        scene=scene_folder.split(os.path.join(root, ""))[-1],
                    ))
    return items


class XTest(TestDataset):
    def __init__(self, cfg: FLDRConfig, multiple: int, validation: bool,
                 half_res: bool = False):
        super().__init__()
        root = cfg.x_val_data_path if validation else cfg.x_test_data_path
        self.items = make_x_test_items(root, multiple)
        self.validation = validation
        self.half_res = half_res          # --xtest2k (utils.py:475-476)
        if not self.items:
            raise FileNotFoundError(f"Found 0 files in subfolders of: {root}")

    def load(self, idx, patch=-1, raw=False):
        # half_res needs float math: raw mode degrades to float32 there
        frames, t, scene = super().load(idx, patch,
                                        raw=raw and not self.half_res)
        if self.half_res:
            frames = half_res_bilinear(frames)
        return frames, t, scene


XIPH_CLIPS = ["BoxingPractice", "Crosswalk", "DrivingPOV", "FoodMarket",
              "FoodMarket2", "RitualDance", "SquareAndTimelapse", "Tango"]


class XiphTest(TestDataset):
    """8 Netflix clips × frames 2..98 step 2 → 392 triplets, t=0.5
    (utils.py:157-203)."""

    def __init__(self, cfg: FLDRConfig, crop_2k: bool = False,
                 half_res: bool = False):
        super().__init__()
        self.items = []
        self.crop_2k = crop_2k
        self.half_res = half_res          # --xiph2k (utils.py:198-199)
        for clip in XIPH_CLIPS:
            for f in range(2, 99, 2):
                def p(i):
                    return os.path.join(cfg.xiph_data_path,
                                        f"{clip}-{str(i).zfill(3)}.png")
                self.items.append(TestItem(
                    paths=(p(f - 1), p(f + 1), p(f)), t=0.5,
                    scene=f"{clip}/{f}"))

    def load(self, idx, patch=-1, raw=False):
        frames, t, scene = super().load(idx, patch,
                                        raw=raw and not self.half_res)
        if self.crop_2k:   # Xiph2KC centre crop (utils.py:195-197)
            frames = frames[:, 540:-540, 1024:-1024]
        if self.half_res:
            frames = half_res_bilinear(frames)
        return frames, t, scene


class Inter4KTest(TestDataset):
    """Inter4K ×8 interpolation over 8- ('S') or 16-frame ('L') spans
    (inter4kreader.py:10-43): scene folders of consecutive frames."""

    MULTIPLE = 8

    def __init__(self, cfg: FLDRConfig, scenerange: int):
        super().__init__()
        root = cfg.inter4k_data_path
        self.items = []
        scenes = {}
        for folder in sorted(glob.glob(os.path.join(root, "*", ""))):
            frames = sorted(glob.glob(os.path.join(folder, "*.png")))
            if frames:
                scenes[folder] = frames
        step = scenerange // self.MULTIPLE     # 1 (S) or 2 (L)
        t_vals = np.linspace(1 / self.MULTIPLE, 1 - 1 / self.MULTIPLE,
                             self.MULTIPLE - 1)
        for folder, frames in scenes.items():
            for start in range(0, len(frames) - scenerange, scenerange):
                i0, i1 = frames[start], frames[start + scenerange]
                for mul in range(self.MULTIPLE - 1):
                    it = frames[start + step * (mul + 1)]
                    self.items.append(TestItem(
                        paths=(i0, i1, it), t=float(t_vals[mul]),
                        scene=os.path.basename(os.path.dirname(folder))))


class VimeoTest(TestDataset):
    """vimeo_triplet tri_testlist (utils.py:522-557); t=0.5, inputs im1 and
    im3, target im2."""

    def __init__(self, cfg: FLDRConfig, validation: bool = False):
        super().__init__()
        self.items = []
        with open(os.path.join(cfg.vimeo_data_path, "tri_testlist.txt")) as f:
            scene_paths = [ln.strip() for ln in f if ln.strip()]
        if validation:
            scene_paths = scene_paths[::37]
        for sp in scene_paths:
            fr = sorted(glob.glob(os.path.join(
                cfg.vimeo_data_path, "sequences", sp, "*.png")))
            if len(fr) >= 3:
                self.items.append(TestItem(paths=(fr[0], fr[2], fr[1]),
                                           t=0.5, scene=sp))


def get_test_dataset(cfg: FLDRConfig, name: str, multiple: int,
                     validation: bool = False,
                     half_res: bool = False) -> TestDataset:
    """Dataset-name dispatch (get_test_data, utils.py:132-151); `half_res`
    is the --xtest2k/--xiph2k mode."""
    if name in ("X4K1000FPS", "X-Test"):
        return XTest(cfg, multiple, validation, half_res=half_res)
    if name == "Vimeo":
        return VimeoTest(cfg, validation)
    if name == "Xiph-4K":
        return XiphTest(cfg, half_res=half_res)
    if name == "Xiph2KC":
        return XiphTest(cfg, crop_2k=True)
    if name == "Inter4K-S":
        return Inter4KTest(cfg, scenerange=8)
    if name == "Inter4K-L":
        return Inter4KTest(cfg, scenerange=16)
    raise ValueError(f"unknown test dataset {name}")


TEST_MULTIPLES = {"X4K1000FPS": 8, "XTest2KC": 8, "Inter4K-S": 8,
                  "Inter4K-L": 8, "Xiph-4K": 2, "Xiph2KC": 2, "Vimeo": 2,
                  "Adobe240": 8, "HD": 4}


# ---------------------------------------------------------------------------
# training dataset (X_Train, utils.py:369-409)
# ---------------------------------------------------------------------------

class XTrain:
    """65-frame clips under x_train_data_path/<scene>/<clip>/*.png; random
    t step in [2, 32], a random triplet with temporal reversal, random
    crop, horizontal flip and rot90."""

    def __init__(self, cfg: FLDRConfig, max_t_step_size: int = 32):
        self.cfg = cfg
        self.max_t_step = max_t_step_size
        self.clips = []
        for scene in sorted(glob.glob(os.path.join(cfg.x_train_data_path,
                                                   "*", ""))):
            for sample in sorted(glob.glob(os.path.join(scene, "*", ""))):
                frames = sorted(glob.glob(os.path.join(sample, "*.png")))
                if frames:
                    self.clips.append(frames)
        if not self.clips:
            raise RuntimeError(
                f"Found 0 files in subfolders of: {cfg.x_train_data_path}")

    def __len__(self):
        return len(self.clips)

    def sample(self, idx: int, rng: random.Random):
        """Returns (frames [3,ps,ps,C] float32 in [-1,1] — I0, I1, It —,
        t)."""
        t_step = rng.randint(2, self.max_t_step)
        t_list = np.linspace(1 / t_step, 1 - 1 / t_step, t_step - 1)
        clip = self.clips[idx]
        first = rng.randint(0, 64 - t_step)
        inter = rng.randint(1, t_step - 1)
        t_value = float(t_list[inter - 1])
        if rng.randint(0, 1):
            frange = [first, first + t_step, first + inter]
        else:                                   # temporal reversal
            frange = [first + t_step, first, first + inter]
            t_value = 1.0 - t_value
        frames = np.stack([imread_bgr(clip[i]) for i in frange], 0)

        ps = self.cfg.patch_size
        ih, iw = frames.shape[1:3]
        ix = rng.randrange(0, iw - ps + 1)
        iy = rng.randrange(0, ih - ps + 1)
        frames = frames[:, iy:iy + ps, ix:ix + ps]
        if rng.random() < 0.5:
            frames = frames[:, :, ::-1]
        rot = rng.randint(0, 3)
        frames = np.rot90(frames, rot, (1, 2))
        return frames_to_tensor(np.ascontiguousarray(frames)), t_value


class Inter4KTrain(XTrain):
    """Inter4K multi-resolution training clips (reference utils.py:269-323):
    root/<scene>/<sample>/<frame>/im{1k,2k,4k}.png, each clip a list of
    frame directories. A sample picks its resolution at random (im2k or
    im4k when patch_size > 512, else any of the three), then follows
    X-Train's triplet, crop, horizontal flip and rot90; no vertical
    flip."""

    def __init__(self, cfg: FLDRConfig, max_t_step_size: int = 32):
        self.cfg = cfg
        self.max_t_step = max_t_step_size
        self.clips = []
        root = cfg.inter4k_data_path
        for scene in sorted(glob.glob(os.path.join(root, "*", ""))):
            for sample in sorted(glob.glob(os.path.join(scene, "*", ""))):
                frames = sorted(glob.glob(os.path.join(sample, "*", "")))
                if frames:
                    self.clips.append(frames)
        if not self.clips:
            raise RuntimeError(
                f"Found 0 clip folders in subfolders of: {root}")

    def sample(self, idx: int, rng: random.Random):
        t_step = rng.randint(2, self.max_t_step)
        t_list = np.linspace(1 / t_step, 1 - 1 / t_step, t_step - 1)
        clip = self.clips[idx]
        first = rng.randint(0, len(clip) - 1 - t_step)
        inter = rng.randint(1, t_step - 1)
        t_value = float(t_list[inter - 1])
        if rng.randint(0, 1):
            frange = [first, first + t_step, first + inter]
        else:
            frange = [first + t_step, first, first + inter]
            t_value = 1.0 - t_value
        ps = self.cfg.patch_size
        choices = (["im2k.png", "im4k.png"] if ps > 512
                   else ["im1k.png", "im2k.png", "im4k.png"])
        res = choices[rng.randint(0, len(choices) - 1)]
        frames = np.stack(
            [imread_bgr(os.path.join(clip[i], res)) for i in frange], 0)
        ih, iw = frames.shape[1:3]
        ix = rng.randrange(0, iw - ps + 1)
        iy = rng.randrange(0, ih - ps + 1)
        frames = frames[:, iy:iy + ps, ix:ix + ps]
        if rng.random() < 0.5:
            frames = frames[:, :, ::-1]
        frames = np.rot90(frames, rng.randint(0, 3), (1, 2))
        return frames_to_tensor(np.ascontiguousarray(frames)), t_value


class VimeoTrain:
    """vimeo_triplet's tri_trainlist (reference utils.py:485-519): the
    middle frame at t = 0.5, a random temporal flip, a random crop where
    the frames are at least patch_size, horizontal flip and rot90."""

    def __init__(self, cfg: FLDRConfig):
        self.cfg = cfg
        self.clips = []
        with open(os.path.join(cfg.vimeo_data_path, "tri_trainlist.txt")) as f:
            for ln in f:
                sp = ln.strip()
                if sp:
                    fr = sorted(glob.glob(os.path.join(
                        cfg.vimeo_data_path, "sequences", sp, "*.png")))
                    if len(fr) >= 3:
                        self.clips.append(fr)

    def __len__(self):
        return len(self.clips)

    def sample(self, idx: int, rng: random.Random):
        clip = self.clips[idx]
        frange = [0, 2, 1] if rng.randint(0, 1) else [2, 0, 1]
        frames = np.stack([imread_bgr(clip[i]) for i in frange], 0)
        ps = self.cfg.patch_size
        ih, iw = frames.shape[1:3]
        if ih >= ps and iw >= ps:
            ix = rng.randrange(0, iw - ps + 1)
            iy = rng.randrange(0, ih - ps + 1)
            frames = frames[:, iy:iy + ps, ix:ix + ps]
        if rng.random() < 0.5:
            frames = frames[:, :, ::-1]
        frames = np.rot90(frames, rng.randint(0, 3), (1, 2))
        return frames_to_tensor(np.ascontiguousarray(frames)), 0.5


def get_train_dataset(cfg: FLDRConfig):
    """The training set cfg.dataset names: X-Train for X4K1000FPS, Inter4K
    for Inter4K*, else the Vimeo triplets."""
    if cfg.dataset == "X4K1000FPS":
        return XTrain(cfg)
    if cfg.dataset.startswith("Inter4K"):
        return Inter4KTrain(cfg)
    return VimeoTrain(cfg)
