"""The X-Train training clips and the frame decoding they need
(counterpart of fldrx/data/datasets.py `imread_bgr`, `frames_to_tensor` and
`XTrain`; the test sets and the native decoder are not ported yet).

Decoding uses PIL, imported at first use; PIL loads RGB and the frames are
flipped to BGR, the reference's cv2 order.
"""

from __future__ import annotations

import glob
import os
import random

import numpy as np

from ..config import FLDRConfig


def imread_bgr(path: str) -> np.ndarray:
    """uint8 HWC BGR."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)[..., ::-1]


def frames_to_tensor(frames: np.ndarray) -> np.ndarray:
    """[T,H,W,C] uint8 → [T,H,W,C] float32 in [-1,1], ((x/255 − 0.5)·2)
    in place on one buffer, in the reference's order of operations."""
    x = frames.astype(np.float32)
    x /= 255.0
    x -= 0.5
    x *= 2.0
    return x


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
