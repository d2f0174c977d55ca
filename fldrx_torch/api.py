"""Public inference API, signature parity with the reference's
run_on_your_images.py (counterpart of fldrx/api.py).

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU present and no explicit CPU request they raise rather than fall back.
PIL is imported only by `load_trans_frames` and for the `resfold` PNG.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .config import FLDRConfig, papermodel_test5
from .device import resolve_device
from .eval.pipeline import Interpolator
from .ops import metrics
from .weights import load_npz, params_from_numpy

DEFAULT_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints", "fldrnet_best.npz")


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def prepare_model(ckpt_path: str = DEFAULT_NPZ,
                  cfg: Optional[FLDRConfig] = None, device=None):
    """Build the papermodel+test5scales engine from the converted .npz
    checkpoint. Returns (interpolator, cfg, device)."""
    dev = resolve_device(device)
    cfg = cfg or papermodel_test5()
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
    tree, _, _ = load_npz(ckpt_path)
    return Interpolator(params_from_numpy(tree, dev), cfg, dev), cfg, dev


def load_trans_frames(im0_path: str, im1_path: str,
                      imt_path: Optional[str] = None) -> np.ndarray:
    """Load 2-3 images → [1, 2 or 3, H, W, 3] float32 in [-1,1], BGR order
    (the reference reads with cv2; PIL's RGB is flipped)."""
    from PIL import Image

    paths = [im0_path, im1_path] + ([imt_path] if imt_path else [])
    arrs = []
    for p in paths:
        a = np.asarray(Image.open(p).convert("RGB"), np.float32)[..., ::-1]
        arrs.append(a / 255.0 * 2.0 - 1.0)
    return np.stack(arrs, 0)[None]


def run_on_images(model: Interpolator, cfg_or_args, device, frames, t_value,
                  resfold: Optional[str] = None, evalit: bool = True):
    """Interpolate one frame (reference run_on_your_images.py:96-178).

    model: Interpolator from prepare_model(); device: where to run, which
    must be the model's device (None means the model's).
    frames: [B, C, T, H, W] (T=3: I0, I1, It or a dummy) or [B, T, H, W, C]
    — detected by the channel axis. t_value: [B, 1] in (0, 1).
    Returns the PSNR if evalit else 0; writes a PNG into resfold if given."""
    if device is not None and not _same_device(torch.device(device),
                                               model.device):
        raise ValueError(f"model is on {model.device}, asked to run on "
                         f"{device}")
    frames = np.asarray(frames, np.float32)
    if frames.ndim == 5 and frames.shape[1] in (1, 3) \
            and frames.shape[2] in (2, 3):
        frames = np.transpose(frames, (0, 2, 3, 4, 1))   # BCTHW → BTHWC
    gt = frames[:, -1] if (evalit and frames.shape[1] == 3) else None
    inputs = frames[:, :2]

    t = np.asarray(t_value, np.float32).reshape(-1, 1)
    pred = model.interpolate_np(inputs, t)               # [B,H,W,3]

    out_img = np.around(metrics.denorm255(pred[0]))
    if resfold:
        from PIL import Image
        os.makedirs(resfold, exist_ok=True)
        Image.fromarray(out_img[..., ::-1].astype(np.uint8)).save(
            os.path.join(resfold, f"{int(float(t[0]) * 8)}.png"))
    if evalit and gt is not None:
        return metrics.psnr(metrics.denorm255(gt[0]), out_img)
    return 0
