"""Flow colour-wheel images, the training pyramid grid and image writing
(copies of fldrx/eval/visualize.py; reference utils.py:902-1121). Host
numpy, with the port's resize for the grid's upscales; PIL is imported at
first use.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["make_color_wheel", "flow_to_image", "denorm_u8", "pyramid_grid",
           "save_image"]


def make_color_wheel() -> np.ndarray:
    """The Middlebury flow colour wheel (makecolorwheel, utils.py:1069)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray,
                  max_flow: Optional[float] = None) -> np.ndarray:
    """Flow [H,W,2] → uint8 RGB colour-wheel image (flow2img,
    utils.py:1024-1067)."""
    u = np.asarray(flow[..., 0], np.float64)
    v = np.asarray(flow[..., 1], np.float64)
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-5)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255
        col1 = wheel[k1, c] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img


def denorm_u8(x: np.ndarray) -> np.ndarray:
    return np.clip((np.asarray(x) + 1) / 2, 0, 1) * 255


def pyramid_grid(pred_pyramid: Sequence[np.ndarray],
                 flow_pyramid: Sequence[np.ndarray],
                 target: np.ndarray, mean_img: Optional[np.ndarray] = None,
                 n_rows: int = 4) -> np.ndarray:
    """The training visualisation grid (get_pyramid_images,
    utils.py:945-995): a column per pyramid level's prediction (bicubic
    upscale) and flow image (nearest upscale), then the target and the
    mean image; a row per batch item. Inputs NHWC in [-1,1]; returns uint8
    HWC BGR."""
    from ..ops.resize import resize_2d

    H, W = target.shape[1:3]
    cols: List[np.ndarray] = []
    for p in pred_pyramid:
        up = resize_2d(torch.as_tensor(np.asarray(p, np.float32)), (H, W),
                       "bicubic").numpy()
        cols.append(denorm_u8(up))
    for f in flow_pyramid:
        fl = np.asarray(f)
        imgs = np.stack([flow_to_image(fl[b, ..., :2])
                         for b in range(fl.shape[0])], 0).astype(np.float32)
        cols.append(resize_2d(torch.as_tensor(imgs), (H, W),
                              "nearest").numpy())
    cols.append(denorm_u8(target))
    if mean_img is not None:
        cols.append(denorm_u8(mean_img))
    n = min(n_rows, target.shape[0])
    grid = np.concatenate(
        [np.concatenate([c[b] for c in cols], axis=1) for b in range(n)],
        axis=0)
    return grid.astype(np.uint8)


def save_image(path: str, img_bgr_u8: np.ndarray) -> None:
    """Write a uint8 BGR image as PNG (PIL takes RGB)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.asarray(img_bgr_u8, np.uint8)[..., ::-1]).save(path)
