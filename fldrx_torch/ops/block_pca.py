"""Learned block-PCA ("fLDR") features: the in-graph transform
`to_pca_diff` (reference pca_comp.py:473-528) as in fldrx/ops/block_pca.py
(its default 'legacy' layout): 8×8 blocking, (x − Mean)·EVᵀ, / meanVec,
min-max to [-1,1]; the one-time fit `fit_block_pca` that training
runs on its first batch (host numpy in float64, as fldrx fits); and its
inverse `pca_inverse`, which the PCA diagnostics use.

Channel order (checkpoint contract): feature channel = c·2nf + t·nf + comp.
The min-max uses `amin`/`amax`, whose gradient splits evenly among tied
extremes, as jnp.min/jnp.max do. A caller whose batch is split over
devices passes `minmax`, which returns the whole batch's extremes
(parallel/distributed.py, parallel/spatial.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["block_pca_features", "blocks_from_images", "fit_block_pca",
           "pca_inverse", "pca_projection", "PCAState"]


@dataclasses.dataclass
class PCAState:
    """Result of the one-time PCA fit."""
    mean: np.ndarray              # [wiS²]
    eigenvectors: np.ndarray      # [n_comp, wiS²]
    mean_vec: np.ndarray          # [n_comp], mean |component|
    eigenvalues: Optional[np.ndarray] = None


def fit_block_pca(images: np.ndarray, n_components: int,
                  wiS: int = 8) -> PCAState:
    """PCA of the wiS×wiS blocks of images [N, H, W] (each channel/frame
    one image), in float64 on the host: the top right singular vectors of
    the centred blocks, and the mean |component| of the projection."""
    images = np.asarray(images, dtype=np.float64)
    N, H, W = images.shape
    hb, wb = H // wiS, W // wiS
    b = images.reshape(N, hb, wiS, wb, wiS).transpose(0, 1, 3, 2, 4)
    data = b.reshape(-1, wiS * wiS)
    mean = data.mean(axis=0)
    centred = data - mean
    _, s, vt = np.linalg.svd(centred, full_matrices=False)
    ev = vt[:n_components, :]
    transformed = centred @ ev.T
    mean_vec = np.abs(transformed).mean(axis=0)
    eigenvalues = (s ** 2) / data.shape[0]
    return PCAState(mean=mean, eigenvectors=ev, mean_vec=mean_vec,
                    eigenvalues=eigenvalues)


def blocks_from_images(x: torch.Tensor, wiS: int = 8) -> torch.Tensor:
    """[..., H, W] → [..., hb, wb, wiS·wiS], each block read row-major."""
    *lead, H, W = x.shape
    hb, wb = H // wiS, W // wiS
    x = x.reshape(*lead, hb, wiS, wb, wiS)
    x = x.movedim(-3, -2)
    return x.reshape(*lead, hb, wb, wiS * wiS)


def pca_projection(frames: torch.Tensor, mean: torch.Tensor,
                   ev: torch.Tensor, mean_vec: torch.Tensor,
                   wiS: int = 8) -> torch.Tensor:
    """frames [B, 2, H, W, C] → the block-PCA components before the min-max,
    [B, H/wiS, W/wiS, C·2·nf] float32."""
    B, T, H, W, C = frames.shape
    if T != 2:
        raise ValueError(f"expected two frames, got {T}")
    x = frames.float()
    nf = ev.shape[0]
    hb, wb = H // wiS, W // wiS
    xc = x.permute(0, 4, 1, 2, 3)                       # [B,C,2,H,W]
    b = blocks_from_images(xc, wiS)                     # [B,C,2,hb,wb,64]
    proj = torch.einsum("...k,nk->...n", b - mean.float(), ev.float())
    proj = proj / mean_vec.float()                      # [B,C,2,hb,wb,nf]
    return proj.permute(0, 3, 4, 1, 2, 5).reshape(B, hb, wb, C * 2 * nf)


def block_pca_features(frames: torch.Tensor, mean: torch.Tensor,
                       ev: torch.Tensor, mean_vec: torch.Tensor,
                       wiS: int = 8,
                       per_item_minmax: bool = False,
                       minmax: Optional[Callable] = None) -> torch.Tensor:
    """frames [B, 2, H, W, C] in [-1,1] → [B, H/wiS, W/wiS, C·2·nf] float32,
    min-max normalised to [-1,1] over the whole batch (the reference), or
    over each batch item with `per_item_minmax`. `minmax(feat)` → (min,
    max), if given, supplies the batch's extremes where `frames` is only
    a part of the batch; it is not used with `per_item_minmax`."""
    feat = pca_projection(frames, mean, ev, mean_vec, wiS)
    B = feat.shape[0]
    if per_item_minmax:
        flat = feat.reshape(B, -1)
        mi = flat.amin(1).view(B, 1, 1, 1)
        ma = flat.amax(1).view(B, 1, 1, 1)
    elif minmax is not None:
        mi, ma = minmax(feat)
    else:
        mi = feat.amin()
        ma = feat.amax()
    feat = (feat - mi) / (ma - mi)
    return feat * 2.0 - 1.0


def pca_inverse(feats: torch.Tensor, mean: torch.Tensor, ev: torch.Tensor,
                mean_vec: Optional[torch.Tensor] = None, wiS: int = 8,
                minmax: Optional[tuple] = None) -> torch.Tensor:
    """Components → blocks → image, the inverse of the block-PCA transform
    (the diagnostics path), in float32 with a full-precision product.

    feats [..., hb, wb, n_comp] of one channel image; `minmax` (mi, ma)
    first undoes the [-1,1] normalisation, `mean_vec` the mean-|component|
    scaling. Returns [..., hb·wiS, wb·wiS]."""
    x = torch.as_tensor(feats).float()
    if minmax is not None:
        mi, ma = minmax
        x = (x + 1.0) * 0.5 * (ma - mi) + mi
    if mean_vec is not None:
        x = x * torch.as_tensor(mean_vec, device=x.device).float()
    ev = torch.as_tensor(ev, device=x.device).float()
    # full float32, as fldrx's Precision.HIGHEST, whatever the caller set
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        blocks = torch.einsum("...n,nk->...k", x, ev)
    finally:
        torch.set_float32_matmul_precision(prec)
    blocks = blocks + torch.as_tensor(mean, device=x.device).float()
    *lead, hb, wb, _ = blocks.shape
    blocks = blocks.reshape(*lead, hb, wb, wiS, wiS).movedim(-2, -3)
    return blocks.reshape(*lead, hb * wiS, wb * wiS)
