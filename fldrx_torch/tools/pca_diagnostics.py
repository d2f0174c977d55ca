"""Offline block-PCA diagnostics (counterpart of
fldrx/tools/pca_diagnostics.py, after the reference's pca_comp.py
analysis scripts): reconstruction PSNR over block sizes and component
fractions, fits carried across images, and how much of an image the
checkpoint's learned basis keeps.

The fits, blocks and components are host numpy in float64; the
reconstruction is `ops.block_pca.pca_inverse` in float32 on `device`
(default cuda).

Usage:
    python -m fldrx_torch.tools.pca_diagnostics [--device cpu] [image.png ...]
Without images it runs on three synthetic 512×512 images.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops.block_pca import blocks_from_images, fit_block_pca, pca_inverse
from ..ops.metrics import psnr


def _blocks(img: np.ndarray, wiS: int) -> np.ndarray:
    return blocks_from_images(torch.from_numpy(
        np.asarray(img, np.float64)), wiS).numpy()


def reconstruction_psnr(img: np.ndarray, wiS: int, n_comp: int, pca=None,
                        device=None):
    """(PSNR of `img` [H, W] in [0, 255] against its reconstruction from
    n_comp components of wiS×wiS blocks, the PCAState used). The fit is
    made on `img` unless `pca` is given."""
    dev = resolve_device(device)
    H = img.shape[0] // wiS * wiS
    W = img.shape[1] // wiS * wiS
    img = img[:H, :W]
    st = pca or fit_block_pca(img[None], n_comp, wiS)
    blocks = _blocks(img, wiS)
    hb, wb = blocks.shape[0], blocks.shape[1]
    t = (blocks.reshape(-1, wiS * wiS) - st.mean) @ st.eigenvectors.T
    rec = pca_inverse(torch.from_numpy(t.reshape(hb, wb, n_comp)).to(dev),
                      torch.from_numpy(st.mean), torch.from_numpy(
                          st.eigenvectors), wiS=wiS).cpu().numpy()
    return psnr(img, rec, data_range=255.0), st


def sweep(images, block_sizes=(4, 8, 16), fractions=(1 / 2, 1 / 4, 1 / 8),
          device=None):
    """[(wiS, fraction, n_comp, mean PSNR over `images`)] over block sizes
    and component fractions."""
    rows = []
    for wiS in block_sizes:
        for frac in fractions:
            n_comp = max(1, int(wiS * wiS * frac))
            vals = [reconstruction_psnr(im, wiS, n_comp, device=device)[0]
                    for im in images]
            rows.append((wiS, frac, n_comp, float(np.mean(vals))))
            print(f"wiS={wiS:2d} frac={frac:.3f} comps={n_comp:3d} "
                  f"PSNR={np.mean(vals):7.2f} dB")
    return rows


def cross_generalisation(images, wiS: int = 8, n_comp: int = 16,
                         device=None):
    """Fit on image 0 and reconstruct the others; their PSNRs."""
    _, st = reconstruction_psnr(images[0], wiS, n_comp, device=device)
    out = []
    for i, im in enumerate(images[1:], 1):
        p, _ = reconstruction_psnr(im, wiS, n_comp, pca=st, device=device)
        out.append(p)
        print(f"image {i}: cross-PCA reconstruction {p:.2f} dB")
    return out


def checkpoint_ev_reconstruction(images, ckpt_npz=None, wiS: int = 8):
    """PSNR of each image through the checkpoint's learned EVs. They are
    not orthonormal (the papermodel trains without the orthogonality loss),
    so the components are inverted with the pseudo-inverse: this measures
    what the learned subspace keeps."""
    from ..api import DEFAULT_NPZ
    from ..weights import load_npz

    params = load_npz(ckpt_npz or DEFAULT_NPZ)[0]
    mean = np.asarray(params["pca"]["mean"], np.float64)
    ev = np.asarray(params["pca"]["ev"], np.float64)
    out = []
    for i, img in enumerate(images):
        H = img.shape[0] // wiS * wiS
        W = img.shape[1] // wiS * wiS
        im = (np.asarray(img, np.float64)[:H, :W] / 255.0) * 2 - 1
        blocks = _blocks(im, wiS)
        hb, wb = blocks.shape[0], blocks.shape[1]
        t = (blocks.reshape(-1, wiS * wiS) - mean) @ ev.T
        rec = (t @ np.linalg.pinv(ev.T) + mean).reshape(
            hb, wb, wiS, wiS).transpose(0, 2, 1, 3).reshape(H, W)
        p = psnr((im + 1) * 127.5, (rec + 1) * 127.5, data_range=255.0)
        out.append(p)
        print(f"image {i}: checkpoint-EV reconstruction {p:.2f} dB")
    return out


def load_or_synth(paths):
    """Grey images [H, W] float64 in [0, 255]: the files at `paths`, or
    three synthetic 512×512 ones."""
    if paths:
        from PIL import Image
        return [np.asarray(Image.open(p).convert("L"), np.float64)
                for p in paths]
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:512, 0:512]
    return [np.sin(xx / 9.0 + k) * np.cos(yy / 13.0) * 100 + 128
            + rng.randn(512, 512) * 5 for k in range(3)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fldrx_torch.tools.pca_diagnostics")
    ap.add_argument("--device", default=None,
                    help="where pca_inverse runs (default cuda)")
    ap.add_argument("images", nargs="*")
    a = ap.parse_args(argv)
    images = load_or_synth(a.images)
    print("== reconstruction sweep ==")
    sweep(images, device=a.device)
    print("== cross-image generalisation (fit on image 0) ==")
    cross_generalisation(images, device=a.device)
    print("== checkpoint learned-EV reconstruction ==")
    checkpoint_ev_reconstruction(images)
    return 0


if __name__ == "__main__":
    sys.exit(main())
