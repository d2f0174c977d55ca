"""Host metrics in numpy, copies of fldrx/ops/metrics.py: PSNR with
skimage.peak_signal_noise_ratio semantics (data_range 255), the XVFI RMSE
form, and SSIM on the Y channel of BGR images with skimage's defaults
(uniform 7×7 window, K1=0.01, K2=0.03, sample covariance, valid crop), as
the reference evaluates them (utils.py:644-710).

The functions work in place on one buffer where fldrx does, in the same
order of operations, so each value equals fldrx's bit for bit. SSIM runs
in float32 (fldrx's default; scipy's filter accumulates in double).
ops/metrics_torch.py computes the same PSNR and SSIM on the card.
"""

from __future__ import annotations

import numpy as np

__all__ = ["denorm255", "psnr", "psnr_xvfi", "rgb2ycbcr", "to_uint8",
           "ssim_gray", "ssim_bgr"]

# BT.601 Y coefficients for BGR channel order (utils.py:691-710)
TY_BGR = (0.097905882352941, 0.504129411764706, 0.256788235294118)


def denorm255(x: np.ndarray) -> np.ndarray:
    """[-1,1] → [0,255] with clipping (reference utils.py:685-688)."""
    y = x + 1.0
    y /= 2.0
    np.clip(y, 0.0, 1.0, out=y)
    y *= 255.0
    return y


def to_uint8(x: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """Rescale [vmin, vmax] to [0, 255], round half to even and clip; the
    values of a uint8 image, kept float32."""
    x = x.astype(np.float32)
    x -= vmin
    x /= np.float32(vmax - vmin)
    x *= 255
    np.round(x, out=x)
    np.clip(x, 0, 255, out=x)
    return x


def _mse(img_true: np.ndarray, img_pred: np.ndarray) -> float:
    """Mean squared error, float64 accumulator; float32 elementwise work
    unless an input is float64 (exact for integer-valued inputs)."""
    a = np.asarray(img_true)
    b = np.asarray(img_pred)
    if a.dtype == np.float64 or b.dtype == np.float64:
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        np.square(d, out=d)
        return float(np.mean(d))
    d = np.subtract(a, b, dtype=np.float32)
    np.square(d, out=d)
    return float(np.mean(d, dtype=np.float64))


def psnr(img_true: np.ndarray, img_pred: np.ndarray,
         data_range: float = 255.0) -> float:
    """skimage.peak_signal_noise_ratio equivalent."""
    mse = _mse(img_true, img_pred)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10((data_range ** 2) / mse))


def psnr_xvfi(img_true: np.ndarray, img_pred: np.ndarray) -> float:
    """The --XVFIPSNR RMSE formula (utils.py:654-659)."""
    rmse = np.sqrt(_mse(img_true, img_pred))
    if rmse == 0:
        return float("inf")
    return float(20 * np.log10(255.0 / rmse))


def rgb2ycbcr(img: np.ndarray, max_val: float = 255.0) -> np.ndarray:
    """BT.601 RGB→YCbCr, constants from utils.py:691-710."""
    O = np.array([16.0, 128.0, 128.0])
    T = np.array([
        [0.256788235294118, 0.504129411764706, 0.097905882352941],
        [-0.148223529411765, -0.290992156862745, 0.439215686274510],
        [0.439215686274510, -0.367788235294118, -0.071427450980392],
    ])
    if max_val == 1:
        O = O / 255.0
    return img @ T.T + O


try:
    from scipy.ndimage import uniform_filter as _scipy_uniform_filter
except ImportError:                              # pragma: no cover
    _scipy_uniform_filter = None


def _uniform_filter_valid(x: np.ndarray, w: int) -> np.ndarray:
    """Mean over w×w windows, valid interior (skimage filters the whole
    image, then crops (w−1)/2 on each side). scipy's moving-sum filter where
    scipy is installed, else a float64 integral image."""
    if _scipy_uniform_filter is not None:
        p = w // 2
        f = _scipy_uniform_filter(x, size=w, mode="constant")
        return f[p:x.shape[0] - p, p:x.shape[1] - p]
    c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0)), mode="constant"),
                            axis=0), axis=1)
    s = c[w:, w:] - c[:-w, w:] - c[w:, :-w] + c[:-w, :-w]
    return s / (w * w)


def ssim_gray(im1: np.ndarray, im2: np.ndarray, data_range: float,
              win_size: int = 7, K1: float = 0.01, K2: float = 0.03,
              dtype=np.float64) -> float:
    """skimage structural_similarity for 2-D float images with its
    defaults (uniform window, sample covariance, crop)."""
    im1 = np.asarray(im1, dtype)
    im2 = np.asarray(im2, dtype)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)
    ux = _uniform_filter_valid(im1, win_size)
    uy = _uniform_filter_valid(im2, win_size)
    buf = im1 * im1
    uxx = _uniform_filter_valid(buf, win_size)
    np.multiply(im2, im2, out=buf)
    uyy = _uniform_filter_valid(buf, win_size)
    np.multiply(im1, im2, out=buf)
    uxy = _uniform_filter_valid(buf, win_size)
    uxux = ux * ux
    uyuy = uy * uy
    uxuy = ux * uy
    vx = uxx
    vx -= uxux
    vx *= cov_norm
    vy = uyy
    vy -= uyuy
    vy *= cov_norm
    vxy = uxy
    vxy -= uxuy
    vxy *= cov_norm
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1 = uxuy                 # 2·ux·uy + C1 (×2 is exact)
    A1 *= 2
    A1 += C1
    A2 = vxy                  # 2·vxy + C2
    A2 *= 2
    A2 += C2
    B1 = uxux
    B1 += uyuy
    B1 += C1
    B2 = vx
    B2 += vy
    B2 += C2
    S = A1
    S *= A2
    B1 *= B2
    S /= B1
    return float(S.mean())


def ssim_bgr(img_true: np.ndarray, img_pred: np.ndarray) -> float:
    """SSIM on the Y channel of HWC BGR images in [0,255]
    (utils.py:662-669), in float32; data_range is the prediction's Y
    range."""
    dt = np.float32
    ty_bgr = np.array(TY_BGR, dt)

    def y_of(img):
        y = to_uint8(img, 0, 255) @ ty_bgr
        y += dt(16.0)
        return y

    y_true = y_of(img_true)
    y_pred = y_of(img_pred)
    dr = float(y_pred.max()) - float(y_pred.min())
    return ssim_gray(y_true, y_pred, data_range=dr, dtype=dt)
