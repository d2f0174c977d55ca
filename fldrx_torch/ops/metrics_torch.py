"""PSNR and SSIM on the device — the counterpart of fldrx/ops/metrics_jax.py,
with the formulas of the host chain in ops/metrics.py (the evaluator's
metrics_job): out_img = round(denorm255(pred)), tgt_img = denorm255(target),
PSNR over data_range 255 (or the XVFI RMSE form), SSIM on the BT.601 Y of
BGR with a uniform 7×7 window, sample covariance, valid crop and
data_range = max(y_pred) − min(y_pred).

Two places follow the host arithmetic closely, so that the card agrees with
it to well under the reported 4 decimals:

- The 7×7 window means are local sums, never a global cumsum or integral
  image (fldrx measured 5.4e-4 of SSIM lost that way at 4K). They are
  separable, rows then columns, each pass summed in float64 and rounded to
  float32, as scipy's uniform_filter computes them on the host.
- Rounding is half to even (`torch.round`, as `np.around`), and divisions
  by 255 are true divisions (PyTorch's CUDA kernels turn division by a
  Python scalar into a multiply by its reciprocal).

The MSE is a float32 difference and square summed in float64, as on the
host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .metrics import TY_BGR

__all__ = ["psnr_ssim_frame", "psnr_ssim_frames", "make_chunk_metrics"]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division on every device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _denorm255(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0) * 255.0


def _y_of(img: torch.Tensor) -> torch.Tensor:
    """to_uint8(img, 0, 255) then the BT.601 Y of BGR, + 16: [T,H,W,3] →
    [T,H,W] float32."""
    x = torch.clamp(torch.round(_div(img, 255.0) * 255), 0, 255)
    return (x[..., 0] * TY_BGR[0] + x[..., 1] * TY_BGR[1]
            + x[..., 2] * TY_BGR[2] + 16.0)


def _window_mean(x: torch.Tensor, w: int) -> torch.Tensor:
    """Mean over w×w windows, valid interior, [T,H,W] → [T,H−w+1,W−w+1]:
    along H, then along W, each pass summed in float64 and rounded to
    float32."""
    x = x[:, None]
    x = F.avg_pool2d(x.double(), (w, 1), stride=1).float()
    x = F.avg_pool2d(x.double(), (1, w), stride=1).float()
    return x[:, 0]


def _ssim_y(y1: torch.Tensor, y2: torch.Tensor, data_range: torch.Tensor,
            win_size: int = 7, K1: float = 0.01, K2: float = 0.03):
    """Per-frame SSIM of [T,H,W] float32 images, ops in ops/metrics.py
    ssim_gray's order; data_range [T] float64."""
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)
    ux = _window_mean(y1, win_size)
    uy = _window_mean(y2, win_size)
    uxx = _window_mean(y1 * y1, win_size)
    uyy = _window_mean(y2 * y2, win_size)
    uxy = _window_mean(y1 * y2, win_size)
    uxux, uyuy, uxuy = ux * ux, uy * uy, ux * uy
    vx = (uxx - uxux) * cov_norm
    vy = (uyy - uyuy) * cov_norm
    vxy = (uxy - uxuy) * cov_norm
    C1 = ((K1 * data_range) ** 2).float()[:, None, None]
    C2 = ((K2 * data_range) ** 2).float()[:, None, None]
    S = ((uxuy * 2 + C1) * (vxy * 2 + C2)) / ((uxux + uyuy + C1)
                                                * (vx + vy + C2))
    return S.double().mean(dim=(1, 2))


def psnr_ssim_frames(preds: torch.Tensor, targets: torch.Tensor,
                     xvfi_psnr: bool = False):
    """(psnr [T], ssim [T]) float64 of preds [T,H,W,3] BGR float in [-1,1]
    against targets of the same shape, float in [-1,1] or uint8."""
    if targets.dtype == torch.uint8:      # the host's frames_to_tensor
        targets = (_div(targets.float(), 255.0) - 0.5) * 2.0
    out_img = torch.round(_denorm255(preds.float()))
    tgt_img = _denorm255(targets.float())
    d = tgt_img - out_img
    mse = (d * d).double().mean(dim=(1, 2, 3))
    if xvfi_psnr:
        p = 20.0 * torch.log10(255.0 / torch.sqrt(mse))
    else:
        p = 10.0 * torch.log10(255.0 ** 2 / mse)
    y_t, y_p = _y_of(tgt_img), _y_of(out_img)
    dr = (y_p.amax(dim=(1, 2)).double() - y_p.amin(dim=(1, 2)).double())
    return p, _ssim_y(y_t, y_p, dr)


def psnr_ssim_frame(pred: torch.Tensor, target: torch.Tensor,
                    xvfi_psnr: bool = False):
    """One frame's (psnr, ssim), 0-dim float64 tensors: pred, target
    [H,W,3] as in `psnr_ssim_frames`."""
    p, s = psnr_ssim_frames(pred[None], target[None], xvfi_psnr)
    return p[0], s[0]


def make_chunk_metrics(xvfi_psnr: bool = False):
    """(preds [T,H,W,3], targets [T,H,W,3]) → (psnr [T], ssim [T]), on the
    tensors' device and without gradients."""
    def fn(preds: torch.Tensor, targets: torch.Tensor):
        with torch.inference_mode():
            return psnr_ssim_frames(preds, targets, xvfi_psnr)
    return fn
