"""The PWC-Net cost volume and its hand-written kernel (counterpart of
fldrx/ops/correlation.py).

`correlation_cost_volume(f1, f2)` is the plain version: f1, f2 [B,H,W,C]
float32 → [B,H,W,81], output channel k = (dy+4)·9 + (dx+4) the channel mean
of f1 · f2[y+dy, x+dx] with zeros outside the frame, dy, dx in ±4.

`correlation(f1, f2)` dispatches on the tensors' device: a CUDA tensor
launches the kernel in csrc/correlation.cu (built at first use, see
ops/_build.py) or raises; a CPU tensor takes the plain version. The kernel
picks its tile and its number of channel groups from the frame, sums each
group's channels with fmaf in channel order, adds the groups in a fixed
order and multiplies by 1/C, where the plain version takes torch's mean:
the two agree to about 1e-6 relative. One launch per call; `LAUNCHES`
counts them.

Gradients: fldrx's kernel is forward only and its VJP differentiates the
plain formula (`_corr_vjp_bwd`). `correlation_diff` does the same: kernel
forward, the plain formula's VJP backward. The teacher runs without
gradients, under `torch.inference_mode()`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import trace
from . import _build
from .fastwarp import refuse_grad

__all__ = ["correlation", "correlation_cost_volume", "correlation_diff",
           "MAX_DISPLACEMENT", "LAUNCHES"]

MAX_DISPLACEMENT = 4
LAUNCHES = trace.counters("correlation", {"correlation": 0})


def correlation_cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                            max_disp: int = MAX_DISPLACEMENT) -> torch.Tensor:
    """Plain version of `correlation`."""
    B, H, W, C = f1.shape
    d = max_disp
    f2p = F.pad(f2, (0, 0, d, d, d, d))
    outs = [torch.mean(f1 * f2p[:, dy:dy + H, dx:dx + W], dim=-1)
            for dy in range(2 * d + 1) for dx in range(2 * d + 1)]
    return torch.stack(outs, dim=-1)


def _check(f1: torch.Tensor, f2: torch.Tensor, max_disp: int) -> None:
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation: f1 {tuple(f1.shape)}, f2 "
                         f"{tuple(f2.shape)}")
    if f1.device != f2.device:
        raise ValueError(f"correlation: f1 on {f1.device}, f2 on {f2.device}")
    if max_disp != MAX_DISPLACEMENT and f1.device.type == "cuda":
        raise ValueError(f"the correlation kernel takes max_disp "
                         f"{MAX_DISPLACEMENT}, got {max_disp}")


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_disp: int = MAX_DISPLACEMENT) -> torch.Tensor:
    """The cost volume of f1, f2 [B,H,W,C] float32 → [B,H,W,81]; on the
    card through the kernel."""
    _check(f1, f2, max_disp)
    if f1.device.type == "cpu":
        return correlation_cost_volume(f1, f2, max_disp)
    refuse_grad("correlation", "correlation_diff", f1, f2)
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise TypeError(f"the correlation kernel takes float32, got "
                        f"{f1.dtype}, {f2.dtype}")
    f1, f2 = f1.contiguous(), f2.contiguous()
    B, H, W, C = f1.shape
    out = torch.empty((B, H, W, (2 * max_disp + 1) ** 2),
                      dtype=torch.float32, device=f1.device)
    lib = _build.library("correlation")
    err = lib.fldrx_correlation_f32(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C,
        torch.cuda.current_stream(f1.device).cuda_stream)
    LAUNCHES["correlation"] += 1
    _build.check(err, "correlation")
    return out


class _CorrelationFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, max_disp):
        ctx.save_for_backward(f1, f2)
        ctx.max_disp = max_disp
        return correlation(f1, f2, max_disp)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        with torch.enable_grad():
            a = f1.detach().requires_grad_(ctx.needs_input_grad[0])
            b = f2.detach().requires_grad_(ctx.needs_input_grad[1])
            out = correlation_cost_volume(a, b, ctx.max_disp)
            wrt = [x for x in (a, b) if x.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (next(grads) if a.requires_grad else None,
                next(grads) if b.requires_grad else None, None)


def correlation_diff(f1: torch.Tensor, f2: torch.Tensor,
                     max_disp: int = MAX_DISPLACEMENT) -> torch.Tensor:
    """`correlation` with gradients to f1 and f2 (fldrx
    correlation_cost_volume_pallas): the kernel forward, the plain
    formula's VJP backward."""
    return _CorrelationFn.apply(f1, f2, max_disp)
