"""The refine UNet's hand-written 3×3 conv (counterpart of
fldrx/ops/fastconv.py conv3x3_pixrows).

`conv3x3(x, w, b)`: 3×3, stride 1, pad 1 on NHWC `x` with OIHW `w` and
bias `b`; bf16 operands, f32 accumulation, f32 bias, output in the input
dtype. A CUDA tensor launches the kernel in csrc/conv3x3.cu (bf16 only;
built at first use, see ops/_build.py) or raises; a CPU tensor takes the
plain version, `F.conv2d` in float32 on the operands rounded to the input
dtype. `LAUNCHES` counts kernel launches.

The kernel's output carries no gradient, so on the card `conv3x3` raises
when grad mode is on and an input requires grad; training runs the refine
UNet in float32 through `F.conv2d`, off this kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fastwarp import refuse_grad

__all__ = ["conv3x3", "conv3x3_plain", "LAUNCHES"]

LAUNCHES = {"conv3x3": 0}


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Plain version of `conv3x3`."""
    xf = x.permute(0, 3, 1, 2).float()
    wf = w.to(x.dtype).float()
    y = F.conv2d(xf, wf, b.float(), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B,H,W,Cin], w [K,Cin,3,3], b [K] → [B,H,W,K] in x.dtype."""
    B, H, W, Cin = x.shape
    K = w.shape[0]
    if tuple(w.shape) != (K, Cin, 3, 3) or tuple(b.shape) != (K,):
        raise ValueError(f"conv3x3: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    devs = {x.device.type, w.device.type, b.device.type}
    if devs == {"cpu"}:
        return conv3x3_plain(x, w, b)
    if devs != {"cuda"}:
        raise ValueError(f"conv3x3: tensors on {sorted(devs)}")
    refuse_grad("conv3x3", "F.conv2d", x, w, b)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 kernel takes bfloat16, got {x.dtype}")
    x = x.contiguous()
    w_hwio = w.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    bf = b.float().contiguous()
    out = torch.empty((B, H, W, K), dtype=torch.bfloat16, device=x.device)
    lib = _build.library("conv3x3")
    err = lib.fldrx_conv3x3_bf16(
        x.data_ptr(), w_hwio.data_ptr(), bf.data_ptr(), out.data_ptr(),
        B, H, W, Cin, K, torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["conv3x3"] += 1
    _build.check(err, "conv3x3")
    return out
