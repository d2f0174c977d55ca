"""The refine UNet's hand-written 3×3 conv (counterpart of
fldrx/ops/fastconv.py conv3x3_pixrows).

`conv3x3(x, w, b)`: 3×3, stride 1, pad 1 on NHWC `x` with OIHW `w` and
bias `b`; bf16 operands, f32 accumulation, f32 bias, output in the input
dtype. A CUDA tensor launches the tensor-core kernel in csrc/conv3x3.cu
(bf16 only; built at first use, see ops/_build.py) or raises; a CPU tensor
takes the plain version, `F.conv2d` in float32 on the operands rounded to
the input dtype. `LAUNCHES` counts kernel launches.

The kernel reads its weights packed per input-channel chunk and per block
of output channels (`pack_weights`), and its input with a channel count
that is a multiple of 8: the wrapper pads other counts with zero channels.

The kernel's output carries no gradient, so on the card `conv3x3` raises
when grad mode is on and an input requires grad; training runs the refine
UNet in float32 through `F.conv2d`, off this kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import trace
from . import _build
from .fastwarp import refuse_grad

__all__ = ["conv3x3", "conv3x3_plain", "block_n", "pack_weights", "LAUNCHES"]

LAUNCHES = trace.counters("fastconv", {"conv3x3": 0})

CHUNK = 16      # input channels per stage of the kernel (csrc/conv3x3.cu CC)


def block_n(K: int) -> int:
    """Output channels per block of the kernel for K output channels: all
    of them up to 96 (32, 64 or 96), else blocks of 64."""
    return 32 if K <= 32 else 64 if K <= 64 else 96 if K <= 96 else 64


def pack_weights(w: torch.Tensor, nb: int) -> torch.Tensor:
    """OIHW [K, Cin, 3, 3] → the kernel's bf16 layout
    [ceil(Cin/CHUNK), ceil(K/nb), 9, nb, CHUNK]: per input-channel chunk and
    output-channel block, the 9 taps (ky·3 + kx) of nb rows of CHUNK input
    channels, zero past K and Cin."""
    K, Cin = w.shape[:2]
    nkb, nch = -(-K // nb), -(-Cin // CHUNK)
    wp = torch.zeros((nkb * nb, nch * CHUNK, 3, 3), dtype=torch.bfloat16,
                     device=w.device)
    wp[:K, :Cin] = w
    return wp.view(nkb, nb, nch, CHUNK, 3, 3).permute(
        2, 0, 4, 5, 1, 3).contiguous().view(nch, nkb, 9, nb, CHUNK)


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
    if Cin % 8:
        x = F.pad(x, (0, 8 - Cin % 8))
    x = x.contiguous()
    nb = block_n(K)
    wp = pack_weights(w, nb)
    bf = b.float().contiguous()
    out = torch.empty((B, H, W, K), dtype=torch.bfloat16, device=x.device)
    lib = _build.library("conv3x3")
    err = lib.fldrx_conv3x3_bf16(
        x.data_ptr(), wp.data_ptr(), bf.data_ptr(), out.data_ptr(),
        B, H, W, x.shape[-1], K, nb,
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["conv3x3"] += 1
    _build.check(err, "conv3x3")
    return out
