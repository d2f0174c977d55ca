"""The benchmark's inputs, made from the seed on the device.

The texture is the band-limited pattern of the port's bench
(`fldrx_torch/bench_inputs.py` `texture`), rewritten in torch so that a 4K
clip is made on the card in a few calls: three sums of sines at periods of
5 to 61 pixels, each colour channel seen at its own small offset, so that
the content moves as one rigid picture when the offset changes.

Every random number comes from `numpy.random.default_rng(seed)`, which takes
any whole number of 64 bits; the seed draws a handful of offsets, and the
device computes the pixels from them. The same seed gives the same inputs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# the bench texture's per-channel offsets within one frame
CHANNEL_SHIFTS = ((0.0, 0.0), (9.0, 4.0), (3.0, 11.0))


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one kind of draw for `seed` (any whole number)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def texture(H: int, W: int, offsets: Sequence[Tuple[float, float]],
            device) -> torch.Tensor:
    """The texture seen at each (x, y) offset → float32 [N, H, W, 3] in
    about [-1, 1], computed on `device`."""
    off = torch.tensor(offsets, dtype=torch.float64).reshape(-1, 1, 2)
    sh = torch.tensor(CHANNEL_SHIFTS, dtype=torch.float64).reshape(1, 3, 2)
    # [N, 3] phases; float32 on the device from here on
    p = (off + sh).to(device=device, dtype=torch.float32)
    px = p[..., 0].reshape(-1, 1, 1, 3)
    py = p[..., 1].reshape(-1, 1, 1, 3)
    xx = torch.arange(W, device=device, dtype=torch.float32).reshape(1, 1, W, 1)
    yy = torch.arange(H, device=device, dtype=torch.float32).reshape(1, H, 1, 1)
    tex = (torch.sin((xx + px) / 17) * torch.cos((yy + py) / 23)
           + 0.5 * torch.sin((xx + py) / 5.3) * torch.sin((yy + px) / 7.1)
           + 0.3 * torch.sin((xx - px) / 61) * torch.cos((yy + py) / 47))
    return tex * 0.6


def to_uint8(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float → uint8, rounded as a decoder's 8-bit frame."""
    return torch.clamp(torch.round((frames + 1.0) * 127.5), 0, 255).to(
        torch.uint8)


def clip_offsets(seed: int, n_frames: int, motion: Sequence[float]):
    """The camera path of a clip: a random start, then per frame step a
    motion drawn per axis uniformly from [motion[0], motion[1]] pixels with
    a random sign. Returns n_frames (x, y) offsets."""
    g = rng(seed, 1)
    lo, hi = float(motion[0]), float(motion[1])
    start = g.uniform(0.0, 1000.0, 2)
    steps = g.uniform(lo, hi, (n_frames - 1, 2)) * g.choice(
        [-1.0, 1.0], (n_frames - 1, 2))
    path = np.concatenate([start[None], start[None] + np.cumsum(steps, 0)])
    return [tuple(map(float, p)) for p in path]


def make_clip(seed: int, H: int, W: int, n_frames: int,
              motion: Sequence[float], device) -> torch.Tensor:
    """A clip of uint8 frames [n_frames, H, W, 3] on `device`, made one
    frame at a time (a 4K float frame is 106 MB)."""
    out = torch.empty((n_frames, H, W, 3), dtype=torch.uint8, device=device)
    for i, off in enumerate(clip_offsets(seed, n_frames, motion)):
        out[i] = to_uint8(texture(H, W, [off], device))[0]
    return out


def train_specs(seed: int, n: int, phase_px: float, pan_px: float,
                t_range: Sequence[float]):
    """Per sample of n: (phase, pan, t), drawn as the port's train_batch
    draws them: a phase of up to phase_px, a pan of up to pan_px each way,
    t uniform in t_range."""
    g = rng(seed, 2)
    phase = g.uniform(0.0, phase_px, (n, 2))
    pan = g.uniform(-pan_px, pan_px, (n, 2))
    t = g.uniform(float(t_range[0]), float(t_range[1]), n)
    return phase, pan, t


def train_batch(phase, pan, t, size: int, device) -> dict:
    """A training batch of the texture: frame 0 at the phase, frame 1
    panned by the pan, the target by t·pan. Returns {frames [B,2,S,S,3],
    target [B,S,S,3], t [B,1]}, float32 on `device`."""
    offs = []
    for ph, pn, tb in zip(phase, pan, t):
        offs += [tuple(ph), tuple(ph + pn), tuple(ph + float(tb) * pn)]
    f = texture(size, size, offs, device).reshape(len(t), 3, size, size, 3)
    return {"frames": f[:, :2].contiguous(), "target": f[:, 2].contiguous(),
            "t": torch.tensor(np.asarray(t, np.float32).reshape(-1, 1),
                              device=device)}
