"""The deploy configuration and synthetic frames of bench.py (`bench.py:86-138`),
shared by chip_smoke.py and tools/profile_pair so both run the same path on
the same content; and training batches of the same texture for the train
step (chip_smoke.py phase 5, profile_pair --train, the CPU tests)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .config import FLDRConfig, papermodel, papermodel_test5

# bench.py's per-channel texture offsets within one frame
_CHANNEL_SHIFTS = ((0, 0), (9, 4), (3, 11))


def deploy_config() -> FLDRConfig:
    """bench.py's deploy mix: papermodel_test5 with a bf16 refine UNet, the
    float32 flow path, t chunks of 4 and the ×N synthesis returned as
    u-planes (planes_out, on by default)."""
    return papermodel_test5().replace(compute_dtype="bfloat16",
                                      flow_dtype="float32", t_chunk=4)


def train_config() -> FLDRConfig:
    """The papermodel training recipe as fldrx trains it: S_trn=3, batch 8,
    512×512 patches, float32, fast_warp_train."""
    return papermodel().replace(phase="train")


def texture(H: int, W: int,
            offsets: Sequence[Tuple[float, float]]) -> np.ndarray:
    """bench.py's band-limited texture seen at each (x, y) offset →
    float32 [len(offsets), H, W, 3] in about [-1, 1]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    def tex(px, py):
        return (np.sin((xx + px) / 17) * np.cos((yy + py) / 23)
                + 0.5 * np.sin((xx + py) / 5.3) * np.sin((yy + px) / 7.1)
                + 0.3 * np.sin((xx - px) / 61) * np.cos((yy + py) / 47))

    frames = [np.stack([tex(ox + sx, oy + sy) for sx, sy in _CHANNEL_SHIFTS],
                       -1) for ox, oy in offsets]
    return np.stack(frames, 0).astype(np.float32) * 0.6


def bench_frames(H: int, W: int) -> np.ndarray:
    """bench.py's naturalistic content: band-limited texture with a camera
    pan between the two frames, as uint8 [1, 2, H, W, 3]."""
    frames = texture(H, W, [(0, 0), (22, 13)])[None]
    return np.clip(np.round((frames + 1.0) * 127.5), 0, 255).astype(np.uint8)


def train_batch(size: int, t: np.ndarray, seed: int) -> dict:
    """A training batch of the bench texture: per sample a random phase
    and a pan p of up to 24 px each way; frame 0 at the phase, frame 1
    panned by p, the target by t·p. t [B, 1] in (0, 1). Returns the train
    step's batch {frames [B,2,S,S,3], target [B,S,S,3], t [B,1]}, float32."""
    t = np.asarray(t, np.float32).reshape(-1, 1)
    rng = np.random.RandomState(seed)
    frames, target = [], []
    for tb in t[:, 0]:
        ph = rng.uniform(0, 60, 2)
        pan = rng.uniform(-24, 24, 2)
        f = texture(size, size, [tuple(ph), tuple(ph + pan),
                                 tuple(ph + float(tb) * pan)])
        frames.append(f[:2])
        target.append(f[2])
    return {"frames": np.stack(frames, 0), "target": np.stack(target, 0),
            "t": t}
