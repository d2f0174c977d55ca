"""Inference pipeline: frames → pad → pyramid → forward (counterpart of
fldrx/eval/pipeline.py, without jit: PyTorch runs eagerly).

Test-time preprocessing as in the reference's main.py:833-867:
reflect-pad to (2^S_tst)·8 divisibility, a bicubic pyramid with scale factor
8/s_i, forward without gradients, crop to the original size.

Spans (utils/trace.py; recorded only while a profiler runs): `flow`, a new
request, over `precompute_flow` with its stages `ingest` (the host-to-
device copy, normalisation and padding), `pyramid`, `features` and
`levels` (model/fldrnet.py) and `extras`; `synth` (attribute `n_t`) over
each `synthesize_multi_at`, with the synthesis stages inside.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import FLDRConfig
from ..model.fldrnet import (dtype_of, flow_extras, forward_flow,
                             forward_synthesis, forward_synthesis_multi,
                             forward_test)
from ..ops.pad import pad_frames
from ..ops.repack import planes_to_plain_np
from ..ops.resize import resize_2d
from ..utils import trace


def build_pyramid(frames: torch.Tensor, cfg: FLDRConfig, n_levels: int):
    """frames [B, 2, H, W, C] (already padded) → list of levels; level i is
    a bicubic downscale by 8/scales[i], always directly from full res."""
    B, T, H, W, C = frames.shape
    pyr = [frames]
    flat = frames.reshape(B * T, H, W, C)
    for i in range(1, n_levels):
        f = cfg.scales[0] / cfg.scales[i]
        oh, ow = int(H * f), int(W * f)
        lev = resize_2d(flat, (oh, ow), "bicubic", cfg.align_corners)
        pyr.append(lev.reshape(B, T, oh, ow, C))
    return pyr


def to_model_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 frames → float32 in [-1,1]; float frames pass through."""
    if frames.dtype == torch.uint8:
        return (frames.float() / 255.0 - 0.5) * 2.0
    return frames


class Interpolator:
    """User-facing engine: holds parameters, configuration and device.

    frames: [B, 2, H, W, 3] float in [-1,1], or uint8 (normalised on the
    device). On a CUDA device TF32 is turned off for float32 matmuls and
    convs (torch.backends flags), so the float32 stages stay float32."""

    def __init__(self, params, cfg: FLDRConfig, device="cuda"):
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        self._compute_dtype = dtype_of(cfg.compute_dtype)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _ingest(self, frames) -> torch.Tensor:
        frames = torch.as_tensor(np.asarray(frames) if not torch.is_tensor(
            frames) else frames)
        if frames.dtype != torch.uint8:
            frames = frames.float()
        return frames.to(self.device)

    def _prepare(self, frames: torch.Tensor) -> torch.Tensor:
        """Normalised, padded frames, dense NHWC: padding can leave them
        channel-planar (F.pad on the card does), and the pyramid's resizes
        and the synthesis's kernels read dense frames best, so one copy a
        pair here spares a strided read or a copy in each of them."""
        frames = to_model_frames(frames)
        return pad_frames(frames, self.cfg.div_pad,
                          self.cfg.padding).contiguous()

    def __call__(self, frames, t) -> torch.Tensor:
        """Interpolate: returns [B, H, W, 3] at time(s) t [B, 1]."""
        frames = self._ingest(frames)
        B, _, H, W, _ = frames.shape
        t = torch.as_tensor(np.asarray(t, np.float32).reshape(B, 1),
                            device=self.device)
        with torch.inference_mode():
            padded = self._prepare(frames)
            pyr = build_pyramid(padded, self.cfg, self.cfg.S_tst + 1)
            return forward_test(self.params, self.cfg, pyr, t, orig_hw=(H, W),
                                compute_dtype=self._compute_dtype)

    def interpolate_np(self, frames, t) -> np.ndarray:
        return self(frames, t).cpu().numpy()

    # -- multi-t throughput mode: flow once per pair, synthesis per t ----

    def precompute_flow(self, frames):
        """frames [B,2,H,W,3] → (flow, padded_frames, extras); the padded
        frames dense NHWC."""
        with trace.span("flow", request=True):
            with trace.span("ingest"):
                frames = self._ingest(frames)
                with torch.inference_mode():
                    padded = self._prepare(frames)
            with torch.inference_mode():
                with trace.span("pyramid"):
                    pyr = build_pyramid(padded, self.cfg, self.cfg.S_tst + 1)
                flow = forward_flow(self.params, self.cfg, pyr,
                                    self._compute_dtype)
                with trace.span("extras"):
                    extras = flow_extras(self.params, self.cfg, flow, padded)
        return flow, padded, extras

    def synthesize_at(self, flow, padded_frames, t, orig_hw: Tuple[int, int],
                      extras=None) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(t, np.float32).reshape(
            flow.shape[0], 1), device=self.device)
        with torch.inference_mode():
            out = forward_synthesis(self.params, self.cfg, flow,
                                    padded_frames, t, precomputed=extras,
                                    compute_dtype=self._compute_dtype)
        return out[:, :orig_hw[0], :orig_hw[1]]

    def synthesize_multi_at(self, flow, padded_frames, t_values: Sequence,
                            orig_hw: Tuple[int, int], extras=None,
                            planes_out=None) -> torch.Tensor:
        """t_values: sequence of scalars → [T, B, H, W, 3] (cropped) or,
        with planes_out on the packed path, the u-planes [T, B, 4, H/4, W·3]
        (shape[-1] != 3; ops.repack.planes_to_plain_np unpacks them).
        planes_out=None takes cfg.planes_out; the evaluator asks for plain
        rows when it scores the frames on the device."""
        B = flow.shape[0]
        if planes_out is None:
            planes_out = self.cfg.planes_out
        with trace.span("synth", n_t=len(t_values)):
            ts = [torch.full((B, 1), float(tv), dtype=torch.float32,
                             device=self.device) for tv in t_values]
            with torch.inference_mode():
                out = forward_synthesis_multi(
                    self.params, self.cfg, flow, padded_frames, ts,
                    precomputed=extras, compute_dtype=self._compute_dtype,
                    planes_out=planes_out and orig_hw[0] % 4 == 0)
        if out.shape[-1] != 3:                          # u-planes
            return out[..., :orig_hw[0] // 4, :orig_hw[1] * 3]
        return out[:, :, :orig_hw[0], :orig_hw[1]]

    def interpolate_multi_np(self, frames, t_values) -> np.ndarray:
        """×N mode: one flow computation, then synthesis in chunks of
        cfg.t_chunk t values. Returns [len(t_values), B, H, W, 3]."""
        H, W = frames.shape[2], frames.shape[3]
        flow, padded, extras = self.precompute_flow(frames)
        chunk = max(1, self.cfg.t_chunk)
        outs = []
        for k in range(0, len(t_values), chunk):
            out = self.synthesize_multi_at(flow, padded,
                                           t_values[k:k + chunk], (H, W),
                                           extras).cpu().numpy()
            outs.append(planes_to_plain_np(out) if out.shape[-1] != 3
                        else out)
        return np.concatenate(outs, 0)
