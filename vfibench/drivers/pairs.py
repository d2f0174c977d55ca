"""×N interpolation of a clip, one pair at a time (the way `evaluate()`
and a video tool run): the program's Interpolator takes each pair's uint8
frames from pinned host memory, computes the flow once
(`precompute_flow`) and then the N − 1 frames in chunks of t_chunk t
values (`synthesize_multi_at`), as plain rows on the device. A pair is
done when its last frame is ready on the device; the next is handed over
then (a closed loop, one stream).

Traffic parameters: height, width, multiple, clip_frames, motion_px [lo,
hi], warmup_pairs, check_pairs (pairs of the clip compared with the
reference after the window, drawn from the seed), trace_pairs.

Each compared pair is compared at one of its occurrences in the window's
first CHECK_CYCLES passes over the clip, drawn from the seed (a window too
short to reach it goes on to it, untimed): its flow and
frames are copied to pinned host memory there, on a side stream (the copy
engine, beside the next pair's kernels), so the card holds no more than a
user's loop would. One copy a window: a copy at every occurrence (743 MB
at ×8 4K) slowed the pair after it and set the 95th percentile.
"""

from __future__ import annotations

import math
import os
import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import inputs, work
from . import Marks, fields_to_config, pinned, segments, sync

# a flow vector whose gap to the reference's exceeds this many pixels of
# the flow grid is far off: rounding flips a few where the texture
# repeats; a fault of a tile, a border or a halo moves a whole strip
FAR_PX = 0.25
CHECK_CYCLES = 4


class Driver:
    kind = "infer"
    SPANS = ("flow", "synth", "sync")

    def __init__(self, cell: dict, device, seed: int, control=None):
        """control: the configuration's "control" (None for the program as
        configured): its "overrides" switch the program's flow to the
        precision below, its "reference_unet": "int8" puts the reference
        with an int8 refine UNet in the program's place for the
        synthesis."""
        self.cell, self.seed = cell, int(seed)
        self.dev = torch.device(device)
        tr = cell["traffic"]
        self.H, self.W = int(tr["height"]), int(tr["width"])
        self.multiple = int(tr["multiple"])
        self.ts = [k / self.multiple for k in range(1, self.multiple)]
        control = control or {}
        self.unet_int8 = control.get("reference_unet") == "int8"
        self.fields = dict(cell["config"]["fldr_config"],
                           **control.get("overrides", {}))
        self.cfg = fields_to_config(self.fields)
        n = int(tr["clip_frames"]) - 1
        self.n_pairs = n
        g = inputs.rng(self.seed, 3)
        self.check_pairs = sorted(int(k) for k in g.choice(
            n, int(tr["check_pairs"]), replace=False))
        # the window's request that each compared pair is taken from
        self.check_at = {k + n * int(g.integers(CHECK_CYCLES)): k
                         for k in self.check_pairs}
        self.kept = {}
        self.side = (torch.cuda.Stream(self.dev) if self.dev.type == "cuda"
                     else None)

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from fldrx_torch.api import prepare_model

        tr = self.cell["traffic"]
        t_start = time.perf_counter()
        ckpt = os.path.join(self.cell["root"], self.cell["config"]["checkpoint"])
        self.interp, _, _ = prepare_model(ckpt_path=ckpt, cfg=self.cfg,
                                          device=self.dev)
        parts = {"program_s": time.perf_counter() - t_start}
        clip = inputs.make_clip(self.seed, self.H, self.W,
                                int(tr["clip_frames"]), tr["motion_px"],
                                self.dev)
        self.clip = pinned(clip)
        del clip
        # each pair a view of two consecutive frames, [1, 2, H, W, 3]
        self.pairs = [self.clip[k:k + 2].unsqueeze(0)
                      for k in range(self.n_pairs)]
        parts["inputs_s"] = time.perf_counter() - t_start - parts["program_s"]
        for i in range(int(tr["warmup_pairs"])):
            flow, outs, _ = self.run_pair(i % self.n_pairs)
            sync(self.dev)
            parts[f"warm{i}_s"] = (time.perf_counter() - t_start
                                   - sum(parts.values()))
        # the host buffers the compared pairs are copied into, shaped as a
        # pair's flow and chunks
        self.kept = {k: [torch.empty(x.shape, dtype=x.dtype,
                                     pin_memory=self.side is not None)
                         for x in [flow] + outs]
                     for k in self.check_pairs}
        del flow, outs
        parts["kept_s"] = time.perf_counter() - t_start - sum(parts.values())
        self.setup_parts = parts
        self.seen = set()

    def _keep(self, k: int, flow, outs) -> None:
        """Pair k's flow and chunks into its host buffers, on the side
        stream after what the current stream has queued."""
        srcs = [flow] + outs
        if self.side is None:
            for src, dst in zip(srcs, self.kept[k]):
                dst.copy_(src)
        else:
            self.side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(self.side):
                for src, dst in zip(srcs, self.kept[k]):
                    dst.copy_(src, non_blocking=True)
                    src.record_stream(self.side)
        self.seen.add(k)

    def run_pair(self, k: int, marks=None, spans=False):
        """Pair k through the program → (flow, [chunk outputs], marks):
        with `marks`, the device marks before, after the flow and after
        each chunk (else None); with spans, each call in a profiler
        span."""
        from torch.profiler import record_function

        interp, chunk = self.interp, max(1, self.cfg.t_chunk)
        m = [marks.mark()] if marks else None
        with record_function("flow") if spans else nullcontext():
            flow, padded, extras = interp.precompute_flow(self.pairs[k])
        if marks:
            m.append(marks.mark())
        outs = []
        for c in range(0, len(self.ts), chunk):
            with record_function("synth") if spans else nullcontext():
                outs.append(interp.synthesize_multi_at(
                    flow, padded, self.ts[c:c + chunk], (self.H, self.W),
                    extras))
            if marks:
                m.append(marks.mark())
        return flow, outs, m

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float, marks: Marks = None) -> dict:
        sync(self.dev)
        lat, stamps, ends = [], [], []
        i = 0
        t0 = time.perf_counter()
        while True:
            k = i % self.n_pairs
            ts = time.perf_counter()
            flow, outs, m = self.run_pair(k, marks)
            sync(self.dev)
            te = time.perf_counter()
            lat.append(te - ts)
            ends.append(te - t0)
            if m:
                stamps.append(m)
            if i in self.check_at:
                self._keep(k, flow, outs)
            del flow, outs
            i += 1
            if te - t0 >= seconds:
                break
        window_s = te - t0
        # a window too short to reach a compared request (a test's, the
        # control's) goes on to it, untimed: the answer is late, not lost
        late = 0
        while len(self.seen) < len(self.check_at):
            k = (i + late) % self.n_pairs
            flow, outs, _ = self.run_pair(k)
            if i + late in self.check_at:
                self._keep(k, flow, outs)
            del flow, outs
            late += 1
        frames = i * len(self.ts)
        res = {"requests": i, "window_s": window_s,
               "e2e": {"frames_per_s": frames / window_s,
                       "pair_p95_ms": float(np.percentile(lat, 95)) * 1e3},
               "notes": dict(segments(ends, window_s), pairs=i,
                             pairs_after_window=late,
                             pair_median_ms=float(np.median(lat)) * 1e3)}
        if marks:
            chunk = max(1, self.cfg.t_chunk)
            sizes = [len(self.ts[c:c + chunk])
                     for c in range(0, len(self.ts), chunk)]
            flow_ms = [marks.ms(m[0], m[1]) for m in stamps]
            synth = [sum(marks.ms(m[j], m[j + 1]) for j in range(1, len(m) - 1))
                     for m in stamps]
            res["layers"] = {
                "flow_ms": float(np.mean(flow_ms)),
                "synth_ms_per_t": float(np.sum(synth)) / (len(synth)
                                                          * sum(sizes)),
                "pair_wall_ms": window_s * 1e3 / i}
        return res

    def traced(self, n: int) -> None:
        from torch.profiler import record_function

        for i in range(n):
            self.run_pair(i % self.n_pairs, spans=True)
            with record_function("sync"):
                sync(self.dev)

    def trace_requests(self) -> int:
        return int(self.cell["traffic"]["trace_pairs"])

    # -- work counts ---------------------------------------------------------
    def work(self, peaks: dict) -> dict:
        g = work.geometry(self.fields)
        div = 2 ** self.cfg.S_tst * self.cfg.wiS
        Hp = self.H + (-self.H) % div
        Wp = self.W + (-self.W) % div
        flow_dt = self.cfg.flow_dtype or self.cfg.compute_dtype
        unet_dt = self.cfg.unet_dtype or self.cfg.compute_dtype
        flow = work.flow_stages(g, self.H, self.W, Hp, Wp, self.cfg.S_tst + 1,
                                flow_dt)
        synth = work.synth_stages(g, self.H, self.W, Hp, Wp, unet_dt)
        n_t = len(self.ts)
        flops = work.total_flops(flow)
        for k, v in work.total_flops(synth).items():
            flops[k] = flops.get(k, 0) + n_t * v
        return {"flow_floor_ms": work.floor_ms(flow, peaks),
                "synth_floor_ms_per_t": work.floor_ms(synth, peaks),
                "compute_ms_per_request": work.compute_ms(flops, peaks)}

    # -- the check -------------------------------------------------------------
    def release(self) -> None:
        del self.interp, self.pairs
        if self.side is not None:
            self.side.synchronize()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The kept pairs against the plain reference on the same uint8
        frames; the cell's limits name which of these numbers are compared
        (the rest go to the notes), each the worst over the pairs:

        - flow_p90_px (and flow_rms_px): the 90th percentile (the RMS) of
          the flow's gap, in pixels of the flow grid, to the reference's
          flow from the frames; where the texture repeats, a rounding-level
          change flips a few vectors, which the RMS weighs and the
          percentile does not;
        - flow_far_share: the share of the flow's vectors whose gap
          exceeds FAR_PX, which a fault confined to a strip of the grid
          (under a tenth of it, so the percentile misses it) raises;
        - frame_rel_gap: the pair's frames against the reference's synthesis
          from the flow the program returned (a rounding-level change of
          the flow moves the frames where the texture repeats, so a
          synthesis is judged from its own flow, and the flow above): the
          RMS gap over the RMS spread of the reference's blend (the six
          candidates about the frame, blend-weighted), pooled over the
          pair's frames; an error of the UNet's logits moves a frame in
          proportion to that spread, which differs from clip to clip."""
        from ..reference import convert, pipeline

        sd = convert.state_dict(
            os.path.join(self.cell["root"], self.cell["config"]["checkpoint"]),
            self.dev)
        geom = dict(work.geometry(self.fields), fast_warp=self.cfg.fast_warp,
                    packed_synth=self.cfg.packed_synth)
        worst = {k: 0.0 for k in ("flow_rms_px", "flow_p90_px",
                                  "flow_far_share", "frame_rel_gap")}
        self.check_notes = []
        for k in self.check_pairs:
            if k not in self.seen:          # the window never reached it
                worst = {n: math.inf for n in worst}
                continue
            flow, *outs = [x.to(self.dev) for x in self.kept[k]]
            pair = self.clip[k:k + 2].to(self.dev)
            ref_flow = pipeline.flow_pair(sd, pair, geom)
            frames = torch.cat([o.float() for o in outs], 0)[:, 0]
            if self.unet_int8:               # the control's synthesis
                frames = pipeline.synthesize_pair(sd, flow, pair, self.ts,
                                                  geom, unet_int8=True)
            spreads = []
            ref_frames = pipeline.synthesize_pair(sd, flow, pair, self.ts,
                                                  geom, spreads=spreads)
            if (flow.shape != ref_flow.shape
                    or frames.shape != ref_frames.shape):
                worst = {n: math.inf for n in worst}
                continue
            gap = (flow.float() - ref_flow).double()
            a = gap.abs().flatten()
            # the flow holds two vectors a grid point, (u, v) each
            far = gap.reshape(-1, 2).norm(dim=1) > FAR_PX
            got = {"flow_rms_px": float(torch.sqrt(torch.mean(a ** 2))),
                   "flow_p90_px": float(a.kthvalue(
                       max(1, round(a.numel() * 0.9))).values),
                   "flow_far_share": float(far.double().mean())}
            sq_gap = sq_spread = 0.0
            for j in range(frames.shape[0]):
                d = (frames[j] - ref_frames[j]).double()
                r = float(torch.sqrt(torch.mean(d ** 2)))
                sq_gap += r * r
                sq_spread += spreads[j] ** 2
                self.check_notes.append({
                    "pair": k, "t": self.ts[j], "rmse_8bit": r * 127.5,
                    "spread_8bit": spreads[j] * 127.5,
                    "max_8bit": float(d.abs().max()) * 127.5})
            got["frame_rel_gap"] = math.sqrt(sq_gap / sq_spread)
            self.check_notes.append(dict(got, pair=k))
            worst = {n: max(v, _finite(got[n])) for n, v in worst.items()}
        return {n: (worst[n], lim) for n, lim in self.cell["limits"].items()}


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf
