"""PWC-Net teacher calls, one after another: the program's
`get_bidirectional_flow(params, im0, im1)` (the reference's
MyPWC.get_flow) on batches of RGB pairs in [0, 1] that are on the card
already, as a training job that distils the teacher hands it its batch,
cycled from a pool; both directions a call.

Set-up makes the pool from the seed, draws the weights from the seed in
the benchmark's own code (`reference/pwcnet.init_weights` at the
configuration's widths: the trained checkpoint is not in the repository)
and hands that one tree to the program and, for the check, to the
reference, as a checkpoint would be handed to both; then the warm-up
calls.

The check compares the flows of `check_batches` of the window's own
calls, each one of its first CHECK_CALLS drawn from the seed (a window
too short to reach it goes on to it, untimed): they are copied to pinned
host memory there, on a side stream, beside the next call's kernels.

Traffic parameters: pool (batches), phase_px, pan_px, warmup_calls,
check_batches, trace_calls. The batch size and crop size are the
configuration's.
"""

from __future__ import annotations

import math
import time

import torch

from .. import inputs, work, work_teacher
from ..reference import pwcnet as reference
from . import Marks, segments, sync

# a flow vector is far off when its gap to the reference's exceeds this
# share of the reference flow's RMS: float32 rounding through the ≈40
# convs of a direction leaves an RMS gap under 1e-6 of it on the card and
# no vector past this, while a fault confined to part of the frame (the
# warp's border mask dropped moves a band along each level's frame edges)
# moves a few percent of the vectors past it, which the RMS gap dilutes
FAR_REL = 1e-3
CHECK_CALLS = 4
# the correlation kernels' names on the card (csrc/correlation.cu)
CORR_KERNEL = "correlation_kernel"
CORR_CALLS = 2                  # calls whose correlation kernels are timed


def gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The program's flows [B,H,W,4] against the reference's:
    teacher_flow_rel_gap, the RMS of the difference over the RMS of the
    reference's flow; teacher_flow_far_share, the share of flow vectors
    (two a pixel: flow_10 and flow_01) whose gap exceeds FAR_REL of that
    RMS. Infinite where the shapes differ or the gap is not finite."""
    if got.shape != want.shape:
        return {"teacher_flow_rel_gap": math.inf,
                "teacher_flow_far_share": math.inf}
    d = (got.float() - want.float()).double()
    rms = torch.sqrt(torch.mean(want.double() ** 2))
    rel = float(torch.sqrt(torch.mean(d ** 2)) / rms)
    if not math.isfinite(rel):
        return {"teacher_flow_rel_gap": math.inf,
                "teacher_flow_far_share": math.inf}
    far = d.reshape(-1, 2).norm(dim=1) > FAR_REL * rms
    return {"teacher_flow_rel_gap": rel,
            "teacher_flow_far_share": float(far.double().mean())}


class Driver:
    kind = "teacher"
    SPANS = ("teacher", "sync")

    def __init__(self, cell: dict, device, seed: int, control=None):
        """control: the configuration's "control" (None for the teacher as
        configured): "tf32" turns TF32 on, the call below float32."""
        self.cell, self.seed = cell, int(seed)
        self.dev = torch.device(device)
        self.tf32 = bool((control or {}).get("tf32", False))
        cfg = cell["config"]
        self.B, self.size = int(cfg["batch_size"]), int(cfg["crop_size"])
        self.spec = cfg["pwcnet"]
        g = inputs.rng(self.seed, 4)
        # the window's calls whose flows are compared
        self.check_at = sorted(int(i) for i in g.choice(
            CHECK_CALLS, int(cell["traffic"]["check_batches"]),
            replace=False))
        self.kept = {}
        self.layers = None
        self.side = (torch.cuda.Stream(self.dev) if self.dev.type == "cuda"
                     else None)

    def setup(self) -> None:
        from fldrx_torch.model.pwcnet import get_bidirectional_flow

        # the teacher is float32 with TF32 off; the control turns it on
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        tr = self.cell["traffic"]
        t_start = time.perf_counter()
        n = int(tr["pool"])
        phase, pan, t = inputs.train_specs(self.seed, n * self.B,
                                           tr["phase_px"], tr["pan_px"],
                                           (0.5, 0.5))
        self.pool = []
        for i in range(n):
            s = slice(i * self.B, (i + 1) * self.B)
            fr = inputs.train_batch(phase[s], pan[s], t[s], self.size,
                                    self.dev)["frames"]
            fr = torch.clamp((fr + 1.0) / 2.0, 0.0, 1.0)
            self.pool.append((fr[:, 0].contiguous(), fr[:, 1].contiguous()))
        parts = {"inputs_s": time.perf_counter() - t_start}
        self.params = reference.init_weights(self.seed, self.spec, self.dev)
        count = reference.check_tree(self.params, self.spec)
        if count != int(self.cell["config"]["parameters"]):
            raise ValueError(f"{count} parameters, the configuration "
                             f"states {self.cell['config']['parameters']}")
        parts["weights_s"] = time.perf_counter() - t_start - sum(
            parts.values())
        self.call = get_bidirectional_flow
        for i in range(int(tr["warmup_calls"])):
            flow = self.call(self.params, *self.pool[i % n])
            sync(self.dev)
            parts[f"call{i}_s"] = (time.perf_counter() - t_start
                                   - sum(parts.values()))
        # the host buffers the compared calls' flows are copied into
        self.host = {i: torch.empty(flow.shape, dtype=flow.dtype,
                                    pin_memory=self.side is not None)
                     for i in self.check_at}
        del flow
        parts["kept_s"] = time.perf_counter() - t_start - sum(parts.values())
        self.done = int(tr["warmup_calls"])
        self.setup_parts = parts

    def _keep(self, i: int, k: int, flow: torch.Tensor) -> None:
        """Window call i's flow (on pool batch k) into its host buffer, on
        the side stream after what the current stream has queued."""
        dst = self.host[i]
        if self.side is None:
            dst.copy_(flow)
        else:
            self.side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(self.side):
                dst.copy_(flow, non_blocking=True)
                flow.record_stream(self.side)
        self.kept[i] = (k, dst)

    def window(self, seconds: float, marks: Marks = None) -> dict:
        n = len(self.pool)
        sync(self.dev)
        calls, ends = 0, []
        t0 = time.perf_counter()
        while True:
            k = (self.done + calls) % n
            flow = self.call(self.params, *self.pool[k])
            if calls in self.host:
                self._keep(calls, k, flow)
            del flow
            calls += 1
            # the host's clock as each call returns (the device runs
            # behind it by what the call leaves queued)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        sync(self.dev)
        window_s = time.perf_counter() - t0
        # a window too short to reach a compared call (a test's, the
        # control's) goes on to it, untimed
        late = 0
        while len(self.kept) < len(self.host):
            i = calls + late
            k = (self.done + i) % n
            flow = self.call(self.params, *self.pool[k])
            if i in self.host:
                self._keep(i, k, flow)
            del flow
            late += 1
        self.done += calls + late
        res = {"requests": calls, "window_s": window_s,
               "e2e": {"samples_per_s": calls * self.B / window_s},
               "notes": dict(segments(ends, window_s), calls=calls,
                             calls_after_window=late,
                             call_ms=window_s * 1e3 / calls)}
        if marks:
            # corr_kernel_ms is filled in by release(), after the traced
            # windows: a profile before them slows their calls' spans
            self.layers = res["layers"] = {
                "call_wall_ms": window_s * 1e3 / calls,
                "trace_calls": self.trace_requests()}
        return res

    def corr_kernel_ms(self):
        """The correlation kernels' own device ms a call: CORR_CALLS more
        calls under a profiler of the device alone, the summed durations
        of the kernels named CORR_KERNEL over the calls. None off the card
        (the CPU runs the correlation's plain version, no kernel)."""
        if self.dev.type != "cuda":
            return None
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        sync(self.dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(CORR_CALLS):
                self.call(self.params,
                          *self.pool[(self.done + i) % len(self.pool)])
            sync(self.dev)
        self.done += CORR_CALLS
        us = sum(e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and CORR_KERNEL in e.name)
        return us * 1e-3 / CORR_CALLS if us else None

    def traced(self, n: int) -> None:
        from torch.profiler import record_function

        for i in range(n):
            with record_function("teacher"):
                self.call(self.params,
                          *self.pool[(self.done + i) % len(self.pool)])
        with record_function("sync"):
            sync(self.dev)
        self.done += n

    def trace_requests(self) -> int:
        return int(self.cell["traffic"]["trace_calls"])

    def work(self, peaks: dict) -> dict:
        stages = work_teacher.call_stages(
            work_teacher.geometry(self.cell["config"]))
        return {"compute_ms_per_request": work.compute_ms(
                    work.total_flops(stages), peaks),
                "corr_floor_ms": work.floor_ms(
                    [work_teacher.stage(stages, "corr")], peaks)}

    def release(self) -> None:
        if self.layers is not None:
            self.layers["corr_kernel_ms"] = self.corr_kernel_ms()
        self.pool = {k: self.pool[k] for k, _ in self.kept.values()}
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The kept flows, both directions, against the plain reference's
        (vfibench/reference/pwcnet.py) from the same weights on the same
        batch; the cell's limits name which of `gaps()`'s numbers are
        compared, each the worst over the compared calls."""
        sync(self.dev)                  # the side stream's copies too
        worst = {"teacher_flow_rel_gap": 0.0, "teacher_flow_far_share": 0.0}
        self.check_notes = []
        for i, (k, flow) in sorted(self.kept.items()):
            want = reference.bidirectional_flow(self.params, self.spec,
                                                *self.pool[k])
            got = gaps(flow.to(self.dev), want)
            self.check_notes.append(dict(got, call=i, batch=k, flow_rms_px=(
                float(torch.sqrt(torch.mean(want.double() ** 2))))))
            worst = {m: max(v, got[m]) for m, v in worst.items()}
        if not self.kept:
            worst = {m: math.inf for m in worst}
        return {m: (worst[m], lim) for m, lim in self.cell["limits"].items()}
