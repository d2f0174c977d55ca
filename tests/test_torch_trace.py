"""The port's spans and counters (fldrx_torch/utils/trace.py) on the CPU:
nothing records without a profiler; under one the stages nest as the
pipeline, the synthesis and the train step name them, one request a pair
or step; the counters are the LAUNCHES deltas; the store is bounded;
`ranges()` puts the spans on the profile; the span names are the stages
of vfibench/work.py; the benchmark's readers of the spans read numbers
from a traced run and None from an empty store; and
tools/profile_pair.py's busy time and idle-gap labels on a synthetic
event list."""

import glob
import os

import numpy as np
import pytest
import torch

from fldrx_torch.api import prepare_model
from fldrx_torch.bench_inputs import train_batch
from fldrx_torch.config import papermodel, papermodel_test5
from fldrx_torch.ops import _build, correlation, fastconv, fastwarp, repack
from fldrx_torch.tools import profile_pair
from fldrx_torch.train.trainer import TrainState, make_train_step
from fldrx_torch.utils import trace
from fldrx_torch.weights import load_npz, params_from_numpy
from vfibench import catalog, work

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (200, 300)                      # padded to 256×512: the plain synthesis
FLOW = {"flow", "flow/ingest", "flow/pyramid", "flow/features",
        "flow/levels", "flow/extras", "flow/extras/pack", "flow/extras/z"}
SYNTH = {"synth"} | {f"synth/{k}" for k in (
    "splat", "flowback", "gather", "refine_in", "unet", "blend")}


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def interp():
    return prepare_model(cfg=papermodel_test5(), device="cpu")[0]


def _frames(hw=HW, seed=0):
    return torch.as_tensor((np.random.RandomState(seed).rand(
        1, 2, *hw, 3) * 255).astype(np.uint8))


def _pair(interp, hw=HW, ts=(0.25, 0.5, 0.75), seed=0):
    flow, padded, extras = interp.precompute_flow(_frames(hw, seed))
    for k in range(0, len(ts), 2):
        interp.synthesize_multi_at(flow, padded, list(ts[k:k + 2]), hw,
                                   extras, planes_out=False)


@pytest.fixture(scope="module")
def train():
    cfg = papermodel().replace(S_trn=1, phase="train", batch_size=2,
                               patch_size=64)
    params = params_from_numpy(load_npz(os.path.join(
        ROOT, "checkpoints", "fldrnet_best.npz"))[0], "cpu")
    state = TrainState.create(params, cfg)
    batch = train_batch(64, np.full((2, 1), 0.5, np.float32), 0)
    step = make_train_step(cfg)
    return lambda: step(state, batch)


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def traced(interp, train):
    """The spans of a traced packed pair at 768×768 (the packed path's
    smallest frame) with three t values, and of a traced train step."""
    trace.clear()
    with _profile():
        _pair(interp, hw=(768, 768), ts=(0.25, 0.5, 0.75))
        train()
    spans = list(trace.RECORDER.spans)
    trace.clear()
    return spans


def _restore(monkeypatch, spans):
    monkeypatch.setattr(trace.RECORDER, "spans", list(spans))


def test_nothing_records_without_a_profiler(interp, train, monkeypatch):
    """With no profiler running, a pair and a train step make no span
    object and no profiler range, and leave the store empty."""
    def refuse(*a, **k):
        raise AssertionError("recorded with tracing off")

    monkeypatch.setattr(trace, "_Span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _pair(interp)
    train()
    assert trace.snapshot() == {} and trace.dropped() == 0


def test_pair_spans_nest_with_one_request_a_pair(interp):
    with _profile():
        _pair(interp, seed=1)
        _pair(interp, seed=2)
    snap = trace.snapshot()
    assert set(snap) == FLOW | SYNTH
    for path, row in snap.items():
        assert row["requests"] == 2, path
        assert set(row["by_request"]) == set(snap["flow"]["by_request"])
    assert snap["flow"]["calls"] == 2 and snap["synth"]["calls"] == 4
    assert snap["synth/unet"]["calls"] == 6             # a span a t
    assert snap["synth"]["n_t"] == 6
    assert [r["n_t"] for r in snap["synth"]["by_request"].values()] == [3, 3]
    # self time: the duration less the children's
    for top, kids in (("flow", FLOW), ("synth", SYNTH),
                      ("flow/extras", {"flow/extras/pack", "flow/extras/z"})):
        inner = sum(snap[k]["device_ms"] for k in kids
                    if k.count("/") == top.count("/") + 1
                    and k.startswith(top + "/"))
        assert snap[top]["self_device_ms"] == pytest.approx(
            snap[top]["device_ms"] - inner, abs=1e-9)
        assert 0 <= snap[top]["self_device_ms"] < snap[top]["device_ms"]
    # on the CPU the device interval is the host interval
    assert all(r["device_ms"] == r["host_ms"] > 0 for r in snap.values())


def test_packed_synthesis_names_its_stages(traced, monkeypatch):
    """At 768×768 the packed synthesis runs: its stages carry the same
    names, with the interleave into plain rows."""
    _restore(monkeypatch, traced)
    snap = trace.snapshot()
    pair = {p for p in snap if not p.startswith("train_step")}
    assert pair == FLOW | SYNTH | {"synth/interleave"}
    assert snap["synth/interleave"]["calls"] == 3
    assert snap["synth"]["n_t"] == 3 and snap["flow"]["requests"] == 1


def test_train_step_spans(train):
    with _profile():
        train()
        train()
    snap = trace.snapshot()
    top = {"train_step", "train_step/forward", "train_step/backward",
           "train_step/optimizer", "train_step/forward/features",
           "train_step/forward/levels"}
    assert top <= set(snap)
    assert all(p.startswith("train_step/forward/levels/")
               for p in set(snap) - top)
    assert snap["train_step"]["calls"] == 2
    assert snap["train_step"]["requests"] == 2
    assert snap["train_step/forward/levels/unet"]["calls"] == 4   # 2 levels


def test_counters_are_the_launch_deltas():
    """A top-level span keeps the launches its inside made, by kernel;
    launches outside any span are nobody's."""
    fastwarp.LAUNCHES["gather"] += 5
    with trace.recording():
        with trace.span("flow", request=True):
            fastwarp.LAUNCHES["gather"] += 3
            with trace.span("levels"):
                fastconv.LAUNCHES["conv3x3"] += 2
        fastwarp.LAUNCHES["splat"] += 1
        with trace.span("synth", n_t=1):
            fastwarp.LAUNCHES["splat"] += 4
    snap = trace.snapshot()
    assert snap["flow"]["launches"] == 5
    assert snap["flow"]["launches_by_kernel"] == {"fastwarp.gather": 3,
                                                 "fastconv.conv3x3": 2}
    assert snap["flow/levels"]["launches"] == 0
    assert snap["synth"]["launches_by_kernel"] == {"fastwarp.splat": 4}
    # the synthesis belongs to the request the flow began
    (req,) = snap["flow"]["by_request"]
    assert snap["synth"]["by_request"][req]["launches"] == 4
    assert trace.RECORDER.groups == {
        "fastwarp": fastwarp.LAUNCHES, "fastconv": fastconv.LAUNCHES,
        "correlation": correlation.LAUNCHES, "repack": repack.LAUNCHES}


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(trace.RECORDER, "cap", 3)
    with trace.recording():
        for _ in range(5):
            with trace.span("x"):
                pass
    assert trace.snapshot()["x"]["calls"] == 3 and trace.dropped() == 2
    trace.clear()
    assert trace.dropped() == 0 and trace.snapshot() == {}


def test_ranges_put_the_spans_on_the_profile():
    def names(use_ranges):
        with _profile() as prof:
            if use_ranges:
                with trace.ranges(), trace.span("outer"), \
                        trace.span("inner"):
                    torch.ones(4).sum()
            else:
                with trace.span("outer"), trace.span("inner"):
                    torch.ones(4).sum()
        return {e.name for e in prof.events()}

    assert {"outer", "inner"} <= names(True)
    assert not {"outer", "inner"} & names(False)


def test_span_names_are_the_work_counts_stages(traced, monkeypatch):
    """Each stage that vfibench/work.py counts is a span of the same name,
    so a stage's floor reads against its span."""
    _restore(monkeypatch, traced)
    snap = trace.snapshot()
    g = work.geometry({})
    flow = {s["name"] for s in work.flow_stages(g, 768, 768, 768, 768, 4)}
    synth = {s["name"] for s in work.synth_stages(g, 768, 768, 768, 768)}
    assert flow == {p.split("/")[1] for p in snap
                    if p.count("/") == 1 and p.startswith("flow/")}
    assert synth <= {p.split("/")[1] for p in snap if p.startswith("synth/")}


READERS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(ROOT, "vfibench", "metrics", "trace.*.py")))


def test_the_readers_are_the_benchmarks():
    assert len(READERS) == 20
    entries = catalog.layer_entries()
    assert sum(d["reader"] in READERS for d in entries.values()) == 29


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_run_and_none_from_an_empty_store(
        name, traced, monkeypatch):
    reader = catalog.load_metric(name)
    kind = "train" if reader.MOVES == "samples_per_s" else "infer"
    rec = {"kind": kind, "layers": {}, "work": None, "trace": None}
    monkeypatch.setitem(_build.BUILDS, "cached", 0)
    monkeypatch.setitem(_build.BUILDS, "built", 0)
    assert reader.read(rec) is None
    # a process that loaded its kernel libraries from the build directory
    monkeypatch.setitem(_build.BUILDS, "cached", 4)
    _restore(monkeypatch, traced)
    v = reader.read(rec)
    assert isinstance(v, float) and np.isfinite(v) and v >= 0, v
    if reader.UNIT == "ms":
        assert v > 0
    if name.startswith("trace.setup."):
        assert v == _build.BUILDS["compile_s"]
    else:
        other = dict(rec, kind="infer" if kind == "train" else "train")
        assert reader.read(other) is None


def test_build_counts(monkeypatch):
    """library() counts a build with the seconds it waited, or a library
    found built."""
    class Proc:
        returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILDS", {"built": 0, "compile_s": 0.0,
                                           "cached": 0})
    monkeypatch.setattr(_build.os, "replace", lambda a, b: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "prototypes", lambda name: {})
    for proc in (Proc(), None):
        monkeypatch.setattr(_build, "_start",
                            lambda name, p=proc: (p, "lib.so", "lib.tmp"))
        _build.library.cache_clear()
        _build.library("warp")
    _build.library.cache_clear()
    assert _build.BUILDS["built"] == 1 and _build.BUILDS["cached"] == 1
    assert _build.BUILDS["compile_s"] > 0


def test_profile_pair_busy_time_and_idle_gap_labels():
    """Overlapping operations count once; each gap is labelled by the
    spans around its middle, outermost first; the ranges' device copies
    are not operations."""
    W = profile_pair.WINDOW
    ops = [("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60), ("k4", 61, 100),
           ("k5", 130, 140)]
    spans = [(W, 0, 150), ("flow", 5, 70), ("ingest", 28, 45),
             ("synth", 70, 150)]
    assert profile_pair.busy_us(ops) == 20 + 10 + 39 + 10
    assert profile_pair.union([(1, 2), (2, 3), (5, 6)]) == [(1, 3), (5, 6)]
    host = [("cudaStreamSynchronize", 29, 49), ("aten::copy_", 28, 49),
            ("Activity Buffer Request", 1, 9)]
    gaps = profile_pair.idle_gaps(ops, spans, host)
    assert [g[0] for g in gaps] == ["synth", "flow/ingest", "flow", "synth",
                                    "flow"]
    assert [g[1] for g in gaps] == pytest.approx([0.03, 0.02, 0.01, 0.01,
                                                  0.001])
    # the host operation over most of each gap, the shorter on a tie
    assert [g[2] for g in gaps] == ["", "cudaStreamSynchronize",
                                    "Activity Buffer Request", "", ""]
    assert profile_pair.idle_gaps(ops, spans, host, top=2) == gaps[:2]

    class E:
        def __init__(self, name, dev, a, b):
            from torch.autograd import DeviceType
            self.name = name
            self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
            self.time_range = type("R", (), {"start": a, "end": b})

    class Prof:
        def events(self):
            return [E(W, False, 0, 150), E("flow", False, 5, 70),
                    E("flow", True, 6, 69), E("k1", True, 10, 20),
                    E("aten::add", False, 8, 9)]

    got_ops, got_spans, got_host = profile_pair.events(Prof(), {"flow"})
    assert got_ops == [("k1", 10, 20)]
    assert got_spans == [(W, 0, 150), ("flow", 5, 70)]
    assert got_host == [("aten::add", 8, 9)]
