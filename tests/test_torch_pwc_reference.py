"""The port's PWC-Net teacher against the benchmark's plain reference
(vfibench/reference/pwcnet.py) on the CPU, with no JAX: the whole
bidirectional call, the cost volume and the warp alone; the comparison
that decides the teacher_b8_512 cell's `correct` (0 on identical flows,
over its limits on planted faults); the cell's readers of the program's
spans from a traced call; and vfibench/work_teacher.py's flops against
FlopCounterMode on the reference.

Weights: the benchmark's own seeded draw, `reference/pwcnet.init_weights`
at the configuration's published widths (the trained checkpoint is not in
the repository), handed to both sides.

Tolerances: the whole call is a deep float32 conv stack whose convs run
NHWC-permuted in the port and NCHW in the reference, with the resizes as
dense matrix products against F.interpolate: sums in other orders, so the
flows agree to rounding (about 1e-6 relative here), held at relative L2
1e-5; the cost volume sums C float32 products in another order (rtol 1e-5,
atol 1e-6); the warp's sample positions are built in another order and
move by about 1e-6 px, so atol 1e-5 on unit-variance features.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fldrx_torch.model import pwcnet
from fldrx_torch.ops.correlation import correlation
from fldrx_torch.utils import trace
from vfibench import catalog, drivers, inputs, peaks, work, work_teacher
from vfibench.drivers import teacher_calls
from vfibench.reference import pwcnet as ref

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 9_876_543_210_123
H100 = peaks.peaks("NVIDIA H100 80GB HBM3")
READERS = sorted(n for n in catalog.names("metrics")
                 if n.startswith("trace_teacher."))
with open(os.path.join(ROOT, "vfibench", "configs",
                       "pwcnet_teacher.json")) as _f:
    CONFIG = json.load(_f)
SPEC = CONFIG["pwcnet"]


@pytest.fixture(scope="module")
def params():
    return ref.init_weights(3, SPEC)


def _pair(H, W, batch=2, seed=11):
    """RGB pairs in [0, 1] [batch, H, W, 3] twice: the cell's crops."""
    phase, pan, t = inputs.train_specs(seed, batch, 60, 24, (0.5, 0.5))
    fr = inputs.train_batch(phase, pan, t, max(H, W), "cpu")["frames"]
    fr = torch.clamp((fr + 1.0) / 2.0, 0.0, 1.0)[:, :, :H, :W]
    return fr[:, 0].contiguous(), fr[:, 1].contiguous()


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm())


def _tiny_cell(batch=2, size=64):
    """The teacher_b8_512 cell at a CPU test's size."""
    cell = catalog.load_cell("teacher_b8_512")
    cell["config"] = dict(cell["config"], batch_size=batch, crop_size=size)
    cell["traffic"] = dict(cell["traffic"], pool=2)
    return cell


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


# -- the whole call ---------------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 128), (72, 100)])
def test_teacher_matches_the_plain_reference(hw, params):
    """Batch 2 at a multiple of 64 and at a size that is not, so both
    resizes run: (flow_10, flow_01) within relative L2 1e-5."""
    im0, im1 = _pair(*hw)
    got = pwcnet.get_bidirectional_flow(params, im0, im1)
    want = ref.bidirectional_flow(params, SPEC, im0, im1)
    assert got.shape == want.shape == (2, *hw, 4)
    assert float(want.abs().max()) > 0
    assert _rel_l2(got, want) < 1e-5


def test_reference_leaves_tf32_as_it_was(params):
    """The reference turns TF32 off while it runs and puts the flags
    back."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        seen = []
        real = ref.forward

        def spy(*a):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return real(*a)

        with mock.patch.object(ref, "forward", spy):
            ref.bidirectional_flow(params, SPEC, *_pair(64, 64, batch=1))
        assert seen == [(False, False)] * 2
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- the weights ---------------------------------------------------------------

def test_the_benchmarks_weights_have_the_configurations_widths():
    """The draw gives the configuration's parameter count, the same tree
    for one seed and another for the next; the program's own init has the
    same layout (so its published widths are the configuration's)."""
    a, b = ref.init_weights(7, SPEC), ref.init_weights(7, SPEC)
    assert ref.check_tree(a, SPEC) == CONFIG["parameters"] == 9_374_274
    assert torch.equal(a["dec2"]["one"]["w"], b["dec2"]["one"]["w"])
    other = ref.init_weights(8, SPEC)
    assert not torch.equal(a["dec2"]["one"]["w"], other["dec2"]["one"]["w"])
    assert float(a["refiner"][0]["b"].abs().max()) > 0
    port = pwcnet.init_pwc_params(torch.Generator().manual_seed(0), "cpu")
    assert ref.check_tree(port, SPEC) == CONFIG["parameters"]


@pytest.mark.parametrize("change", ["width", "missing"])
def test_the_reference_refuses_a_tree_of_other_widths(change, params):
    bad = ref.init_weights(3, dict(SPEC, decoder=[128, 128, 96, 64, 16]))
    if change == "missing":
        bad = dict(params, refiner=params["refiner"][:-1])
    with pytest.raises(ValueError):
        ref.bidirectional_flow(bad, SPEC, *_pair(64, 64, batch=1))


# -- the cost volume and the warp alone --------------------------------------

@pytest.mark.parametrize("shape", [
    # the teacher's channel counts, dec2 to dec6, at small frames
    (2, 9, 10, 32), (1, 8, 9, 64), (1, 6, 7, 96), (1, 5, 6, 128),
    (2, 5, 5, 196),
    # a frame smaller than the ±4 displacement window
    (1, 3, 5, 32),
])
def test_cost_volume_matches_the_port(shape):
    g = torch.Generator().manual_seed(5)
    f1, f2 = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    got = correlation(f1, f2)
    want = ref.cost_volume(f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2),
                           SPEC["max_displacement"]).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (*shape[:3], 81)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 3.0, 8.0])
def test_backward_warp_matches_the_port(scale):
    """Flows of up to `scale` px push samples off the frame, so the mask
    zeroes a border band: the port's separable mask test and the
    reference's sampled ones agree there."""
    g = torch.Generator().manual_seed(int(scale * 10))
    x = torch.randn((2, 12, 17, 32), generator=g)
    flow = scale * torch.randn((2, 12, 17, 2), generator=g)
    got = pwcnet.backward_warp_pwc(x, flow)
    want = ref.backward_warp(x.permute(0, 3, 1, 2),
                             flow.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    zeroed = (want == 0).all(-1)
    assert 0 < float(zeroed.float().mean()) < 1
    assert torch.equal((got == 0).all(-1), zeroed)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- the check that decides `correct` --------------------------------------------

def test_check_numbers_are_zero_on_identical_flows(params):
    flow = pwcnet.get_bidirectional_flow(params, *_pair(64, 64))
    assert teacher_calls.gaps(flow, flow.clone()) == {
        "teacher_flow_rel_gap": 0.0, "teacher_flow_far_share": 0.0}
    inf = teacher_calls.gaps(flow[:1], flow)
    assert all(v == float("inf") for v in inf.values())


def _run_check(cell, seed=SEED, seconds=0.05):
    d = teacher_calls.Driver(cell, "cpu", seed)
    d.setup()
    d.window(seconds)
    d.release()
    return d.check()


def _half_batch(real):
    def call(params, im0, im1):
        n = max(1, im0.shape[0] // 2)
        half = real(params, im0[:n], im1[:n])
        return torch.cat([half] * (im0.shape[0] // n), 0)
    return call


def _mask_dropped(real):
    def gather(x, sx, sy, mask=False):
        return real(x, sx, sy, False)
    return gather


def _drifts_after(real, good_calls):
    """A teacher whose calls after the first `good_calls` come out 1%
    off: state carried from call to call, which warm-up calls alone do
    not show."""
    seen = []

    def call(params, im0, im1):
        seen.append(1)
        out = real(params, im0, im1)
        return out if len(seen) <= good_calls else out * 1.01
    return call


def test_the_sound_cell_is_correct():
    checks = _run_check(_tiny_cell())
    assert set(checks) == {"teacher_flow_rel_gap", "teacher_flow_far_share"}
    assert all(v <= lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("fault", ["half_batch", "mask_dropped",
                                   "drifts_after_warmup"])
def test_planted_faults_fail_the_check(fault):
    """A call that computes half its batch and repeats it, a warp that
    drops its border mask, and a teacher that drifts once the warm-up
    calls are done, each fail at least one of the cell's limits."""
    real = pwcnet.get_bidirectional_flow
    if fault == "half_batch":
        patch = mock.patch.object(pwcnet, "get_bidirectional_flow",
                                  _half_batch(real))
    elif fault == "drifts_after_warmup":
        warm = _tiny_cell()["traffic"]["warmup_calls"]
        patch = mock.patch.object(pwcnet, "get_bidirectional_flow",
                                  _drifts_after(real, warm))
    else:
        patch = mock.patch.object(pwcnet, "gather_diff",
                                  _mask_dropped(pwcnet.gather_diff))
    with patch:
        checks = _run_check(_tiny_cell())
    assert any(v > lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("seed", [SEED, 2_147_483_647, 5])
@pytest.mark.parametrize("seconds", [0.0, 0.5])
def test_the_compared_flow_is_a_window_calls(seed, seconds):
    """The compared call is one of the window's first CHECK_CALLS, drawn
    from the seed, on the pool batch that call ran; a window too short to
    reach it goes on to it, untimed; its kept flow is that call's."""
    cell = _tiny_cell()
    d = teacher_calls.Driver(cell, "cpu", seed)
    assert d.check_at == teacher_calls.Driver(cell, "cpu", seed).check_at
    (i,) = d.check_at
    assert 0 <= i < teacher_calls.CHECK_CALLS
    d.setup()
    win = d.window(seconds)
    assert win["requests"] + win["notes"]["calls_after_window"] > i
    assert set(d.kept) == {i}
    k, flow = d.kept[i]
    n = cell["traffic"]["pool"]
    assert k == (cell["traffic"]["warmup_calls"] + i) % n
    assert torch.equal(flow, pwcnet.get_bidirectional_flow(d.params,
                                                          *d.pool[k]))


# -- spans and readers ------------------------------------------------------------

def test_spans_are_off_without_a_profiler(params, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("recorded with tracing off")

    monkeypatch.setattr(trace, "_Span", refuse)
    pwcnet.get_bidirectional_flow(params, *_pair(64, 64, batch=1))
    assert trace.snapshot() == {}


@pytest.mark.parametrize("hw, resizes", [((64, 64), 2), ((72, 100), 4)])
def test_teacher_spans_nest_one_request_a_call(hw, resizes, params):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            pwcnet.get_bidirectional_flow(params, *_pair(*hw, batch=1))
    snap = trace.snapshot()
    calls = {"teacher": 2, "teacher/extractor": 4, "teacher/decoders": 4,
             "teacher/decoders/corr": 20, "teacher/decoders/warp": 16,
             "teacher/refiner": 4, "teacher/resize": 2 * resizes}
    assert {p: r["calls"] for p, r in snap.items()} == calls
    assert all(r["requests"] == 2 for r in snap.values())
    for r in snap["teacher"]["by_request"].values():
        assert r["calls"] == 1
    # the stages and the call's own time cover the call
    kids = sum(snap[p]["device_ms"] for p in calls if p.count("/") == 1)
    assert snap["teacher"]["self_device_ms"] == pytest.approx(
        snap["teacher"]["device_ms"] - kids, abs=1e-9)


@pytest.fixture(scope="module")
def traced_rec():
    """A traced CPU run of the cell at a small size: the driver's window
    (with marks), traced calls under a CPU profile and the release; the
    record as the harness builds it, with H100 work counts and a made-up device trace
    (a CPU run has none)."""
    trace.clear()
    d = teacher_calls.Driver(_tiny_cell(), "cpu", SEED)
    d.setup()
    win = d.window(0.05, drivers.Marks(torch.device("cpu")))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        d.traced(2)
    d.release()
    spans = list(trace.RECORDER.spans)
    trace.clear()
    rec = {"kind": "teacher", "layers": win["layers"], "work": d.work(H100),
           "trace": {"busy_s": 0.75, "window_s": 1.0, "device_ops": []}}
    return rec, spans


def test_the_readers_are_the_cells():
    assert len(READERS) == 9
    cell = catalog.load_cell("teacher_b8_512")
    assert sorted(cell["layers"]) == sorted(
        READERS + ["trace.setup.kernel_build_s"])
    assert set(cell["e2e"]) == {"samples_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_call_and_none_from_an_empty_store(
        name, traced_rec, monkeypatch):
    reader = catalog.load_metric(name)
    rec, spans = traced_rec
    empty = dict(rec, work=None, trace=None)
    assert reader.read(empty) is None
    monkeypatch.setattr(trace.RECORDER, "spans", list(spans))
    v = reader.read(rec)
    if name == "trace_teacher.corr_roofline":
        # the CPU runs the correlation's plain version: no kernel to time
        assert rec["layers"]["corr_kernel_ms"] is None and v is None
        v = reader.read(dict(rec, layers=dict(rec["layers"],
                                              corr_kernel_ms=0.2)))
        assert v == pytest.approx(
            100.0 * rec["work"]["corr_floor_ms"] / 0.2)
    assert isinstance(v, float) and np.isfinite(v) and v >= 0, v
    if name == "trace_teacher.counter.launches":
        assert v == 0.0                 # the plain versions launch nothing
    elif reader.UNIT in ("ms", "%"):
        assert v > 0
    assert reader.read(dict(rec, kind="train")) is None


# -- the work counts -----------------------------------------------------------------

def _geometry():
    with open(os.path.join(ROOT, "vfibench", "configs",
                           "pwcnet_teacher.json")) as f:
        return work_teacher.geometry(json.load(f))


@pytest.mark.parametrize("hw", [(64, 64), (72, 100)])
def test_work_counts_match_the_flop_counter(hw, params):
    """Every conv and deconv of the reference's bidirectional call, as
    FlopCounterMode counts them (2 a multiply-add, a deconv by its input
    pixels), against work_teacher's extractor, decoders and refiner."""
    g = _geometry()
    im0, im1 = _pair(*hw, batch=1)
    with FlopCounterMode(display=False) as mode:
        ref.bidirectional_flow(params, SPEC, im0, im1)
    counted = sum(n for op, n in mode.get_flop_counts()["Global"].items()
                  if "convolution" in str(op))
    stages = work_teacher.call_stages(g, *hw, batch=1)
    assert counted == work_teacher.conv_flops_of(stages)


def test_work_counts_at_the_cells_size():
    """A call at batch 8 of 512×512: about 1.54 TFLOP of float32, dec2's
    stack and the refiner the most; the ten cost volumes' floor is their
    bytes at the HBM bandwidth."""
    g = _geometry()
    stages = work_teacher.call_stages(g)
    assert [s["name"] for s in stages] == [
        "extractor", "decoders", "corr", "warp", "refiner", "resize"]
    total = sum(s["flops"]["float32"] for s in stages)
    assert 1.5e12 < total < 1.6e12
    corr = work_teacher.stage(stages, "corr")
    # dec2 to dec6: (C, side) of each volume, both features in, 81 out
    want = 2 * 4 * 8 * sum(s * s * (2 * c + 81) for c, s in (
        (32, 128), (64, 64), (96, 32), (128, 16), (196, 8)))
    assert corr["bytes"] == want
    assert work.floor_ms([corr], H100) == pytest.approx(
        want / 3.35e12 * 1e3)
