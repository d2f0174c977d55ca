"""The roofline (fldrx_torch/tools/roofline.py) and the probes
(tools/perfprobe.py, tools/perfprobe2.py) on the CPU: each kernel's bound
at the SXM peaks equals the table of chip_smoke.py phase 2 (PERF.md §6) to
its printed digits; the stages' matmul and convolution flops equal
torch.utils.flop_counter.FlopCounterMode over the port's plain CPU path at
small frames; no output names a TPU; perfprobe2 runs every variant and
leaves every function it swapped as it was."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fldrx_torch.bench_inputs import deploy_config
from fldrx_torch.eval import pipeline
from fldrx_torch.model import fldrnet
from fldrx_torch.ops import fastwarp
from fldrx_torch.tools import perfprobe, perfprobe2, roofline as R

torch.set_num_threads(1)

SXM = R.PEAKS["SXM"]

# (kernel function, its shape arguments, the bound as printed in PERF.md
# §6's kernel table, what bounds it)
TABLE = [
    (R.gather, (1, 2304, 4096, 3), "0.090", "bytes"),
    (R.gather, (1, 288, 512, 2), "0.001", "bytes"),
    (R.gather, (8, 512, 512, 3), "0.020", "bytes"),
    (R.gather, (8, 128, 128, 32), "0.010", "bytes"),
    (R.gather, (1, 2304, 2560, 3), "0.056", "bytes"),
    (R.gather, (4, 512, 512, 3), "0.010", "bytes"),
    (R.splat, (1, 2304, 4096, 4), "0.113", "bytes"),
    (R.splat, (1, 288, 512, 49), "0.018", "bytes"),
    (R.splat, (1, 2304, 2560, 4), "0.070", "bytes"),
    (R.splat, (4, 512, 512, 4), "0.0125", "bytes"),
    (R.splat, (4, 64, 64, 49), "0.0020", "bytes"),
    (R.splat, (8, 512, 512, 4), "0.025", "bytes"),
    (R.splat, (8, 64, 64, 49), "0.004", "bytes"),
    (R.conv3x3, (576, 1024, 416, 64), "0.286", "operations"),
    (R.conv3x3, (576, 1024, 64, 32), "0.034", "bytes"),
    (R.conv3x3, (288, 512, 128, 64), "0.022", "operations"),
    (R.conv3x3, (576, 1024, 192, 64), "0.132", "operations"),
    (R.conv3x3, (576, 1024, 256, 96), "0.264", "operations"),
    (R.interleave, (1, 2304, 12288), "0.068", "bytes"),
    (R.deinterleave, (1, 2304, 12288), "0.068", "bytes"),
    (R.pack_s2d4, (1, 2304, 4096, 26, 2), "0.439", "bytes"),
    (R.blend6, (1, 2304, 4096, 2), "0.270", "bytes"),
    (R.resize_taps, (2, 2304, 4096, 3, 1152, 2048, 4), "0.0845", "bytes"),
    (R.resize_taps, (1, 288, 512, 2, 2304, 4096, 2), "0.0229", "bytes"),
    (R.resize_taps, (1, 1152, 2048, 1, 2304, 4096, 2), "0.0141", "bytes"),
    (R.correlation, (8, 128, 128, 32), "0.0227", "bytes"),
    (R.correlation, (8, 64, 64, 64), "0.0082", "bytes"),
    (R.correlation, (8, 32, 32, 96), "0.0027", "bytes"),
    (R.correlation, (8, 16, 16, 128), "0.0008", "bytes"),
    (R.correlation, (8, 8, 8, 196), "0.0003", "bytes"),
    (R.gather_grad, (8, 512, 512, 3, False), "0.025", "bytes"),
    (R.gather_grad, (8, 512, 512, 2, True), "0.025", "bytes"),
    (R.gather_grad, (4, 512, 512, 3, False), "0.0125", "bytes"),
    (R.gather_grad, (4, 512, 512, 2, True), "0.0125", "bytes"),
    (R.gather_grad, (8, 512, 512, 3, True), "0.033", "bytes"),
    (R.splat_grad, (8, 512, 512, 4, True), "0.040", "bytes"),
    (R.splat_grad, (8, 64, 64, 49, False), "0.004", "bytes"),
    (R.splat_grad, (4, 512, 512, 4, True), "0.020", "bytes"),
    (R.splat_grad, (4, 64, 64, 49, False), "0.0020", "bytes"),
    (R.splat_grad, (8, 64, 64, 49, True), "0.006", "bytes"),
]


@pytest.mark.parametrize("fn,args,printed,by", TABLE)
def test_kernel_bound_equals_the_table(fn, args, printed, by):
    ms, got_by = R.kernel_bound(SXM, fn(*args))
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed and got_by == by


def test_peaks_for_names_the_variant():
    assert R.peaks_for("NVIDIA H100 80GB HBM3, 700.00 W") == ("SXM", SXM)
    assert R.peaks_for("NVIDIA H100 PCIe, 350.00 W")[0] == "PCIe"


def _flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        fn()
    return counter.get_total_flops()


def _interp(hw):
    from fldrx_torch.api import prepare_model
    return prepare_model(cfg=deploy_config(), device="cpu")[0]


@pytest.mark.parametrize("hw", [(256, 512), (512, 256)])
def test_pyramid_flops_equal_the_flop_counter(hw):
    frames = torch.rand(1, 2, *hw, 3)
    got = _flops(lambda: pipeline.build_pyramid(frames, deploy_config(), 6))
    assert got == R.cpu_resize_flops("pyramid", *hw) > 0
    assert R.pyramid(*hw).mm == 0


def test_flow_flops_equal_the_flop_counter():
    """forward_flow's PCA projections and convolutions (features) and the
    levels' upsamples and convolutions, in float32 (at 512×1024 the
    coarsest grid is 2×4: on a grid of one row einsum multiplies without a
    matmul, which FlopCounterMode does not count)."""
    H, W = 512, 1024
    interp = _interp((H, W))
    pyr = pipeline.build_pyramid(torch.rand(1, 2, H, W, 3) * 2 - 1,
                                 interp.cfg, 6)
    got = _flops(lambda: fldrnet.forward_flow(interp.params, interp.cfg, pyr))
    want = R.features(H, W) + R.levels(H, W)
    assert want.tc == 0
    assert got == want.mm + R.cpu_resize_flops("levels", H, W)


def test_flow_extras_flops_equal_the_flop_counter():
    """flow_extras on the packed path (a flow grid of 96 or more): the z
    stage's resizes to half resolution and the pack's to full."""
    H, W = 768, 1024
    interp = _interp((H, W))
    g = torch.Generator().manual_seed(0)
    flow = torch.randn(1, H // 8, W // 8, 4, generator=g)
    images = torch.rand(1, 2, H, W, 3, generator=g) * 2 - 1
    got = _flops(lambda: fldrnet.flow_extras(interp.params, interp.cfg, flow,
                                             images))
    assert got == (R.cpu_resize_flops("z", H, W)
                   + R.cpu_resize_flops("pack", H, W))
    assert R.z(H, W).mm == R.pack(H, W).mm == 0


@pytest.mark.parametrize("hw", [(64, 96), (128, 64)])
def test_unet_flops_equal_the_flop_counter(hw):
    """The refine UNet's seven convolutions in bf16 (the five packed ones
    through conv3x3's plain version here), all on the tensor cores."""
    H, W = hw
    interp = _interp(hw)
    x = (torch.rand(1, H // 4, W // 4, 16 * R.UNET_IN) * 2 - 1).to(
        torch.bfloat16)
    got = _flops(lambda: fldrnet.refine_unet_s2d_core(
        interp.params["vfinet"]["refine"], x))
    want = R.unet(H, W)
    assert want.mm == 0 and got == want.tc


def test_flowback_resizes_equal_the_flop_counter():
    H, W = 256, 384
    fb = torch.rand(1, H // 8, W // 8, 2)
    got = _flops(lambda: fldrnet.resize_2d(fb, (H, W), "bilinear"))
    assert 2 * got == R.cpu_resize_flops("flowback", H, W)
    assert R.flowback(H, W).mm == 0


def _main(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert R.main(argv) == 0
    return out.getvalue()


FAKE_PROBE = {
    "hw": [2160, 4096], "t_per_pair": 7,
    "flow": {"whole_ms": 40.0, "variants": {
        k: {"ms": 30.0, "delta_ms": 10.0, "delta_spread_ms": 0.1,
            "span_ms": 12.0} for k in R.FLOW_STAGES}},
    "synthesis": {"whole_ms": 150.0, "variants": {
        k: {"ms": 136.0, "delta_ms": 14.0, "delta_spread_ms": 0.1,
            "span_ms": 21.0} for k in ("splat", "flowback", "gather", "unet",
                                       "blend")}},
}


def test_measured_column_and_no_tpu(tmp_path):
    """--measured puts perfprobe2's in-context ms (per pair for the flow,
    per t for the synthesis) beside each floor; the stages without a stub
    read None. No output names a TPU."""
    path = tmp_path / "probe.json"
    path.write_text(json.dumps(FAKE_PROBE))
    text = _main(["--measured", str(path)])
    other = _main(["--chip", "PCIe", "--hw", "1080", "1920"])
    for word in ("tpu", "v5e", "v5p", "mxu", "vpu"):
        assert word not in (text + other).lower()
    rep = json.loads(text.splitlines()[-1])
    assert json.loads(other.splitlines()[-1])["padded"] == [1280, 2048]
    st = rep["stages"]
    assert st["pyramid"]["measured_ms"] == 10.0
    assert st["unet"]["measured_ms"] == pytest.approx(2.0)
    assert st["refine_in"]["measured_ms"] is None
    assert st["unet"]["share_of_floor"] == pytest.approx(
        st["unet"]["floor_ms"] / 2.0)
    assert st["unet"]["span_ms"] == pytest.approx(3.0)
    assert st["pyramid"]["share_of_span"] == pytest.approx(
        st["pyramid"]["floor_ms"] / 12.0)
    assert rep["padded"] == [2304, 4096]
    assert st["unet"]["bound_by"] == "tensor cores"
    per_frame = sum(r["floor_ms"] / (7 if r["per"] == "pair" else 1)
                    for r in st.values())
    assert rep["floor_ms_per_frame"] == pytest.approx(per_frame)
    with pytest.raises(ValueError, match="measured at"):
        R.report("SXM", (1080, 1920), FAKE_PROBE)


SWAPPED = [(m, n) for stubs in (perfprobe2.FLOW_STUBS,
                                perfprobe2.SYNTH_STUBS)
           for targets in stubs.values() for m, n, _ in targets]


def test_perfprobe2_runs_every_variant_and_restores_what_it_swapped():
    """At 768×768 (the packed path's smallest frame) with one t: every
    stub is reached, every variant timed, and afterwards each swapped
    function is the very object it was."""
    before = [getattr(m, n) for m, n in SWAPPED]
    rec = perfprobe2.run(device="cpu", hw=(768, 768), n=1, t_values=[0.5])
    assert [getattr(m, n) for m, n in SWAPPED] == before
    assert all(getattr(m, n) is b for (m, n), b in zip(SWAPPED, before))
    assert set(rec["flow"]["variants"]) == set(perfprobe2.FLOW_STUBS)
    assert set(rec["synthesis"]["variants"]) == set(perfprobe2.SYNTH_STUBS)
    for part in ("flow", "synthesis"):
        for v in rec[part]["variants"].values():
            assert np.isfinite(v["ms"]) and np.isfinite(v["delta_ms"])
            assert 0 < v["span_ms"] < rec[part]["whole_ms"]
    assert rec["device"] == "cpu" and rec["t_per_pair"] == 1
    rep = R.report("SXM", (768, 768), rec)
    assert rep["stages"]["unet"]["measured_ms"] is not None


def test_a_stub_that_is_never_reached_raises():
    stub = perfprobe2.Stubbed("splat", [(fastwarp, "splat", None)], (8, 8))
    with pytest.raises(RuntimeError, match="never called"):
        with stub:
            pass
    assert fastwarp.splat is not None and not stub.recorded
    assert "stub" not in fastwarp.splat.__name__


def test_probes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    for tool in (perfprobe, perfprobe2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.run(hw=(768, 768), n=1)


def test_perfprobe_times_each_operation():
    rec = perfprobe.run(device="cpu", hw=(768, 768), n=1)
    assert set(rec["ms"]) == {"softsplat 3ch+z", "bwarp 3ch", "s2d UNet bf16",
                              "flow precompute", "synthesize_at"}
    assert all(np.isfinite(v) and v > 0 for v in rec["ms"].values())
    assert rec["padded"] == [768, 768] and rec["card"] == "cpu"
