"""The work counts of vfibench/work.py: the convolutions' and the block
PCA's flops against FlopCounterMode on the plain reference, the resize
taps by hand, the training step as 3 × its forward, and floors under the
time of any implementation (every stage's floor positive and summing to
the pass's)."""

import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from vfibench import inputs, peaks, work
from vfibench.reference import convert, pipeline

NPZ = os.path.join(ROOT, "checkpoints", "fldrnet_best.npz")


def _fields(name):
    with open(os.path.join(ROOT, "vfibench", "configs", name + ".json")) as f:
        return json.load(f)["fldr_config"]


def _counted(mode):
    """(conv flops, matmul flops) FlopCounterMode saw."""
    conv = mm = 0
    for op, n in mode.get_flop_counts()["Global"].items():
        name = str(op)
        if "convolution" in name:
            conv += n
        elif any(k in name for k in ("mm", "bmm", "matmul")):
            mm += n
    return conv, mm


def test_inference_convs_and_pca_match_the_flop_counter():
    fields = _fields("papermodel_test5_deploy")
    g = work.geometry(fields)
    H, W = 256, 512
    ts = [0.25, 0.5, 0.75]
    sd = convert.state_dict(NPZ, "cpu")
    pair = inputs.make_clip(3, H, W, 2, (2, 6), "cpu")
    torch.set_num_threads(2)
    with FlopCounterMode(display=False) as mode:
        pipeline.infer_pair(sd, pair, ts, g)
    conv, mm = _counted(mode)
    flow = work.flow_stages(g, H, W, H, W, g["S_tst"] + 1)
    synth = work.synth_stages(g, H, W, H, W)
    want_conv = (sum(s["conv_flops"] for s in flow)
                 + len(ts) * sum(s["conv_flops"] for s in synth))
    assert conv == want_conv
    # the block PCA: 2·64·nf a block of each of the 6 images of every level
    levels = [(H >> i, W >> i) for i in range(g["S_tst"] + 1)]
    assert mm == sum(6 * (h * w // 64) * 2 * 64 * g["nf"] for h, w in levels)


def test_resize_taps_by_hand():
    # 1 channel, 8×8 → 4×4 bicubic: rows first, 4 × 8 outputs, then 4 × 4,
    # each 4 taps of 2 operations
    assert work.resize_flops(1, 8, 8, 4, 4, 4) == 2 * 4 * (4 * 8 + 4 * 4)
    assert work.resize_flops(3, 4, 4, 8, 8, 2) == 3 * 2 * 2 * (8 * 4 + 8 * 8)
    assert work.resize_flops(5, 7, 9, 7, 9, 4) == 0


def test_unet_counts_the_reference_convs():
    g = work.geometry(_fields("papermodel_test5_deploy"))
    x = torch.zeros(1, 26, 64, 128)
    sd = convert.state_dict(NPZ, "cpu")
    from vfibench.reference.model import refine_unet_torch

    with FlopCounterMode(display=False) as mode:
        refine_unet_torch(sd, x)
    assert _counted(mode)[0] == work.unet_convs(g, 64, 128)


def test_train_step_is_three_forwards():
    g = work.geometry(_fields("papermodel_train"))
    fwd = work.train_forward_flops(g, 512, 8)
    step = work.train_step_flops(g, 512, 8)
    assert set(step) == {"float32"}
    assert step["float32"] == 3 * fwd["float32"]


def test_floors_are_sums_of_stage_floors():
    g = work.geometry(_fields("papermodel_test5_deploy"))
    pk = peaks.peaks("NVIDIA H100 80GB HBM3")
    stages = work.synth_stages(g, 2160, 4096, 2304, 4096, "bfloat16")
    each = [work.floor_ms([s], pk) for s in stages]
    assert all(v > 0 for v in each)
    assert abs(sum(each) - work.floor_ms(stages, pk)) < 1e-12
    # the UNet's floor at the bfloat16 tensor-core peak
    unet = [s for s in stages if s["name"] == "unet"][0]
    assert unet["flops"] == {"bfloat16": work.unet_convs(g, 2304, 4096)}


def test_peaks_by_card_name():
    assert peaks.peaks("NVIDIA H100 80GB HBM3")["part"] == "H100 SXM"
    assert peaks.peaks("NVIDIA H100 PCIe")["tflops"]["float32"] == 51.0
    assert peaks.peaks("NVIDIA H100 NVL")["hbm_tb_s"] == 3.9
