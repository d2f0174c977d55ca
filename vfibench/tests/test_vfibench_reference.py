"""The plain reference (vfibench/reference/) holds the port: the strict and
fast inference paths at 256×512 and the training step at a batch of 2 of
128×128, on the CPU; the deploy mix at 768×1280 on the card."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from vfibench import inputs, work
from vfibench.reference import convert, pipeline

NPZ = os.path.join(ROOT, "checkpoints", "fldrnet_best.npz")


def _config(name):
    with open(os.path.join(ROOT, "vfibench", "configs", name + ".json")) as f:
        return json.load(f)["fldr_config"]


def _pair(H, W, seed, device="cpu"):
    return inputs.make_clip(seed, H, W, 2, (4, 12), device)


def _program(fields, device):
    from fldrx_torch.api import prepare_model
    from vfibench.drivers import fields_to_config

    return prepare_model(NPZ, fields_to_config(fields), device)[0]


def _reference(fields, pair, ts, device):
    sd = convert.state_dict(NPZ, device)
    geom = dict(work.geometry(fields), fast_warp=fields["fast_warp"],
                packed_synth=fields["packed_synth"])
    return pipeline.infer_pair(sd, pair, ts, geom)


def _program_pair(interp, pair, ts):
    flow, padded, extras = interp.precompute_flow(pair[None])
    frames = interp.synthesize_multi_at(flow, padded, ts, pair.shape[1:3],
                                        extras, planes_out=False)
    return flow, frames[:, 0]


@pytest.mark.parametrize("path,flow_tol,frame_tol", [
    # strict: the reference's own algebra, float32 against the float64 PCA
    ("strict", 1e-4, 1e-4),
    # fast float32: the kernels' plain twins on the CPU, the fast algebra
    ("fast_f32", 1e-3, 2e-3),
    # the deploy mix: float32 flow, bfloat16 refine UNet
    ("deploy", 1e-3, 3e-2),
])
def test_inference_paths_hold_to_the_reference(path, flow_tol, frame_tol):
    torch.set_num_threads(2)
    fields = dict(_config("papermodel_test5_deploy"))
    if path != "deploy":
        fields.update(compute_dtype="float32", flow_dtype="")
    if path == "strict":
        fields.update(fast_warp=False, packed_synth=False)
    pair = _pair(256, 512, 11)
    ts = [0.25, 0.75]
    with torch.no_grad():
        flow, frames = _program_pair(_program(fields, "cpu"), pair, ts)
        ref_flow, ref_frames = _reference(fields, pair, ts, "cpu")
    assert flow.shape == ref_flow.shape and frames.shape == ref_frames.shape
    assert float((flow - ref_flow).abs().max()) < flow_tol
    assert float((frames - ref_frames).abs().max()) < frame_tol


def test_fast_algebra_holds_where_the_packed_path_runs():
    # 768×768: a flow grid of 96, so the program takes the packed
    # synthesis (z at half resolution, the flowback at the flow grid)
    torch.set_num_threads(2)
    fields = dict(_config("papermodel_test5_deploy"),
                  compute_dtype="float32", flow_dtype="")
    pair = _pair(768, 768, 11)
    ts = [0.875]
    with torch.no_grad():
        flow, frames = _program_pair(_program(fields, "cpu"), pair, ts)
        ref_flow, ref_frames = _reference(fields, pair, ts, "cpu")
    assert float((flow - ref_flow).abs().max()) < 1e-4
    assert float((frames - ref_frames).abs().max()) < 1e-4


def test_int8_unet_is_the_step_below():
    x = torch.randn(1, 26, 32, 64)
    sd = convert.state_dict(NPZ, "cpu")
    from vfibench.reference.model import refine_unet_torch

    full = refine_unet_torch(sd, x)
    lower = refine_unet_torch(sd, x, in_int8=True)
    rel = float((lower - full).norm() / full.norm())
    assert 1e-3 < rel < 0.5


def test_train_step_holds_to_the_reference():
    from fldrx_torch.train.trainer import train_loss
    from fldrx_torch.weights import load_npz, named_leaves, params_from_numpy
    from vfibench.drivers import fields_to_config

    torch.set_num_threads(2)
    fields = dict(_config("papermodel_train"), batch_size=2, patch_size=128)
    cfg = fields_to_config(fields)
    phase, pan, t = inputs.train_specs(5, 2, 60, 24, (1 / 32, 31 / 32))
    batch = inputs.train_batch(phase, pan, t, 128, "cpu")
    params = params_from_numpy(load_npz(NPZ)[0], "cpu")
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    loss, _ = train_loss(cfg, params, batch)
    loss.backward()
    sd = convert.state_dict(NPZ, "cpu", requires_grad=True)
    geom = dict(work.geometry(fields), smoothness=0.5, warp_alpha=0.05)
    ref = pipeline.train_loss(sd, batch, geom)
    ref.backward()
    loss, ref = float(loss.detach()), float(ref.detach())
    assert abs(loss - ref) <= 1e-6 * abs(ref)
    worst = 0.0
    for name, ref_name in ((convert.checkpoint_name(k), k) for k in sd):
        p = dict(named_leaves(params))[name]
        if sd[ref_name].grad is None:
            continue
        g, r = p.grad, sd[ref_name].grad
        worst = max(worst, float((g - r).norm() / r.norm().clamp_min(1e-30)))
    assert worst < 1e-3


def test_reference_adam_is_torch_adam():
    torch.manual_seed(0)
    a = torch.randn(5, 4, requires_grad=True)
    b = a.detach().clone().requires_grad_(True)
    opt = torch.optim.AdamW([b], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)
    state = {}
    for step in range(1, 4):
        g = torch.randn(5, 4)
        a.grad, b.grad = g.clone(), g.clone()
        pipeline.adam_update({"a": a}, state, {"a": 1e-3}, step)
        opt.step()
    assert torch.allclose(a, b, rtol=0, atol=1e-7)


def test_pad_and_pyramid_are_the_reference_mains():
    x = torch.arange(2 * 3 * 5 * 7, dtype=torch.float32).reshape(2, 3, 5, 7)
    got = pipeline.pad_reflect(x, 8)
    want = np.pad(x.numpy(), ((0, 0), (0, 0), (0, 3), (0, 1)), "reflect")
    assert got.shape == (2, 3, 8, 8)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.cuda
def test_deploy_mix_on_the_card_holds_to_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    fields = _config("papermodel_test5_deploy")
    pair = _pair(768, 1280, 13, "cuda")
    ts = [0.375]
    flow, frames = _program_pair(_program(fields, "cuda"), pair, ts)
    geom = dict(work.geometry(fields), fast_warp=True, packed_synth=True)
    sd = convert.state_dict(NPZ, "cuda")
    ref_flow = pipeline.flow_pair(sd, pair, geom)
    spreads = []
    ref_frames = pipeline.synthesize_pair(sd, flow, pair, ts, geom,
                                          spreads=spreads)
    with open(os.path.join(ROOT, "vfibench", "cells", "x8_4k.json")) as f:
        lim = json.load(f)["limits"]

    def rms(a, b):
        return float(torch.sqrt(torch.mean((a.float() - b).double() ** 2)))

    gap = (flow.float() - ref_flow).abs().flatten()
    assert float(gap.kthvalue(round(gap.numel() * 0.9)).values) \
        <= lim["flow_p90_px"]
    assert rms(frames, ref_frames) / spreads[0] <= lim["frame_rel_gap"]
