"""The packed synthesis's six-way blend (fldrx_torch/ops/blend.py) on the
CPU: `blend6_plain` into plain rows equals the u-plane blend followed by
the interleave, and into u-planes the u-plane blend, bit for bit; the
packed `forward_synthesis_multi` returns exactly the stack of its per-t
frames as the u-plane blend and the interleave make them, from dense and
from channel-planar frames alike; `blend6_out`
refuses what the kernel does not take on every device; its launch counter
is registered with utils/trace.py and stays 0 on the CPU. The kernel
itself is held against `blend6_plain` on the card
(tests/test_torch_kernels.py)."""

import pytest
import torch

from fldrx_torch.config import papermodel
from fldrx_torch.model import fldrnet
from fldrx_torch.ops import blend
from fldrx_torch.ops.repack import interleave_planes_plain
from fldrx_torch.utils import trace

torch.set_num_threads(1)


def _inputs(B=2, H=8, W=12, dtype=torch.bfloat16, seed=0):
    """Logits [B, H/4, W/4, 96] in `dtype`, the six candidates (x0 and x1
    batch-strided views of one [B, 2, H, W, 3] tensor), t [B, 1, 1, 1] and
    T [1]."""
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn(B, H // 4, W // 4, 96, generator=g) * 3).to(dtype)
    images = torch.rand(B, 2, H, W, 3, generator=g) * 2 - 1
    cands = [torch.rand(B, H, W, 3, generator=g) * 2 - 1 for _ in range(4)]
    cands += [images[:, 0], images[:, 1]]
    t = torch.tensor([0.125, 0.875][:B]).reshape(B, 1, 1, 1)
    return logits, cands, t, torch.tensor([0.7])


def _parent(logits, cands, t, T):
    """The parent's frame in plain rows: the u-plane blend of the float32
    logits, then the interleave."""
    B, Hp4, Wp4, _ = logits.shape
    planes = blend.blend6_planes(logits.float(), cands, t, T)
    return interleave_planes_plain(planes).reshape(B, 4 * Hp4, 4 * Wp4, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 2])
def test_plain_blend_is_the_planes_blend_and_the_interleave(dtype, B):
    logits, cands, t, T = _inputs(B=B, dtype=dtype, seed=B)
    H, W = cands[0].shape[1:3]
    rows = torch.full((B, H, W, 3), float("nan"))
    planes = torch.full((B, 4, H // 4, W * 3), float("nan"))
    assert blend.blend6_out(logits, cands, t, T, rows) is rows
    assert blend.blend6_out(logits, cands, t, T, planes) is planes
    assert torch.equal(rows, _parent(logits, cands, t, T))
    assert torch.equal(planes,
                       blend.blend6_planes(logits.float(), cands, t, T))


def _synthesis_setup():
    cfg = papermodel().replace(fast_warp=True, packed_synth=True)
    params = fldrnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    g = torch.Generator().manual_seed(1)
    B, H, W = 1, 768, 768
    images = torch.rand(B, 2, H, W, 3, generator=g) * 2 - 1
    flow = torch.rand(B, H // 8, W // 8, 4, generator=g) * 6 - 3
    assert fldrnet.can_use_packed(flow, images)
    ts = [torch.full((B, 1), t) for t in (0.25, 0.5, 0.75)]
    return cfg, params, flow, images, ts


@pytest.mark.parametrize("planes_out", [False, True])
def test_packed_synthesis_returns_the_stack_of_its_frames(planes_out,
                                                          monkeypatch):
    """At 768×768 with 3 t values: the chunk's frames, written in place,
    equal torch.stack of the parent's per-t frames bit for bit (plain rows
    through the interleave, or the u-planes as the blend wrote them)."""
    cfg, params, flow, images, ts = _synthesis_setup()
    frames = []
    real = fldrnet.blend6_out

    def recording(logits, cands, t, T, out):
        frames.append(_parent(logits, cands, t, T) if not planes_out else
                      blend.blend6_planes(logits.float(), cands, t, T))
        return real(logits, cands, t, T, out)

    monkeypatch.setattr(fldrnet, "blend6_out", recording)
    with torch.inference_mode():
        extras = fldrnet.flow_extras(params, cfg, flow, images)
        got = fldrnet.forward_synthesis_multi(params, cfg, flow, images, ts,
                                              precomputed=extras,
                                              planes_out=planes_out)
    assert len(frames) == 3
    assert got.is_contiguous()
    assert torch.equal(got, torch.stack(frames, 0))


def test_packed_synthesis_takes_channel_planar_frames():
    """Frames whose channels are planar in memory (as a padding on the card
    can leave them) give the dense frames' result bit for bit: the
    synthesis makes them dense once, where the blend reads their rows."""
    cfg, params, flow, images, ts = _synthesis_setup()
    planar = images.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
    assert planar[:, 0].stride()[1:] != (3 * 768, 3, 1)
    with torch.inference_mode():
        extras = fldrnet.flow_extras(params, cfg, flow, images)
        got, want = (fldrnet.forward_synthesis_multi(
            params, cfg, flow, x, ts[1:2], precomputed=extras)
            for x in (planar, images))
    assert torch.equal(got, want)


def _bad_cases():
    """(name, edit of the inputs, the exception the wrapper raises)."""
    def grad(x):
        x[0] = x[0].float().requires_grad_()

    def ragged(x):
        x[1] = [c[:, :6] for c in x[1]]

    def batch(x):
        x[1][2] = torch.cat([x[1][2]] * 2)

    def width(x):
        x[0] = x[0][:, :, :2]

    def half(x):
        x[1][3] = x[1][3].half()

    def columns(x):
        c = x[1][1]
        x[1][1] = c.transpose(1, 2).contiguous().transpose(1, 2)

    def fp16(x):
        x[0] = x[0].half()

    def channels(x):
        x[0] = x[0][..., :48]

    def out(x):
        x[4] = x[4][:, :4]

    def out_columns(x):
        B, H, W, _ = x[4].shape
        x[4] = torch.empty(B, W, H, 3).transpose(1, 2)

    return [("requires grad", grad, RuntimeError),
            ("H not a multiple of 4", ragged, ValueError),
            ("candidate of another batch", batch, ValueError),
            ("logits of another width", width, ValueError),
            ("float16 candidate", half, TypeError),
            ("candidate stored by columns", columns, ValueError),
            ("float16 logits", fp16, TypeError),
            ("48 logits a cell", channels, ValueError),
            ("out of another shape", out, ValueError),
            ("out stored by columns", out_columns, ValueError)]


@pytest.mark.parametrize("name,edit,exc", _bad_cases(),
                         ids=[c[0] for c in _bad_cases()])
def test_blend_refuses(name, edit, exc):
    logits, cands, t, T = _inputs()
    B, H, W = cands[0].shape[:3]
    x = [logits, list(cands), t, T, torch.empty(B, H, W, 3)]
    edit(x)
    with pytest.raises(exc, match="blend6_out"):
        blend.blend6_out(*x)


def test_launch_counter_is_registered_and_stays_0_on_the_cpu():
    assert trace.RECORDER.groups["blend"] is blend.LAUNCHES
    before = blend.LAUNCHES["blend6"]
    logits, cands, t, T = _inputs()
    blend.blend6_out(logits, cands, t, T, torch.empty(2, 8, 12, 3))
    assert blend.LAUNCHES == {"blend6": before} and before == 0
