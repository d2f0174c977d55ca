"""Multi-device evaluation (counterpart of fldrx/parallel/spatial.py).

fldrx runs one program over the mesh and lets XLA move the data. Here one
process issues each shard's work on its device, and the data moves as
device-to-device copies; each builder returns a callable that takes the
whole frames and returns the whole output, as fldrx's do. On one card (a
device repeated in the mesh) the shards run one after the other: that
measures the split's overhead, not its scaling.

* `make_t_parallel_eval`: the flow and its t-independent extras run once
  on the first device and are copied to the others; the t values are
  padded to a multiple of the device count by repeating the last; each
  device runs the fast synthesis (gather, splat, conv3x3) for its share.
* `make_sharded_fast_eval`: per pair, pad, pyramid, flow, the full-res
  flows and the strict z maps on the first device; per t, the field pack
  (`field_pack_t`) is cut into sp width slabs, each slab receives `halo`
  columns of each neighbour (none beyond the frame's edges,
  `exchange_halo_w`), and each device synthesises its extended slab with
  the splat kernel, the gather kernel in the global sampling convention
  (`bwarp_global`) and the s2d refine UNet, and keeps its centre. Motion
  beyond halo − 32 px would reach past a slab: such a t reruns on the
  exact path (on_spill='exact') or warns (on_spill='warn').
* `make_sharded_eval`: the strict forward of the global batch, each dp
  row's items on that row's device, the PCA min/max reduced over the rows.
  fldrx also splits the strict forward's width, through XLA's partitioner
  alone; the port does not.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import FLDRConfig
from ..eval.pipeline import build_pyramid, to_model_frames
from ..model.fldrnet import (_bwarp_ones_mask, _stage_dtype, dtype_of,
                             flow_extras, forward_flow,
                             forward_synthesis_multi, forward_test,
                             pca_extrema, refine_unet, refine_unet_s2d,
                             z_metrics)
from ..ops import fastwarp
from ..ops.pad import pad_frames
from ..ops.resize import resize_2d
from ..ops.splat import softsplat
from ..ops.warp import bwarp
from .mesh import Mesh, make_mesh, replicate, visible_devices

TILE_ALIGN = 32        # slab widths and halos are multiples of this


def _frames_on(frames, device) -> torch.Tensor:
    """[B, 2, H, W, 3] uint8 or float (numpy or tensor) → float32 in
    [-1, 1] on `device`."""
    if not torch.is_tensor(frames):
        frames = torch.as_tensor(np.asarray(frames))
    if frames.dtype != torch.uint8:
        frames = frames.float()
    return to_model_frames(frames.to(device))


def _t_column(t, B: int, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32).reshape(B, 1).to(device)


def _unique_to(x: torch.Tensor, devices) -> Dict[str, torch.Tensor]:
    """{str(device): x on it}, one copy per distinct device."""
    return {str(d): x.to(d) for d in {str(d): d for d in devices}.values()}


# ---------------------------------------------------------------------------
# strict path
# ---------------------------------------------------------------------------

def make_sharded_eval(params, cfg: FLDRConfig, mesh: Mesh):
    """Returns call(frames [B,2,H,W,3], t [B,1]) → [B, H, W, 3] on the
    mesh's first device: the strict forward (fast_warp off, float32) of the
    global batch. The batch splits over the dp rows (B a multiple of dp);
    each row runs its items on its first device, with the PCA min/max of
    the whole batch unless cfg.per_item_minmax."""
    cfg = cfg.replace(fast_warp=False)
    rows = [mesh.devices[i, 0] for i in range(mesh.shape["dp"])]
    lead = rows[0]
    copies = replicate(mesh, params)
    n_levels = cfg.S_tst + 1

    def call(frames, t):
        with torch.inference_mode():
            frames = _frames_on(frames, lead)
            B, _, H, W, _ = frames.shape
            if B % len(rows):
                raise ValueError(f"batch {B} does not split over dp "
                                 f"{len(rows)}")
            t = _t_column(t, B, lead)
            n = B // len(rows)
            pyrs = []
            for i, dev in enumerate(rows):
                part = pad_frames(frames[i * n:(i + 1) * n].to(dev),
                                  cfg.div_pad, cfg.padding)
                pyrs.append(build_pyramid(part, cfg, n_levels))
            minmax = None
            if len(rows) > 1 and not cfg.per_item_minmax:
                ext = [pca_extrema(copies[str(d)], cfg, p, n_levels)
                       for d, p in zip(rows, pyrs)]
                lo = [torch.stack([e[k][0].to(lead) for e in ext]).amin()
                      for k in range(n_levels)]
                hi = [torch.stack([e[k][1].to(lead) for e in ext]).amax()
                      for k in range(n_levels)]

                def minmax(feat, level):
                    return (lo[level].to(feat.device),
                            hi[level].to(feat.device))
            outs = [forward_test(copies[str(d)], cfg, p,
                                 t[i * n:(i + 1) * n].to(d), orig_hw=(H, W),
                                 minmax=minmax)
                    for i, (d, p) in enumerate(zip(rows, pyrs))]
            return torch.cat([o.to(lead) for o in outs], 0)

    return call


# ---------------------------------------------------------------------------
# width-sharded fast path
# ---------------------------------------------------------------------------

def exchange_halo_w(slabs: Sequence[torch.Tensor],
                    halo: int) -> List[torch.Tensor]:
    """Width slabs [.., W_local, C], each on its device, → each extended by
    its left neighbour's rightmost and its right neighbour's leftmost
    `halo` columns, copied from their devices. A slab at the frame's edge
    gets nothing on that side: there the frame's edge is the slab's, so
    the warps read zeros beyond it and the refine UNet pads it with zeros
    at every layer, as on the whole frame. (fldrx appends zero columns
    there, which the UNet's biases turn into activations that reach into
    the frame.)"""
    out = []
    for j, x in enumerate(slabs):
        if len(slabs) > 1 and halo > x.shape[-2]:
            raise ValueError(f"halo {halo} is wider than a slab "
                             f"({x.shape[-2]} columns)")
        parts = [x]
        if j:
            parts.insert(0, slabs[j - 1][..., -halo:, :].to(x.device))
        if j + 1 < len(slabs):
            parts.append(slabs[j + 1][..., :halo, :].to(x.device))
        out.append(torch.cat(parts, -2))
    return out


def bwarp_global(x_slab: torch.Tensor, flow_slab: torch.Tensor, Wg: int,
                 x_off: int) -> torch.Tensor:
    """bwarp on a width slab in the whole frame's p·S/(S−1)−0.5 sampling
    convention (S is the frame's width, not the slab's), through the gather
    kernel, times the 0.999 ones-mask of the frame's bounds. x_slab
    [B, H, Ws, C]; flow_slab [B, H, Ws, 2]; x_off: the frame column of the
    slab's first column."""
    B, H, Ws, C = x_slab.shape
    dev = x_slab.device
    xs = torch.arange(Ws, dtype=torch.float32, device=dev) + x_off
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    gx = xs + flow_slab[..., 0]
    gy = ys[:, None] + flow_slab[..., 1]
    sx_g = gx * (Wg / max(Wg - 1, 1)) - 0.5           # frame column
    sy = gy * (H / max(H - 1, 1)) - 0.5
    out = fastwarp.gather(x_slab, sx_g - x_off, sy)
    # the sampled all-ones image over the frame, in corner-sum form
    x0 = torch.floor(sx_g)
    y0 = torch.floor(sy)
    fx = sx_g - x0
    fy = sy - y0
    x0i = x0.long()
    y0i = y0.long()

    def valid(xi, yi):
        return ((xi >= 0) & (xi < Wg) & (yi >= 0) & (yi < H)).float()

    ones = (valid(x0i, y0i) * (1 - fx) * (1 - fy)
            + valid(x0i + 1, y0i) * fx * (1 - fy)
            + valid(x0i, y0i + 1) * (1 - fx) * fy
            + valid(x0i + 1, y0i + 1) * fx * fy)
    return out * (ones >= 0.999).float().unsqueeze(-1)


def field_pack_t(cfg: FLDRConfig, flow, frames, flow_10, flow_01, z0, z1,
                 t) -> torch.Tensor:
    """The t-dependent full-res fields of the level-0 synthesis as one
    [B, H, W, 16] tensor: x0(3) x1(3) flow_t0(2) flow_t1(2) z0 z1 fb0(2)
    fb1(2). flow_10, flow_01, z0, z1 are the pair's (t-independent). The
    flowbacks are composed strictly at the flow grid (full res when the
    grid is under 96) and masked at full resolution, as the unsharded fast
    path gates it."""
    B = flow.shape[0]
    tb = t.reshape(B, 1, 1, 1).float()
    H, W = frames.shape[2], frames.shape[3]
    upscale = H // flow.shape[1]

    def up(f):
        return upscale * resize_2d(f, (H, W), "bilinear")

    flow = flow.float()
    x0 = frames[:, 0].float()
    x1 = frames[:, 1].float()
    flow_t0 = tb * flow_01
    flow_t1 = (1.0 - tb) * flow_10
    if min(flow.shape[1], flow.shape[2]) >= 96:
        fb0 = up(bwarp(flow[..., 0:2] * tb, (1.0 - tb) * flow[..., 2:4],
                       False)) * _bwarp_ones_mask((1.0 - tb) * flow_01)
        fb1 = up(bwarp(flow[..., 2:4] * (1.0 - tb), tb * flow[..., 0:2],
                       False)) * _bwarp_ones_mask(tb * flow_10)
    else:
        fb0 = bwarp(flow_10 * tb, (1.0 - tb) * flow_01)
        fb1 = bwarp(flow_01 * (1.0 - tb), tb * flow_10)
    return torch.cat([x0, x1, flow_t0, flow_t1, z0, z1, fb0, fb1], -1)


def max_disp(pack: torch.Tensor) -> float:
    """The farthest horizontal reach of a pack's warps: the splat targets
    move by flow_t*, the gathers sample at fb* (+2 px for the global
    p·S/(S−1)−0.5 shift)."""
    return float(torch.maximum(pack[..., 6:10:2].abs().amax(),
                               pack[..., 12:16:2].abs().amax() + 2.0))


def synth_local(params, cfg: FLDRConfig, Wg: int, left: int, Wl: int,
                ext: torch.Tensor, x_off: int, t: torch.Tensor,
                unet_dtype) -> torch.Tensor:
    """The level-0 synthesis of one extended slab of the pack, returning
    the Wl columns of its own slab, which start `left` columns in
    ([B, H, Wl, 3]). x_off: the frame column of the extended slab's first
    column."""
    x0, x1 = ext[..., 0:3], ext[..., 3:6]
    flow_t0, flow_t1 = ext[..., 6:8], ext[..., 8:10]
    z0, z1 = ext[..., 10:11], ext[..., 11:12]
    fb0, fb1 = ext[..., 12:14], ext[..., 14:16]
    B = ext.shape[0]

    # a splat moves values by their flow, wherever the slab starts
    warped0 = softsplat(x0, flow_t0, z=z0, splat_fn=fastwarp.splat)
    warped1 = softsplat(x1, flow_t1, z=z1, splat_fn=fastwarp.splat)
    im0_tot = bwarp_global(x0, fb0, Wg, x_off)
    im1_tot = bwarp_global(x1, fb1, Wg, x_off)

    vp = params["vfinet"]
    refine_in = torch.cat([x0, x1, warped0, warped1, flow_t0, flow_t1,
                           fb0, fb1, im0_tot, im1_tot], -1)
    unet = (refine_unet_s2d
            if refine_in.shape[1] % 4 == 0 and refine_in.shape[2] % 4 == 0
            else refine_unet)
    out = unet(vp["refine"], refine_in.to(unet_dtype)).float()

    tb = t.reshape(B, 1, 1, 1).float()
    occ = torch.softmax(out[..., :6] / vp["T_param"].float(), -1)
    w0 = (1 - tb) * occ[..., 0:1]
    w1 = tb * occ[..., 1:2]
    w2 = (1 - tb) * occ[..., 2:3]
    w3 = tb * occ[..., 3:4]
    w4 = (1 - tb) * occ[..., 4:5]
    w5 = tb * occ[..., 5:6]
    divisor = w0 + w1 + w2 + w3 + w4 + w5
    out_l = (w0 * warped0 + w1 * warped1 + w2 * im0_tot + w3 * im1_tot
             + w4 * x0 + w5 * x1) / divisor
    return out_l[:, :, left:left + Wl]


def make_sharded_fast_eval(params, cfg: FLDRConfig, mesh: Mesh,
                           halo: int = 256, on_spill: str = "exact",
                           verbose: bool = True):
    """Width-sharded evaluation on the warp and conv kernels. Returns
    call(frames [B,2,H,W,3], t [B,1]) → [B, H, W, 3] on the mesh's first
    device, with call.multi(frames, t_values) → [T·B, H, W, 3] (one flow
    run for all t) and call.counters {"n_flow_runs", "n_spill_fallbacks"}.

    The slabs are the first dp row's devices (the other rows would repeat
    the same work). The padded width must split into sp slabs of a multiple
    of 32 columns, and `halo` (a multiple of 32, at most a slab's width)
    columns of each neighbour extend each slab, so the slabs at the frame's
    edges are narrower than the others. The refine UNet runs in the
    configuration's UNet dtype (fldrx runs it in float32 there), so the
    deploy mix's bfloat16 UNet takes the conv3x3 kernel.

    A t whose motion exceeds halo − 32 px (`max_disp`) is counted in
    n_spill_fallbacks and, with on_spill='exact', computed on
    `make_sharded_eval`'s strict path over the same devices; with 'warn'
    the sharded result stands and a warning is printed."""
    if halo % TILE_ALIGN:
        raise ValueError(f"halo {halo} is not a multiple of {TILE_ALIGN}")
    if on_spill not in ("exact", "warn"):
        raise ValueError(f"on_spill must be 'exact' or 'warn', got "
                         f"{on_spill!r}")
    row = Mesh(mesh.devices[:1])
    slabs = list(row.devices[0])
    nsp = len(slabs)
    lead = slabs[0]
    copies = replicate(row, params)
    unet_dtype = _stage_dtype(cfg, "unet_dtype", dtype_of(cfg.compute_dtype))
    counters = {"n_flow_runs": 0, "n_spill_fallbacks": 0}
    exact_call = []

    def prep(frames):
        """pad → pyramid → flow → full-res flows → strict z, once a pair."""
        counters["n_flow_runs"] += 1
        p = copies[str(lead)]
        padded = pad_frames(_frames_on(frames, lead), cfg.div_pad,
                            cfg.padding)
        H, W = padded.shape[2], padded.shape[3]
        if W % (nsp * TILE_ALIGN):
            raise ValueError(f"padded width {W} does not split into {nsp} "
                             f"slabs of a multiple of {TILE_ALIGN}")
        flow = forward_flow(p, cfg, build_pyramid(padded, cfg,
                                                  cfg.S_tst + 1)).float()
        x0, x1 = padded[:, 0].float(), padded[:, 1].float()
        upscale = H // flow.shape[1]
        flow_10 = upscale * resize_2d(flow[..., 0:2], (H, W), "bilinear")
        flow_01 = upscale * resize_2d(flow[..., 2:4], (H, W), "bilinear")
        z0, z1 = z_metrics(p["vfinet"], x0, x1, flow_10, flow_01, fast=False)
        return flow, padded, flow_10, flow_01, z0, z1

    def synth(pack, t):
        W = pack.shape[2]
        Wl = W // nsp
        parts = [pack[:, :, j * Wl:(j + 1) * Wl].to(d)
                 for j, d in enumerate(slabs)]
        outs = []
        for j, (d, ext) in enumerate(zip(slabs,
                                         exchange_halo_w(parts, halo))):
            left = halo if j else 0
            outs.append(synth_local(copies[str(d)], cfg, W, left, Wl, ext,
                                    j * Wl - left, t.to(d), unet_dtype))
        return torch.cat([o.to(lead) for o in outs], 2)

    def synth_one(pr, frames, t, H, W):
        flow, padded, f10, f01, z0, z1 = pr
        t = _t_column(t, flow.shape[0], lead)
        pack = field_pack_t(cfg, flow, padded, f10, f01, z0, z1, t)
        reach = max_disp(pack)
        if reach > halo - TILE_ALIGN:
            counters["n_spill_fallbacks"] += 1
            if on_spill == "exact":
                if verbose:
                    print(f"# sharded fast eval: motion {reach:.0f} px "
                          f"exceeds halo-{TILE_ALIGN} = {halo - TILE_ALIGN};"
                          " rerunning the frame on the exact path",
                          flush=True)
                if not exact_call:
                    exact_call.append(make_sharded_eval(params, cfg, row))
                return exact_call[0](frames, t)
            print(f"# WARNING: sharded fast eval spill: max displacement "
                  f"{reach:.0f} px > {halo - TILE_ALIGN} px halo budget; "
                  "slab-edge pixels may zero-fill (on_spill='warn')",
                  flush=True)
        return synth(pack, t)[:, :H, :W]

    def call(frames, t):
        with torch.inference_mode():
            H, W = frames.shape[2], frames.shape[3]
            return synth_one(prep(frames), frames, t, H, W)

    def multi(frames, t_values):
        """One prep for the pair, then each t → [T·B, H, W, 3]."""
        with torch.inference_mode():
            H, W = frames.shape[2], frames.shape[3]
            pr = prep(frames)
            B = pr[0].shape[0]
            return torch.cat([synth_one(pr, frames, np.full((B, 1), tv),
                                        H, W) for tv in t_values], 0)

    call.multi = multi
    call.counters = counters
    return call


# ---------------------------------------------------------------------------
# t-parallel path
# ---------------------------------------------------------------------------

def make_t_parallel_eval(params, cfg: FLDRConfig, mesh: Mesh):
    """×N throughput over every device of the mesh. Returns
    call(frames [1,2,H,W,3], t_values [T]) → [T, H, W, 3] on the mesh's
    first device. The flow and its t-independent extras (`flow_extras`, as
    the single-device ×N path hoists them) run once on the first device
    and are copied to each; the t values, padded by repeating the last to
    a multiple of the device count, split in order over the devices, and
    each runs the synthesis for its share in chunks of cfg.t_chunk."""
    devices = list(mesh.devices.reshape(-1))
    n = len(devices)
    lead = devices[0]
    copies = replicate(mesh, params)
    dtype = dtype_of(cfg.compute_dtype)
    chunk = max(1, cfg.t_chunk)

    def call(frames, t_values):
        with torch.inference_mode():
            frames = _frames_on(frames, lead)
            B, _, H, W, _ = frames.shape
            if B != 1:
                raise ValueError(f"t-parallel evaluation takes one pair, "
                                 f"got {B}")
            padded = pad_frames(frames, cfg.div_pad, cfg.padding)
            p = copies[str(lead)]
            flow = forward_flow(p, cfg, build_pyramid(padded, cfg,
                                                      cfg.S_tst + 1), dtype)
            extras = flow_extras(p, cfg, flow, padded)
            on = {k: _unique_to(v, devices) for k, v in
                  (("flow", flow), ("padded", padded))}
            ex = [_unique_to(e, devices) for e in extras]
            ts = np.asarray(t_values, np.float32).reshape(-1)
            T = ts.shape[0]
            ts = np.concatenate([ts, np.repeat(ts[-1:], (-T) % n)])
            per = ts.shape[0] // n
            outs = []
            for k, dev in enumerate(devices):
                d = str(dev)
                mine = ts[k * per:(k + 1) * per]
                for c in range(0, per, chunk):
                    tcol = [torch.full((1, 1), float(tv), device=dev)
                            for tv in mine[c:c + chunk]]
                    out = forward_synthesis_multi(
                        copies[d], cfg, on["flow"][d], on["padded"][d],
                        tcol, precomputed=tuple(e[d] for e in ex),
                        compute_dtype=dtype, planes_out=False)
                    outs.append(out[:, 0])
            return torch.cat([o.to(lead) for o in outs], 0)[:T, :H, :W]

    return call


def build_parallel_eval(params, cfg: FLDRConfig, mode: str = "t",
                        devices=None, halo: int = 256):
    """The multi-device bridge of `eval.evaluator.evaluate` (and the CLI's
    --mesh): fn(frames [1,2,H,W,3], t_values) → float32 [T, H, W, 3] on the
    first device. `devices` defaults to every visible CUDA device; a device
    may repeat.

    mode 't'  — the t values split over the devices (make_t_parallel_eval);
    mode 'sp' — each synthesis split over the devices by width
                (make_sharded_fast_eval), one flow run per pair."""
    devices = list(devices) if devices is not None else visible_devices()
    if mode == "t":
        return make_t_parallel_eval(params, cfg, make_mesh(
            devices, dp=len(devices), sp=1))
    if mode == "sp":
        call = make_sharded_fast_eval(params, cfg, make_mesh(
            devices, dp=1, sp=len(devices)), halo=halo)
        return call.multi
    raise ValueError(f"unknown parallel-eval mode: {mode!r}")
