"""The work of fLDRnet's passes, counted from the configuration's geometry:
floating-point operations (by the precision they run in) and device-memory
bytes, stage by stage.

The counts are of the work the model needs, whatever the implementation
does, so a change of implementation cannot make them stale:

- a convolution counts its multiply-adds at the resolution the reference
  network runs it (2 · out pixels · C_in · C_out · k²), the refine UNet's
  as the reference's seven convs, not a packed form with zero taps;
- a resize counts its taps per axis, separably (4 for bicubic, 2 for
  bilinear), not dense interpolation matrices;
- a warp counts its corners (4 taps a channel), the block PCA its
  projection (2 · 64 · nf a block);
- bytes are each stage's inputs read once and its outputs written once;
  what a stage makes and uses inside itself is free, so a floor assumes
  only that stages hand over through device memory;
- elementwise arithmetic (normalisations, softmax, masks) is left out, so
  the counts stay below what any implementation must do.

A stage's floor is max(bytes / bandwidth, Σ flops / the peak of their
precision); a pass's floor is the sum over its stages. Each is a lower
bound on the time, so a share of it stays at or under 100%.
"""

from __future__ import annotations

from typing import Dict, List

F32, BF16 = "float32", "bfloat16"
_BYTES = {F32: 4, BF16: 2}


def conv_flops(h_out: int, w_out: int, cin: int, cout: int, k: int,
               batch: int = 1) -> int:
    """Multiply-adds of a k×k convolution, 2 a tap."""
    return 2 * batch * h_out * w_out * cin * cout * k * k


def resize_flops(channels: int, h_in: int, w_in: int, h_out: int, w_out: int,
                 taps: int) -> int:
    """A separable resize, rows first: each output of each pass reads
    `taps` inputs (4 for bicubic, 2 for bilinear), 2 operations a tap."""
    if (h_in, w_in) == (h_out, w_out):
        return 0
    return 2 * taps * channels * (h_out * w_in + h_out * w_out)


def geometry(fields: dict) -> dict:
    """The sizes the counts need from a configuration's FLDRConfig
    fields (the published values where a field is absent)."""
    scales = list(fields.get("scales", (8, 16, 32, 64)))
    fractions = list(fields.get("fractions", (4, 16, 64, 256)))
    wiS = int(fields.get("wiS", 8))
    nf = scales[0] ** 2 // fractions[0]          # components per channel
    img = int(fields.get("img_ch", 3))
    return {"scales": scales, "wiS": wiS, "nf": nf, "feat": 2 * img * nf,
            "img": img, "unet_nf": int(fields.get("unet_nf", 16)),
            "unet_in": int(fields.get("unet_in", 26)),
            "unet_out": int(fields.get("unet_out", 6)),
            "S_tst": int(fields.get("S_tst", 3)),
            "S_trn": int(fields.get("S_trn", 3))}


def _stage(name: str, flops: Dict[str, int], nbytes: int,
           conv: int = 0) -> dict:
    return {"name": name, "flops": {k: int(v) for k, v in flops.items() if v},
            "bytes": int(nbytes), "conv_flops": int(conv)}


def _levels(g: dict, H: int, W: int, n_levels: int):
    """(h, w) of pyramid levels 0..n_levels-1 of an H×W frame."""
    return [(int(H * g["scales"][0] / g["scales"][i]),
             int(W * g["scales"][0] / g["scales"][i])) for i in range(n_levels)]


def unet_convs(g: dict, H: int, W: int, batch: int = 1) -> int:
    """The refine UNet's seven convs at an H×W frame (fLDRnet.py
    PCARefineUNet): 4×4 stride-2 encoders, 3×3 decoders after nearest
    upsampling and the skip concatenations."""
    u, cin, cout = g["unet_nf"], g["unet_in"], g["unet_out"]
    h2, w2, h4, w4, h8, w8 = H // 2, W // 2, H // 4, W // 4, H // 8, W // 8
    return (conv_flops(h2, w2, cin, u, 4, batch)           # enc1
            + conv_flops(h4, w4, u, 2 * u, 4, batch)       # enc2
            + conv_flops(h8, w8, 2 * u, 4 * u, 4, batch)   # enc3
            + conv_flops(h8, w8, 4 * u, 4 * u, 3, batch)   # dec0
            + conv_flops(h4, w4, 6 * u, 2 * u, 3, batch)   # dec1
            + conv_flops(h2, w2, 3 * u, u, 3, batch)       # dec2
            + conv_flops(H, W, u, cout, 3, batch))         # dec3


def _flow_level_convs(g: dict, hf: int, wf: int, bottom: bool,
                      batch: int) -> int:
    c, half = g["feat"], g["feat"] // 2
    if bottom:                     # conv_flow_bottom: 96,96,96 → 48 → 6
        return (3 * conv_flops(hf, wf, c, c, 3, batch)
                + conv_flops(hf, wf, c, half, 3, batch)
                + conv_flops(hf, wf, half, 6, 3, batch))
    return (2 * conv_flops(hf, wf, c, half, 3, batch)      # conv_flow1 ×2
            + conv_flops(hf, wf, c + 4, c, 3, batch)       # conv_flow2
            + conv_flops(hf, wf, c, c, 3, batch)
            + conv_flops(hf, wf, c, half, 3, batch)
            + conv_flops(hf, wf, half, half, 3, batch)
            + conv_flops(hf, wf, half, 4, 3, batch))


def _weights_bytes(conv_list) -> int:
    return sum(4 * (cin * cout * k * k + cout) for cin, cout, k in conv_list)


def flow_stages(g: dict, H: int, W: int, Hp: int, Wp: int, n_levels: int,
                flow_dtype: str = F32, batch: int = 1,
                frames_dtype: str = "uint8") -> List[dict]:
    """The flow of one pair (or a batch of pairs): frames H×W, padded to
    Hp×Wp, n_levels pyramid levels, the convs and features in flow_dtype."""
    fb = _BYTES[flow_dtype]
    c, half, img = g["feat"], g["feat"] // 2, g["img"]
    px_in = 1 if frames_dtype == "uint8" else 4
    stages = [_stage("ingest", {}, batch * 2 * img * (H * W * px_in
                                                      + Hp * Wp * 4))]
    levels = _levels(g, Hp, Wp, n_levels)
    n_img = batch * 2 * img
    pyr_flops = sum(resize_flops(n_img, Hp, Wp, h, w, 4) for h, w in levels)
    pyr_bytes = 4 * n_img * (Hp * Wp + sum(h * w for h, w in levels[1:]))
    stages.append(_stage("pyramid", {F32: pyr_flops}, pyr_bytes))
    wi = g["wiS"]
    feat_flops = feat_conv = feat_bytes = 0
    for h, w in levels:
        hf, wf = h // wi, w // wi
        feat_flops += 2 * n_img * h * w * g["nf"]               # projection
        conv = 2 * conv_flops(hf, wf, c, c, 3, batch)            # rec_ctx
        feat_conv += conv
        feat_bytes += 4 * n_img * h * w + fb * batch * c * hf * wf
    feat_bytes += _weights_bytes([(c, c, 3)] * 2)
    stages.append(_stage("features", {flow_dtype: feat_flops + feat_conv},
                         feat_bytes, feat_conv))
    lev_conv = lev_other = lev_bytes = 0
    for i, (h, w) in enumerate(levels):
        hf, wf = h // wi, w // wi
        bottom = i == n_levels - 1
        lev_conv += _flow_level_convs(g, hf, wf, bottom, batch)
        lev_bytes += fb * batch * (c + 4) * hf * wf
        if not bottom:
            # the coarser flow upsampled, two splats of half + 1 channels
            lev_other += resize_flops(batch * 4, hf // 2, wf // 2, hf, wf, 2)
            lev_other += 2 * 8 * batch * (half + 1) * hf * wf
            lev_bytes += fb * batch * 4 * (hf // 2) * (wf // 2)
    lev_bytes += _weights_bytes(
        [(c, c, 3)] * 3 + [(c, half, 3), (half, 6, 3), (c, half, 3),
                           (c + 4, c, 3), (c, c, 3), (c, half, 3),
                           (half, half, 3), (half, 4, 3)])
    stages.append(_stage("levels", {flow_dtype: lev_conv + lev_other},
                         lev_bytes, lev_conv))
    hf0, wf0 = levels[0][0] // wi, levels[0][1] // wi
    ext_flops = resize_flops(batch * 4, hf0, wf0, Hp, Wp, 2)
    # reads the flow and both frames; writes the full-resolution flows and
    # the two importance maps
    ext_bytes = 4 * batch * (4 * hf0 * wf0 + 2 * img * Hp * Wp
                             + 4 * Hp * Wp + 2 * Hp * Wp)
    stages.append(_stage("extras", {F32: ext_flops}, ext_bytes))
    return stages


def synth_stages(g: dict, H: int, W: int, Hp: int, Wp: int,
                 unet_dtype: str = F32, batch: int = 1) -> List[dict]:
    """The synthesis of one t at the padded Hp×Wp frame, its output H×W."""
    img, wi = g["img"], g["wiS"]
    N = batch * Hp * Wp
    hf, wf = Hp // wi, Wp // wi
    ub = _BYTES[unet_dtype]
    ch = img + 1                            # a splat's channels: colour + weight
    return [
        # two softmax splats: frames, importance maps and flows in,
        # the two warped frames out; 4 corners a channel
        _stage("splat", {F32: 2 * 8 * ch * N},
               4 * N * (2 * img + 2 + 4 + 2 * img)),
        # the flowback flows: two 2-channel gathers at the flow grid and
        # their bilinear upsampling
        _stage("flowback", {F32: 2 * 8 * 2 * batch * hf * wf
                            + resize_flops(batch * 4, hf, wf, Hp, Wp, 2)},
               4 * batch * (8 * hf * wf + 4 * Hp * Wp)),
        # the two frames gathered along the flowback flows
        _stage("gather", {F32: 2 * 8 * img * N},
               4 * N * (2 * img + 4 + 2 * img)),
        # the refine UNet: 26 channels in, 6 logits out, in unet_dtype
        _stage("unet", {unet_dtype: unet_convs(g, Hp, Wp, batch)},
               ub * N * (g["unet_in"] + g["unet_out"])
               + 4 * _unet_params(g), unet_convs(g, Hp, Wp, batch)),
        # the six-way blend: logits and six candidates in, the frame out
        _stage("blend", {F32: 2 * 6 * img * N},
               ub * N * g["unet_out"] + 4 * N * 6 * img
               + 4 * batch * H * W * img),
    ]


def _unet_params(g: dict) -> int:
    u, cin, cout = g["unet_nf"], g["unet_in"], g["unet_out"]
    convs = [(cin, u, 4), (u, 2 * u, 4), (2 * u, 4 * u, 4), (4 * u, 4 * u, 3),
             (6 * u, 2 * u, 3), (3 * u, u, 3), (u, cout, 3)]
    return sum(a * b * k * k + b for a, b, k in convs)


def train_forward_flops(g: dict, size: int, batch: int) -> Dict[str, int]:
    """The training forward's flops, all float32: the pyramid, features
    and flow at levels S_trn..0, and at every level the synthesis with
    its refine UNet."""
    n = g["S_trn"] + 1
    total: Dict[str, int] = {}
    stages = flow_stages(g, size, size, size, size, n, F32, batch, F32)
    for h, w in _levels(g, size, size, n):
        stages += synth_stages(g, h, w, h, w, F32, batch)
    for st in stages:
        for k, v in st["flops"].items():
            total[k] = total.get(k, 0) + v
    return total


def train_step_flops(g: dict, size: int, batch: int) -> Dict[str, int]:
    """A training step: 3 × the forward (forward, and backward to the
    activations and to the weights)."""
    return {k: 3 * v for k, v in train_forward_flops(g, size, batch).items()}


def floor_ms(stages: List[dict], peaks: dict) -> float:
    """Σ over stages of max(bytes / bandwidth, Σ flops / peak)."""
    total = 0.0
    for st in stages:
        t_bytes = st["bytes"] / (peaks["hbm_tb_s"] * 1e12)
        t_flops = sum(v / (peaks["tflops"][k] * 1e12)
                      for k, v in st["flops"].items())
        total += max(t_bytes, t_flops)
    return total * 1e3


def compute_ms(flops: Dict[str, int], peaks: dict) -> float:
    """The time the flops take at the peak of their precisions."""
    return sum(v / (peaks["tflops"][k] * 1e12) for k, v in flops.items()) * 1e3


def total_flops(stages: List[dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for st in stages:
        for k, v in st["flops"].items():
            out[k] = out.get(k, 0) + v
    return out
