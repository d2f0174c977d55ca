"""Golden-clip quality fixture, a numpy copy of fldrx/eval/goldenclip.py: a
deterministic, procedurally generated scene with exact ground truth at any
t — the benchmark protocol's proxy for the X-Test/Inter4K footage, which is
not in the repository (reference protocol: the reference's
main.py:842-911).

Scene model: a band-limited textured background panning at one velocity
plus soft-edged textured discs moving at other velocities — so the clip
has occlusion AND disocclusion boundaries with large motion (up to ~60 px
at 4K scale). Every frame is rendered analytically from the scene model at
time t (NOT warped from another frame), so GT is exact and the pinned PSNRs
regression-test the full pipeline end to end: any kernel/precision change
that moves quality shows up as a PSNR shift.

All geometry scales with (H, W) so the CPU test (512×768, S_tst=3) and the
4K run (test5scales) render the same scene. `golden_psnrs` runs the ×N
protocol through the port's `Interpolator.interpolate_multi_np`;
`GoldenTestSet` serves one pair to the evaluator as an 8-bit test set.
"""

from __future__ import annotations

import numpy as np

from ..data.datasets import TestDataset, TestItem


def _texture(xx, yy, phases, scale=1.0):
    """Band-limited texture in [-1,1] from fixed sinusoid banks."""
    t = np.zeros_like(xx)
    for (fx, fy, px, py, a) in phases:
        t = t + a * np.sin(xx * fx * scale + px) * np.cos(yy * fy * scale + py)
    m = np.max(np.abs(t)) + 1e-6
    return 0.85 * t / m


_BG_PHASES = [
    (0.055, 0.042, 0.3, 1.1, 1.0), (0.21, 0.17, 2.0, 0.4, 0.5),
    (0.013, 0.019, 0.9, 2.2, 0.8), (0.35, 0.29, 1.4, 2.8, 0.25),
]
_FG_PHASES = [
    [(0.09, 0.07, 0.1, 0.5, 1.0), (0.28, 0.33, 1.2, 0.2, 0.45)],
    [(0.06, 0.11, 2.1, 1.3, 1.0), (0.41, 0.23, 0.6, 1.9, 0.35)],
    [(0.15, 0.05, 0.8, 2.6, 1.0), (0.24, 0.38, 2.4, 0.9, 0.4)],
]

# (center_x, center_y, radius, vel_x, vel_y) — fractions of (W, H) for
# positions/radius, fractions of W per unit time for velocity
_DISCS = [
    (0.30, 0.40, 0.110, +0.0150, +0.0045),
    (0.62, 0.62, 0.080, -0.0110, +0.0060),
    (0.78, 0.25, 0.060, +0.0065, -0.0110),
]
_BG_VEL = (-0.0058, +0.0023)      # background pan (fraction of W per unit t)


def render_golden(H: int, W: int, t: float, family: str = "pan") -> np.ndarray:
    """Render a golden scene at time t ∈ [0, 1] → [H, W, 3] f32 in [-1,1].

    Families (VERDICT r3 weak #7 — the quality gate needs more than one
    content class; each is fully analytic so GT is exact at any t):
      pan    — textured background pan + occluding textured discs (the
               original fixture: occlusion/disocclusion + large motion)
      affine — rotation + zoom + shear about the centre (+ a moving disc):
               spatially VARYING flow, the case the low-res flowback and
               spill tiers never see from pure pans
      thin   — moving thin textured bars at several angles over a slow
               pan: thin-structure destruction under splat spreading
      flat   — low-frequency low-amplitude gradients, slow pan: banding /
               precision sensitivity (bf16 quality canary)
    """
    if family == "affine":
        return _render_affine(H, W, t)
    if family == "thin":
        return _render_thin(H, W, t)
    if family == "flat":
        return _render_flat(H, W, t)
    assert family == "pan", family
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    sc = 768.0 / W                     # geometry-invariant texture frequency
    out = None

    bx, by = _BG_VEL[0] * W * t, _BG_VEL[1] * W * t
    chans = []
    for c in range(3):
        ph = [(fx, fy, px + 0.7 * c, py + 1.3 * c, a)
              for fx, fy, px, py, a in _BG_PHASES]
        chans.append(_texture((xx - bx) * sc, (yy - by) * sc, ph))
    out = np.stack(chans, -1)

    edge = max(1.5, W / 512.0)         # soft disc edge (anti-aliased)
    for i, (cx, cy, r, vx, vy) in enumerate(_DISCS):
        px = (cx + vx * t) * W
        py = (cy + vy * t * (W / H)) * H
        rad = r * W
        d = np.sqrt((xx - px) ** 2 + (yy - py) ** 2)
        alpha = np.clip((rad - d) / edge, 0.0, 1.0)[..., None]
        chans = []
        for c in range(3):
            ph = [(fx, fy, px0 + 0.9 * c, py0 + 0.5 * c, a)
                  for fx, fy, px0, py0, a in _FG_PHASES[i]]
            chans.append(_texture((xx - px) * sc, (yy - py) * sc, ph))
        fg = np.stack(chans, -1)
        out = out * (1 - alpha) + fg * alpha
    return out.astype(np.float32)


def _render_affine(H: int, W: int, t: float) -> np.ndarray:
    """Rotation + zoom + shear of the background about the image centre,
    plus one independently moving occluding disc. Far-corner displacement
    ≈ 55 px at 4K (within the pan family's large-motion envelope)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    sc = 768.0 / W
    cx, cy = W / 2.0, H / 2.0
    ang, zoom, shear = 0.012 * t, 1.0 + 0.014 * t, 0.008 * t
    ca, sa = np.cos(ang), np.sin(ang)
    # forward map M = zoom·R(ang)·Shear; sample the texture at M⁻¹·(p−c)
    m00, m01 = zoom * ca, zoom * (ca * shear - sa)
    m10, m11 = zoom * sa, zoom * (sa * shear + ca)
    det = m00 * m11 - m01 * m10
    i00, i01, i10, i11 = m11 / det, -m01 / det, -m10 / det, m00 / det
    dx, dy = xx - cx, yy - cy
    u = i00 * dx + i01 * dy
    v = i10 * dx + i11 * dy
    chans = []
    for c in range(3):
        ph = [(fx, fy, px + 0.7 * c, py + 1.3 * c, a)
              for fx, fy, px, py, a in _BG_PHASES]
        chans.append(_texture(u * sc, v * sc, ph))
    out = np.stack(chans, -1)

    edge = max(1.5, W / 512.0)
    cx_d, cy_d, r, vx, vy = 0.35, 0.55, 0.09, +0.0125, -0.0050
    px = (cx_d + vx * t) * W
    py = (cy_d + vy * t * (W / H)) * H
    d = np.sqrt((xx - px) ** 2 + (yy - py) ** 2)
    alpha = np.clip((r * W - d) / edge, 0.0, 1.0)[..., None]
    chans = [_texture((xx - px) * sc, (yy - py) * sc,
                      [(fx, fy, p0 + 0.9 * c, p1 + 0.5 * c, a)
                       for fx, fy, p0, p1, a in _FG_PHASES[0]])
             for c in range(3)]
    return (out * (1 - alpha)
            + np.stack(chans, -1) * alpha).astype(np.float32)


# (angle_rad, start_offset, normal_velocity, half_width) — offsets and
# velocity as fractions of W; half_width as a fraction of W, floored at
# ~1.5 px so the bars stay genuinely thin at test resolution
_BARS = [
    (0.35, 0.30, +0.0120, 0.0040),
    (1.25, 0.55, -0.0095, 0.0022),
    (2.10, 0.10, +0.0080, 0.0013),
    (2.80, 0.75, -0.0135, 0.0030),
]


def _render_thin(H: int, W: int, t: float) -> np.ndarray:
    """Thin textured bars sweeping along their normals over a slowly
    panning background — splat spreading / hole-filling destroys thin
    structures first, so this family guards them explicitly."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    sc = 768.0 / W
    bx, by = 0.25 * _BG_VEL[0] * W * t, 0.25 * _BG_VEL[1] * W * t
    chans = []
    for c in range(3):
        ph = [(fx, fy, px + 0.7 * c, py + 1.3 * c, 0.6 * a)
              for fx, fy, px, py, a in _BG_PHASES]
        chans.append(_texture((xx - bx) * sc, (yy - by) * sc, ph))
    out = np.stack(chans, -1)
    edge = max(1.0, W / 1024.0)
    for i, (ang, off0, vel, hw) in enumerate(_BARS):
        nx, ny = np.cos(ang), np.sin(ang)
        d = np.abs(xx * nx + yy * ny - (off0 + vel * t) * W)
        halfw = max(1.5, hw * W)
        alpha = np.clip((halfw - d) / edge, 0.0, 1.0)[..., None]
        phases = _FG_PHASES[i % len(_FG_PHASES)]
        along = xx * (-ny) + yy * nx       # texture varies along the bar
        chans = [_texture(along * sc, d * sc,
                          [(fx, fy, p0 + 0.9 * c + i, p1 + 0.5 * c, a)
                           for fx, fy, p0, p1, a in phases])
                 for c in range(3)]
        out = out * (1 - alpha) + np.stack(chans, -1) * alpha
    return out.astype(np.float32)


def _render_flat(H: int, W: int, t: float) -> np.ndarray:
    """Slowly panning low-frequency, low-amplitude gradients plus one soft
    radial bump — no texture to hide behind, so precision loss (bf16
    rounding, resize ringing) reads directly as banding here."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    u = (xx - 0.0100 * W * t) / W
    v = (yy - 0.0040 * W * t) / H
    two_pi = 2 * np.pi
    chans = []
    for c in range(3):
        g = (0.45 * np.sin(two_pi * (0.70 * u + 0.40 * v) + 0.9 * c)
             + 0.22 * np.cos(two_pi * (0.30 * u - 0.55 * v) + 0.4 * c)
             + 0.12 * np.sin(two_pi * (1.10 * u + 0.90 * v) + 1.7 * c))
        chans.append(g)
    out = np.stack(chans, -1)
    # soft radial highlight drifting against the pan
    px, py = (0.45 - 0.0080 * t) * W, (0.50 + 0.0055 * t * (W / H)) * H
    r2 = ((xx - px) ** 2 + (yy - py) ** 2) / (0.18 * W) ** 2
    out = out + 0.28 * np.exp(-r2)[..., None]
    # fixed normalizer (sum of component amplitudes): a data-dependent max
    # would pump global brightness between frames as the scene pans
    return (0.8 * out / 1.07).astype(np.float32)


GOLDEN_FAMILIES = ("pan", "affine", "thin", "flat")


def golden_pair(H: int, W: int, multiple: int = 8, family: str = "pan"):
    """Returns (frames [1,2,H,W,3], t_values [multiple-1], gts [T,H,W,3])."""
    f0 = render_golden(H, W, 0.0, family)
    f1 = render_golden(H, W, 1.0, family)
    ts = np.linspace(1 / multiple, 1 - 1 / multiple, multiple - 1)
    gts = np.stack([render_golden(H, W, float(t), family) for t in ts], 0)
    return np.stack([f0, f1], 0)[None], ts, gts


def to_uint8_frames(frames: np.ndarray) -> np.ndarray:
    """Frames in [-1, 1] → 8-bit, the inverse of frames_to_tensor up to
    rounding (values past ±1 clip)."""
    return np.clip(np.around((frames + 1.0) * 127.5), 0, 255).astype(np.uint8)


class GoldenTestSet(TestDataset):
    """One golden pair as an 8-bit ×N test set held in memory, for
    `evaluate(..., dataset=)`: item k is (I0, I1, the target at ts[k]),
    like an X-Test scene. Built from golden_pair's output, so a caller that
    has rendered the clip does not render it again."""

    def __init__(self, frames: np.ndarray, ts, gts: np.ndarray,
                 family: str = "pan"):
        name = f"golden/{family}/"
        self._store = {name + "I0": to_uint8_frames(frames[0, 0]),
                       name + "I1": to_uint8_frames(frames[0, 1])}
        self.items = []
        for k, t in enumerate(ts):
            self._store[name + f"t{k}"] = to_uint8_frames(gts[k])
            self.items.append(TestItem(paths=(name + "I0", name + "I1",
                                              name + f"t{k}"),
                                       t=float(t), scene=f"golden_{family}"))

    def _frames(self, paths) -> np.ndarray:
        return np.stack([self._store[p] for p in paths], 0)


def golden_psnrs(interp, H: int, W: int, multiple: int = 8,
                 family: str = "pan"):
    """Run the ×N protocol on the golden pair and return per-t PSNRs (dB,
    data_range=255 like the benchmark protocol) plus their mean."""
    from ..ops import metrics

    frames, ts, gts = golden_pair(H, W, multiple, family)
    preds = interp.interpolate_multi_np(frames, list(ts))[:, 0]
    ps = []
    for pred, gt in zip(preds, gts):
        ps.append(metrics.psnr(metrics.denorm255(gt),
                               np.around(metrics.denorm255(pred))))
    return np.asarray(ps), float(np.mean(ps))
