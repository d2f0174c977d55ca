"""The correlation kernel of csrc/correlation.cu at every geometry of
GEOMETRIES — (TY, XG, G): TY×4·XG pixel tiles, G channel groups — and, with
--variants, at variants of its source, at chip_smoke.py's CORR_ROWS (the
teacher's five cost volumes, batch 8). Each launch is checked against the
plain version (1e-5·(1+|ref|)) and timed on the device alone
(chip_smoke.queued_ms), twice in turn. This is how the entry point's
choice of geometry was made:

    python fldrx_torch/tools/corr_geometry.py [--variants] [--out FILE]

The variants: 16-channel chunks ("cc16"), 8 pixels a thread ("px8"), a
minimum of blocks per SM in __launch_bounds__ ("occ") and streaming
stores ("cs"). Prints one JSON line (the card, and for each row and
kernel its two times in ms); --out also appends it to a file. Needs a GPU
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

GEOMETRIES = ((4, 8, 1), (8, 4, 1), (4, 4, 1), (2, 8, 1), (4, 8, 2),
              (2, 8, 2), (4, 4, 2), (2, 4, 2), (2, 4, 4), (2, 2, 8),
              (1, 4, 8), (1, 2, 8))

# (name, text of csrc/correlation.cu, its replacement)
VARIANTS = (
    ("cc16", "constexpr int kCc = 8;", "constexpr int kCc = 16;"),
    ("px8", "constexpr int kPX = 4;", "constexpr int kPX = 8;"),
    ("occ", "__launch_bounds__(Geom<TY, XG, G>::kThreads)",
     "__launch_bounds__(Geom<TY, XG, G>::kThreads, "
     "1152 / Geom<TY, XG, G>::kThreads)"),
    ("cs", "*reinterpret_cast<float4*>(o + e) =\n"
           "            make_float4(v.x * inv_c, v.y * inv_c, v.z * inv_c, "
           "v.w * inv_c);",
     "__stcs(reinterpret_cast<float4*>(o + e),\n"
     "            make_float4(v.x * inv_c, v.y * inv_c, v.z * inv_c, "
     "v.w * inv_c));"),
)


def entry_point() -> str:
    """A C entry point that launches geometry number gi of GEOMETRIES."""
    cases = "\n".join(
        f"    case {i}: return launch<{ty}, {xg}, {g}>(f1, f2, out, B, H, W, "
        f"C, vi, vo, s);" for i, (ty, xg, g) in enumerate(GEOMETRIES))
    return f'''
extern "C" int corr_geometry(const float* f1, const float* f2, float* out,
                             int B, int H, int W, int C, int gi,
                             void* stream) {{
  const bool vi = C % 4 == 0 && aligned16(f1) && aligned16(f2);
  const bool vo = W % 4 == 0 && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (gi) {{
{cases}
  }}
  return -1;
}}
'''


def build(variants):
    """Build the kernel source and each variant (one nvcc each, all at
    once) into fldrx_torch/_build/corr_geometry/; returns {name: CDLL}."""
    from fldrx_torch.ops import _build

    with open(os.path.join(_build.SRC_DIR, "correlation.cu")) as f:
        base = f.read()
    sources = {"kernel": base}
    for name, old, new in variants:
        if old not in base:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               "csrc/correlation.cu")
        sources[name] = base.replace(old, new)
    out_dir = os.path.join(_build.BUILD_DIR, "corr_geometry")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src + entry_point())
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.corr_geometry.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("corr_geometry: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from fldrx_torch.ops import correlation

    libs = build(VARIANTS if args.variants else ())
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for label, B, H, W, C in smoke.CORR_ROWS:
        f1 = torch.randn(B, H, W, C, device="cuda", generator=g)
        f2 = torch.randn(B, H, W, C, device="cuda", generator=g)
        ref = correlation.correlation_cost_volume(f1, f2)
        out = torch.empty_like(ref)
        runs = {}
        for name, lib in libs.items():
            for gi, geom in enumerate(GEOMETRIES):
                def run(lib=lib, gi=gi):
                    return lib.corr_geometry(f1.data_ptr(), f2.data_ptr(),
                                             out.data_ptr(), B, H, W, C, gi,
                                             stream)
                out.fill_(float("nan"))
                if run():             # refused: too much shared memory
                    continue
                torch.cuda.synchronize()
                if not smoke.excess(out, ref, 1e-5) <= 0:
                    raise AssertionError(f"{name} {geom} disagrees with the "
                                         f"plain version at {label}")
                runs[f"{name} {geom}"] = run
        times = {k: [] for k in runs}
        for _ in range(2):
            for k, run in runs.items():
                times[k].append(smoke.queued_ms(run))
        rows[label] = times
        best = sorted(times.items(), key=lambda kv: min(kv[1]))[:4]
        print(f"{label}: " + ", ".join(f"{k} {min(v):.4f}" for k, v in best),
              flush=True)
        del f1, f2, ref, out
    line = json.dumps({"card": smoke.card_line(), "rows": rows})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
