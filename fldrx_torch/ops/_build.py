"""Build and load the port's CUDA kernels and its host library.

Each CUDA source in `fldrx_torch/csrc/` (SOURCES, `<name>.cu`) is compiled
on first use by `nvcc` into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds rather than minutes) and loaded
with ctypes, the argument types taken from the source's `extern "C"`
prototypes. Wrappers pass pointers from `tensor.data_ptr()` and the stream
from `torch.cuda.current_stream().cuda_stream`; each C entry point returns
the `cudaGetLastError()` of its launch, which the wrapper raises on.

The host sources (HOST_SOURCES, `<name>.cpp`: the PNG decoder) take the
same route through the host C++ compiler (`$CXX`, else g++ or c++) with
HOST_FLAGS and HOST_LIBS.

Builds go to `fldrx_torch/_build/` (git-ignored), named by a hash of the
source and flags so a changed source is rebuilt. A failed build raises: no
wrapper falls back to the plain version. `build_all()` starts one `nvcc` per
CUDA source at once and waits for all of them. `BUILDS` counts, for the
process, the libraries built, the seconds it waited on the compilers, and
the libraries found already built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("warp", "conv3x3", "correlation", "repack", "resize", "blend")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_SOURCES = ("decoder",)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
HOST_LIBS = ("-lpng", "-lpthread")

BUILDS = {"built": 0, "compile_s": 0.0, "cached": 0}

_PROTO = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def source_path(name: str) -> str:
    """csrc/<name>.cpp for a host source, else csrc/<name>.cu."""
    ext = ".cpp" if name in HOST_SOURCES else ".cu"
    return os.path.join(SRC_DIR, name + ext)


def prototypes(name: str) -> Dict[str, List]:
    """The ctypes argument types of each `extern "C" int fn(...)` entry
    point in the source `name`, read from the source itself so the binding
    cannot drift from it: a pointer is c_void_p, an `int` is c_int, a
    `uint32_t` is c_uint32, and any other parameter type raises."""
    with open(source_path(name)) as f:
        src = f.read()
    protos = {}
    for fn, params in _PROTO.findall(src):
        types = []
        for param in params.split(","):
            words = param.replace("*", " * ").split()
            if "*" in words:
                types.append(ctypes.c_void_p)
            elif words[:-1] == ["int"]:
                types.append(ctypes.c_int)
            elif words[:-1] == ["uint32_t"]:
                types.append(ctypes.c_uint32)
            else:
                raise TypeError(f"{name}: {fn}: no ctypes type for "
                                f"parameter {param.strip()!r}")
        protos[fn] = types
    if not protos:
        raise RuntimeError(f"{name} declares no extern \"C\" entry point")
    return protos


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (set CXX)")


def _flags(name: str):
    if name in HOST_SOURCES:
        return HOST_FLAGS + HOST_LIBS
    return NVCC_FLAGS


def library_path(name: str) -> str:
    """Where the library built from the source `name` lives (named by a
    hash of the source and the flags)."""
    with open(source_path(name), "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start the compiler for `name` unless its library exists; returns
    (process or None, library path, temporary output path)."""
    path = library_path(name)
    if os.path.exists(path):
        return None, path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    src = source_path(name)
    if name in HOST_SOURCES:
        # the libraries follow the source, or the linker drops them
        cmd = [_cxx(), *HOST_FLAGS, "-o", tmp, src, *HOST_LIBS]
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, path, tmp


def _finish(name: str, proc, path: str, tmp) -> str:
    """Wait for a build started by `_start`; returns the compiler's output."""
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for "
                           f"{os.path.basename(source_path(name))}:\n{out}")
    os.replace(tmp, path)          # atomic: a reader never sees half a file
    return out


def _tally(procs, t0: float) -> None:
    """Count builds started at t0 (a process each, None where the library
    was found) into BUILDS, with the seconds waited for them."""
    built = sum(p is not None for p in procs)
    BUILDS["built"] += built
    BUILDS["cached"] += len(procs) - built
    if built:
        BUILDS["compile_s"] += time.perf_counter() - t0


def build_all() -> Dict[str, str]:
    """Build every source in parallel; returns {name: nvcc output}."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in SOURCES}
    out = {n: _finish(n, *s) for n, s in started.items()}
    _tally([s[0] for s in started.values()], t0)
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for the source `name`, built at first use."""
    t0 = time.perf_counter()
    proc, path, tmp = _start(name)
    _finish(name, proc, path, tmp)
    _tally([proc], t0)
    lib = ctypes.CDLL(path)
    for fn, argtypes in prototypes(name).items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
