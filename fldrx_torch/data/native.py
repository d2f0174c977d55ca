"""The native PNG decoder (counterpart of fldrx/data/native.py): ctypes
bindings of csrc/decoder.cpp, which libpng decodes to 8-bit BGR on a pool
of threads.

The library is built at first use by ops/_build.py with the host C++
compiler and libpng. Where it cannot be built (no compiler, no libpng),
`get_lib` returns None after one warning that carries the build error, and
the readers decode with PIL; where PIL is missing too they raise
`NoPNGDecoder`. `decoder_in_use()` says which decoder ran last.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from typing import List, Optional, Tuple

import numpy as np

from ..ops import _build


class NoPNGDecoder(RuntimeError):
    """Neither the native decoder nor PIL is available."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_in_use: Optional[str] = None


def get_lib() -> Optional[ctypes.CDLL]:
    """The decoder library, built at first use; None where it cannot be
    built or loaded (the first such call warns with the error)."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _build.library("decoder")
            except (RuntimeError, OSError) as e:
                _build_error = str(e)
                warnings.warn("the native PNG decoder cannot be built, PNGs "
                              f"decode with PIL: {_build_error}",
                              RuntimeWarning, stacklevel=2)
        return _lib


def build_error() -> Optional[str]:
    """Why the library could not be built, or None."""
    return _build_error


def decoder_in_use() -> Optional[str]:
    """"native" or "pil": the decoder of the last decode; None before
    any."""
    return _in_use


def _ran(name: str) -> None:
    global _in_use
    _in_use = name


def probe_png(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) of a PNG, or None (no library, not a readable
    PNG)."""
    lib = get_lib()
    if lib is None:
        return None
    w, h = ctypes.c_uint32(), ctypes.c_uint32()
    if lib.fldrx_png_probe(os.fsencode(path), ctypes.byref(w),
                           ctypes.byref(h)):
        return None
    return int(w.value), int(h.value)


def decode_png_batch_bgr(paths: List[str],
                         threads: int = 8) -> Optional[np.ndarray]:
    """Decode PNGs of one size to [N, H, W, 3] uint8 BGR on `threads` C++
    threads. None where the library is missing, the list is empty, a size
    differs from the first file's or a decode fails: the caller then
    decodes one by one. The frames are views into one array."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    wh = probe_png(paths[0])
    if wh is None:
        return None
    w, h = wh
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    names = [os.fsencode(p) for p in paths]     # alive across the call
    c_paths = (ctypes.c_char_p * n)(*names)
    c_outs = (ctypes.c_void_p * n)(*[out[i].ctypes.data for i in range(n)])
    if lib.fldrx_png_decode_batch(c_paths, n, c_outs, w, h, threads):
        return None
    _ran("native")
    return out


def _pil_bgr(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        native = (f"is unavailable ({_build_error})" if _build_error
                  else "cannot read it")
        raise NoPNGDecoder(f"cannot decode {path}: the native PNG decoder "
                           f"{native} and PIL is not installed") from None
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), np.uint8)
    _ran("pil")
    return np.ascontiguousarray(rgb[..., ::-1])


def read_bgr(path: str) -> np.ndarray:
    """One image → uint8 HWC BGR: the native decoder where it reads the
    file, else PIL (which also reads what is not a PNG)."""
    lib = get_lib()
    wh = probe_png(path) if lib is not None else None
    if wh is not None:
        w, h = wh
        out = np.empty((h, w, 3), np.uint8)
        if lib.fldrx_png_decode(os.fsencode(path), out.ctypes.data, w,
                                h) == 0:
            _ran("native")
            return out
    return _pil_bgr(path)


def read_bgr_batch(paths: List[str], threads: int = 3) -> List[np.ndarray]:
    """Images → uint8 HWC BGR arrays, each its own copy: one native batch
    call where the files share a size, else one by one."""
    batch = decode_png_batch_bgr(paths, threads)
    if batch is None:
        return [read_bgr(p) for p in paths]
    # copies: views would pin the whole batch array while any one lives
    return [f.copy() for f in batch]
