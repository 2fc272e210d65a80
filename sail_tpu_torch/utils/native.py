"""ctypes binding to the native image codec (port of
`sail_tpu/utils/native.py`).

The codec is the repository's `native/imagecodec.cpp`: an HDR float image
tone-mapped through a 4096-entry LUT (sqrt-indexed, so the dark end keeps
its resolution) and encoded as a PNG through zlib.  It is built at first
use by `utils/build.load_host` (g++ -O3 -fPIC -shared -lz) into
`build/native/`, leaving `native/` as it is.  `utils/imageio.png_bytes`
takes it where `available()`, the Python encoder otherwise (a host without
g++ or zlib's headers).  The LUT's tone map is within 3/255 of
`imageio.to_uint8`'s `pow` (the JAX package's own bound); the encoder
alone gives the Python encoder's pixels.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from . import build

SOURCE = os.path.join(build.REPO_DIR, "native", "imagecodec.cpp")

_lib = None
_error = None


def _load():
    """The loaded library, building it at the first call; None (and the
    reason in `_error`) where it cannot be built."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            lib = build.load_host(SOURCE, ("-lz",))
        except (OSError, RuntimeError) as e:
            _error = e
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tonemap_u8.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, u8p]
        lib.tonemap_u8.restype = None
        lib.encode_png.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                   ctypes.c_long]
        lib.encode_png.restype = ctypes.c_long
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the codec builds and loads on this host."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native image codec is not available: "
                           f"{_error}")
    return lib


def tonemap_u8(hdr: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """(H, W, 3) float → uint8 through the codec's clamp-and-gamma LUT."""
    lib = _require()
    hdr = np.ascontiguousarray(hdr, np.float32)
    h, w, _ = hdr.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.tonemap_u8(hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
                   ctypes.c_float(gamma),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def encode_png(u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → PNG bytes (8-bit RGB, filter 0, zlib level 6)."""
    lib = _require()
    u8 = np.ascontiguousarray(u8, np.uint8)
    h, w, _ = u8.shape
    cap = h * w * 3 + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.encode_png(u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h,
                       w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       cap)
    if n < 0:
        raise RuntimeError(f"native png encode failed ({n})")
    return out[:n].tobytes()


def png_bytes(hdr: np.ndarray, gamma: float = 2.2) -> bytes:
    """HDR float image → PNG bytes, both steps native."""
    return encode_png(tonemap_u8(hdr, gamma))
