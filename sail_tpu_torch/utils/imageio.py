"""Image output helpers, PPM and PNG (port of `sail_tpu/utils/imageio.py`;
numpy and zlib).  `png_bytes` takes the native codec (`utils/native.py`)
where it builds, as the JAX package does, and the Python encoder (the
same bytes as the JAX package's) on a host without g++."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Float HDR image → display uint8 with gamma."""
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    x = np.power(x, 1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path: str, img: np.ndarray, gamma: float = 2.2):
    u8 = to_uint8(img, gamma)
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def png_bytes(img: np.ndarray, gamma: float = 2.2) -> bytes:
    """PNG bytes (8-bit RGB, zlib level 6) of a float HDR image: the
    native codec's tone map and encoder where it builds, else `to_uint8`
    and the Python encoder."""
    from . import native
    if native.available():
        return native.png_bytes(np.asarray(img, np.float32), gamma)
    return _png_bytes_py(to_uint8(img, gamma))


def _png_bytes_py(u8: np.ndarray) -> bytes:
    h, w, _ = u8.shape
    raw = b"".join(b"\x00" + u8[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, gamma: float = 2.2):
    with open(path, "wb") as f:
        f.write(png_bytes(img, gamma))
