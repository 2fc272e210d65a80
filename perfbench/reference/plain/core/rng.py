"""Counter-based random numbers, bit-exact with `sail_tpu/core/rng.py`.

Every (seed, sample, bounce, tag, pixel) tuple hashes to the same three
uniforms the JAX package draws, so the port traces the same paths.  The JAX
version runs the hash in int32 with wrapping multiplies; here each 32-bit
word is held as a non-negative int64 in [0, 2**32) and every product is
split into 16-bit halves so that no intermediate leaves int64's range (no
reliance on signed overflow).  Right shifts of non-negative values are
logical, which is what the JAX version's shift-plus-mask computes.  The CUDA
megakernel runs the same hash in `uint32_t` (`csrc/megakernel.cu`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve

# Purpose tags — keep unique so streams never collide.
TAG_PIXEL_JITTER = 0
TAG_BSDF = 1
TAG_LIGHT_PICK = 2
TAG_LIGHT_U = 3
TAG_LOBE = 4
TAG_LENS = 5

_MASK = 0xFFFFFFFF


def _u32(x, device=None) -> torch.Tensor:
    """Any int (or int tensor) as its uint32 bit pattern in int64."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 words held in int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _pcg3d(x, y, z):
    """3-in 3-out PCG hash (Jarzynski & Olano)."""
    m = 1664525
    a = 1013904223
    x = (_mul(x, m) + a) & _MASK
    y = (_mul(y, m) + a) & _MASK
    z = (_mul(z, m) + a) & _MASK
    x = (x + _mul(y, z)) & _MASK
    y = (y + _mul(z, x)) & _MASK
    z = (z + _mul(x, y)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + _mul(y, z)) & _MASK
    y = (y + _mul(z, x)) & _MASK
    z = (z + _mul(x, y)) & _MASK
    return x, y, z


def _splitmix32(x):
    x = (x + 0x9E3779B9) & _MASK
    x = _mul(x ^ (x >> 16), 0x21F0AAAD)
    x = _mul(x ^ (x >> 15), 0x735A2D97)
    return x ^ (x >> 15)


def _to_unit(u):
    """Hash word → float32 in [0, 1) from its top 24 bits."""
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def stream(seed, sample_idx, bounce: int, tag: int) -> torch.Tensor:
    """Mix (seed, sample, bounce, tag) into one stream id (uint32 in int64)."""
    s = _u32(seed)
    s = _splitmix32(s ^ _splitmix32(_u32(sample_idx, s.device)))
    return _splitmix32(s ^ ((bounce * 0x9E37 + tag * 0x85EB + 0x1234) & _MASK))


def pixel_uniform3(stream_id, ii, jj):
    """Three independent float32 uniforms per pixel for one stream.  `ii`,
    `jj` are global integer pixel coordinates (any shape)."""
    ii = _u32(ii)
    jj = _u32(jj)
    sid = _u32(stream_id, ii.device).broadcast_to(ii.shape)
    a, b, c = _pcg3d(jj, ii, sid)
    return _to_unit(a), _to_unit(b), _to_unit(c)


class PixelNoise(NamedTuple):
    """Noise coordinates for one progressive sample pass: the RNG is a pure
    function of (seed, sample, bounce, tag, pixel)."""
    seed: int
    sample: int
    ii: torch.Tensor   # global pixel rows
    jj: torch.Tensor   # global pixel cols

    def uniform3(self, bounce: int, tag: int):
        return pixel_uniform3(stream(self.seed, self.sample, bounce, tag),
                              self.ii, self.jj)


def pixel_noise(seed, sample_idx, shape=None, ii=None, jj=None,
                device=None) -> PixelNoise:
    """PixelNoise for an (H, W) image block or a flat ray batch of `shape`
    (grids on `device`: the card unless the caller asks for another), or
    for the given global pixel coordinates `ii`, `jj`."""
    if ii is None:
        device = resolve(device, "pixel_noise")
        if len(shape) == 2:
            h, w = shape
            ii = torch.arange(h, dtype=torch.int32, device=device)[:, None] \
                .expand(shape)
            jj = torch.arange(w, dtype=torch.int32, device=device)[None, :] \
                .expand(shape)
        else:
            (n,) = shape
            ii = torch.arange(n, dtype=torch.int32, device=device)
            jj = torch.zeros((n,), dtype=torch.int32, device=device)
    return PixelNoise(seed, sample_idx, ii, jj)
