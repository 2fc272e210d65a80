"""Procedural surface textures and the Perlin noise library (port of
`sail_tpu/ops/textures.py`).  `surface_color` dispatches over the scene's
texture rows with per-ray row masks, then applies the Cornell-wall
override; `perlin`, `fbm` and `turbulence` are library ops that no texture
row reads, as in the JAX package."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from ..core import vecmath as vm
from ..core.vecmath import Vec3


def _const(color, like: torch.Tensor) -> Vec3:
    return Vec3(*(vm.full(like.shape, c, like) for c in color))


def checkerboard(p, uv_u, uv_v) -> Vec3:
    """White grid with a grey outline."""
    width = 0.5 * p.line_width / p.size
    fx = uv_u / p.size - torch.floor(uv_u / p.size)
    fy = uv_v / p.size - torch.floor(uv_v / p.size)
    in_outline = (fx < width) | (fx > 1.0 - width) | (fy < width) \
        | (fy > 1.0 - width)
    return vm.where(in_outline, _const(C.GREY, uv_u), _const(C.WHITE, uv_u))


def checkerboard2(p, uv_u, uv_v) -> Vec3:
    """Two-color checker."""
    iu = torch.floor(uv_u / p.size)
    iv = torch.floor(uv_v / p.size)
    even = torch.remainder(iu + iv, 2.0) < 0.5
    s = uv_u.shape
    return vm.where(even, p.color1.broadcast_to(s), p.color2.broadcast_to(s))


def bilerp(p, uv_u, uv_v) -> Vec3:
    s = uv_u.shape
    return (p.color00.broadcast_to(s) * ((1.0 - uv_u) * (1.0 - uv_v)) +
            p.color01.broadcast_to(s) * ((1.0 - uv_u) * uv_v) +
            p.color10.broadcast_to(s) * (uv_u * (1.0 - uv_v)) +
            p.color11.broadcast_to(s) * (uv_u * uv_v))


def mixf(p, uv_u, uv_v) -> Vec3:
    s = uv_u.shape
    return vm.lerp(p.color1.broadcast_to(s), p.color2.broadcast_to(s),
                   p.amount)


def scalef(p, uv_u, uv_v) -> Vec3:
    return (p.color1 * p.color2).broadcast_to(uv_u.shape)


def uvf(p, uv_u, uv_v) -> Vec3:
    return Vec3(uv_u - torch.floor(uv_u), uv_v - torch.floor(uv_v),
                torch.zeros_like(uv_u))


_TEX_FNS = {
    C.CHECKERBOARD: checkerboard,
    C.CHECKERBOARD2: checkerboard2,
    C.BILERP: bilerp,
    C.MIXF: mixf,
    C.SCALE: scalef,
    C.UVF: uvf,
}


def surface_color(textures: tuple, static, tex_row, hit_p: Vec3, uv_u, uv_v,
                  sc_override: Vec3, use_override) -> Vec3:
    shape = uv_u.shape
    sc = vm.zeros_vec(shape, uv_u)   # C.BLACK where no row matches
    for row, (cat, params) in enumerate(zip(static.texture_categories,
                                            textures)):
        if cat == C.UNIFORM_COLOR:
            val = params.color.broadcast_to(shape)
        else:
            val = _TEX_FNS[cat](params, uv_u, uv_v)
        sc = vm.where(tex_row == row, val, sc)
    return vm.where(use_override > 0, sc_override, sc)


# -- Perlin noise library -----------------------------------------------------

_NOISE_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225, 140,
    36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148, 247, 120,
    234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32, 57, 177, 33,
    88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175, 74, 165, 71,
    134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122, 60, 211, 133,
    230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54, 65, 25, 63, 161,
    1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169, 200, 196, 135, 130,
    116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64, 52, 217, 226, 250,
    124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212, 207, 206, 59, 227,
    47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213, 119, 248, 152, 2, 44,
    154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9, 129, 22, 39, 253, 19,
    98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104, 218, 246, 97, 228,
    251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241, 81, 51, 145,
    235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157, 184, 84,
    204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93, 222, 114,
    67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], dtype=np.int64)
_NPS = 256


@functools.lru_cache(maxsize=None)
def _perm2(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([_NOISE_PERM, _NOISE_PERM])
                            ).to(device)


def _grad(perm2, ix, iy, iz, dx, dy, dz):
    h = perm2[perm2[perm2[ix] + iy] + iz] & 15
    u = torch.where((h < 8) | (h == 12) | (h == 13), dx, dy)
    v = torch.where((h < 4) | (h == 12) | (h == 13), dy, dz)
    return torch.where(h & 1 != 0, -u, u) + torch.where(h & 2 != 0, -v, v)


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def perlin(p: Vec3) -> torch.Tensor:
    """Classic gradient noise."""
    perm2 = _perm2(p.x.device)
    fl = [torch.floor(c).to(torch.int32) for c in p]
    dx, dy, dz = (c - f for c, f in zip(p, fl))
    ix, iy, iz = ((f & (_NPS - 1)).long() for f in fl)
    w000 = _grad(perm2, ix, iy, iz, dx, dy, dz)
    w100 = _grad(perm2, ix + 1, iy, iz, dx - 1.0, dy, dz)
    w010 = _grad(perm2, ix, iy + 1, iz, dx, dy - 1.0, dz)
    w110 = _grad(perm2, ix + 1, iy + 1, iz, dx - 1.0, dy - 1.0, dz)
    w001 = _grad(perm2, ix, iy, iz + 1, dx, dy, dz - 1.0)
    w101 = _grad(perm2, ix + 1, iy, iz + 1, dx - 1.0, dy, dz - 1.0)
    w011 = _grad(perm2, ix, iy + 1, iz + 1, dx, dy - 1.0, dz - 1.0)
    w111 = _grad(perm2, ix + 1, iy + 1, iz + 1, dx - 1.0, dy - 1.0,
                 dz - 1.0)
    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    x00 = w000 + wx * (w100 - w000)
    x10 = w010 + wx * (w110 - w010)
    x01 = w001 + wx * (w101 - w001)
    x11 = w011 + wx * (w111 - w011)
    y0 = x00 + wy * (x10 - x00)
    y1 = x01 + wy * (x11 - x01)
    return y0 + wz * (y1 - y0)


def _smoothstep(lo: float, hi: float, x: float, like: torch.Tensor):
    t = vm.clip(torch.tensor((x - lo) / (hi - lo), dtype=like.dtype,
                             device=like.device), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fbm(p: Vec3, omega: float, max_octaves: int) -> torch.Tensor:
    """Fractional Brownian motion."""
    n_int = max_octaves // 2
    total = torch.zeros(p.shape, dtype=p.x.dtype, device=p.x.device)
    lam, o = 1.0, 1.0
    for _ in range(n_int):
        total = total + o * perlin(p * lam)
        lam *= 1.99
        o *= omega
    n_partial = float(max_octaves - n_int)
    return total + o * _smoothstep(0.3, 0.7, n_partial, total) \
        * perlin(p * lam)


def turbulence(p: Vec3, omega: float, max_octaves: int) -> torch.Tensor:
    """Absolute-value fbm."""
    n_int = max_octaves // 2
    total = torch.zeros(p.shape, dtype=p.x.dtype, device=p.x.device)
    lam, o = 1.0, 1.0
    for _ in range(n_int):
        total = total + o * torch.abs(perlin(p * lam))
        lam *= 1.99
        o *= omega
    n_partial = float(max_octaves - n_int)
    total = total + o * (0.2 + (torch.abs(perlin(p * lam)) - 0.2)
                         * _smoothstep(0.3, 0.7, n_partial, total))
    for _ in range(n_int, max_octaves):
        total = total + o * 0.2
        o *= omega
    return total
