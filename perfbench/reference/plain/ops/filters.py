"""Display filters (port of `sail_tpu/ops/filters.py`): the tone filters, the
G-buffer views, the 4×4-table windowed filters (box, triangle, gaussian,
mitchell, sinc) and the 3-level à-trous wavelet denoiser.

Plain tensor code on the image's device, in the JAX version's operation
order: the JAX package computes these eagerly outside any kernel too.
"""
from __future__ import annotations

import math

import torch

from ..core.vecmath import Vec3

WINDOW_WIDTH = 4


# -- simple tone filters ----------------------------------------------------

def color(img: Vec3, normal=None, position=None, **params) -> Vec3:
    return img


def gamma(img: Vec3, normal=None, position=None, c: float = 2.2,
          **params) -> Vec3:
    inv = 1.0 / c
    return Vec3(*(torch.pow(torch.clamp(v, min=0.0), inv) for v in img))


def tonemapping(img: Vec3, normal=None, position=None, **params) -> Vec3:
    """Filmic approximation."""
    def tm(v):
        x = torch.clamp(v - 0.004, min=0.0)
        return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    return Vec3(*(tm(v) for v in img))


def normal_view(img: Vec3, normal=None, position=None, **params) -> Vec3:
    """G-buffer view: normals remapped to [0, 1]."""
    n = normal if normal is not None else img
    return n * 0.5 + 0.5


def position_view(img: Vec3, normal=None, position=None, **params) -> Vec3:
    """G-buffer view: position directions remapped to [0, 1] (a zero
    position, a miss, gives 0.5)."""
    p = position if position is not None else img
    return p.normalize() * 0.5 + 0.5


# -- windowed convolution filters ------------------------------------------
# Host-side weight functions, evaluated once per table.

def _w_box(px, py, r, **kw):
    return 1.0


def _w_triangle(px, py, r, **kw):
    return max(0.0, r[0] - px) * max(0.0, r[1] - py)


def _w_gaussian(px, py, r, alpha=2.0, **kw):
    ex = math.exp(-alpha * r[0] * r[0])
    ey = math.exp(-alpha * r[1] * r[1])
    gx = max(0.0, math.exp(-alpha * px * px) - ex)
    gy = max(0.0, math.exp(-alpha * py * py) - ey)
    return gx * gy


def _mitchell_1d(x, b, c):
    x = abs(2.0 * x)
    if x > 1:
        return ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x * x +
                (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
    return ((12 - 9 * b - 6 * c) * x ** 3 +
            (-18 + 12 * b + 6 * c) * x * x + (6 - 2 * b)) / 6.0


def _w_mitchell(px, py, r, b=1.0 / 3.0, c=1.0 / 3.0, **kw):
    return _mitchell_1d(px / r[0], b, c) * _mitchell_1d(py / r[1], b, c)


def _sinc_1d(x):
    x = abs(x)
    if x < 1e-5:
        return 1.0
    return math.sin(math.pi * x) / (math.pi * x)


def _windowed_sinc(x, radius, tau):
    x = abs(x)
    if x > radius:
        return 0.0
    return _sinc_1d(x) * _sinc_1d(x / tau)


def _w_sinc(px, py, r, tau=3.0, **kw):
    return _windowed_sinc(px, r[0], tau) * _windowed_sinc(py, r[1], tau)


_WINDOW_WEIGHT_FNS = {
    "box": _w_box,
    "triangle": _w_triangle,
    "gaussian": _w_gaussian,
    "mitchell": _w_mitchell,
    "sinc": _w_sinc,
}


def window_table(name: str, r=(2.0, 2.0), **params) -> list:
    """The 4×4 (offset x, offset y, weight) table, row by row."""
    fn = _WINDOW_WEIGHT_FNS[name]
    entries = []
    for i in range(WINDOW_WIDTH):
        for j in range(WINDOW_WIDTH):
            px = (j + 0.5) * r[0] / WINDOW_WIDTH
            py = (i + 0.5) * r[1] / WINDOW_WIDTH
            entries.append((px, py, float(fn(px, py, r, **params))))
    return entries


def _window(h: int, w: int, dy: int, dx: int):
    """The destination rows and columns a shift by (dy, dx) fills (empty
    when the shift leaves the image)."""
    def span(n, d):
        start = min(max(d, 0), n)
        return slice(start, max(n + min(d, 0), start))
    return span(h, dy), span(w, dx)


def _shifted(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """`a` shifted by (dy, dx) with zero padding: out-of-bounds taps
    contribute nothing."""
    h, w = a.shape
    out = torch.zeros_like(a)
    ys, xs = _window(h, w, dy, dx)
    out[ys, xs] = a[ys.start - dy:ys.stop - dy, xs.start - dx:xs.stop - dx]
    return out


def _inside(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """1.0 where the tap shifted by (dy, dx) lies inside the image, else
    0.0."""
    valid = torch.zeros_like(a)
    valid[_window(*a.shape, dy, dx)] = 1.0
    return valid


def windowed(img: Vec3, name: str, r=(2.0, 2.0), **params) -> Vec3:
    """A 4×4-table windowed filter with 4 symmetric taps per entry (all 4
    even where offsets coincide), normalised by the in-bounds tap weight."""
    table = window_table(name, r, **params)
    acc = [torch.zeros_like(img.x)] * 3
    wsum = torch.zeros_like(img.x)
    for (px, py, w) in table:
        if w == 0.0:
            continue
        dx = int(round(px))
        dy = int(round(py))
        for sx, sy in ((dx, dy), (dx, -dy), (-dx, dy), (-dx, -dy)):
            cx = _shifted(img.x, sy, sx)
            cy = _shifted(img.y, sy, sx)
            cz = _shifted(img.z, sy, sx)
            acc = [acc[0] + cx * w, acc[1] + cy * w, acc[2] + cz * w]
            wsum = wsum + w * _inside(img.x, sy, sx)
    wsum = torch.clamp(wsum, min=1e-8)
    return Vec3(acc[0] / wsum, acc[1] / wsum, acc[2] / wsum)


# -- à-trous edge-avoiding wavelet denoiser ---------------------------------

_H_KERNEL = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)


def wavelet(img: Vec3, normal: Vec3, position: Vec3, levels: int = 3,
            c_phi: float = 4.0, n_phi: float = 128.0, p_phi: float = 1.0,
            **params) -> Vec3:
    """Edge-avoiding à-trous wavelet denoise over the color, normal and
    position G-buffer: B3-spline levels with tap spacing 2^level, each
    edge-stopping weight clamped at 1."""
    out = img
    for level in range(levels):
        step = 2 ** level
        acc_x = torch.zeros_like(out.x)
        acc_y = torch.zeros_like(out.y)
        acc_z = torch.zeros_like(out.z)
        wsum = torch.zeros_like(out.x)
        for i in range(5):
            for j in range(5):
                h = _H_KERNEL[i] * _H_KERNEL[j]
                dy = (i - 2) * step
                dx = (j - 2) * step
                cx = _shifted(out.x, dy, dx)
                cy = _shifted(out.y, dy, dx)
                cz = _shifted(out.z, dy, dx)
                dc = (out.x - cx) ** 2 + (out.y - cy) ** 2 + (out.z - cz) ** 2
                w_c = torch.clamp(torch.exp(-dc / c_phi), max=1.0)
                nx = _shifted(normal.x, dy, dx)
                ny = _shifted(normal.y, dy, dx)
                nz = _shifted(normal.z, dy, dx)
                dn = ((normal.x - nx) ** 2 + (normal.y - ny) ** 2 +
                      (normal.z - nz) ** 2) / (step * step)
                w_n = torch.clamp(torch.exp(-dn / n_phi), max=1.0)
                px_ = _shifted(position.x, dy, dx)
                py_ = _shifted(position.y, dy, dx)
                pz_ = _shifted(position.z, dy, dx)
                dp = ((position.x - px_) ** 2 + (position.y - py_) ** 2 +
                      (position.z - pz_) ** 2)
                w_p = torch.clamp(torch.exp(-dp / p_phi), max=1.0)
                w = w_c * w_n * w_p * h * _inside(out.x, dy, dx)
                acc_x = acc_x + cx * w
                acc_y = acc_y + cy * w
                acc_z = acc_z + cz * w
                wsum = wsum + w
        wsum = torch.clamp(wsum, min=1e-8)
        out = Vec3(acc_x / wsum, acc_y / wsum, acc_z / wsum)
    return out


_FILTERS = {
    "color": color,
    "gamma": gamma,
    "tonemapping": tonemapping,
    "normal": normal_view,
    "position": position_view,
    "wavelet": wavelet,
}

# The filters that read the G-buffer (the Renderer fills it for them).
GBUFFER_FILTERS = ("normal", "position", "wavelet")


def apply_filter(name: str, img: Vec3, normal: Vec3 = None,
                 position: Vec3 = None, **params) -> Vec3:
    """Run display filter `name` (one of `Scene`'s VALID_FILTERS)."""
    if name in _WINDOW_WEIGHT_FNS:
        return windowed(img, name, **params)
    return _FILTERS[name](img, normal, position, **params)
