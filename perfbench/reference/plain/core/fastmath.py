"""Polynomial arctangents and arccosine, and tan as sin/cos.

Port of `sail_tpu/core/fastmath.py`: the same degree-11 minimax polynomial
(max error ~1e-7), not `torch.atan2` or libdevice, so the port computes the
estimator the TPU kernels compute.  The CUDA megakernels carry the same
functions (`csrc/path.cuh`, `atan2_poly`, `atan_poly1`, `tan_sc`).
"""
from __future__ import annotations

import torch

from ..constants import PI
from .vecmath import clip

PI_2 = PI / 2.0


def _atan_poly(t):
    """atan on |t| <= 1, degree-11 odd minimax polynomial."""
    t2 = t * t
    p = torch.full_like(t, -0.0117212)
    p = p * t2 + 0.05265332
    p = p * t2 + -0.11643287
    p = p * t2 + 0.19354346
    p = p * t2 + -0.33262347
    p = p * t2 + 0.99997726
    return t * p


def atan2(y, x):
    """Four-quadrant arctangent, elementwise."""
    y, x = torch.broadcast_tensors(y, x)
    swap = torch.abs(y) > torch.abs(x)
    num = torch.where(swap, x, y)
    den = torch.where(swap, y, x)
    den = torch.where(den == 0.0, 1e-30, den)
    r = _atan_poly(num / den)
    # |y|>|x|: atan(y/x) = sign(y/x)·π/2 − atan(x/y)
    s = torch.where((y < 0.0) ^ (x < 0.0), -PI_2, PI_2)
    r = torch.where(swap, s - r, r)
    # quadrant shift for x<0
    return torch.where(x < 0.0, torch.where(y >= 0.0, r + PI, r - PI), r)


def acos(x):
    x = clip(x, -1.0, 1.0)
    s = torch.sqrt(clip(1.0 - x * x, 1e-20))
    return atan2(s, x)


def asin(x):
    return PI_2 - acos(x)


def atan(x):
    """One-argument arctangent: the polynomial on |x| <= 1, reflected above."""
    big = torch.abs(x) > 1.0
    inv = 1.0 / torch.where(x == 0.0, 1e-30, x)
    r = _atan_poly(torch.where(big, inv, x))
    s = torch.where(x >= 0.0, PI_2, -PI_2)
    return torch.where(big, s - r, r)


def tan(x):
    """tan as sin/cos, the cosine kept off 0 (JAX's, for Mosaic)."""
    c = torch.cos(x)
    return torch.sin(x) / torch.where(torch.abs(c) < 1e-20, 1e-20, c)
