"""Polynomial arctangent and arccosine.

Port of `sail_tpu/core/fastmath.py`: the same degree-11 minimax polynomial
(max error ~1e-7), not `torch.atan2` or libdevice, so the port computes the
estimator the TPU kernels compute.  The CUDA megakernel carries the same
polynomial (`csrc/megakernel.cu`, `atan2_poly`).
"""
from __future__ import annotations

import torch

from ..constants import PI

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
    x = torch.clamp(x, -1.0, 1.0)
    s = torch.sqrt(torch.clamp(1.0 - x * x, min=1e-20))
    return atan2(s, x)
