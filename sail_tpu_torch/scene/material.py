"""Host-side materials of the slice (MATTE, MIRROR) and their layouts; port
of the matching part of `sail_tpu/scene/material.py`."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as C


class MatteP(NamedTuple):
    kd: torch.Tensor
    sigma: torch.Tensor  # radians


class MirrorP(NamedTuple):
    kr: torch.Tensor


LAYOUTS = {
    C.MATTE: (MatteP, (1, 1)),
    C.MIRROR: (MirrorP, (1,)),
}


class Material:
    category: int = 0
    variant: int = 0    # static sub-type (microfacet distribution kind)

    def pack(self) -> tuple:  # pragma: no cover - overridden
        raise NotImplementedError


class Matte(Material):
    """Lambertian, or Oren–Nayar for sigma > 0 (sigma in degrees)."""
    category = C.MATTE

    def __init__(self, kd: float = 1.0, sigma: float = 0.0):
        if kd <= 0:
            kd = 1.0
        self.kd = float(kd)
        self.sigma = float(sigma)

    def pack(self) -> tuple:
        return (self.kd, self.sigma * math.pi / 180.0)


class Mirror(Material):
    category = C.MIRROR

    def __init__(self, kr: float = 1.0):
        if kr <= 0:
            kr = 0.5
        self.kr = float(kr)

    def pack(self) -> tuple:
        return (self.kr,)
