"""Host-side materials (Matte, Mirror, Metal, Glass) and their layouts; port
of `sail_tpu/scene/material.py`.  A layout row gives the packed fields'
widths in `jax.tree.flatten` order."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as C
from ..core.vecmath import Vec3


class MatteP(NamedTuple):
    kd: torch.Tensor
    sigma: torch.Tensor  # radians


class MirrorP(NamedTuple):
    kr: torch.Tensor


class MetalP(NamedTuple):
    uroughness: torch.Tensor
    vroughness: torch.Tensor
    eta: Vec3
    k: Vec3


class GlassP(NamedTuple):
    kr: torch.Tensor
    kt: torch.Tensor
    eta: torch.Tensor
    uroughness: torch.Tensor
    vroughness: torch.Tensor


LAYOUTS = {
    C.MATTE: (MatteP, (1, 1)),
    C.MIRROR: (MirrorP, (1,)),
    C.METAL: (MetalP, (1, 1, 3, 3)),
    C.GLASS: (GlassP, (1, 1, 1, 1, 1)),
}


def roughness_to_alpha(roughness: float) -> float:
    """PBRT's roughness-to-alpha map (kept for API parity; nothing calls
    it, as in the JAX package)."""
    roughness = max(roughness, 1e-3)
    x = math.log(roughness)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x +
            0.0171201 * x ** 3 + 0.000640711 * x ** 4)


_DISTRIBUTIONS = {"ggx": C.TROWBRIDGE_REITZ,
                  "trowbridge-reitz": C.TROWBRIDGE_REITZ,
                  "beckmann": C.BECKMANN}


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


# Default conductor spectra: gold-like eta and k.
_DEFAULT_ETA = (9.530817595377695, 6.635831967341377, 4.47513354108444)
_DEFAULT_K = (13.028170336874789, 8.112634272577575, 5.502811570992323)


class Metal(Material):
    """Conductor microfacet reflection; `distribution` "ggx" (default) or
    "beckmann", isotropic unless uroughness and vroughness differ."""
    category = C.METAL

    def __init__(self, roughness: float = 0.01, uroughness: float = 0.0,
                 vroughness: float = 0.0, eta=None, k=None,
                 distribution: str = "ggx"):
        self.uroughness = float(uroughness) if uroughness != 0 \
            else float(roughness)
        self.vroughness = float(vroughness) if vroughness != 0 \
            else float(roughness)
        self.eta = tuple(float(v) for v in
                         (eta if eta is not None else _DEFAULT_ETA))
        self.k = tuple(float(v) for v in (k if k is not None else _DEFAULT_K))
        self.variant = _DISTRIBUTIONS[distribution.lower()]

    def pack(self) -> tuple:
        return (self.uroughness, self.vroughness, *self.eta, *self.k)


class Glass(Material):
    """Dielectric: specular where both roughnesses are below EPSILON, else
    rough (microfacet reflection and transmission, 50/50 lobe choice)."""
    category = C.GLASS

    def __init__(self, kr: float = 1.0, kt: float = 1.0, eta: float = 1.5,
                 uroughness: float = 0.0, vroughness: float = 0.0,
                 distribution: str = "ggx"):
        self.kr = float(kr)
        self.kt = float(kt)
        self.eta = float(eta)
        self.uroughness = float(uroughness)
        self.vroughness = float(vroughness)
        self.variant = _DISTRIBUTIONS[distribution.lower()]

    def pack(self) -> tuple:
        return (self.kr, self.kt, self.eta, self.uroughness, self.vroughness)
