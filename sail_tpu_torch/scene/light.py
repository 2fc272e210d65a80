"""Host-side lights and their layouts; port of `sail_tpu/scene/light.py`.
The estimator is the JAX package's: solid-angle converted area pdf,
inverse-square falloff, ×n_lights for the uniform pick."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as C
from ..core.vecmath import Vec3


class AreaLightP(NamedTuple):
    emission: Vec3


class PointLightP(NamedTuple):
    origin: Vec3
    emission: Vec3
    radius: torch.Tensor  # soft-shadow jitter radius


class SpotLightP(NamedTuple):
    origin: Vec3
    cos_total_width: torch.Tensor
    cos_falloff_start: torch.Tensor
    emission: Vec3


# category -> (row type, field widths) in `jax.tree.flatten` order
LAYOUTS = {C.AREA: (AreaLightP, (3,)),
           C.POINT: (PointLightP, (3, 3, 1)),
           C.SPOT: (SpotLightP, (3, 1, 1, 3))}


class Light:
    category: int = -1

    def __init__(self, emission):
        self.emission = tuple(float(e) for e in emission)

    def pack(self) -> tuple:  # pragma: no cover - overridden
        raise NotImplementedError


class AreaLight(Light):
    """Wraps an emissive geometry; the geometry joins the scene's objects
    when the light is added, and the light keeps its index for NEE."""
    category = C.AREA

    def __init__(self, geometry, emission):
        super().__init__(emission)
        geometry.emission = tuple(float(e) for e in emission)
        self.geometry = geometry
        self.index = None  # object index, assigned by Scene.add

    def pack(self) -> tuple:
        return self.emission


class PointLight(Light):
    """A point light at `from_`, its sample jittered over a sphere of
    `radius` (soft shadows)."""
    category = C.POINT

    def __init__(self, from_, emission, radius: float = 0.1):
        super().__init__(emission)
        self.from_ = tuple(float(v) for v in from_)
        self.radius = float(radius)

    def pack(self) -> tuple:
        return (*self.from_, *self.emission, self.radius)


class SpotLight(Light):
    """A spot light at `from_` looking down world -y: full emission within
    `coneangle - conedelta` degrees of the axis, falling off to 0 at
    `coneangle`.  The two cosines are taken in double and rounded to float32
    when packed."""
    category = C.SPOT

    def __init__(self, from_, coneangle, conedelta, emission):
        super().__init__(emission)
        self.from_ = tuple(float(v) for v in from_)
        self.coneangle = float(coneangle)
        self.conedelta = float(conedelta)
        self.cos_total_width = math.cos(coneangle / 180.0 * math.pi)
        self.cos_falloff_start = math.cos(
            (coneangle - conedelta) / 180.0 * math.pi)

    def pack(self) -> tuple:
        return (*self.from_, self.cos_total_width, self.cos_falloff_start,
                *self.emission)
