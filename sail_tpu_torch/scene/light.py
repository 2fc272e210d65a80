"""Host-side AREA light and its layout; port of the matching part of
`sail_tpu/scene/light.py`.  The estimator is the JAX package's: solid-angle
converted area pdf, inverse-square falloff, ×n_lights for the uniform pick."""
from __future__ import annotations

from typing import NamedTuple

from .. import constants as C
from ..core.vecmath import Vec3


class AreaLightP(NamedTuple):
    emission: Vec3


LAYOUTS = {C.AREA: (AreaLightP, (3,))}


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
