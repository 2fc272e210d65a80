"""Host-side geometry classes of the slice and their parameter layouts.

Port of the SPHERE, RECTANGLE and CORNELLBOX parts of
`sail_tpu/scene/geometry.py`.  Same constructor signatures; `pack()` returns
Python floats in the field order of the `*P` NamedTuples, which is the leaf
order `jax.tree.flatten` gives the JAX package's packed scene.  The
NamedTuples are views of a packed parameter tensor (see `scene.unflatten`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..core.vecmath import Vec3
from .material import Matte
from .texture import UniformColor


class SphereP(NamedTuple):
    center: Vec3
    radius: torch.Tensor
    emission: Vec3
    reverse: torch.Tensor  # +1.0 or -1.0 normal sign


class BoxP(NamedTuple):
    """Axis-aligned box params — used by Rectangle and Cornellbox."""
    bmin: Vec3
    bmax: Vec3
    emission: Vec3
    reverse: torch.Tensor


# category -> (view type, width of each field: 3 for a Vec3, 1 for a scalar)
LAYOUTS = {
    C.SPHERE: (SphereP, (3, 1, 3, 1)),
    C.RECTANGLE: (BoxP, (3, 3, 3, 1)),
    C.CORNELLBOX: (BoxP, (3, 3, 3, 1)),
}


class Object3D:
    """Base scene object."""

    category: int = 0

    def __init__(self, material=None, texture=None, emission=(0, 0, 0),
                 reverse_normal: bool = False):
        self.material = material if material is not None else Matte()
        self.texture = texture if texture is not None else UniformColor(C.WHITE)
        self.emission = tuple(float(e) for e in emission)
        self.reverse_normal = bool(reverse_normal)

    @property
    def light(self) -> bool:
        """Emissive iff emission != 0."""
        return any(e != 0.0 for e in self.emission)

    def _tail(self):
        return (*self.emission, -1.0 if self.reverse_normal else 1.0)

    def pack(self) -> tuple:  # pragma: no cover - overridden
        raise NotImplementedError


class _Box(Object3D):
    def __init__(self, bmin, bmax, material=None, texture=None,
                 emission=(0, 0, 0), reverse_normal=False):
        super().__init__(material, texture, emission, reverse_normal)
        self.min = tuple(float(v) for v in bmin)
        self.max = tuple(float(v) for v in bmax)

    def pack(self) -> tuple:
        return (*self.min, *self.max, *self._tail())


class Sphere(Object3D):
    category = C.SPHERE

    def __init__(self, center, radius, material=None, texture=None,
                 emission=(0, 0, 0), reverse_normal=False):
        super().__init__(material, texture, emission, reverse_normal)
        self.center = tuple(float(v) for v in center)
        self.radius = float(radius)

    def pack(self) -> tuple:
        return (*self.center, self.radius, *self._tail())


class Rectangle(_Box):
    """Rectangle spanning min..max (x edge, then the y/z edge): the
    area-light workhorse."""
    category = C.RECTANGLE


class Cornellbox(_Box):
    """Inside-out box with colored walls: left GREEN, right BLUE, others
    WHITE.  Always Matte; wall colors are baked in the intersect op."""
    category = C.CORNELLBOX

    def __init__(self, bmin, bmax, material=None):
        super().__init__(bmin, bmax,
                         material if material is not None else Matte(), None)
