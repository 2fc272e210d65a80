"""Host-side geometry classes and their parameter layouts.

Port of `sail_tpu/scene/geometry.py`: every shape category.  Same
constructor signatures; `pack()` returns Python floats in the field order of
the `*P` NamedTuples, which is the leaf order `jax.tree.flatten` gives the
JAX package's packed scene.  The NamedTuples are views of a packed parameter
tensor (see `scene.unflatten`).
"""
from __future__ import annotations

import math
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
    """Axis-aligned box params — used by Cube, Rectangle and Cornellbox."""
    bmin: Vec3
    bmax: Vec3
    emission: Vec3
    reverse: torch.Tensor


class FrustumP(NamedTuple):
    """Cone / cylinder params: base position, height, radius."""
    p: Vec3
    h: torch.Tensor
    r: torch.Tensor
    emission: Vec3
    reverse: torch.Tensor


class DiskP(NamedTuple):
    p: Vec3
    r: torch.Tensor
    inner_r: torch.Tensor
    emission: Vec3
    reverse: torch.Tensor


class HyperboloidP(NamedTuple):
    p: Vec3
    p1: Vec3
    p2: Vec3
    ah: torch.Tensor
    ch: torch.Tensor
    emission: Vec3
    reverse: torch.Tensor


class ParaboloidP(NamedTuple):
    p: Vec3
    z0: torch.Tensor
    z1: torch.Tensor
    r: torch.Tensor
    emission: Vec3
    reverse: torch.Tensor


# category -> (view type, width of each field: 3 for a Vec3, 1 for a scalar)
LAYOUTS = {
    C.CUBE: (BoxP, (3, 3, 3, 1)),
    C.SPHERE: (SphereP, (3, 1, 3, 1)),
    C.RECTANGLE: (BoxP, (3, 3, 3, 1)),
    C.CONE: (FrustumP, (3, 1, 1, 3, 1)),
    C.CYLINDER: (FrustumP, (3, 1, 1, 3, 1)),
    C.DISK: (DiskP, (3, 1, 1, 3, 1)),
    C.HYPERBOLOID: (HyperboloidP, (3, 3, 3, 1, 1, 3, 1)),
    C.PARABOLOID: (ParaboloidP, (3, 1, 1, 1, 3, 1)),
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
        self.temporary_translation = (0.0, 0.0, 0.0)

    @property
    def light(self) -> bool:
        """Emissive iff emission != 0."""
        return any(e != 0.0 for e in self.emission)

    def temporary_translate(self, v):
        """Drag preview: packs translated by v until `translate` commits."""
        self.temporary_translation = (float(v[0]), float(v[1]), float(v[2]))

    def translate(self):
        self._commit_translation()
        self.temporary_translation = (0.0, 0.0, 0.0)

    def _commit_translation(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def _offset(self, p):
        t = self.temporary_translation
        return (p[0] + t[0], p[1] + t[1], p[2] + t[2])

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

    def _commit_translation(self):
        self.min = self._offset(self.min)
        self.max = self._offset(self.max)

    def pack(self) -> tuple:
        return (*self._offset(self.min), *self._offset(self.max),
                *self._tail())


class Cube(_Box):
    category = C.CUBE


class Sphere(Object3D):
    category = C.SPHERE

    def __init__(self, center, radius, material=None, texture=None,
                 emission=(0, 0, 0), reverse_normal=False):
        super().__init__(material, texture, emission, reverse_normal)
        self.center = tuple(float(v) for v in center)
        self.radius = float(radius)

    def _commit_translation(self):
        self.center = self._offset(self.center)

    def pack(self) -> tuple:
        return (*self._offset(self.center), self.radius, *self._tail())


class Rectangle(_Box):
    """Rectangle spanning min..max (x edge, then the y/z edge): the
    area-light workhorse."""
    category = C.RECTANGLE


class Cone(Object3D):
    category = C.CONE

    def __init__(self, position, height, radius, material=None, texture=None,
                 emission=(0, 0, 0), reverse_normal=False):
        super().__init__(material, texture, emission, reverse_normal)
        self.position = tuple(float(v) for v in position)
        self.height = float(height)
        self.radius = float(radius)

    def _commit_translation(self):
        self.position = self._offset(self.position)

    def pack(self) -> tuple:
        return (*self._offset(self.position), self.height, self.radius,
                *self._tail())


class Cylinder(Cone):
    category = C.CYLINDER


class Disk(Object3D):
    category = C.DISK

    def __init__(self, position, radius, inner_radius=0.0, material=None,
                 texture=None, emission=(0, 0, 0), reverse_normal=False):
        super().__init__(material, texture, emission, reverse_normal)
        self.position = tuple(float(v) for v in position)
        self.radius = float(radius)
        self.inner_radius = float(inner_radius)

    def _commit_translation(self):
        self.position = self._offset(self.position)

    def pack(self) -> tuple:
        return (*self._offset(self.position), self.radius, self.inner_radius,
                *self._tail())


def _hyperboloid_coeffs(p1, p2):
    """Iteratively solve the implicit quadric coefficients ah, ch (the JAX
    package's `_hyperboloid_coeffs`, in Python floats)."""
    pp1, pp2 = list(p1), list(p2)
    if pp2[2] == 0.0:
        pp1, pp2 = pp2, pp1
    pr = list(pp1)
    ah, ch = math.inf, math.inf
    for _ in range(1000):
        if not (math.isinf(ah) or math.isnan(ah)):
            break
        pr = [pr[i] + 2.0 * (pp2[i] - pp1[i]) for i in range(3)]
        xy1 = pr[0] * pr[0] + pr[1] * pr[1]
        xy2 = pp2[0] * pp2[0] + pp2[1] * pp2[1]
        denom = xy1 * pp2[2] * pp2[2] - xy2 * pr[2] * pr[2]
        if denom == 0.0:
            continue
        ah = (1.0 / xy1 - (pr[2] * pr[2]) / (xy1 * pp2[2] * pp2[2])) / \
             (1.0 - (xy2 * pr[2] * pr[2]) / (xy1 * pp2[2] * pp2[2]))
        ch = (ah * xy2 - 1.0) / (pp2[2] * pp2[2])
    if math.isinf(ah) or math.isnan(ah):
        raise ValueError(
            "degenerate hyperboloid: cannot solve implicit coefficients")
    return pp1, pp2, ah, ch


class Hyperboloid(Object3D):
    category = C.HYPERBOLOID

    def __init__(self, position, p1, p2, material=None, texture=None,
                 emission=(0, 0, 0), reverse_normal=False):
        super().__init__(material, texture, emission, reverse_normal)
        self.position = tuple(float(v) for v in position)
        self.p1, self.p2, self.ah, self.ch = _hyperboloid_coeffs(
            [float(v) for v in p1], [float(v) for v in p2])

    def _commit_translation(self):
        self.position = self._offset(self.position)

    def pack(self) -> tuple:
        return (*self._offset(self.position), *self.p1, *self.p2, self.ah,
                self.ch, *self._tail())


class Paraboloid(Object3D):
    category = C.PARABOLOID

    def __init__(self, position, z0, z1, radius, material=None, texture=None,
                 emission=(0, 0, 0), reverse_normal=False):
        super().__init__(material, texture, emission, reverse_normal)
        self.position = tuple(float(v) for v in position)
        self.z0 = float(z0)
        self.z1 = float(z1)
        self.radius = float(radius)

    def _commit_translation(self):
        self.position = self._offset(self.position)

    def pack(self) -> tuple:
        return (*self._offset(self.position), self.z0, self.z1, self.radius,
                *self._tail())


class Cornellbox(_Box):
    """Inside-out box with colored walls: left GREEN, right BLUE, others
    WHITE.  Always Matte; wall colors are baked in the intersect op."""
    category = C.CORNELLBOX

    def __init__(self, bmin, bmax, material=None):
        super().__init__(bmin, bmax,
                         material if material is not None else Matte(), None)
