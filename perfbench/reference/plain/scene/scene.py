"""Scene container and packing (port of `sail_tpu/scene/scene.py`).

`Scene.pack()` returns the scene as (a) ONE flat float32 tensor in the leaf
order `jax.tree.flatten` gives the JAX package's `PackedScene` — objects,
then deduplicated material rows, texture rows, lights, camera — and (b) a
hashable `SceneStatic` with the same fields and values as the JAX one.  The
flat vector is the CUDA megakernel's ABI; `unflatten` views it as the
structured `PackedScene` the plain torch ops read.

The port covers every shape category, in any number, every material and
texture category, and every light: AREA over any shape but a Cornell box
(which `Scene.add` refuses, as the JAX package does), POINT and SPOT.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import constants as C
from ..core.camera import CameraParams, make_camera
from ..core.vecmath import Vec3
from . import geometry, light, material, texture
from .geometry import Object3D
from .light import AreaLight, Light

VALID_FILTERS = ("color", "gamma", "tonemapping", "normal", "position",
                 "box", "triangle", "gaussian", "mitchell", "sinc", "wavelet")
VALID_TRACERS = ("path",)

# Objects per shape category from which the JAX package folds the category
# as one batched group after the other objects (`sail_tpu/ops/intersect.py`
# BATCH_THRESHOLD); the fold order decides which object wins a tie.
BATCH_THRESHOLD = 8

CAMERA_WIDTHS = (3, 3, 3, 3, 1, 1)
CAMERA_SIZE = sum(CAMERA_WIDTHS)

# The shapes an area light can sample (ops/lights.py `_sample_geometry`):
# every one but the inside-out Cornell box.
AREA_SAMPLEABLE = (C.SPHERE, C.RECTANGLE, C.DISK, C.CUBE, C.CONE, C.CYLINDER,
                   C.PARABOLOID, C.HYPERBOLOID)


class PackedScene(NamedTuple):
    """Structured view of the flat parameter tensor."""
    objects: tuple      # per-object SphereP / BoxP / FrustumP / ...
    materials: tuple    # material rows (deduped)
    textures: tuple     # texture rows (deduped)
    lights: tuple       # per-light AreaLightP / PointLightP / SpotLightP
    camera: CameraParams


class SceneStatic(NamedTuple):
    """Hashable scene structure (same fields as the JAX package's)."""
    object_categories: tuple        # shape category per object
    object_mat_rows: tuple          # material row index per object
    object_tex_rows: tuple          # texture row index per object
    object_emissive: tuple          # bool per object
    material_categories: tuple      # category per material row
    material_variants: tuple        # static sub-type per material row
    texture_categories: tuple       # category per texture row
    light_categories: tuple         # category per light
    area_light_objects: tuple       # object index per light (-1 if not area)


def check_supported(static: SceneStatic) -> None:
    """Raise ValueError for a category the port does not know, or an area
    light over a shape without an area sampler."""
    for cat in static.object_categories:
        if cat not in geometry.LAYOUTS:
            raise ValueError(f"unknown shape category {cat}")
    for cat in static.material_categories:
        if cat not in material.LAYOUTS:
            raise ValueError(f"unknown material category {cat}")
    for cat in static.texture_categories:
        if cat not in texture.LAYOUTS:
            raise ValueError(f"unknown texture category {cat}")
    for cat, obj in zip(static.light_categories, static.area_light_objects):
        if cat not in light.LAYOUTS:
            raise ValueError(f"unknown light category {cat}")
        if cat == C.AREA and static.object_categories[obj] \
                not in AREA_SAMPLEABLE:
            raise ValueError(
                "area light over a "
                f"{C.SHAPE_NAMES[static.object_categories[obj]]}: that "
                "shape has no area sampler")


class Offsets(NamedTuple):
    """Start of each packed row in the flat parameter vector."""
    objects: tuple
    materials: tuple
    textures: tuple
    lights: tuple
    camera: int
    size: int


def param_offsets(static: SceneStatic) -> Offsets:
    """Where each object, material, texture and light row starts in the flat
    vector; raises for structure outside the slice."""
    check_supported(static)
    pos = 0
    out = []
    for layouts, cats in ((geometry.LAYOUTS, static.object_categories),
                          (material.LAYOUTS, static.material_categories),
                          (texture.LAYOUTS, static.texture_categories),
                          (light.LAYOUTS, static.light_categories)):
        starts = []
        for cat in cats:
            starts.append(pos)
            pos += sum(layouts[cat][1])
        out.append(tuple(starts))
    return Offsets(*out, camera=pos, size=pos + CAMERA_SIZE)


def _view(cls, widths, params: torch.Tensor, pos: int):
    fields = []
    for w in widths:
        fields.append(params[pos] if w == 1 else
                      Vec3(params[pos], params[pos + 1], params[pos + 2]))
        pos += w
    return cls(*fields)


def unflatten(params: torch.Tensor, static: SceneStatic) -> PackedScene:
    """View the flat parameter tensor as a PackedScene of 0-d tensors (the
    counterpart of the JAX kernel's `jax.tree.unflatten`)."""
    off = param_offsets(static)
    if params.shape != (off.size,):
        raise ValueError(f"scene needs {off.size} params, got "
                         f"{tuple(params.shape)}")

    def rows(layouts, cats, starts):
        return tuple(_view(*layouts[c], params, p) for c, p in zip(cats, starts))

    return PackedScene(
        objects=rows(geometry.LAYOUTS, static.object_categories, off.objects),
        materials=rows(material.LAYOUTS, static.material_categories,
                       off.materials),
        textures=rows(texture.LAYOUTS, static.texture_categories,
                      off.textures),
        lights=rows(light.LAYOUTS, static.light_categories, off.lights),
        camera=_view(CameraParams, CAMERA_WIDTHS, params, off.camera),
    )


def leaf_paths(static: SceneStatic) -> tuple:
    """The key of every float of the flat parameter vector, in its order:
    the string `jax.tree_util.keystr` gives the same leaf of the JAX
    package's PackedScene (`.objects[2].center.x`, `.camera.aspect`), by
    which `trainable_mask` and the tools select leaves."""
    def row(prefix, cls, widths):
        for name, w in zip(cls._fields, widths):
            if w == 1:
                yield f"{prefix}.{name}"
            else:
                yield from (f"{prefix}.{name}.{c}" for c in "xyz")

    check_supported(static)
    paths = []
    for section, layouts, cats in (
            ("objects", geometry.LAYOUTS, static.object_categories),
            ("materials", material.LAYOUTS, static.material_categories),
            ("textures", texture.LAYOUTS, static.texture_categories),
            ("lights", light.LAYOUTS, static.light_categories)):
        for i, cat in enumerate(cats):
            paths.extend(row(f".{section}[{i}]", *layouts[cat]))
    paths.extend(row(".camera", CameraParams, CAMERA_WIDTHS))
    return tuple(paths)


class Camera:
    """Host camera. fovy=55°, aspect=1 default."""

    def __init__(self, eye, center, up=(0.0, 1.0, 0.0), fovy: float = 55.0,
                 aspect: float = 1.0):
        self.eye = tuple(float(v) for v in eye)
        self.center = tuple(float(v) for v in center)
        self.up = tuple(float(v) for v in up)
        self.fovy = float(fovy)
        self.aspect = float(aspect)

    def update(self):
        """No-op: packing always reads the current eye, center and up."""

    def pack(self) -> tuple:
        cam = make_camera(self.eye, self.center, self.up, self.fovy,
                          self.aspect, device="cpu")
        return tuple(float(v) for v in (*cam.eye, *cam.right, *cam.up,
                                         *cam.back, cam.tan_half_fovy,
                                         cam.aspect))


class Scene:
    def __init__(self):
        self.camera: Optional[Camera] = None
        self.objects: list[Object3D] = []
        self.lights: list[Light] = []
        self.sample_count = 0
        self._trace = "path"
        self._filter = "color"
        self.filter_params: dict = {}
        self.select: Optional[int] = None   # object index the overlay boxes
        self.moving = False

    @property
    def filter(self) -> str:
        return self._filter

    @filter.setter
    def filter(self, name):
        if isinstance(name, tuple):
            name, params = name
            self.filter_params = dict(params)
        if name in VALID_FILTERS:
            self._filter = name

    @property
    def trace(self) -> str:
        return self._trace

    @trace.setter
    def trace(self, name: str):
        if name in VALID_TRACERS:
            self._trace = name

    @property
    def eye(self):
        return self.camera.eye

    def add(self, something):
        if isinstance(something, Camera):
            self.camera = something
        elif isinstance(something, Object3D):
            self.objects.append(something)
        elif isinstance(something, Light):
            if isinstance(something, AreaLight):
                if something.geometry.category not in AREA_SAMPLEABLE:
                    raise ValueError(
                        f"AreaLight geometry "
                        f"{type(something.geometry).__name__} has no area "
                        f"sampler; supported: Sphere, Rectangle, Disk, "
                        f"Cube, Cone, Cylinder, Paraboloid, Hyperboloid")
                something.index = len(self.objects)
                self.objects.append(something.geometry)
            self.lights.append(something)
        else:
            raise TypeError(f"cannot add {type(something)!r} to scene")

    def update(self):
        """After the camera moved: the next render starts a new count."""
        if self.camera is not None:
            self.camera.update()
        self.sample_count = 0

    def pack(self) -> tuple[torch.Tensor, SceneStatic]:
        """(flat float32 parameter tensor on the CPU, SceneStatic)."""
        if self.camera is None:
            raise ValueError("scene has no camera")

        values = []
        mat_rows, mat_cats, mat_vars, mat_ids = [], [], [], {}
        tex_rows, tex_cats, tex_ids = [], [], {}
        obj_cats, obj_mat, obj_tex, obj_emissive = [], [], [], []
        for obj in self.objects:
            mid = id(obj.material)
            if mid not in mat_ids:
                mat_ids[mid] = len(mat_rows)
                mat_rows.append(obj.material.pack())
                mat_cats.append(obj.material.category)
                mat_vars.append(obj.material.variant)
            tid = id(obj.texture)
            if tid not in tex_ids:
                tex_ids[tid] = len(tex_rows)
                tex_rows.append(obj.texture.pack())
                tex_cats.append(obj.texture.category)
            values.extend(obj.pack())
            obj_cats.append(obj.category)
            obj_mat.append(mat_ids[mid])
            obj_tex.append(tex_ids[tid])
            obj_emissive.append(obj.light)
        for row in mat_rows + tex_rows:
            values.extend(row)
        for lt in self.lights:
            values.extend(lt.pack())
        values.extend(self.camera.pack())

        static = SceneStatic(
            object_categories=tuple(obj_cats),
            object_mat_rows=tuple(obj_mat),
            object_tex_rows=tuple(obj_tex),
            object_emissive=tuple(obj_emissive),
            material_categories=tuple(mat_cats),
            material_variants=tuple(mat_vars),
            texture_categories=tuple(tex_cats),
            light_categories=tuple(lt.category for lt in self.lights),
            area_light_objects=tuple(
                lt.index if isinstance(lt, AreaLight) else -1
                for lt in self.lights),
        )
        check_supported(static)
        return torch.tensor(values, dtype=torch.float32), static
