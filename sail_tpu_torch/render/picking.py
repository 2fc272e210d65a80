"""Mouse picking and object dragging (port of `sail_tpu/render/picking.py`).

The picker traces one ray through the same closest-hit scan the renderer
uses (`ops/intersect.intersect_scene` on a one-ray batch), on the device it
is given: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import constants as C
from ..core.camera import make_camera
from ..core.vecmath import Vec3
from ..ops import intersect as isect
from ..scene.scene import Scene, unflatten
from ..utils.device import resolve


def _pixel_ray(scene: Scene, x: float, y: float, width: int, height: int,
               device):
    """The world ray through pixel center (x, y), as a one-ray batch on
    `device`, built on the host from the camera basis
    (`core.camera.make_camera`)."""
    c = scene.camera
    cam = make_camera(c.eye, c.center, c.up, c.fovy, c.aspect, device="cpu")
    ndc_x = (x + 0.5) * (2.0 / width) - 1.0
    ndc_y = 1.0 - (y + 0.5) * (2.0 / height)
    sx = ndc_x * float(cam.tan_half_fovy) * float(cam.aspect)
    sy = ndc_y * float(cam.tan_half_fovy)
    d = Vec3(
        cam.right.x * sx + cam.up.x * sy - cam.back.x,
        cam.right.y * sx + cam.up.y * sy - cam.back.y,
        cam.right.z * sx + cam.up.z * sy - cam.back.z,
    ).normalize()
    return tuple(Vec3(*(v.reshape(1).to(device) for v in w))
                 for w in (cam.eye, d))


def _hit(scene: Scene, x: float, y: float, width: int, height: int, device):
    """(closest hit of the pixel's ray, SceneStatic), on `device`."""
    params, static = scene.pack()
    objects = unflatten(params.to(device), static).objects
    ro, rd = _pixel_ray(scene, x, y, width, height, device)
    return isect.intersect_scene(objects, static, ro, rd), static


def pick(scene: Scene, x: float, y: float, width: int = 512,
         height: int = 512, device=None) -> Optional[int]:
    """Index of the object under pixel (x, y), or None.  Cornell boxes are
    not pickable."""
    hit, static = _hit(scene, x, y, width, height, resolve(device, "pick"))
    if not bool(hit.valid[0]):
        return None
    idx = int(hit.obj_id[0])
    if static.object_categories[idx] == C.CORNELLBOX:
        return None
    return idx


class Dragger:
    """Drags an object in the plane through its picked point that faces the
    dominant axis of the view ray."""

    def __init__(self, scene: Scene, obj_index: int, x: float, y: float,
                 width: int = 512, height: int = 512, device=None):
        self.scene = scene
        self.obj = scene.objects[obj_index]
        self.width = width
        self.height = height
        hit, _ = _hit(scene, x, y, width, height, resolve(device, "Dragger"))
        self._p0 = np.array([float(hit.p.x[0]), float(hit.p.y[0]),
                             float(hit.p.z[0])])
        eye = np.asarray(self.scene.camera.eye, float)
        self._axis = int(np.argmax(np.abs(self._p0 - eye)))

    def drag(self, x: float, y: float):
        ro, rd = _pixel_ray(self.scene, x, y, self.width, self.height,
                            "cpu")
        o = np.array([float(v[0]) for v in ro])
        d = np.array([float(v[0]) for v in rd])
        denom = d[self._axis]
        if abs(denom) < 1e-9:
            return
        t = (self._p0[self._axis] - o[self._axis]) / denom
        self.obj.temporary_translate(o + d * t - self._p0)
        self.scene.moving = True

    def end(self):
        self.obj.translate()
        self.scene.moving = False
