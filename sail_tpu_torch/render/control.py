"""Orbit camera controller (port of `sail_tpu/render/control.py`).

Spherical-angle orbit around `camera.center`, wheel zoom scaling the radius
by 0.9 or 1.1, and dragging objects through picking; mouse events are
explicit method calls.  Picking runs on the device the Control is given:
the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import math

from ..scene.scene import Scene
from ..utils.device import resolve
from . import picking


class Control:
    def __init__(self, scene: Scene, width: int = 512, height: int = 512,
                 device=None):
        self.scene = scene
        self.width = width
        self.height = height
        self.device = resolve(device, "Control")
        self._dragger = None
        self._last = None
        self._sync_angles()

    def _sync_angles(self):
        cam = self.scene.camera
        ex, ey, ez = cam.eye
        cx, cy, cz = cam.center
        dx, dy, dz = ex - cx, ey - cy, ez - cz
        self.radius = math.sqrt(dx * dx + dy * dy + dz * dz)
        self.angle_x = math.asin(max(-1.0, min(1.0, dy / max(self.radius, 1e-9))))
        self.angle_y = math.atan2(dx, dz)

    def _apply(self):
        cam = self.scene.camera
        cx, cy, cz = cam.center
        r = self.radius
        ax, ay = self.angle_x, self.angle_y
        cam.eye = (cx + r * math.cos(ax) * math.sin(ay),
                   cy + r * math.sin(ax),
                   cz + r * math.cos(ax) * math.cos(ay))
        self.scene.update()
        self.scene.moving = True

    # -- orbit ----------------------------------------------------------------
    def orbit(self, dx_pixels: float, dy_pixels: float):
        self.angle_y -= dx_pixels * 0.01
        self.angle_x += dy_pixels * 0.01
        limit = math.pi / 2 - 0.01
        self.angle_x = max(-limit, min(limit, self.angle_x))
        self._apply()

    # -- zoom -----------------------------------------------------------------
    def zoom(self, wheel_delta: float):
        self.radius *= 0.9 if wheel_delta > 0 else 1.1
        self._apply()

    # -- drag objects via picking --------------------------------------------
    def mouse_down(self, x: float, y: float) -> bool:
        idx = picking.pick(self.scene, x, y, self.width, self.height,
                           self.device)
        self.scene.select = idx
        if idx is not None:
            self._dragger = picking.Dragger(self.scene, idx, x, y,
                                            self.width, self.height,
                                            self.device)
            return True
        self._last = (x, y)
        return False

    def mouse_move(self, x: float, y: float):
        if self._dragger is not None:
            self._dragger.drag(x, y)
        elif self._last is not None:
            lx, ly = self._last
            self.orbit(x - lx, y - ly)
            self._last = (x, y)

    def mouse_up(self):
        if self._dragger is not None:
            self._dragger.end()
            self._dragger = None
        self._last = None
        self.scene.moving = False
