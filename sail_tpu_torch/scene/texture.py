"""Host-side UNIFORM_COLOR texture and its layout; port of the matching part
of `sail_tpu/scene/texture.py`."""
from __future__ import annotations

from typing import NamedTuple

from .. import constants as C
from ..core.vecmath import Vec3


class UniformColorP(NamedTuple):
    color: Vec3


LAYOUTS = {C.UNIFORM_COLOR: (UniformColorP, (3,))}


class Texture:
    category: int = 0

    def pack(self) -> tuple:  # pragma: no cover - overridden
        raise NotImplementedError


class UniformColor(Texture):
    category = C.UNIFORM_COLOR

    def __init__(self, color=C.WHITE):
        self.color = tuple(float(v) for v in color)

    def pack(self) -> tuple:
        return self.color
