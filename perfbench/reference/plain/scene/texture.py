"""Host-side procedural textures and their layouts; port of
`sail_tpu/scene/texture.py`: UniformColor, Checkerboard (grid with a grey
outline), Checkerboard2 (two-color checker), Bilerp, Mix, ScaleT, UV and
the Color factory.  A layout row gives the packed fields' widths in
`jax.tree.flatten` order."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..core.vecmath import Vec3


class UniformColorP(NamedTuple):
    color: Vec3


class CheckerboardP(NamedTuple):
    size: torch.Tensor
    line_width: torch.Tensor


class Checkerboard2P(NamedTuple):
    color1: Vec3
    color2: Vec3
    size: torch.Tensor


class BilerpP(NamedTuple):
    color00: Vec3
    color01: Vec3
    color10: Vec3
    color11: Vec3


class MixP(NamedTuple):
    color1: Vec3
    color2: Vec3
    amount: torch.Tensor


class ScaleP(NamedTuple):
    color1: Vec3
    color2: Vec3


class UVP(NamedTuple):
    pad: torch.Tensor   # no real parameter; keeps the row non-empty


LAYOUTS = {
    C.UNIFORM_COLOR: (UniformColorP, (3,)),
    C.CHECKERBOARD: (CheckerboardP, (1, 1)),
    C.CHECKERBOARD2: (Checkerboard2P, (3, 3, 1)),
    C.BILERP: (BilerpP, (3, 3, 3, 3)),
    C.MIXF: (MixP, (3, 3, 1)),
    C.SCALE: (ScaleP, (3, 3)),
    C.UVF: (UVP, (1,)),
}


def _rgb(color) -> tuple:
    return tuple(float(v) for v in color)


class Texture:
    category: int = 0

    def pack(self) -> tuple:  # pragma: no cover - overridden
        raise NotImplementedError


class UniformColor(Texture):
    category = C.UNIFORM_COLOR

    def __init__(self, color=C.WHITE):
        self.color = _rgb(color)

    def pack(self) -> tuple:
        return self.color


class Checkerboard(Texture):
    category = C.CHECKERBOARD

    def __init__(self, size: float = 0.1, line_width: float = 0.01):
        if size <= 0:
            size = 0.3
        if line_width < 0:
            line_width = 0.03
        self.size = float(size)
        self.line_width = float(line_width)

    def pack(self) -> tuple:
        return (self.size, self.line_width)


class Checkerboard2(Texture):
    category = C.CHECKERBOARD2

    def __init__(self, color1=(1, 1, 1), color2=(0, 0, 0), size: float = 0.1):
        self.color1 = _rgb(color1)
        self.color2 = _rgb(color2)
        self.size = float(size)

    def pack(self) -> tuple:
        return (*self.color1, *self.color2, self.size)


class Bilerp(Texture):
    category = C.BILERP

    def __init__(self, color00, color01, color10, color11):
        self.color00 = _rgb(color00)
        self.color01 = _rgb(color01)
        self.color10 = _rgb(color10)
        self.color11 = _rgb(color11)

    def pack(self) -> tuple:
        return (*self.color00, *self.color01, *self.color10, *self.color11)


class Mix(Texture):
    category = C.MIXF

    def __init__(self, color1, color2, amount: float = 0.5):
        self.color1 = _rgb(color1)
        self.color2 = _rgb(color2)
        self.amount = float(amount)

    def pack(self) -> tuple:
        return (*self.color1, *self.color2, self.amount)


class ScaleT(Texture):
    category = C.SCALE

    def __init__(self, color1, color2):
        self.color1 = _rgb(color1)
        self.color2 = _rgb(color2)

    def pack(self) -> tuple:
        return (*self.color1, *self.color2)


class UV(Texture):
    category = C.UVF

    def pack(self) -> tuple:
        return (0.0,)


class Color:
    """Named colors, and a uniform texture from one."""
    BLACK = C.BLACK
    WHITE = C.WHITE
    GREY = C.GREY
    RED = C.RED
    GREEN = C.GREEN
    BLUE = C.BLUE

    @staticmethod
    def create_texture(color) -> UniformColor:
        return UniformColor(color)
