"""Display filters (port of the tone filters of `sail_tpu/ops/filters.py`;
plain tensor code — the JAX package has no kernel here either)."""
from __future__ import annotations

import torch

from ..core.vecmath import Vec3


def color(img: Vec3, **params) -> Vec3:
    return img


def gamma(img: Vec3, c: float = 2.2, **params) -> Vec3:
    inv = 1.0 / c
    return Vec3(*(torch.pow(torch.clamp(v, min=0.0), inv) for v in img))


def tonemapping(img: Vec3, **params) -> Vec3:
    """Filmic approximation."""
    def tm(v):
        x = torch.clamp(v - 0.004, min=0.0)
        return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    return Vec3(*(tm(v) for v in img))


_FILTERS = {"color": color, "gamma": gamma, "tonemapping": tonemapping}


def apply_filter(name: str, img: Vec3, **params) -> Vec3:
    if name not in _FILTERS:
        raise NotImplementedError(
            f"filter {name!r} is not ported yet (ROADMAP.md queue 1: "
            "display and runtime)")
    return _FILTERS[name](img, **params)
