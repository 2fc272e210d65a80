"""Pinhole camera and primary-ray generation (port of `sail_tpu/core/camera.py`).

The reference's lookAt negates its x basis after computing y, so the basis
is x' = z × up; reproduced here so renders match its golden images.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.device import resolve
from .vecmath import Vec3, vec3


class CameraParams(NamedTuple):
    """Camera parameters: 0-d float32 tensors and Vec3s of them."""
    eye: Vec3
    right: Vec3     # x' = z × up (reference's flipped basis)
    up: Vec3        # true vertical basis in camera plane
    back: Vec3      # z = normalize(eye - center)
    tan_half_fovy: torch.Tensor
    aspect: torch.Tensor


def _splat(v, device) -> Vec3:
    return vec3(*(float(c) for c in v), device=device)


def make_camera(eye, center, up=(0.0, 1.0, 0.0), fovy: float = 55.0,
                aspect: float = 1.0, device=None) -> CameraParams:
    """The camera basis on `device` (the card unless the caller asks for
    another device)."""
    device = resolve(device, "make_camera")
    eye = _splat(eye, device)
    center = _splat(center, device)
    up = _splat(up, device)
    z = (eye - center).normalize()
    x = z.cross(up).normalize()       # = -(up × z): reference's flip
    y = z.cross(-x).normalize()       # y from the un-negated basis
    return CameraParams(
        eye=eye, right=x, up=y, back=z,
        tan_half_fovy=torch.tensor(math.tan(fovy * math.pi / 360.0),
                                   dtype=torch.float32, device=device),
        aspect=torch.tensor(aspect, dtype=torch.float32, device=device),
    )


def rays_for_pixels(cam: CameraParams, ii, jj, height: int, width: int,
                    jitter_x=None, jitter_y=None) -> tuple[Vec3, Vec3]:
    """Primary rays for float pixel-index tensors `ii` (rows), `jj` (cols);
    a tile passes its global rows, so tiled and whole renders agree."""
    ox = jitter_x if jitter_x is not None else 0.5
    oy = jitter_y if jitter_y is not None else 0.5
    ndc_x = (jj + ox) * (2.0 / width) - 1.0
    ndc_y = 1.0 - (ii + oy) * (2.0 / height)
    sx = ndc_x * cam.tan_half_fovy * cam.aspect
    sy = ndc_y * cam.tan_half_fovy
    d = Vec3(
        cam.right.x * sx + cam.up.x * sy - cam.back.x,
        cam.right.y * sx + cam.up.y * sy - cam.back.y,
        cam.right.z * sx + cam.up.z * sy - cam.back.z,
    ).normalize()
    return cam.eye.broadcast_to(d.shape), d


def _to(x, device):
    if isinstance(x, Vec3):
        return Vec3(*(c.to(device) for c in x))
    return x.to(device) if isinstance(x, torch.Tensor) else x


def generate_rays(cam: CameraParams, height: int, width: int,
                  jitter_x=None, jitter_y=None,
                  device=None) -> tuple[Vec3, Vec3]:
    """Primary rays of a whole H×W image: (origins, directions), each a Vec3
    of (H, W) tensors on `device` (the card unless the caller asks for
    another device; the camera and jitter are moved there); jitter_x/y are
    optional per-pixel uniforms in [0, 1) (the pixel center without them)."""
    dev = resolve(device, "generate_rays")
    cam = CameraParams(*(_to(f, dev) for f in cam))
    jj = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ii = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    return rays_for_pixels(cam, ii, jj, height, width, _to(jitter_x, dev),
                           _to(jitter_y, dev))
