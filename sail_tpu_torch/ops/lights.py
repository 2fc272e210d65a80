"""Next-event light sampling (port of `sail_tpu/ops/lights.py` for AREA
lights over a RECTANGLE).

One light is picked per ray; every light's candidate sample is computed and
mask-selected, so one shadow ray is traced per ray per bounce.  The value
returned is the direct radiance estimate over the pick pdf times the surface
cosine; the integrator multiplies in the BSDF at the light direction.
"""
from __future__ import annotations

import torch

from .. import constants as C
from ..core import vecmath as vm
from ..core.vecmath import Vec3
from . import intersect as isect


def _sample_rectangle(params, u1, u2, shape):
    """Point, normal and area pdf on a rectangle light."""
    ex, ey, n = isect.rectangle_frame(params)
    p = params.bmin + ex * u1 + ey * u2
    area = ex.length() * ey.length()
    pdf = (1.0 / torch.clamp(area, min=1e-12)).broadcast_to(shape)
    return p.broadcast_to(shape), (n * params.reverse).broadcast_to(shape), pdf


def sample_direct(objects: tuple, lights: tuple, static, hit_p: Vec3,
                  hit_n: Vec3, u1, u2, light_idx) -> tuple[Vec3, Vec3]:
    """Returns (radiance, wi_world): incident radiance weighted by the
    surface cosine, geometric terms, visibility and the light-pick pdf; and
    the light direction for BSDF evaluation."""
    shape = hit_p.shape
    n_lights = len(lights)
    black = vm.zeros_vec(shape, hit_p.x)
    if n_lights == 0:
        return black, black

    cand_p = black
    cand_r = black
    for li, (cat, lp) in enumerate(zip(static.light_categories, lights)):
        obj_idx = static.area_light_objects[li]
        if cat != C.AREA or static.object_categories[obj_idx] != C.RECTANGLE:
            raise NotImplementedError(  # refused earlier by check_supported
                f"light category {cat}")
        p_l, n_l, pdf_a = _sample_rectangle(objects[obj_idx], u1, u2, shape)
        to_l = p_l - hit_p
        d2 = torch.clamp(to_l.length_sq(), min=1e-12)
        wi = to_l * vm.rsqrt(d2)
        cos_l = torch.clamp(n_l.dot(-wi), min=0.0)
        cos_s = torch.clamp(wi.dot(hit_n), min=0.0)
        rad = lp.emission.broadcast_to(shape) * (cos_l * cos_s /
                                                 (d2 * pdf_a) * n_lights)
        mask = light_idx == li
        cand_p = vm.where(mask, p_l, cand_p)
        cand_r = vm.where(mask, rad, cand_r)

    # One shadow ray per surface point toward the selected light sample.
    to_l = cand_p - hit_p
    dist = to_l.length()
    wi = to_l * (1.0 / torch.clamp(dist, min=1e-12))
    origin = hit_p + hit_n * 1e-4
    occ = isect.occluded(objects, static, origin, wi, dist * (1.0 - 1e-3))
    vis = torch.where(occ, 0.0, 1.0)
    return cand_r * vis, wi
