"""Next-event light sampling (port of `sail_tpu/ops/lights.py`).

One light is picked per ray; every light's candidate sample is computed and
mask-selected, as the JAX package does, so one shadow ray is traced per ray
per bounce.  The value returned is the direct radiance estimate over the
pick pdf times the surface cosine; the integrator multiplies in the BSDF at
the light direction.  Every `maximum`/`minimum`/`clip` of a differentiable
value goes through `vm.clip` or `torch.maximum`/`minimum` (JAX's 0.5 / 0.5
gradient at a tie), and no division of a masked lane has a 0 denominator,
so a lane that is not picked passes its zero cotangent on as zeros.
"""
from __future__ import annotations

import math

import torch

from .. import constants as C
from ..core import samplers
from ..core import vecmath as vm
from ..core.vecmath import Vec3
from . import intersect as isect


def _sample_rectangle(params, u1, u2, shape):
    ex, ey, n = isect.rectangle_frame(params)
    p = params.bmin + ex * u1 + ey * u2
    area = ex.length() * ey.length()
    pdf = (1.0 / vm.clip(area, 1e-12)).broadcast_to(shape)
    return p.broadcast_to(shape), (n * params.reverse).broadcast_to(shape), pdf


def _sample_cube(params, u1, u2, shape):
    """Uniform over the surface: a face picked by area from u1 (u1 rescaled
    within the face), the point from (u1', u2); pdf = 1 / area."""
    ext = params.bmax - params.bmin
    ax = ext.y * ext.z   # each x-normal face
    ay = ext.x * ext.z
    az = ext.x * ext.y
    area = 2.0 * (ax + ay + az)
    r = u1 * area
    # cumulative areas of the faces x-, x+, y-, y+, z-, z+
    c1, c2, c3, c4, c5 = ax, 2 * ax, 2 * ax + ay, 2 * (ax + ay), \
        2 * (ax + ay) + az
    face = ((r >= c1).int() + (r >= c2).int() + (r >= c3).int()
            + (r >= c4).int() + (r >= c5).int())
    lo = torch.stack([0.0 * r, c1 + 0.0 * r, c2 + 0.0 * r, c3 + 0.0 * r,
                      c4 + 0.0 * r, c5 + 0.0 * r])
    fa = torch.stack([ax + 0.0 * r, ax + 0.0 * r, ay + 0.0 * r,
                      ay + 0.0 * r, az + 0.0 * r, az + 0.0 * r])
    idx = face.long()[None]
    u1p = vm.clip((r - lo.gather(0, idx)[0])
                  / vm.clip(fa.gather(0, idx)[0], 1e-12), 0.0, 1.0)
    on_x = face < 2
    on_y = (face >= 2) & (face < 4)
    hi_face = (face % 2) == 1
    one = torch.where(hi_face, 1.0, 0.0).to(u1p.dtype)
    fx = torch.where(on_x, one, u1p)
    fy = torch.where(on_x, u1p, torch.where(on_y, one, u2))
    fz = torch.where(on_x | on_y, u2, one)
    p = Vec3(params.bmin.x + ext.x * fx, params.bmin.y + ext.y * fy,
             params.bmin.z + ext.z * fz)
    zero = torch.zeros(shape, dtype=u1p.dtype, device=u1p.device)
    sgn = torch.where(hi_face, 1.0, -1.0).to(u1p.dtype)
    n = Vec3(torch.where(on_x, sgn, zero), torch.where(on_y, sgn, zero),
             torch.where(on_x | on_y, zero, sgn)) * params.reverse
    pdf = (1.0 / vm.clip(area, 1e-12)).broadcast_to(shape)
    return p, n, pdf


def _lateral_band(cat: int, params, u2):
    """(zmin, zmax, z, rho, rho') of a z-revolution shape rho = f(z) at the
    sampled height z."""
    if cat == C.CONE:
        zmin = torch.zeros_like(params.h)
        zmax = params.h
        z = zmin + (zmax - zmin) * u2
        mh = vm.clip(params.h, 1e-9)
        return zmin, zmax, z, params.r * (1.0 - z / mh), -params.r / mh + 0.0 * z
    if cat == C.CYLINDER:
        zmin = torch.zeros_like(params.h)
        zmax = params.h
        z = zmin + (zmax - zmin) * u2
        return zmin, zmax, z, params.r + 0.0 * z, 0.0 * z
    if cat == C.PARABOLOID:
        zmin = torch.minimum(params.z0, params.z1)
        zmax = torch.maximum(params.z0, params.z1)
        k = zmax / vm.clip(params.r * params.r, 1e-12)
        # z = k rho^2 exists only where sign(z) == sign(k): the band is
        # clamped to that side, as the intersection clips it
        zmin = torch.where(k > 0, vm.clip(zmin, 0.0), zmin)
        zmax = torch.where(k < 0, vm.clip(zmax, None, 0.0), zmax)
        z = zmin + (zmax - zmin) * u2
        rho = torch.sqrt(vm.clip(z / vm.clip(k, 1e-12), 1e-12))
        return zmin, zmax, z, rho, 1.0 / vm.clip(2.0 * k * rho, 1e-9)
    # HYPERBOLOID: ah (x² + y²) − ch z² = 1
    zmin = torch.minimum(params.p1.z, params.p2.z)
    zmax = torch.maximum(params.p1.z, params.p2.z)
    z = zmin + (zmax - zmin) * u2
    rho = torch.sqrt(vm.clip((1.0 + params.ch * z * z)
                             / vm.clip(params.ah, 1e-12), 1e-12))
    return zmin, zmax, z, rho, params.ch * z / vm.clip(params.ah * rho, 1e-9)


def _sample_lateral(cat: int, params, u1, u2, shape):
    """The lateral surface of a cone, cylinder, paraboloid or hyperboloid:
    (phi, z) uniform in parameter space, over the exact area element
    |dp/dphi x dp/dz| = rho sqrt(1 + rho'^2)."""
    two_pi = 2.0 * math.pi
    phi = two_pi * u1
    zmin, zmax, z, rho, drho = _lateral_band(cat, params, u2)
    cos_p = torch.cos(phi)
    sin_p = torch.sin(phi)
    local = Vec3(rho * cos_p, rho * sin_p, z)
    n_local = Vec3(cos_p, sin_p, -drho).normalize()
    p = isect.from_object(local) + params.p
    n = isect.from_object(n_local) * params.reverse
    jac = rho * torch.sqrt(1.0 + drho * drho)
    pdf = 1.0 / vm.clip(two_pi * (zmax - zmin) * jac, 1e-12)
    return p.broadcast_to(shape), n.broadcast_to(shape), pdf.broadcast_to(shape)


def _sample_geometry(cat: int, params, u1, u2, shape):
    """A point, its normal and the area pdf on an emissive geometry."""
    if cat == C.SPHERE:
        d = samplers.uniform_sphere(u1, u2)
        p = isect.from_object(d * params.radius) + params.center
        n = isect.from_object(d) * params.reverse
        pdf = (1.0 / (4.0 * C.PI * params.radius ** 2)).broadcast_to(shape)
        return p.broadcast_to(shape), n.broadcast_to(shape), pdf
    if cat == C.RECTANGLE:
        return _sample_rectangle(params, u1, u2, shape)
    if cat == C.DISK:
        dx, dy = samplers.concentric_disk(u1, u2)
        # the disk lies in the world xz-plane, normal +y
        p = Vec3(params.p.x + dx * params.r, params.p.y.broadcast_to(shape),
                 params.p.z + dy * params.r)
        area = C.PI * (params.r ** 2 - params.inner_r ** 2)
        zero = torch.zeros(shape, dtype=dx.dtype, device=dx.device)
        n = Vec3(zero, params.reverse.broadcast_to(shape), zero)
        pdf = (1.0 / vm.clip(area, 1e-12)).broadcast_to(shape)
        return p, n, pdf
    if cat == C.CUBE:
        return _sample_cube(params, u1, u2, shape)
    if cat in (C.CONE, C.CYLINDER, C.PARABOLOID, C.HYPERBOLOID):
        return _sample_lateral(cat, params, u1, u2, shape)
    raise ValueError(f"no area sampler for shape category {cat}")


def _toward(p_l: Vec3, hit_p: Vec3, hit_n: Vec3):
    """to_l, d2, wi and the surface cosine toward a light sample."""
    to_l = p_l - hit_p
    d2 = vm.clip(to_l.length_sq(), 1e-12)
    wi = to_l * vm.rsqrt(d2)
    return to_l, d2, wi, vm.clip(wi.dot(hit_n), 0.0)


def sample_light(cat: int, lp, obj_cat: int, obj, hit_p: Vec3, hit_n: Vec3,
                 u1, u2, n_lights: int):
    """One light's candidate: (sample point, radiance before visibility and
    the BSDF)."""
    shape = hit_p.shape
    emission = lp.emission.broadcast_to(shape)
    if cat == C.AREA:
        p_l, n_l, pdf_a = _sample_geometry(obj_cat, obj, u1, u2, shape)
        _, d2, wi, cos_s = _toward(p_l, hit_p, hit_n)
        cos_l = vm.clip(n_l.dot(-wi), 0.0)
        return p_l, emission * (cos_l * cos_s / (d2 * pdf_a) * n_lights)
    if cat == C.POINT:
        jitter = samplers.uniform_sphere(u1, u2) * lp.radius
        p_l = lp.origin.broadcast_to(shape) + jitter
        _, d2, _, cos_s = _toward(p_l, hit_p, hit_n)
        return p_l, emission * (cos_s / d2 * n_lights)
    if cat == C.SPOT:
        # falloff about the spot's -y axis: cos_t = -w.y with w = -wi
        p_l = lp.origin.broadcast_to(shape)
        _, d2, wi, cos_s = _toward(p_l, hit_p, hit_n)
        cos_t = wi.y
        ctw, cfs = lp.cos_total_width, lp.cos_falloff_start
        delta = (cos_t - ctw) / vm.clip(cfs - ctw, 1e-7)
        fall = torch.where(cos_t < ctw, 0.0,
                           torch.where(cos_t >= cfs, 1.0,
                                       (delta * delta) * (delta * delta)))
        return p_l, emission * (fall * cos_s / d2 * n_lights)
    raise ValueError(f"unknown light category {cat}")


def sample_direct(objects: tuple, lights: tuple, static, hit_p: Vec3,
                  hit_n: Vec3, u1, u2, light_idx, cull: bool = False,
                  tally: dict = None) -> tuple[Vec3, Vec3]:
    """Returns (radiance, wi_world): incident radiance weighted by the
    surface cosine, geometric terms, visibility and the light-pick pdf; and
    the light direction for BSDF evaluation.  `cull` and `tally` go to
    the shadow scan (`intersect.occluded`)."""
    shape = hit_p.shape
    n_lights = len(lights)
    black = vm.zeros_vec(shape, hit_p.x)
    if n_lights == 0:
        return black, black

    cand_p = black
    cand_r = black
    for li, (cat, lp) in enumerate(zip(static.light_categories, lights)):
        obj_idx = static.area_light_objects[li]
        area = cat == C.AREA
        p_l, rad = sample_light(
            cat, lp, static.object_categories[obj_idx] if area else None,
            objects[obj_idx] if area else None, hit_p, hit_n, u1, u2,
            n_lights)
        mask = light_idx == li
        cand_p = vm.where(mask, p_l, cand_p)
        cand_r = vm.where(mask, rad, cand_r)

    # One shadow ray per surface point toward the selected light sample.
    to_l = cand_p - hit_p
    dist = to_l.length()
    wi = to_l * (1.0 / vm.clip(dist, 1e-12))
    origin = hit_p + hit_n * 1e-4
    occ = isect.occluded(objects, static, origin, wi, dist * (1.0 - 1e-3),
                         cull=cull, tally=tally)
    vis = torch.where(occ, 0.0, 1.0)
    return cand_r * vis, wi
