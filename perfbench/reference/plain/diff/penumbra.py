"""The penumbra edge term's plain version (`diff/boundary.shadow_boundary_term`'s
coefficients and live sum): Σ coeff · (n̂ · y) over every pixel, receiver,
(sphere, rectangle light) pair and curve sample, coeff and n̂ detached, y the
penumbra-curve point (`curve_points`), live in the occluder's center and
radius and the receiver point; its gradient is the term's by autograd."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as C
from ..core import vecmath as vm
from ..core.vecmath import Vec3
from ..ops import intersect as isect
from ..ops import materials as mat_ops

_SOURCE = "penumbra"
TWO_PI = 2.0 * math.pi
# the kernel's layout (csrc/penumbra.cuh): floats per receiver plane set and
# per light, and its thread block (columns, rows)
PLANES = 18
LIGHT_FLOATS = 20
BLOCK = (16, 16)


class Receiver(NamedTuple):
    """One receiver set: its hits (`isect.intersect_scene`'s record, its
    `valid` already narrowed to where it is seen), the tint it is seen
    through, its shading frame (ss, ts), wo, surface color and mask (a
    valid, matte, not emissive hit)."""
    tag: str             # "primary", "mirror", "ind{k}"
    hit: object
    tint: Vec3
    ss: Vec3
    ts: Vec3
    wo: Vec3
    sc: Vec3
    mask: torch.Tensor


def curve_points(sphere_p, light_obj_p, x: Vec3, cos_a, sin_a):
    """Penumbra-curve points y(t) on the light's plane, (K, H, W), as a
    function of the occluder's parameters and the receiver points x (the
    sphere's tangent circle seen from x, projected from x onto the light's
    plane); with λ, the light's frame and |c − x|."""
    shape = (cos_a.shape[0], *x.shape)
    c, r = sphere_p.center, sphere_p.radius
    w = c - x
    d = w.length()
    w_hat = w * (1.0 / vm.clip(d, 1e-9))
    ratio = vm.clip(r / vm.clip(d, 1e-9), 0.0, 1.0 - 1e-6)
    rho = r * torch.sqrt(vm.clip(1.0 - ratio * ratio, 1e-12))
    m = c - w_hat * (r * ratio)
    e1 = vm.ortho(w_hat).normalize()
    e2 = w_hat.cross(e1)
    s = m.broadcast_to(shape) + (e1 * cos_a + e2 * sin_a) * rho
    ex, ey, n_l = isect.rectangle_frame(light_obj_p)
    denom = (s - x).dot(n_l)
    lam = (light_obj_p.bmin - x).dot(n_l) / torch.where(
        torch.abs(denom) < 1e-9, 1e-9, denom)
    y = x + (s - x) * lam
    return y, lam, (ex, ey, n_l), d


def curve_angles(K: int, like: torch.Tensor):
    """(cos, sin) of the K curve samples' angles 2π (k + ½) / K, each (K, 1,
    1), in `like`'s dtype and device."""
    phis = (torch.arange(K, dtype=like.dtype, device=like.device) + 0.5) / K
    ang = TWO_PI * phis[:, None, None]
    return torch.cos(ang), torch.sin(ang)


def penumbra_scalar_plain(pk, pk_d, static, dL: Vec3, receivers, x_live: dict,
                          pairs, K: int, tally: dict = None) -> torch.Tensor:
    """The plain version: Σ coeff · (n̂ · y_live) over receivers, pairs
    (sphere index, light index, the light's object index) and the K
    samples, coeff and n̂ from the detached scene `pk_d` on (K, H, W)
    tensors, y_live of the live scene `pk`'s spheres and `x_live[tag]`.
    `tally` (a dict) counts the work KP does for these inputs
    (`utils/opcount.penumbra_ops`): receiver pixels per (receiver,
    sphere) and per (receiver, pair), and the samples that light their
    receiver; it changes no value."""
    like = dL.x
    cos_a, sin_a = curve_angles(K, like)
    if tally is not None:
        for key in ("units", "unit_lights", "valid"):
            tally.setdefault(key, 0)
    saved = []   # (tag, sphere index, light object, coeff, n_hat) per pair
    with torch.no_grad():
        for rc in receivers:
            rhit, tint, x = rc.hit, rc.tint, rc.hit.p
            for i, li, obj_idx in pairs:
                sp_d = pk_d.objects[i]
                lobj_d = pk_d.objects[obj_idx]
                le = pk_d.lights[li].emission

                y_d, lam, (ex, ey, n_l), d_cx = curve_points(
                    sp_d, lobj_d, x, cos_a, sin_a)
                rel = y_d - lobj_d.bmin
                exl = ex.length()
                eyl = ey.length()
                u_r = rel.dot(ex) / vm.clip(exl * exl, 1e-12)
                v_r = rel.dot(ey) / vm.clip(eyl * eyl, 1e-12)
                inside = ((u_r >= 0.0) & (u_r <= 1.0) & (v_r >= 0.0)
                          & (v_r <= 1.0))

                to_y = y_d - x
                d2 = vm.clip(to_y.length_sq(), 1e-12)
                wi = to_y * vm.rsqrt(d2)
                cos_s = wi.dot(rhit.n)
                cos_l = (-wi).dot(n_l * lobj_d.reverse)
                wi_local = vm.world_to_local(wi, rhit.n, rc.ss, rc.ts)
                f = mat_ops.eval_matte_f(pk_d.materials, static, rhit.mat_row,
                                         rc.sc, rc.wo, wi_local)
                h = (dL.x * tint.x * le.x * f.x
                     + dL.y * tint.y * le.y * f.y
                     + dL.z * tint.z * le.z * f.z) * (cos_s * cos_l / d2)

                valid = (rc.mask & inside & (lam > 1.0 + 1e-4)
                         & (cos_s > 0.0) & (cos_l > 0.0)
                         & (rhit.obj_id != i)
                         & (d_cx > sp_d.radius * (1.0 + 1e-4)))

                # tangent, arc length and outward normal (periodic)
                tx = Vec3(*(torch.roll(a, -1, 0) - torch.roll(a, 1, 0)
                            for a in y_d))
                dl = 0.5 * tx.length()
                n_raw = (n_l * lobj_d.reverse).cross(tx)
                n_hat = n_raw * (1.0 / vm.clip(n_raw.length(), 1e-12))
                # away from the occluded region: the reference point is
                # the sphere center projected from x
                denom_c = (sp_d.center - x).dot(n_l)
                lam_c = (lobj_d.bmin - x).dot(n_l) / torch.where(
                    torch.abs(denom_c) < 1e-9, 1e-9, denom_c)
                y_c = x + (sp_d.center - x) * lam_c
                n_hat = n_hat * torch.sign((y_d - y_c).dot(n_hat))

                coeff = torch.where(valid, -(h * dl), 0.0)
                saved.append((rc.tag, i, lobj_d, coeff, n_hat))
                if tally is not None:
                    tally["unit_lights"] += int(rc.mask.sum())
                    tally["valid"] += int(valid.sum())
            if tally is not None:
                tally["units"] += int(rc.mask.sum()) * len(
                    {i for i, _, _ in pairs})

    total = torch.zeros((), dtype=like.dtype, device=like.device)
    for tag, i, lobj_d, coeff, n_hat in saved:
        y_live, _, _, _ = curve_points(pk.objects[i], lobj_d, x_live[tag],
                                       cos_a, sin_a)
        total = total + torch.sum(coeff * n_hat.dot(y_live))
    return total


def penumbra_scalar(pk, pk_d, static, dL: Vec3, receivers, x_live: dict,
                    pairs, K: int) -> torch.Tensor:
    """Σ coeff · (n̂ · y_live), the scalar whose gradient is the penumbra
    term, by the plain version on any device."""
    return penumbra_scalar_plain(pk, pk_d, static, dL, receivers, x_live,
                                 pairs, K)
