"""Ray–primitive intersection ops of the slice (port of
`sail_tpu/ops/intersect.py`: sphere, rectangle, cornellbox, the unrolled
closest-hit fold and the shadow any-hit scan).

Each op is elementwise over a batch of rays (Vec3 of tensors); a missing hit
is `t = MAX_DISTANCE`, never control flow.  Expressions keep the JAX
version's operation order.  The batched fold the JAX package uses from
`BATCH_THRESHOLD` same-category objects up is not ported: `scene.unflatten`
refuses such scenes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..core import fastmath
from ..core import vecmath as vm
from ..core.vecmath import Vec3
from ..scene.geometry import BoxP, SphereP

TWO_PI = 2.0 * C.PI


def to_object(v: Vec3) -> Vec3:
    """World → object space, basis N=(0,1,0) S=(0,0,-1) T=(1,0,0): local z
    is world up."""
    return Vec3(-v.z, v.x, v.y)


def from_object(v: Vec3) -> Vec3:
    return Vec3(v.y, v.z, -v.x)


class Hit(NamedTuple):
    """Per-ray intersection record."""
    t: torch.Tensor
    p: Vec3          # world hit point
    ng: Vec3         # geometric normal, NOT reversed / flipped
    dpdu: Vec3       # world tangent (shading frame seed)
    u: torch.Tensor
    v: torch.Tensor
    sc_override: Vec3          # Cornell-box walls carry baked colors
    use_override: torch.Tensor  # int32 0/1


def miss(shape, like) -> Hit:
    z = vm.full(shape, 0.0, like)
    zv = Vec3(z, z, z)
    return Hit(vm.full(shape, C.MAX_DISTANCE, like), zv, zv, zv, z, z, zv,
               torch.zeros(shape, dtype=torch.int32, device=like.device))


def _finish(valid, t, p, ng, dpdu, u, v, shape, sc=None, use_sc=None) -> Hit:
    t = torch.where(valid, t, C.MAX_DISTANCE)
    if sc is None:
        sc = vm.zeros_vec(shape, t)
        use_sc = torch.zeros(shape, dtype=torch.int32, device=t.device)
    return Hit(t, p, ng, dpdu, u, v, sc, use_sc)


def _finish_t(valid, t, shape) -> Hit:
    """The any-hit (detail=False) record: t only."""
    z = vm.zeros_vec(shape, t)
    return _finish(valid, t, z, z, z, 0.0 * t, 0.0 * t, shape)


def _safe_div(num, den, eps=1e-12):
    return num / torch.where(torch.abs(den) < eps,
                             torch.where(den < 0, -eps, eps), den)


def _phi_of(x, y):
    phi = fastmath.atan2(y, x)
    return torch.where(phi < 0.0, phi + TWO_PI, phi)


# --------------------------------------------------------------------------
# Sphere
# --------------------------------------------------------------------------

def sphere_intersect(ro: Vec3, rd: Vec3, s: SphereP, detail: bool = True) -> Hit:
    shape = ro.shape
    o = to_object(ro - s.center)
    d = to_object(rd)

    a = d.dot(d)
    b = 2.0 * o.dot(d)
    c2 = o.dot(o) - s.radius * s.radius
    ok, t1, t2 = vm.quadratic(a, b, c2)
    t = torch.where(t1 < C.EPSILON, t2, t1)
    valid = ok & (t2 >= C.EPSILON) & (t < C.MAX_DISTANCE)
    if not detail:
        return _finish_t(valid, t, shape)

    h = o + d * t
    # Avoid the azimuthal singularity on the pole axis.
    hx = torch.where((h.x == 0.0) & (h.y == 0.0), 1e-5 * s.radius, h.x)
    h = Vec3(hx, h.y, h.z)
    u = _phi_of(h.x, h.y) / TWO_PI
    cos_t = torch.clamp(h.z / s.radius, -1.0 + 1e-6, 1.0 - 1e-6)
    v = fastmath.acos(cos_t) / C.PI

    dpdu = Vec3(-TWO_PI * h.y, TWO_PI * h.x, vm.full(shape, 0.0, t))
    ng = h * (1.0 / s.radius)
    p = from_object(h) + s.center
    return _finish(valid, t, p, from_object(ng), from_object(dpdu), u, v, shape)


# --------------------------------------------------------------------------
# Boxes: slab test, face normal, tangent
# --------------------------------------------------------------------------

def _slab(ro: Vec3, rd: Vec3, bmin: Vec3, bmax: Vec3):
    inv = Vec3(_safe_div(1.0, rd.x), _safe_div(1.0, rd.y), _safe_div(1.0, rd.z))
    tmin = (bmin - ro) * inv
    tmax = (bmax - ro) * inv
    t1 = Vec3(torch.minimum(tmin.x, tmax.x), torch.minimum(tmin.y, tmax.y),
              torch.minimum(tmin.z, tmax.z))
    t2 = Vec3(torch.maximum(tmin.x, tmax.x), torch.maximum(tmin.y, tmax.y),
              torch.maximum(tmin.z, tmax.z))
    return t1.max_component(), t2.min_component()


def _box_face_normal(h: Vec3, bmin: Vec3, bmax: Vec3) -> Vec3:
    """Face normal by nearest-bound comparison; priority x > y > z, default +z."""
    eps = 1e-4
    zero = torch.zeros_like(h.x)
    one = torch.ones_like(h.x)
    nx = torch.where(h.x < bmin.x + eps, -one,
                     torch.where(h.x > bmax.x - eps, one, zero))
    ny = torch.where(h.y < bmin.y + eps, -one,
                     torch.where(h.y > bmax.y - eps, one, zero))
    nz = torch.where(h.z < bmin.z + eps, -one,
                     torch.where(h.z > bmax.z - eps, one, zero))
    has_x = nx != 0.0
    has_y = ny != 0.0
    has_z = nz != 0.0
    return Vec3(
        torch.where(has_x, nx, zero),
        torch.where(~has_x & has_y, ny, zero),
        torch.where(~has_x & ~has_y, torch.where(has_z, nz, one), zero),
    )


def _box_dpdu(n: Vec3) -> Vec3:
    """Tangent via axis cross."""
    zero = torch.zeros_like(n.x)
    one = torch.ones_like(n.x)
    use_x = torch.abs(n.x) < 0.5
    return vm.where(use_x, n.cross(Vec3(one, zero, zero)),
                    n.cross(Vec3(zero, one, zero)))


# --------------------------------------------------------------------------
# Rectangle
# --------------------------------------------------------------------------

def rectangle_frame(r: BoxP):
    """Rectangle spanning edges x=(dx,0,0), y=(0,dy,dz) from min."""
    ext = r.bmax - r.bmin
    zero = torch.zeros_like(ext.x)
    ex = Vec3(ext.x, zero, zero)
    ey = Vec3(zero, ext.y, ext.z)
    return ex, ey, ex.cross(ey).normalize()


def rectangle_intersect(ro: Vec3, rd: Vec3, r: BoxP, detail: bool = True) -> Hit:
    shape = ro.shape
    ex, ey, n = rectangle_frame(r)
    len_x = ex.length()
    len_y = ey.length()
    ss = ex * (1.0 / torch.clamp(len_x, min=1e-20))
    ts = n.cross(ss)

    d_l = vm.world_to_local(rd, n, ss, ts)
    o_l = vm.world_to_local(ro - r.bmin, n, ss, ts)
    t = -_safe_div(o_l.z, d_l.z)
    h = o_l + d_l * t
    valid = (torch.abs(d_l.z) > 1e-12) & (t >= C.EPSILON) & \
            (h.x <= len_x) & (h.y <= len_y) & \
            (h.x >= -C.EPSILON) & (h.y >= -C.EPSILON) & (t < C.MAX_DISTANCE)
    if not detail:
        return _finish_t(valid, t, shape)

    u = h.x / torch.clamp(len_x, min=1e-20)
    v = h.y / torch.clamp(len_y, min=1e-20)
    p = vm.local_to_world(h, n, ss, ts) + r.bmin
    return _finish(valid, t, p, n.broadcast_to(shape), ex.broadcast_to(shape),
                   u, v, shape)


# --------------------------------------------------------------------------
# Cornell box: the far wall of an inside-out box, with baked wall colors
# --------------------------------------------------------------------------

def cornellbox_intersect(ro: Vec3, rd: Vec3, cb: BoxP, detail: bool = True) -> Hit:
    shape = ro.shape
    tnear, tfar = _slab(ro, rd, cb.bmin, cb.bmax)
    t = tfar  # always the far wall: the box is viewed from inside
    valid = (tnear < tfar) & (t > C.EPSILON)
    if not detail:
        return _finish_t(valid, t, shape)

    p = ro + rd * t
    n = -_box_face_normal(p, cb.bmin, cb.bmax)
    dpdu = _box_dpdu(n)
    # left GREEN, right BLUE, floor/ceiling/front WHITE, back BLACK
    eps = 1e-4

    def color(c):
        return Vec3(*(vm.full(shape, v, t) for v in c))

    sc = vm.where(p.x < cb.bmin.x + eps, color(C.GREEN),
                  vm.where(p.x > cb.bmax.x - eps, color(C.BLUE),
                           vm.where((p.y < cb.bmin.y + eps) |
                                    (p.y > cb.bmax.y - eps) |
                                    (p.z > cb.bmin.z + eps),
                                    color(C.WHITE), color(C.BLACK))))
    ext = cb.bmax - cb.bmin
    rel = Vec3(_safe_div(p.x - cb.bmin.x, ext.x),
               _safe_div(p.y - cb.bmin.y, ext.y),
               _safe_div(p.z - cb.bmin.z, ext.z))
    on_x = torch.abs(n.x) > 0.5
    on_y = torch.abs(n.y) > 0.5
    u = torch.where(on_x, rel.y, rel.x)
    v = torch.where(on_x, rel.z, torch.where(on_y, rel.z, rel.y))
    return _finish(valid, t, p, n, dpdu, u, v, shape, sc,
                   torch.ones(shape, dtype=torch.int32, device=t.device))


# --------------------------------------------------------------------------
# Scene dispatcher
# --------------------------------------------------------------------------

SHAPE_FNS = {
    C.SPHERE: sphere_intersect,
    C.RECTANGLE: rectangle_intersect,
    C.CORNELLBOX: cornellbox_intersect,
}


class SceneHit(NamedTuple):
    """Nearest hit over all objects, with per-ray scene bookkeeping."""
    t: torch.Tensor
    p: Vec3
    n: Vec3           # shading normal, flipped to face the ray
    ng: Vec3          # geometric normal, unflipped
    dpdu: Vec3
    u: torch.Tensor
    v: torch.Tensor
    into: torch.Tensor   # entered the surface from outside
    emission: Vec3       # zeroed on back faces (w.r.t. reverse-adjusted normal)
    mat_row: torch.Tensor   # int32 material row per ray
    tex_row: torch.Tensor   # int32 texture row per ray
    obj_id: torch.Tensor    # int32 object index per ray
    emissive: torch.Tensor  # int32 0/1: hit object is an emitter
    sc_override: Vec3
    use_override: torch.Tensor
    valid: torch.Tensor  # bool: t < MAX_DISTANCE


def _select(closer, a, b):
    """Elementwise select over matching (nested) tuples of tensors."""
    if not isinstance(a, tuple):
        return torch.where(closer, a, b)
    vals = [_select(closer, x, y) for x, y in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)


def _fold_one(cat, params, i, static, ro, rd, shape, carry):
    """Fold object i's hit into the (best, best_aux) carry; strict `<`, so a
    tie keeps the earlier object."""
    best, best_aux = carry
    h = SHAPE_FNS[cat](ro, rd, params)
    # Emission is visible only from the front of the reverse-adjusted normal.
    face = (h.ng * params.reverse).dot(rd) < -C.EPSILON
    emission = vm.where(face, params.emission.broadcast_to(shape),
                        vm.zeros_vec(shape, ro.x))
    closer = h.t < best.t
    best = _select(closer, h, best)

    def const(v):
        return torch.full(shape, int(v), dtype=torch.int32, device=ro.x.device)

    aux = (emission, const(static.object_mat_rows[i]),
           const(static.object_tex_rows[i]), const(i),
           const(static.object_emissive[i]))
    return best, _select(closer, aux, best_aux)


def intersect_scene(objects: tuple, static, ro: Vec3, rd: Vec3) -> SceneHit:
    """Nearest-hit fold over the scene's objects, in scene order."""
    shape = torch.broadcast_shapes(ro.shape, rd.shape)
    ro = ro.broadcast_to(shape)
    rd = rd.broadcast_to(shape)

    def const(v):
        return torch.full(shape, v, dtype=torch.int32, device=ro.x.device)

    carry = (miss(shape, ro.x),
             (vm.zeros_vec(shape, ro.x), const(0), const(0), const(-1),
              const(0)))
    for i, cat in enumerate(static.object_categories):
        carry = _fold_one(cat, objects[i], i, static, ro, rd, shape, carry)
    best, (emission, mat_row, tex_row, obj_id, emissive) = carry

    into = best.ng.dot(rd) < -C.EPSILON
    return SceneHit(
        t=best.t, p=best.p, n=vm.where(into, best.ng, -best.ng), ng=best.ng,
        dpdu=best.dpdu, u=best.u, v=best.v, into=into, emission=emission,
        mat_row=mat_row, tex_row=tex_row, obj_id=obj_id, emissive=emissive,
        sc_override=best.sc_override, use_override=best.use_override,
        valid=best.t < C.MAX_DISTANCE,
    )


def occluded(objects: tuple, static, ro: Vec3, rd: Vec3, max_t) -> torch.Tensor:
    """Any-hit shadow query along normalized `rd`, accepting occluders with
    t ∈ (EPSILON, max_t)."""
    shape = torch.broadcast_shapes(ro.shape, rd.shape)
    ro = ro.broadcast_to(shape)
    rd = rd.broadcast_to(shape)
    occ = torch.zeros(shape, dtype=torch.bool, device=ro.x.device)
    for i, cat in enumerate(static.object_categories):
        h = SHAPE_FNS[cat](ro, rd, objects[i], detail=False)
        occ = occ | ((h.t > C.EPSILON) & (h.t < max_t))
    return occ
