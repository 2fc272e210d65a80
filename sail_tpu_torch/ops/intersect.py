"""Ray–primitive intersection ops (port of `sail_tpu/ops/intersect.py`):
the nine shape categories, their bound boxes, the closest-hit fold with the
batched winner-fold for large groups, and the shadow any-hit scan.

Each op is elementwise over a batch of rays (Vec3 of tensors); a missing hit
is `t = MAX_DISTANCE`, never control flow.  Expressions keep the JAX
version's operation order.  Groups of `BATCH_THRESHOLD` or more objects of
one category fold after the other objects, as the JAX package folds them, so
a tie at equal t picks the object JAX picks.  The JAX package's Mosaic
workarounds (`_dyn_at`, the unroll cap) have no counterpart here.

`tally` (optional dict) receives each scan's per-ray count of the tests it
ran, by shape category and "slab" for a cluster's bound box (read by
`utils/opcount.py` for the kernels' bound); nothing is counted without it,
and it never changes a value.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..core import fastmath
from ..core import vecmath as vm
from ..core.vecmath import Vec3
from ..scene.geometry import (BoxP, DiskP, FrustumP, HyperboloidP,
                              ParaboloidP, SphereP)
from ..scene.scene import BATCH_THRESHOLD

TWO_PI = 2.0 * C.PI

# Objects per bound box of the opt-in cull: consecutive objects of a batched
# group in scene order (the JAX megakernel's CLUSTER).
CLUSTER = 8


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


def _full(shape, v):
    """A 0-d (or per-ray) parameter broadcast to the rays' shape."""
    return torch.broadcast_to(v, shape)


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
    cos_t = vm.clip(h.z / s.radius, -1.0 + 1e-6, 1.0 - 1e-6)
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


def _box_uv(p: Vec3, n: Vec3, b: BoxP):
    """Face-local uv from the two tangential extents."""
    ext = b.bmax - b.bmin
    rel = Vec3(_safe_div(p.x - b.bmin.x, ext.x),
               _safe_div(p.y - b.bmin.y, ext.y),
               _safe_div(p.z - b.bmin.z, ext.z))
    on_x = torch.abs(n.x) > 0.5
    on_y = torch.abs(n.y) > 0.5
    u = torch.where(on_x, rel.y, rel.x)
    v = torch.where(on_x, rel.z, torch.where(on_y, rel.z, rel.y))
    return u, v


def cube_intersect(ro: Vec3, rd: Vec3, cb: BoxP, detail: bool = True) -> Hit:
    shape = ro.shape
    tnear, tfar = _slab(ro, rd, cb.bmin, cb.bmax)
    hit_outside = (tnear > C.EPSILON) & (tnear < tfar)
    t = torch.where(hit_outside, tnear, tfar)
    valid = (tnear < tfar) & (t > C.EPSILON)
    if not detail:
        return _finish_t(valid, t, shape)

    p = ro + rd * t
    n = _box_face_normal(p, cb.bmin, cb.bmax)
    u, v = _box_uv(p, n, cb)
    return _finish(valid, t, p, n, _box_dpdu(n), u, v, shape)


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
    ss = ex * (1.0 / vm.clip(len_x, 1e-20))
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

    u = h.x / vm.clip(len_x, 1e-20)
    v = h.y / vm.clip(len_y, 1e-20)
    p = vm.local_to_world(h, n, ss, ts) + r.bmin
    return _finish(valid, t, p, n.broadcast_to(shape), ex.broadcast_to(shape),
                   u, v, shape)


# --------------------------------------------------------------------------
# Cone / Cylinder
# --------------------------------------------------------------------------

def _clipped_quadratic(o: Vec3, d: Vec3, a, b, c2, zlo, zhi):
    """Solve the quadratic, picking the nearest root whose hit lies in
    z ∈ [zlo, zhi]; fall back to the far root (cone, cylinder, quadrics)."""
    ok, t1, t2 = vm.quadratic(a, b, c2)
    ok = ok & (t2 >= -C.EPSILON)
    t1c = torch.where(t1 < C.EPSILON, t2, t1)
    z1 = o.z + d.z * t1c
    in1 = (z1 >= zlo) & (z1 <= zhi)
    # If near fails the clip, try far (only if near wasn't already far).
    z2 = o.z + d.z * t2
    in2 = (z2 >= zlo) & (z2 <= zhi) & (t1c != t2)
    t = torch.where(in1, t1c, t2)
    valid = ok & (in1 | in2) & (t < C.MAX_DISTANCE) & (t >= C.EPSILON)
    return valid, t


def _frustum_detail(valid, t, o, d, f: FrustumP, dpdv_xy, shape) -> Hit:
    """Shared tail of the cone and cylinder hits: (u, v) = (phi/2pi, z/h),
    ng = normalize(dpdu x dpdv)."""
    h = o + d * t
    u = _phi_of(h.x, h.y) / TWO_PI
    v = h.z / f.h
    zero = torch.zeros(shape, dtype=t.dtype, device=t.device)
    dpdu = Vec3(-TWO_PI * h.y, TWO_PI * h.x, zero)
    dx, dy = dpdv_xy(h, v)
    dpdv = Vec3(dx, dy, _full(shape, f.h))
    ng = dpdu.cross(dpdv).normalize()
    p = from_object(h) + f.p
    return _finish(valid, t, p, from_object(ng), from_object(dpdu), u, v, shape)


def cone_intersect(ro: Vec3, rd: Vec3, cn: FrustumP, detail: bool = True) -> Hit:
    shape = ro.shape
    o = to_object(ro - cn.p)
    d = to_object(rd)
    rh = cn.r / cn.h
    k = rh * rh
    a = d.x * d.x + d.y * d.y - k * d.z * d.z
    b = 2.0 * (d.x * o.x + d.y * o.y - k * d.z * (o.z - cn.h))
    c2 = o.x * o.x + o.y * o.y - k * (o.z - cn.h) * (o.z - cn.h)
    valid, t = _clipped_quadratic(o, d, a, b, c2, -C.EPSILON, cn.h)
    if not detail:
        return _finish_t(valid, t, shape)

    def dpdv_xy(h, v):
        inv1mv = _safe_div(1.0, 1.0 - v)
        return -h.x * inv1mv, -h.y * inv1mv

    return _frustum_detail(valid, t, o, d, cn, dpdv_xy, shape)


def cylinder_intersect(ro: Vec3, rd: Vec3, cy: FrustumP, detail: bool = True) -> Hit:
    shape = ro.shape
    o = to_object(ro - cy.p)
    d = to_object(rd)
    a = d.x * d.x + d.y * d.y
    b = 2.0 * (d.x * o.x + d.y * o.y)
    c2 = o.x * o.x + o.y * o.y - cy.r * cy.r
    valid, t = _clipped_quadratic(o, d, a, b, c2, -C.EPSILON, cy.h)
    if not detail:
        return _finish_t(valid, t, shape)

    def dpdv_xy(h, v):
        zero = torch.zeros_like(h.x)
        return zero, zero

    return _frustum_detail(valid, t, o, d, cy, dpdv_xy, shape)


# --------------------------------------------------------------------------
# Disk
# --------------------------------------------------------------------------

def disk_intersect(ro: Vec3, rd: Vec3, dk: DiskP, detail: bool = True) -> Hit:
    shape = ro.shape
    o = to_object(ro - dk.p)
    d = to_object(rd)
    t = -_safe_div(o.z, d.z)
    h = o + d * t
    dist2 = h.x * h.x + h.y * h.y
    valid = (torch.abs(d.z) > 1e-12) & (t > 0.0) & (t < C.MAX_DISTANCE) & \
            (dist2 <= dk.r * dk.r) & (dist2 >= dk.inner_r * dk.inner_r)
    if not detail:
        return _finish_t(valid, t, shape)

    u = _phi_of(h.x, h.y) / TWO_PI
    r_hit = torch.sqrt(dist2)
    v = 1.0 - _safe_div(r_hit - dk.inner_r, dk.r - dk.inner_r)
    zero = torch.zeros(shape, dtype=t.dtype, device=t.device)
    one = torch.ones(shape, dtype=t.dtype, device=t.device)
    dpdu = Vec3(-TWO_PI * h.y, TWO_PI * h.x, zero)
    ng = Vec3(zero, zero, one)  # local +z == world +y
    p = from_object(h) + dk.p
    return _finish(valid, t, p, from_object(ng), from_object(dpdu), u, v, shape)


# --------------------------------------------------------------------------
# Hyperboloid / Paraboloid
# --------------------------------------------------------------------------

def hyperboloid_intersect(ro: Vec3, rd: Vec3, hy: HyperboloidP,
                          detail: bool = True) -> Hit:
    shape = ro.shape
    o = to_object(ro - hy.p)
    d = to_object(rd)
    a = hy.ah * (d.x * d.x + d.y * d.y) - hy.ch * d.z * d.z
    b = 2.0 * (hy.ah * (d.x * o.x + d.y * o.y) - hy.ch * d.z * o.z)
    c2 = hy.ah * (o.x * o.x + o.y * o.y) - hy.ch * o.z * o.z - 1.0
    zmin = torch.minimum(hy.p1.z, hy.p2.z)
    zmax = torch.maximum(hy.p1.z, hy.p2.z)
    valid, t = _clipped_quadratic(o, d, a, b, c2, zmin, zmax)
    if not detail:
        return _finish_t(valid, t, shape)

    h = o + d * t
    v = _safe_div(h.z - hy.p1.z, hy.p2.z - hy.p1.z)
    pr = vm.lerp(hy.p1.broadcast_to(shape), hy.p2.broadcast_to(shape), v)
    phi = _phi_of(pr.x * h.x + pr.y * h.y, pr.x * h.y - h.x * pr.y)
    u = phi / TWO_PI
    sin_p = torch.sin(phi)
    cos_p = torch.cos(phi)
    zero = torch.zeros(shape, dtype=t.dtype, device=t.device)
    dpdu = Vec3(-TWO_PI * h.y, TWO_PI * h.x, zero)
    dx = hy.p2.x - hy.p1.x
    dy = hy.p2.y - hy.p1.y
    dz = hy.p2.z - hy.p1.z
    dpdv = Vec3(dx * cos_p - dy * sin_p, dx * sin_p + dy * cos_p,
                _full(shape, dz))
    ng = dpdu.cross(dpdv).normalize()
    p = from_object(h) + hy.p
    return _finish(valid, t, p, from_object(ng), from_object(dpdu), u, v, shape)


def paraboloid_intersect(ro: Vec3, rd: Vec3, pb: ParaboloidP,
                         detail: bool = True) -> Hit:
    shape = ro.shape
    o = to_object(ro - pb.p)
    d = to_object(rd)
    zmin = torch.minimum(pb.z0, pb.z1)
    zmax = torch.maximum(pb.z0, pb.z1)
    k = _safe_div(zmax, pb.r * pb.r)
    a = k * (d.x * d.x + d.y * d.y)
    b = 2.0 * k * (d.x * o.x + d.y * o.y) - d.z
    c2 = k * (o.x * o.x + o.y * o.y) - o.z
    valid, t = _clipped_quadratic(o, d, a, b, c2, zmin, zmax)
    if not detail:
        return _finish_t(valid, t, shape)

    h = o + d * t
    u = _phi_of(h.x, h.y) / TWO_PI
    v = _safe_div(h.z - zmin, zmax - zmin)
    zero = torch.zeros(shape, dtype=t.dtype, device=t.device)
    dpdu = Vec3(-TWO_PI * h.y, TWO_PI * h.x, zero)
    hz = torch.where(torch.abs(h.z) < 1e-8, 1e-8, h.z)
    dz = zmax - zmin
    dpdv = Vec3(dz * h.x / (2.0 * hz), dz * h.y / (2.0 * hz),
                _full(shape, dz))
    ng = dpdu.cross(dpdv).normalize()
    p = from_object(h) + pb.p
    return _finish(valid, t, p, from_object(ng), from_object(dpdu), u, v, shape)


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
    u, v = _box_uv(p, n, cb)
    return _finish(valid, t, p, n, dpdu, u, v, shape, sc,
                   torch.ones(shape, dtype=torch.int32, device=t.device))


# --------------------------------------------------------------------------
# Bound boxes (the opt-in cull; comparisons only, never differentiated)
# --------------------------------------------------------------------------

def object_aabb(cat: int, p):
    """Conservative world AABB of one packed shape.  Degenerate axes are
    padded relative to the coordinate's magnitude, so a flat rectangle or a
    disk survives the strict slab test on the rays that hit its plane."""
    if cat in (C.CUBE, C.RECTANGLE, C.CORNELLBOX):
        mag = torch.maximum(
            torch.maximum(torch.abs(p.bmin.x), torch.abs(p.bmax.x)),
            torch.maximum(torch.maximum(torch.abs(p.bmin.y),
                                        torch.abs(p.bmax.y)),
                          torch.maximum(torch.abs(p.bmin.z),
                                        torch.abs(p.bmax.z))))
        eps = 1e-4 * (1.0 + mag)
        pad = Vec3(eps, eps, eps)
        return p.bmin - pad, p.bmax + pad
    if cat == C.SPHERE:
        r = p.radius
        return p.center - Vec3(r, r, r), p.center + Vec3(r, r, r)
    if cat in (C.CONE, C.CYLINDER):
        # local z ∈ [0, h] is world y; radial extent r in world x/z
        return (p.p + Vec3(-p.r, 0.0 * p.h, -p.r),
                p.p + Vec3(p.r, p.h, p.r))
    if cat == C.DISK:
        eps = 1e-4 * (1.0 + torch.abs(p.p.y))
        return (p.p + Vec3(-p.r, -eps, -p.r),
                p.p + Vec3(p.r, eps, p.r))
    if cat == C.PARABOLOID:
        zmax = torch.maximum(p.z0, p.z1)
        zmin = torch.minimum(torch.minimum(p.z0, p.z1), 0.0 * p.z0)
        return (p.p + Vec3(-p.r, zmin, -p.r), p.p + Vec3(p.r, zmax, p.r))
    if cat == C.HYPERBOLOID:
        r1 = torch.sqrt(p.p1.x * p.p1.x + p.p1.y * p.p1.y)
        r2 = torch.sqrt(p.p2.x * p.p2.x + p.p2.y * p.p2.y)
        r = torch.maximum(r1, r2)
        zlo = torch.minimum(p.p1.z, p.p2.z)
        zhi = torch.maximum(p.p1.z, p.p2.z)
        return p.p + Vec3(-r, zlo, -r), p.p + Vec3(r, zhi, r)
    raise ValueError(f"no AABB for category {cat}")


def _vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
                torch.minimum(a.z, b.z))


def _vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
                torch.maximum(a.z, b.z))


def cluster_aabb(cat: int, params: list):
    """The bound box of a cluster of same-category objects."""
    amin, amax = object_aabb(cat, params[0])
    for p in params[1:]:
        a0, a1 = object_aabb(cat, p)
        amin, amax = _vmin(amin, a0), _vmax(amax, a1)
    return amin, amax


# --------------------------------------------------------------------------
# Scene dispatcher
# --------------------------------------------------------------------------

SHAPE_FNS = {
    C.SPHERE: sphere_intersect,
    C.CUBE: cube_intersect,
    C.RECTANGLE: rectangle_intersect,
    C.CONE: cone_intersect,
    C.CYLINDER: cylinder_intersect,
    C.DISK: disk_intersect,
    C.HYPERBOLOID: hyperboloid_intersect,
    C.PARABOLOID: paraboloid_intersect,
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


def fold_groups(static):
    """(unbatched object indices in scene order, [(category, indices)] of the
    batched groups in the order each category first appears): the fold
    order of the closest-hit and shadow scans."""
    groups = {}
    for i, cat in enumerate(static.object_categories):
        groups.setdefault(cat, []).append(i)
    batched = [(c, v) for c, v in groups.items() if len(v) >= BATCH_THRESHOLD]
    big = {c for c, _ in batched}
    plain = [i for i, c in enumerate(static.object_categories) if c not in big]
    return plain, batched


def _select(closer, a, b):
    """Elementwise select over matching (nested) tuples of tensors."""
    if not isinstance(a, tuple):
        return torch.where(closer, a, b)
    vals = [_select(closer, x, y) for x, y in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)


def _facing_emission(h: Hit, params, rd: Vec3, shape) -> Vec3:
    """Emission is visible only from the front of the reverse-adjusted
    normal."""
    face = (h.ng * params.reverse).dot(rd) < -C.EPSILON
    return vm.where(face, params.emission.broadcast_to(shape),
                    vm.zeros_vec(shape, rd.x))


def _fold_one(cat, params, i, static, ro, rd, shape, carry):
    """Fold object i's hit into the (best, best_aux) carry; strict `<`, so a
    tie keeps the earlier object."""
    best, best_aux = carry
    h = SHAPE_FNS[cat](ro, rd, params)
    emission = _facing_emission(h, params, rd, shape)
    closer = h.t < best.t
    best = _select(closer, h, best)

    def const(v):
        return torch.full(shape, int(v), dtype=torch.int32, device=ro.x.device)

    aux = (emission, const(static.object_mat_rows[i]),
           const(static.object_tex_rows[i]), const(i),
           const(static.object_emissive[i]))
    return best, _select(closer, aux, best_aux)


def _cluster_possible(cat, params, ro, rd, bound):
    """Rays that can reach the cluster's bound box before `bound`."""
    amin, amax = cluster_aabb(cat, params)
    tn, tf = _slab(ro, rd, amin, amax)
    return (tn < tf) & (tf > C.EPSILON) & (tn < bound)


def _count(tests: dict, key, n: int, mask=None) -> None:
    """Add n tests of `key` (a shape category, or "slab") to a tally's
    counts, on the rays of `mask` (every ray by default); no-op without a
    tally."""
    if tests is not None:
        tests[key] = tests.get(key, 0) + (n if mask is None else mask * n)


def _batched_fold(cat, idxs, objects, static, ro, rd, shape, carry,
                  cull: bool, tests: dict):
    """The winner-fold of one large group: the loop runs the t-only test and
    carries the winning object's parameters and rows through selects; the
    detail pass runs once from the per-ray winning parameters, with t from
    the loop.  With `cull`, a ray skips each cluster of CLUSTER consecutive
    objects whose bound box it cannot reach before its best hit so far
    (exact: such a cluster cannot change the fold)."""
    best, best_aux = carry
    dev = ro.x.device

    def const(v):
        return torch.full(shape, int(v), dtype=torch.int32, device=dev)

    t_group = vm.full(shape, C.MAX_DISTANCE, ro.x)
    aux = (const(0), const(0), const(-1), const(0))
    # the winner's parameters start as object 0's (real geometry on no-hit
    # rays, so the detail pass and its gradient stay finite)
    win = objects[idxs[0]]
    for c0 in range(0, len(idxs), CLUSTER):
        sub = idxs[c0:c0 + CLUSTER]
        possible = None
        if cull:
            possible = _cluster_possible(cat, [objects[i] for i in sub], ro,
                                         rd, torch.minimum(best.t, t_group))
            _count(tests, "slab", 1)
        _count(tests, cat, len(sub), possible)
        for i in sub:
            h = SHAPE_FNS[cat](ro, rd, objects[i], detail=False)
            closer = h.t < t_group
            if possible is not None:
                closer = closer & possible
            t_group = torch.where(closer, h.t, t_group)
            row = (const(static.object_mat_rows[i]),
                   const(static.object_tex_rows[i]), const(i),
                   const(static.object_emissive[i]))
            aux = _select(closer, row, aux)
            win = _select(closer, objects[i], win)

    h = SHAPE_FNS[cat](ro, rd, win, detail=True)._replace(t=t_group)
    emission = _facing_emission(h, win, rd, shape)
    closer = t_group < best.t
    best = _select(closer, h, best)
    return best, _select(closer, (emission, *aux), best_aux)


def intersect_scene(objects: tuple, static, ro: Vec3, rd: Vec3,
                    cull: bool = False, tally: dict = None) -> SceneHit:
    """Nearest-hit fold: the objects of small categories in scene order,
    then each batched group (`fold_groups`)."""
    shape = torch.broadcast_shapes(ro.shape, rd.shape)
    ro = ro.broadcast_to(shape)
    rd = rd.broadcast_to(shape)

    def const(v):
        return torch.full(shape, v, dtype=torch.int32, device=ro.x.device)

    carry = (miss(shape, ro.x),
             (vm.zeros_vec(shape, ro.x), const(0), const(0), const(-1),
              const(0)))
    plain, batched = fold_groups(static)
    cats = static.object_categories
    tests = None if tally is None else {}
    for i in plain:
        _count(tests, cats[i], 1)
        carry = _fold_one(cats[i], objects[i], i, static, ro, rd, shape,
                          carry)
    for cat, idxs in batched:
        carry = _batched_fold(cat, idxs, objects, static, ro, rd, shape,
                              carry, cull, tests)
    best, (emission, mat_row, tex_row, obj_id, emissive) = carry
    if tally is not None:
        tally["scan"] = tests

    into = best.ng.dot(rd) < -C.EPSILON
    return SceneHit(
        t=best.t, p=best.p, n=vm.where(into, best.ng, -best.ng), ng=best.ng,
        dpdu=best.dpdu, u=best.u, v=best.v, into=into, emission=emission,
        mat_row=mat_row, tex_row=tex_row, obj_id=obj_id, emissive=emissive,
        sc_override=best.sc_override, use_override=best.use_override,
        valid=best.t < C.MAX_DISTANCE,
    )


def occluded(objects: tuple, static, ro: Vec3, rd: Vec3, max_t,
             cull: bool = False, tally: dict = None) -> torch.Tensor:
    """Any-hit shadow query along normalized `rd`, accepting occluders with
    t ∈ (EPSILON, max_t), in the closest-hit fold's order.  With `cull`, a
    ray skips each cluster of a batched group whose bound box it cannot
    reach before max_t."""
    shape = torch.broadcast_shapes(ro.shape, rd.shape)
    ro = ro.broadcast_to(shape)
    rd = rd.broadcast_to(shape)
    occ = torch.zeros(shape, dtype=torch.bool, device=ro.x.device)
    plain, batched = fold_groups(static)
    cats = static.object_categories
    # the tests of a scan that stops at its first occluder, as the kernel's
    tests = None if tally is None else {}

    def test(cat, params, possible=None):
        nonlocal occ
        live = ~occ if possible is None else ~occ & possible
        _count(tests, cat, 1, live)
        h = SHAPE_FNS[cat](ro, rd, params, detail=False)
        occ = occ | ((h.t > C.EPSILON) & (h.t < max_t) & live)

    for i in plain:
        test(cats[i], objects[i])
    for cat, idxs in batched:
        for c0 in range(0, len(idxs), CLUSTER):
            sub = idxs[c0:c0 + CLUSTER]
            possible = None
            if cull:
                if tests is not None:
                    _count(tests, "slab", 1, ~occ)
                possible = _cluster_possible(
                    cat, [objects[i] for i in sub], ro, rd, max_t)
            for i in sub:
                test(cat, objects[i], possible)
    if tally is not None:
        tally["shadow"], tally["occluded"] = tests, occ
    return occ
