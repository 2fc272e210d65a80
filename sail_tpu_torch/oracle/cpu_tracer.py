"""Pure-NumPy reference path tracer, the correctness oracle (port of
`sail_tpu/oracle/cpu_tracer.py`, kept in numpy: it is the independent
reference, and written in torch it would share the code it checks).

It re-implements the renderer's estimator semantics in NumPy (no torch,
no shared compute code but the port's host scene classes and
`constants.py`), per-pixel vectorized, readable over fast.  Tests drive
the port's plain integrator and this oracle with the *same* uniform
random fields (`trace_rays(..., rand_override=...)`) and assert allclose;
on the same scene and fields it gives the JAX package's oracle's numbers
bit for bit (`tests/test_torch_oracle.py`).

Semantics mirror the corrected estimators (see scene/light.py and
ops/bsdf.py docstrings for the documented deviations from the reference
GLSL).
"""
from __future__ import annotations

import math

import numpy as np

from .. import constants as C

MAXD = C.MAX_DISTANCE
EPS = C.EPSILON


# -- small numpy vec helpers (arrays of shape (..., 3)) ---------------------

def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _norm(v):
    n = np.sqrt(np.maximum(np.sum(v * v, axis=-1, keepdims=True), 1e-20))
    return v / n


def _cross(a, b):
    return np.cross(a, b)


def to_obj(v):
    """World→object basis N=(0,1,0),S=(0,0,-1),T=(1,0,0)."""
    return np.stack([-v[..., 2], v[..., 0], v[..., 1]], axis=-1)


def from_obj(v):
    return np.stack([v[..., 1], v[..., 2], -v[..., 0]], axis=-1)


def quadratic(a, b, c):
    disc = b * b - 4 * a * c
    ok = disc >= 0
    root = np.sqrt(np.maximum(disc, 0.0))
    q = np.where(b < 0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / np.where(a == 0, 1e-20, a)
    t1 = c / np.where(q == 0, 1e-20, q)
    return ok, np.minimum(t0, t1), np.maximum(t0, t1)


# -- intersections -----------------------------------------------------------

def isect_sphere(ro, rd, center, radius):
    o = to_obj(ro - np.asarray(center))
    d = to_obj(rd)
    a = _dot(d, d)
    b = 2 * _dot(o, d)
    c = _dot(o, o) - radius * radius
    ok, t1, t2 = quadratic(a, b, c)
    t = np.where(t1 < EPS, t2, t1)
    valid = ok & (t2 >= EPS) & (t < MAXD)
    t = np.where(valid, t, MAXD)
    h = o + d * t[..., None]
    ng = from_obj(h / radius)
    p = from_obj(h) + np.asarray(center)
    phi = np.arctan2(h[..., 1], np.where((h[..., 0] == 0) & (h[..., 1] == 0),
                                         1e-5 * radius, h[..., 0]))
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    u = phi / (2 * np.pi)
    v = np.arccos(np.clip(h[..., 2] / radius, -1, 1)) / np.pi
    dpdu = from_obj(np.stack([-2 * np.pi * h[..., 1], 2 * np.pi * h[..., 0],
                              np.zeros_like(t)], axis=-1))
    return t, p, ng, dpdu, u, v


def _slab(ro, rd, bmin, bmax):
    rd_safe = np.where(np.abs(rd) < 1e-12, np.where(rd < 0, -1e-12, 1e-12), rd)
    tmin = (np.asarray(bmin) - ro) / rd_safe
    tmax = (np.asarray(bmax) - ro) / rd_safe
    t1 = np.minimum(tmin, tmax)
    t2 = np.maximum(tmin, tmax)
    return t1.max(axis=-1), t2.min(axis=-1)


def _box_normal(p, bmin, bmax):
    eps = 1e-4
    bmin = np.asarray(bmin)
    bmax = np.asarray(bmax)
    n = np.zeros_like(p)
    sel_done = np.zeros(p.shape[:-1], bool)
    for axis in range(3):
        lo = p[..., axis] < bmin[axis] + eps
        hi = p[..., axis] > bmax[axis] - eps
        pick = (lo | hi) & ~sel_done
        n[..., axis] = np.where(pick, np.where(lo, -1.0, 1.0), n[..., axis])
        sel_done |= pick
    n[..., 2] = np.where(~sel_done, 1.0, n[..., 2])
    return n


def _box_dpdu(n):
    x = np.array([1.0, 0, 0])
    y = np.array([0, 1.0, 0])
    use_x = np.abs(n[..., 0]) < 0.5
    return np.where(use_x[..., None], _cross(n, x), _cross(n, y))


def isect_cube(ro, rd, bmin, bmax):
    tnear, tfar = _slab(ro, rd, bmin, bmax)
    t = np.where((tnear > EPS) & (tnear < tfar), tnear, tfar)
    valid = (tnear < tfar) & (t > EPS)
    t = np.where(valid, t, MAXD)
    p = ro + rd * t[..., None]
    n = _box_normal(p, bmin, bmax)
    dpdu = _box_dpdu(n)
    ext = np.asarray(bmax) - np.asarray(bmin)
    rel = (p - np.asarray(bmin)) / np.where(np.abs(ext) < 1e-12, 1.0, ext)
    on_x = np.abs(n[..., 0]) > 0.5
    on_y = np.abs(n[..., 1]) > 0.5
    u = np.where(on_x, rel[..., 1], rel[..., 0])
    v = np.where(on_x, rel[..., 2], np.where(on_y, rel[..., 2], rel[..., 1]))
    return t, p, n, dpdu, u, v


def isect_cornellbox(ro, rd, bmin, bmax):
    tnear, tfar = _slab(ro, rd, bmin, bmax)
    t = tfar
    valid = (tnear < tfar) & (t > EPS)
    t = np.where(valid, t, MAXD)
    p = ro + rd * t[..., None]
    n = -_box_normal(p, bmin, bmax)
    dpdu = _box_dpdu(n)
    return t, p, n, dpdu, np.zeros_like(t), np.zeros_like(t)


def cornell_color(p, bmin, bmax):
    eps = 1e-4
    bmin = np.asarray(bmin)
    bmax = np.asarray(bmax)
    sc = np.zeros_like(p)
    left = p[..., 0] < bmin[0] + eps
    right = p[..., 0] > bmax[0] - eps
    white = ((p[..., 1] < bmin[1] + eps) | (p[..., 1] > bmax[1] - eps) |
             (p[..., 2] > bmin[2] + eps))
    sc[left] = C.GREEN
    sc[right & ~left] = C.BLUE
    sc[white & ~left & ~right] = C.WHITE
    return sc


def isect_rectangle(ro, rd, bmin, bmax):
    bmin = np.asarray(bmin, float)
    bmax = np.asarray(bmax, float)
    ext = bmax - bmin
    ex = np.array([ext[0], 0, 0])
    ey = np.array([0, ext[1], ext[2]])
    n = _norm(_cross(ex, ey))
    lx = np.linalg.norm(ex)
    ly = np.linalg.norm(ey)
    ss = ex / max(lx, 1e-20)
    ts = _cross(n, ss)
    d_l = np.stack([_dot(rd, ss), _dot(rd, ts), _dot(rd, n)], axis=-1)
    o_rel = ro - bmin
    o_l = np.stack([_dot(o_rel, ss), _dot(o_rel, ts), _dot(o_rel, n)], axis=-1)
    t = -o_l[..., 2] / np.where(np.abs(d_l[..., 2]) < 1e-12, 1e-12, d_l[..., 2])
    h = o_l + d_l * t[..., None]
    valid = (np.abs(d_l[..., 2]) > 1e-12) & (t >= EPS) & (t < MAXD) & \
            (h[..., 0] <= lx) & (h[..., 1] <= ly) & \
            (h[..., 0] >= -EPS) & (h[..., 1] >= -EPS)
    t = np.where(valid, t, MAXD)
    p = (ss * h[..., 0:1] + ts * h[..., 1:2] + n * h[..., 2:3]) + bmin
    u = h[..., 0] / max(lx, 1e-20)
    v = h[..., 1] / max(ly, 1e-20)
    ng = np.broadcast_to(n, p.shape).copy()
    dpdu = np.broadcast_to(ex, p.shape).copy()
    return t, p, ng, dpdu, u, v


def isect_disk(ro, rd, pos, r, inner_r):
    o = to_obj(ro - np.asarray(pos))
    d = to_obj(rd)
    t = -o[..., 2] / np.where(np.abs(d[..., 2]) < 1e-12, 1e-12, d[..., 2])
    h = o + d * t[..., None]
    dist2 = h[..., 0] ** 2 + h[..., 1] ** 2
    valid = (np.abs(d[..., 2]) > 1e-12) & (t > 0) & (t < MAXD) & \
            (dist2 <= r * r) & (dist2 >= inner_r * inner_r)
    t = np.where(valid, t, MAXD)
    p = from_obj(h) + np.asarray(pos)
    ng = np.broadcast_to(from_obj(np.array([0.0, 0.0, 1.0])), p.shape).copy()
    dpdu = from_obj(np.stack([-2 * np.pi * h[..., 1], 2 * np.pi * h[..., 0],
                              np.zeros_like(t)], axis=-1))
    phi = np.arctan2(h[..., 1], h[..., 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    u = phi / (2 * np.pi)
    v = 1.0 - (np.sqrt(dist2) - inner_r) / max(r - inner_r, 1e-20)
    return t, p, ng, dpdu, u, v


def _clipped_quad(o, d, a, b, c, zlo, zhi):
    ok, t1, t2 = quadratic(a, b, c)
    ok = ok & (t2 >= -EPS)
    t1c = np.where(t1 < EPS, t2, t1)
    z1 = o[..., 2] + d[..., 2] * t1c
    in1 = (z1 >= zlo) & (z1 <= zhi)
    z2 = o[..., 2] + d[..., 2] * t2
    in2 = (z2 >= zlo) & (z2 <= zhi) & (t1c != t2)
    t = np.where(in1, t1c, t2)
    valid = ok & (in1 | in2) & (t < MAXD) & (t >= EPS)
    return valid, t


def isect_cone(ro, rd, pos, h_, r):
    o = to_obj(ro - np.asarray(pos))
    d = to_obj(rd)
    k = (r / h_) ** 2
    a = d[..., 0] ** 2 + d[..., 1] ** 2 - k * d[..., 2] ** 2
    b = 2 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1] -
             k * d[..., 2] * (o[..., 2] - h_))
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - k * (o[..., 2] - h_) ** 2
    valid, t = _clipped_quad(o, d, a, b, c, -EPS, h_)
    t = np.where(valid, t, MAXD)
    h = o + d * t[..., None]
    v = h[..., 2] / h_
    dpdu = np.stack([-2 * np.pi * h[..., 1], 2 * np.pi * h[..., 0],
                     np.zeros_like(t)], axis=-1)
    inv1mv = 1.0 / np.where(np.abs(1 - v) < 1e-7, 1e-7, 1 - v)
    dpdv = np.stack([-h[..., 0] * inv1mv, -h[..., 1] * inv1mv,
                     np.full_like(t, h_)], axis=-1)
    ng = _norm(_cross(dpdu, dpdv))
    phi = np.arctan2(h[..., 1], h[..., 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    return (t, from_obj(h) + np.asarray(pos), from_obj(ng), from_obj(dpdu),
            phi / (2 * np.pi), v)


def isect_cylinder(ro, rd, pos, h_, r):
    o = to_obj(ro - np.asarray(pos))
    d = to_obj(rd)
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1])
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - r * r
    valid, t = _clipped_quad(o, d, a, b, c, -EPS, h_)
    t = np.where(valid, t, MAXD)
    h = o + d * t[..., None]
    dpdu = np.stack([-2 * np.pi * h[..., 1], 2 * np.pi * h[..., 0],
                     np.zeros_like(t)], axis=-1)
    dpdv = np.stack([np.zeros_like(t), np.zeros_like(t),
                     np.full_like(t, h_)], axis=-1)
    ng = _norm(_cross(dpdu, dpdv))
    phi = np.arctan2(h[..., 1], h[..., 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    return (t, from_obj(h) + np.asarray(pos), from_obj(ng), from_obj(dpdu),
            phi / (2 * np.pi), h[..., 2] / h_)


def isect_paraboloid(ro, rd, pos, z0, z1, r):
    o = to_obj(ro - np.asarray(pos))
    d = to_obj(rd)
    zmin, zmax = min(z0, z1), max(z0, z1)
    k = zmax / (r * r)
    a = k * (d[..., 0] ** 2 + d[..., 1] ** 2)
    b = 2 * k * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1]) - d[..., 2]
    c = k * (o[..., 0] ** 2 + o[..., 1] ** 2) - o[..., 2]
    valid, t = _clipped_quad(o, d, a, b, c, zmin, zmax)
    t = np.where(valid, t, MAXD)
    h = o + d * t[..., None]
    dpdu = np.stack([-2 * np.pi * h[..., 1], 2 * np.pi * h[..., 0],
                     np.zeros_like(t)], axis=-1)
    hz = np.where(np.abs(h[..., 2]) < 1e-8, 1e-8, h[..., 2])
    dpdv = np.stack([(zmax - zmin) * h[..., 0] / (2 * hz),
                     (zmax - zmin) * h[..., 1] / (2 * hz),
                     np.full_like(t, zmax - zmin)], axis=-1)
    ng = _norm(_cross(dpdu, dpdv))
    phi = np.arctan2(h[..., 1], h[..., 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    v = (h[..., 2] - zmin) / max(zmax - zmin, 1e-20)
    return (t, from_obj(h) + np.asarray(pos), from_obj(ng), from_obj(dpdu),
            phi / (2 * np.pi), v)


def isect_hyperboloid(ro, rd, pos, p1, p2, ah, ch):
    o = to_obj(ro - np.asarray(pos))
    d = to_obj(rd)
    a = ah * (d[..., 0] ** 2 + d[..., 1] ** 2) - ch * d[..., 2] ** 2
    b = 2 * (ah * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1]) -
             ch * d[..., 2] * o[..., 2])
    c = ah * (o[..., 0] ** 2 + o[..., 1] ** 2) - ch * o[..., 2] ** 2 - 1.0
    zmin, zmax = min(p1[2], p2[2]), max(p1[2], p2[2])
    valid, t = _clipped_quad(o, d, a, b, c, zmin, zmax)
    t = np.where(valid, t, MAXD)
    h = o + d * t[..., None]
    v = (h[..., 2] - p1[2]) / max(p2[2] - p1[2], 1e-20)
    pr = (1 - v[..., None]) * np.asarray(p1) + v[..., None] * np.asarray(p2)
    phi = np.arctan2(pr[..., 0] * h[..., 1] - h[..., 0] * pr[..., 1],
                     h[..., 0] * pr[..., 0] + h[..., 1] * pr[..., 1])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    dpdu = np.stack([-2 * np.pi * h[..., 1], 2 * np.pi * h[..., 0],
                     np.zeros_like(t)], axis=-1)
    dx, dy, dz = (np.asarray(p2) - np.asarray(p1))
    dpdv = np.stack([dx * np.cos(phi) - dy * np.sin(phi),
                     dx * np.sin(phi) + dy * np.cos(phi),
                     np.full_like(t, dz)], axis=-1)
    ng = _norm(_cross(dpdu, dpdv))
    return (t, from_obj(h) + np.asarray(pos), from_obj(ng), from_obj(dpdu),
            phi / (2 * np.pi), v)


def intersect_object(obj, ro, rd):
    cat = obj.category
    if cat == C.SPHERE:
        return isect_sphere(ro, rd, obj.center, obj.radius)
    if cat == C.CUBE:
        return isect_cube(ro, rd, obj.min, obj.max)
    if cat == C.CORNELLBOX:
        return isect_cornellbox(ro, rd, obj.min, obj.max)
    if cat == C.RECTANGLE:
        return isect_rectangle(ro, rd, obj.min, obj.max)
    if cat == C.DISK:
        return isect_disk(ro, rd, obj.position, obj.radius, obj.inner_radius)
    if cat == C.CONE:
        return isect_cone(ro, rd, obj.position, obj.height, obj.radius)
    if cat == C.CYLINDER:
        return isect_cylinder(ro, rd, obj.position, obj.height, obj.radius)
    if cat == C.PARABOLOID:
        return isect_paraboloid(ro, rd, obj.position, obj.z0, obj.z1, obj.radius)
    if cat == C.HYPERBOLOID:
        return isect_hyperboloid(ro, rd, obj.position, obj.p1, obj.p2,
                                 obj.ah, obj.ch)
    raise NotImplementedError(f"oracle: shape {cat}")


# -- textures ----------------------------------------------------------------

def surface_color(obj, p, u, v):
    if obj.category == C.CORNELLBOX:
        return cornell_color(p, obj.min, obj.max)
    tex = obj.texture
    if tex.category == C.UNIFORM_COLOR:
        return np.broadcast_to(np.asarray(tex.color), p.shape).copy()
    if tex.category == C.CHECKERBOARD:
        w = 0.5 * tex.line_width / tex.size
        fx = u / tex.size - np.floor(u / tex.size)
        fy = v / tex.size - np.floor(v / tex.size)
        outline = (fx < w) | (fx > 1 - w) | (fy < w) | (fy > 1 - w)
        return np.where(outline[..., None], np.asarray(C.GREY), np.asarray(C.WHITE))
    if tex.category == C.CHECKERBOARD2:
        iu = np.floor(u / tex.size)
        iv = np.floor(v / tex.size)
        even = np.mod(iu + iv, 2.0) < 0.5
        return np.where(even[..., None], np.asarray(tex.color1), np.asarray(tex.color2))
    if tex.category == C.BILERP:
        return ((1 - u) * (1 - v))[..., None] * np.asarray(tex.color00) + \
               ((1 - u) * v)[..., None] * np.asarray(tex.color01) + \
               (u * (1 - v))[..., None] * np.asarray(tex.color10) + \
               (u * v)[..., None] * np.asarray(tex.color11)
    if tex.category == C.MIXF:
        c = (1 - tex.amount) * np.asarray(tex.color1) + tex.amount * np.asarray(tex.color2)
        return np.broadcast_to(c, p.shape).copy()
    if tex.category == C.SCALE:
        c = np.asarray(tex.color1) * np.asarray(tex.color2)
        return np.broadcast_to(c, p.shape).copy()
    if tex.category == C.UVF:
        return np.stack([u - np.floor(u), v - np.floor(v), np.zeros_like(u)], axis=-1)
    raise NotImplementedError(f"oracle: texture {tex.category}")


# -- BSDFs -------------------------------------------------------------------

def fr_dielectric(cos_i, eta_i, eta_t):
    cos_i = np.clip(cos_i, -1, 1)
    entering = cos_i > 0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    cos_i = np.abs(cos_i)
    sin_i = np.sqrt(np.maximum(0, 1 - cos_i ** 2))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1
    cos_t = np.sqrt(np.maximum(0, 1 - sin_t ** 2))
    rpar = (et * cos_i - ei * cos_t) / np.maximum(et * cos_i + ei * cos_t, 1e-20)
    rper = (ei * cos_i - et * cos_t) / np.maximum(ei * cos_i + et * cos_t, 1e-20)
    return np.where(tir, 1.0, 0.5 * (rpar ** 2 + rper ** 2))


def fr_conductor(cos_i, eta, k):
    cos_i = np.clip(np.abs(cos_i), 0, 1)[..., None]
    eta = np.asarray(eta)
    k = np.asarray(k)
    cos2 = cos_i ** 2
    sin2 = 1 - cos2
    eta2 = eta ** 2
    etak2 = k ** 2
    t0 = eta2 - etak2 - sin2
    a2b2 = np.sqrt(np.maximum(t0 ** 2 + 4 * eta2 * etak2, 0))
    t1 = a2b2 + cos2
    a = np.sqrt(np.maximum(0.5 * (a2b2 + t0), 0))
    t2 = 2 * cos_i * a
    rs = (t1 - t2) / (t1 + t2)
    t3 = cos2 * a2b2 + sin2 ** 2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / (t3 + t4)
    return 0.5 * (rp + rs)


def cosine_hemisphere(u1, u2):
    r = np.sqrt(u1)
    ang = 2 * np.pi * u2
    return np.stack([r * np.cos(ang), r * np.sin(ang),
                     np.sqrt(np.maximum(0, 1 - u1))], axis=-1)


def uniform_sphere(u1, u2):
    z = 1 - 2 * u1
    r = np.sqrt(np.maximum(0, 1 - z * z))
    ang = 2 * np.pi * u2
    return np.stack([r * np.cos(ang), r * np.sin(ang), z], axis=-1)


def oren_nayar_ab(sigma):
    s2 = sigma * sigma
    return 1 - s2 / (2 * (s2 + 0.33)), 0.45 * s2 / (s2 + 0.09)


def matte_f(kd, sigma, sc, wo, wi):
    r = sc * kd
    if sigma < EPS:
        return r / np.pi
    a, b = oren_nayar_ab(sigma)
    def sin_theta(w):
        return np.sqrt(np.maximum(0, 1 - w[..., 2] ** 2))
    def cos_phi(w):
        s = sin_theta(w)
        return np.where(np.abs(s) < 1e-3, 1.0, np.clip(w[..., 0] / np.where(s == 0, 1, s), -1, 1))
    def sin_phi(w):
        s = sin_theta(w)
        return np.where(np.abs(s) < 1e-3, 0.0, np.clip(w[..., 1] / np.where(s == 0, 1, s), -1, 1))
    sti, sto = sin_theta(wi), sin_theta(wo)
    dcos = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
    max_cos = np.where((sti > EPS) & (sto > EPS), np.maximum(0, dcos), 0.0)
    aci = np.abs(wi[..., 2])
    aco = np.abs(wo[..., 2])
    steeper = aci > aco
    sin_a = np.where(steeper, sto, sti)
    tan_b = np.where(steeper, sti / np.maximum(aci, 1e-7), sto / np.maximum(aco, 1e-7))
    return r * (1 / np.pi * (a + b * max_cos * sin_a * tan_b))[..., None]


# -- light sampling ----------------------------------------------------------

def sample_geometry(obj, u1, u2):
    if obj.category == C.SPHERE:
        d = uniform_sphere(u1, u2)
        p = from_obj(d * obj.radius) + np.asarray(obj.center)
        n = from_obj(d) * (-1.0 if obj.reverse_normal else 1.0)
        pdf = np.full(u1.shape, 1.0 / (4 * np.pi * obj.radius ** 2))
        return p, n, pdf
    if obj.category == C.RECTANGLE:
        bmin = np.asarray(obj.min, float)
        bmax = np.asarray(obj.max, float)
        ext = bmax - bmin
        ex = np.array([ext[0], 0, 0])
        ey = np.array([0, ext[1], ext[2]])
        p = bmin + ex * u1[..., None] + ey * u2[..., None]
        n = _norm(_cross(ex, ey)) * (-1.0 if obj.reverse_normal else 1.0)
        pdf = np.full(u1.shape, 1.0 / max(np.linalg.norm(ex) * np.linalg.norm(ey), 1e-12))
        return p, np.broadcast_to(n, p.shape).copy(), pdf
    if obj.category == C.CUBE:
        # mirrors ops/lights._sample_geometry CUBE: area-weighted face pick
        # from u1 (rescaled within the face), point from (u1', u2)
        bmin = np.asarray(obj.min, float)
        bmax = np.asarray(obj.max, float)
        ext = bmax - bmin
        ax, ay, az = ext[1] * ext[2], ext[0] * ext[2], ext[0] * ext[1]
        area = 2 * (ax + ay + az)
        r = u1 * area
        cums = [ax, 2 * ax, 2 * ax + ay, 2 * (ax + ay), 2 * (ax + ay) + az]
        face = sum((r >= c).astype(int) for c in cums)
        lo = np.array([0, ax, 2 * ax, 2 * ax + ay, 2 * (ax + ay),
                       2 * (ax + ay) + az])
        fa = np.array([ax, ax, ay, ay, az, az])
        u1p = np.clip((r - lo[face]) / np.maximum(fa[face], 1e-12), 0, 1)
        on_x = face < 2
        on_y = (face >= 2) & (face < 4)
        hi = (face % 2) == 1
        hi01 = np.where(hi, 1.0, 0.0)
        fx = np.where(on_x, hi01, u1p)
        fy = np.where(on_x, u1p, np.where(on_y, hi01, u2))
        fz = np.where(on_x, u2, np.where(on_y, u2, hi01))
        p = bmin + ext * np.stack([fx, fy, fz], axis=-1)
        sgn = np.where(hi, 1.0, -1.0)
        zero = np.zeros_like(sgn)
        n = np.stack([np.where(on_x, sgn, zero), np.where(on_y, sgn, zero),
                      np.where(on_x | on_y, zero, sgn)], -1)
        n = n * (-1.0 if obj.reverse_normal else 1.0)
        pdf = np.full(u1.shape, 1.0 / max(area, 1e-12))
        return p, n, pdf
    raise NotImplementedError(f"oracle: area light geometry {obj.category}")


def occluded(objects, ro, rd, max_t):
    occ = np.zeros(ro.shape[:-1], bool)
    for obj in objects:
        t = intersect_object(obj, ro, rd)[0]
        occ |= (t > EPS) & (t < max_t)
    return occ


def concentric_disk_np(u1, u2):
    uo = 2 * u1 - 1
    vo = 2 * u2 - 1
    origin = (uo == 0) & (vo == 0)
    use_u = np.abs(uo) > np.abs(vo)
    r = np.where(use_u, uo, vo)
    theta = np.where(use_u, (vo / np.where(uo == 0, 1e-20, uo)) * (np.pi / 4),
                     np.pi / 2 - (uo / np.where(vo == 0, 1e-20, vo)) * (np.pi / 4))
    return (np.where(origin, 0, r * np.cos(theta)),
            np.where(origin, 0, r * np.sin(theta)))


def sample_direct(scene, objects, p, n, u1, u2, lidx):
    n_lights = len(scene.lights)
    if n_lights == 0:
        return np.zeros_like(p), np.zeros_like(p)
    cand_p = np.zeros_like(p)
    cand_r = np.zeros_like(p)
    for li, light in enumerate(scene.lights):
        mask = lidx == li
        if light.category == C.AREA:
            g = objects[light.index]
            pl, nl, pdf = sample_geometry(g, u1, u2)
            tol = pl - p
            d2 = np.maximum(_dot(tol, tol), 1e-12)
            wi = tol / np.sqrt(d2)[..., None]
            cos_l = np.maximum(0, _dot(nl, -wi))
            cos_s = np.maximum(0, _dot(wi, n))
            rad = np.asarray(light.emission) * (cos_l * cos_s / (d2 * pdf) * n_lights)[..., None]
        elif light.category == C.POINT:
            pl = np.asarray(light.from_) + uniform_sphere(u1, u2) * light.radius
            tol = pl - p
            d2 = np.maximum(_dot(tol, tol), 1e-12)
            wi = tol / np.sqrt(d2)[..., None]
            cos_s = np.maximum(0, _dot(wi, n))
            rad = np.asarray(light.emission) * (cos_s / d2 * n_lights)[..., None]
        elif light.category == C.SPOT:
            pl = np.broadcast_to(np.asarray(light.from_), p.shape).copy()
            tol = pl - p
            d2 = np.maximum(_dot(tol, tol), 1e-12)
            wi = tol / np.sqrt(d2)[..., None]
            ct = wi[..., 1]
            delta = (ct - light.cos_total_width) / max(
                light.cos_falloff_start - light.cos_total_width, 1e-7)
            fall = np.where(ct < light.cos_total_width, 0.0,
                            np.where(ct >= light.cos_falloff_start, 1.0, delta ** 4))
            cos_s = np.maximum(0, _dot(wi, n))
            rad = np.asarray(light.emission) * (fall * cos_s / d2 * n_lights)[..., None]
        else:
            raise ValueError(light.category)
        cand_p = np.where(mask[..., None], pl, cand_p)
        cand_r = np.where(mask[..., None], rad, cand_r)

    tol = cand_p - p
    dist = np.sqrt(np.maximum(_dot(tol, tol), 1e-24))
    wi = tol / dist[..., None]
    occ = occluded(objects, p + n * 1e-4, wi, dist * (1 - 1e-3))
    vis = np.where(occ, 0.0, 1.0)
    return cand_r * vis[..., None], wi


# -- the tracer --------------------------------------------------------------

def trace(scene, ro, rd, rand, max_bounces=C.MAX_BOUNCES, clamp_weight=True):
    """Path-trace rays through a host `Scene`.

    `rand`: list (length max_bounces) of dicts with keys
    u1,u2,u_lobe,lu1,lu2,lidx — arrays shaped like the ray batch. Supplying
    the same fields to the JAX integrator gives deterministic parity.
    """
    objects = scene.objects
    shape = ro.shape[:-1]
    e = np.zeros(ro.shape)
    throughput = np.ones(ro.shape)
    alive = np.ones(shape, bool)
    skip_emission = np.zeros(shape, bool)
    ro = ro.copy()
    rd = rd.copy()

    for bounce in range(max_bounces):
        rb = rand[bounce]
        # nearest hit
        best_t = np.full(shape, MAXD)
        best = None
        obj_idx = np.full(shape, -1)
        for i, obj in enumerate(objects):
            t, p, ng, dpdu, u, v = intersect_object(obj, ro, rd)
            closer = t < best_t
            if best is None:
                best = [t, p, ng, dpdu, u, v]
            else:
                cm = closer[..., None]
                best = [np.where(closer, t, best[0]), np.where(cm, p, best[1]),
                        np.where(cm, ng, best[2]), np.where(cm, dpdu, best[3]),
                        np.where(closer, u, best[4]), np.where(closer, v, best[5])]
            best_t = best[0]
            obj_idx = np.where(closer, i, obj_idx)

        t, p, ng, dpdu, u, v = best
        valid = t < MAXD
        alive = alive & valid
        into = _dot(ng, rd) < -EPS
        n = np.where(into[..., None], ng, -ng)

        # per-ray object attributes
        emission = np.zeros(ro.shape)
        sc = np.zeros(ro.shape)
        is_matte = np.zeros(shape, bool)
        emissive = np.zeros(shape, bool)
        mat_of = {}
        for i, obj in enumerate(objects):
            m = obj_idx == i
            if not m.any():
                continue
            rev = -1.0 if obj.reverse_normal else 1.0
            face = _dot(ng * rev, rd) < -EPS
            emis = np.asarray(obj.emission)
            emission = np.where((m & face)[..., None], emis, emission)
            sc = np.where(m[..., None], surface_color(obj, p, u, v), sc)
            is_matte = np.where(m, obj.material.category == C.MATTE, is_matte)
            emissive = np.where(m, any(x != 0 for x in obj.emission), emissive)
            mat_of[i] = obj.material

        # shading frame
        dpdu_ok = _dot(dpdu, dpdu) > 1e-16
        fallback = np.where((np.abs(n[..., 0:1]) > 1e-5) | (np.abs(n[..., 1:2]) > 1e-5),
                            np.stack([n[..., 1], -n[..., 0], np.zeros(shape)], axis=-1),
                            np.stack([np.zeros(shape), n[..., 2], -n[..., 1]], axis=-1))
        ss = np.where(dpdu_ok[..., None], dpdu, fallback)
        ss = _norm(ss - n * _dot(ss, n)[..., None])
        ts = _cross(n, ss)
        wo = np.stack([_dot(-rd, ss), _dot(-rd, ts), _dot(-rd, n)], axis=-1)

        # material sampling per object's material
        wi_l = np.zeros(ro.shape)
        weight = np.zeros(ro.shape)
        f_nee = np.zeros(ro.shape)
        for i, mat in mat_of.items():
            m = obj_idx == i
            if mat.category == C.MATTE:
                w = cosine_hemisphere(rb["u1"], rb["u2"])
                same = wo[..., 2] * w[..., 2] > EPS
                pdf = np.where(same, np.abs(w[..., 2]) / np.pi, 0.0)
                f = matte_f(mat.kd, mat.sigma * np.pi / 180.0, sc, wo, w)
                wt = f * np.where(pdf > 0, np.abs(w[..., 2]) / np.maximum(pdf, 1e-20), 0.0)[..., None]
                fn = f
            elif mat.category == C.MIRROR:
                w = np.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
                wt = sc * mat.kr
                fn = np.zeros(ro.shape)
            elif mat.category == C.METAL:
                w, wt = _metal_sample_np(mat, sc, rb["u1"], rb["u2"], wo)
                fn = np.zeros(ro.shape)
            elif mat.category == C.GLASS:
                w, wt = _glass_sample_np(mat, sc, rb["u1"], rb["u2"],
                                         rb["u_lobe"], wo, into)
                fn = np.zeros(ro.shape)
            else:
                raise ValueError(mat.category)
            wi_l = np.where(m[..., None], w, wi_l)
            weight = np.where(m[..., None], wt, weight)
            f_nee = np.where(m[..., None], fn, f_nee)

        if clamp_weight:
            weight = np.clip(weight, 0.0, 1.0)

        emit = np.where((skip_emission & emissive)[..., None], 0.0, emission)
        contrib = emit

        did_nee = np.zeros(shape, bool)
        if len(scene.lights) > 0:
            nee_mask = is_matte & ~emissive & alive
            direct, wi_light = sample_direct(scene, objects, p, n,
                                             rb["lu1"], rb["lu2"], rb["lidx"])
            wll = np.stack([_dot(wi_light, ss), _dot(wi_light, ts),
                            _dot(wi_light, n)], axis=-1)
            fl = np.zeros(ro.shape)
            for i, mat in mat_of.items():
                if mat.category != C.MATTE:
                    continue
                m = (obj_idx == i) & (wo[..., 2] * wll[..., 2] > EPS)
                fl = np.where(m[..., None],
                              matte_f(mat.kd, mat.sigma * np.pi / 180.0, sc, wo, wll), fl)
            direct = direct * fl
            contrib = contrib + np.where(nee_mask[..., None], direct, 0.0)
            did_nee = nee_mask

        e = e + throughput * np.where(alive[..., None], contrib, 0.0)
        throughput = throughput * weight
        skip_emission = did_nee

        wi_w = (ss * wi_l[..., 0:1] + ts * wi_l[..., 1:2] + n * wi_l[..., 2:3])
        outdot = _dot(n, wi_w)
        ro = p + n * np.where(outdot > EPS, 1e-4, -1e-4)[..., None]
        rd = wi_w
        alive = alive & (throughput.max(axis=-1) > 0)

    return e


# Metal / glass numpy lobes (scalar alpha; isotropic + anisotropic GGX)

def _ggx_sample_wh(u1, u2, ax, ay, wo):
    if abs(ax - ay) < 1e-7:
        phi = 2 * np.pi * u2
        tan2 = ax * ax * u1 / np.maximum(1 - u1, 1e-7)
    else:
        phi = np.arctan(ay / ax * np.tan(np.pi / 2 + 2 * np.pi * u1))
        phi = np.where(u1 > 0.5, phi + np.pi, phi)
        alpha2 = 1.0 / (np.cos(phi) ** 2 / ax ** 2 + np.sin(phi) ** 2 / ay ** 2)
        tan2 = alpha2 * u1 / np.maximum(1 - u1, 1e-7)
    ct = 1 / np.sqrt(1 + tan2)
    st = np.sqrt(np.maximum(0, 1 - ct * ct))
    wh = np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1)
    flip = wo[..., 2] * wh[..., 2] <= EPS
    return np.where(flip[..., None], -wh, wh)


def _ggx_d(wh, ax, ay):
    c2 = wh[..., 2] ** 2
    tan2 = np.where(c2 < 1e-5, 1e5, np.maximum(0, 1 - c2) / np.maximum(c2, 1e-20))
    cos4 = c2 * c2
    s2 = np.maximum(0, 1 - c2)
    s = np.sqrt(s2)
    cp = np.where(s < 1e-3, 1.0, np.clip(wh[..., 0] / np.where(s == 0, 1, s), -1, 1))
    sp = np.where(s < 1e-3, 0.0, np.clip(wh[..., 1] / np.where(s == 0, 1, s), -1, 1))
    e = (cp ** 2 / ax ** 2 + sp ** 2 / ay ** 2) * tan2
    d = 1.0 / (np.pi * ax * ay * np.maximum(cos4 * (1 + e) ** 2, 1e-20))
    return np.where(tan2 >= C.INF, 0.0, d)


def _metal_sample_np(mat, sc, u1, u2, wo):
    ax = max(mat.uroughness, 1e-4)
    ay = max(mat.vroughness, 1e-4)
    wh = _ggx_sample_wh(u1, u2, ax, ay, wo)
    wi = 2 * _dot(wo, wh)[..., None] * wh - wo
    ok = (wo[..., 2] >= EPS) & (wo[..., 2] * wi[..., 2] > EPS)
    cos_o = np.abs(wo[..., 2])
    cos_i = np.abs(wi[..., 2])
    whn = _norm(wo + wi)
    f = fr_conductor(_dot(wi, whn), mat.eta, mat.k)
    d = _ggx_d(whn, ax, ay)
    degenerate = (cos_i < EPS) | (cos_o < EPS) | (_dot(wo + wi, wo + wi) < 1e-12)
    fval = sc * f * (d / np.maximum(4 * cos_i * cos_o, 1e-12))[..., None]
    fval = np.where(degenerate[..., None], 0.0, fval)
    pdf = _ggx_d(wh, ax, ay) * np.abs(wh[..., 2]) / np.maximum(4 * _dot(wo, wh), 1e-12)
    w = fval * np.where(ok & (pdf > 1e-12), cos_i / np.maximum(pdf, 1e-12), 0.0)[..., None]
    return wi, w


def _refract_np(i, n, eta):
    eta = np.asarray(eta)
    cos_i = -_dot(i, n)
    k = 1 - eta * eta * (1 - cos_i ** 2)
    tir = k < 0
    d = i * eta[..., None] + n * (eta * cos_i - np.sqrt(np.maximum(k, 0)))[..., None]
    return np.where(tir[..., None], 0.0, d), tir


def _glass_sample_np(mat, sc, u1, u2, u_lobe, wo, into):
    if mat.uroughness < EPS and mat.vroughness < EPS:
        f_refl = fr_dielectric(wo[..., 2], 1.0, mat.eta)
        pick_r = u_lobe < f_refl
        wi_r = np.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
        w_r = sc * mat.kr
        rel = np.where(into, 1.0 / mat.eta, mat.eta)
        nl = np.stack([np.zeros_like(u1), np.zeros_like(u1),
                       np.where(wo[..., 2] >= 0, 1.0, -1.0)], axis=-1)
        wi_t, tir = _refract_np(-wo, nl, rel)
        w_t = sc * (mat.kt * rel * rel)[..., None]
        w_t = np.where(tir[..., None], 0.0, w_t)
        wi = np.where(pick_r[..., None], wi_r, wi_t)
        w = np.where(pick_r[..., None], w_r, w_t)
        return wi, w
    # rough glass
    ax = max(mat.uroughness, 1e-4)
    ay = max(mat.vroughness, 1e-4)
    wh = _ggx_sample_wh(u1, u2, ax, ay, wo)
    # reflection branch
    wi_r = 2 * _dot(wo, wh)[..., None] * wh - wo
    ok = (wo[..., 2] >= EPS) & (wo[..., 2] * wi_r[..., 2] > EPS)
    whn = _norm(wo + wi_r)
    fr = fr_dielectric(_dot(wi_r, whn), 1.0, mat.eta)
    d = _ggx_d(whn, ax, ay)
    cos_o = np.abs(wo[..., 2])
    cos_i = np.abs(wi_r[..., 2])
    degenerate = (cos_i < EPS) | (cos_o < EPS)
    f_r = sc * mat.kr * (fr * d / np.maximum(4 * cos_i * cos_o, 1e-12))[..., None]
    f_r = np.where(degenerate[..., None], 0.0, f_r)
    pdf_r = _ggx_d(wh, ax, ay) * np.abs(wh[..., 2]) / np.maximum(4 * _dot(wo, wh), 1e-12)
    w_r = f_r * np.where(ok & (pdf_r > 1e-12), cos_i / np.maximum(pdf_r, 1e-12), 0.0)[..., None]
    # transmission branch
    rel_in = np.where(into, 1.0 / mat.eta, mat.eta)
    wh_f = np.where(_dot(wo, wh)[..., None] < 0, -wh, wh)
    wi_t, tir = _refract_np(-wo, wh_f, rel_in)
    eta_rel = np.where(into, mat.eta, 1.0 / mat.eta)
    wht = _norm(wo + wi_t * eta_rel[..., None])
    wht = np.where(wht[..., 2:3] < 0, -wht, wht)
    ft = fr_dielectric(_dot(wo, wht), 1.0, mat.eta)
    denom = _dot(wo, wht) + eta_rel * _dot(wi_t, wht)
    dt = _ggx_d(wht, ax, ay)
    ci = wi_t[..., 2]
    co = wo[..., 2]
    bad = (wo[..., 2] * wi_t[..., 2] > EPS) | (np.abs(ci) < 1e-3) | (np.abs(co) < 1e-3)
    denom2 = np.where(np.abs(ci * co * denom ** 2) < 1e-12, 1e-12, ci * co * denom ** 2)
    factor = np.abs(dt * eta_rel ** 2 * np.abs(_dot(wi_t, wht)) * np.abs(_dot(wo, wht)) / denom2)
    f_t = sc * mat.kt * ((1 - ft) * factor / np.maximum(eta_rel ** 2, 1e-12))[..., None]
    f_t = np.where(bad[..., None], 0.0, f_t)
    dwh_dwi = np.abs(eta_rel ** 2 * _dot(wi_t, wht) /
                     np.where(np.abs(denom ** 2) < 1e-12, 1e-12, denom ** 2))
    pdf_t = np.where(bad, 0.0, _ggx_d(wht, ax, ay) * np.abs(wht[..., 2]) * dwh_dwi)
    w_t = f_t * np.where(pdf_t > 1e-9, np.abs(ci) / np.maximum(pdf_t, 1e-9), 0.0)[..., None]
    w_t = np.where(tir[..., None], 0.0, w_t)
    pick_t = u_lobe >= 0.5
    wi = np.where(pick_t[..., None], wi_t, wi_r)
    w = np.where(pick_t[..., None], w_t * 2, w_r * 2)
    return wi, w


def camera_rays(cam, height, width, jx=None, jy=None):
    """Numpy twin of core/camera.generate_rays (same flipped-x basis)."""
    eye = np.asarray(cam.eye, float)
    center = np.asarray(cam.center, float)
    up = np.asarray(cam.up, float)
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, -x)
    y = y / np.linalg.norm(y)
    tanf = math.tan(cam.fovy * math.pi / 360.0)
    jj = np.arange(width)[None, :] + (jx if jx is not None else 0.5)
    ii = np.arange(height)[:, None] + (jy if jy is not None else 0.5)
    ndc_x = jj * (2.0 / width) - 1.0
    ndc_y = 1.0 - ii * (2.0 / height)
    d = (x * (ndc_x * tanf * cam.aspect)[..., None] +
         y * (ndc_y * tanf)[..., None] - z)
    d = _norm(d)
    o = np.broadcast_to(eye, d.shape).copy()
    return o, d
