"""KP: the penumbra edge term (`diff/boundary.shadow_boundary_term`'s
coefficients and live sum) as one CUDA kernel with its adjoint.

For every pixel, receiver (the surface seen directly, through a mirror or
through one diffuse bounce), (sphere, rectangle light) pair and curve sample,
the term is coeff · (n̂ · y): coeff and n̂ detached, y the penumbra-curve
point (`curve_points`), live in the occluder's center and radius and the
receiver point.  `penumbra_scalar` gives Σ coeff · (n̂ · y) as a scalar whose
gradient is the term's: on a CPU tensor by the plain version
(`penumbra_scalar_plain`, eager torch over (K, H, W) tensors and autograd);
on a CUDA tensor through `_Penumbra`, a `torch.autograd.Function` whose
forward launches KP (`csrc/penumbra.cu`, `penumbra_partials`), which
computes the scalar and its partials with respect to the spheres' (S, 4)
centers and radii and the receivers' (R, 3, H, W) points in one pass, and
whose backward hands those partials on.  No fallback from one to the other.

KP replaces no TPU kernel: the JAX package's `shadow_boundary_term`
(`sail_tpu/diff/boundary.py:773`) is XLA's inside the jitted train step
(`sail_tpu/parallel/render_sharded.py:257`).  `penumbra_partials.launches`
counts its launches (each is followed by one K2 reduce, `reduce_grad_rows`,
which sums its block rows).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ... import constants as C
from ...core import vecmath as vm
from ...core.vecmath import Vec3
from ...ops import intersect as isect
from ...ops import materials as mat_ops
from ...utils import build
from . import megakernel as mk

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


class Inputs(NamedTuple):
    """KP's inputs but the live ones (the spheres, the receiver points), as
    csrc/penumbra.cuh's KPIn lays them out."""
    planes: torch.Tensor      # (R, PLANES, H, W) n, ss, ts, wo, sc, tint
    ints: torch.Tensor        # (R, 2, H, W) int32: material row (-1: no
    #                           receiver), object id
    dl: torch.Tensor          # (3, H, W) loss adjoint
    mats: torch.Tensor        # (n_mat, 2) kd, sigma
    sphere_obj: torch.Tensor  # (S,) int32 scene index
    lights: torch.Tensor      # (L, LIGHT_FLOATS)
    light_obj: torch.Tensor   # (L,) int32 scene index of the light's rectangle
    cs: torch.Tensor          # (2, K) cos, sin of the sample angles


def _stack(parts) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*parts))


@functools.lru_cache(maxsize=64)
def _ints_on(values: tuple, device: torch.device) -> torch.Tensor:
    """An int32 tensor of `values` on `device`, copied there once per
    scene structure, so a call copies nothing from the host."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def pack_inputs(pk_d, static, dL: Vec3, receivers, pairs, K: int):
    """(sphere indices, Inputs) for KP from the detached scene."""
    like = dL.x
    sphere_ids = list(dict.fromkeys(i for i, _, _ in pairs))
    light_ids = list(dict.fromkeys((li, o) for _, li, o in pairs))
    planes = torch.stack([_stack((*rc.hit.n, *rc.ss, *rc.ts, *rc.wo,
                                  *rc.sc, *rc.tint)) for rc in receivers])
    ints = torch.stack([torch.stack((
        torch.where(rc.mask, rc.hit.mat_row.to(torch.int32), -1),
        rc.hit.obj_id.to(torch.int32))) for rc in receivers])
    mats = [torch.stack((m.kd, m.sigma)) if cat == C.MATTE
            else like.new_zeros(2)
            for cat, m in zip(static.material_categories, pk_d.materials)]
    lights = []
    for li, obj_idx in light_ids:
        lobj = pk_d.objects[obj_idx]
        ex, ey, n_l = isect.rectangle_frame(lobj)
        exl, eyl = ex.length(), ey.length()
        lights.append(torch.stack((
            *lobj.bmin, *ex, *ey, *n_l, *(n_l * lobj.reverse),
            *pk_d.lights[li].emission, vm.clip(exl * exl, 1e-12),
            vm.clip(eyl * eyl, 1e-12))))
    cos_a, sin_a = curve_angles(K, like)
    return sphere_ids, Inputs(
        planes.contiguous(), ints.contiguous(), dL.stack(0).contiguous(),
        torch.stack(mats).contiguous(), _ints_on(tuple(sphere_ids),
                                                 like.device),
        torch.stack(lights).contiguous(),
        _ints_on(tuple(o for _, o in light_ids), like.device),
        torch.stack((cos_a.view(-1), sin_a.view(-1))).contiguous())


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.load(_SOURCE)
    limits = (ctypes.c_int * 8)()
    lib.sail_penumbra_limits(limits)
    built = (tuple(limits[:2]), limits[3], limits[4])
    if built != (BLOCK, PLANES, LIGHT_FLOATS):
        raise RuntimeError(f"KP was built for (block, planes, light floats) "
                           f"{built}, the wrapper expects "
                           f"{(BLOCK, PLANES, LIGHT_FLOATS)}")
    fn = lib.sail_penumbra
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, limits[2]


def _check(spheres: torch.Tensor, xs: torch.Tensor, c: Inputs):
    """Raise on what KP does not take; return (R, S, L, K, H, W)."""
    R, three, H, W = xs.shape
    S, L = spheres.shape[0], c.lights.shape[0]
    K = c.cs.shape[1]
    want = {"spheres": (spheres, (S, 4), torch.float32),
            "xs": (xs, (R, 3, H, W), torch.float32),
            "planes": (c.planes, (R, PLANES, H, W), torch.float32),
            "ints": (c.ints, (R, 2, H, W), torch.int32),
            "dl": (c.dl, (3, H, W), torch.float32),
            "mats": (c.mats, (c.mats.shape[0], 2), torch.float32),
            "sphere_obj": (c.sphere_obj, (S,), torch.int32),
            "lights": (c.lights, (L, LIGHT_FLOATS), torch.float32),
            "light_obj": (c.light_obj, (L,), torch.int32),
            "cs": (c.cs, (2, K), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if not (tuple(t.shape) == shape and t.dtype == dtype
                and t.is_contiguous() and t.device == xs.device):
            raise TypeError(f"KP's {name} must be a contiguous {dtype} "
                            f"tensor of shape {shape} on {xs.device}; got "
                            f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if three != 3 or K < 1:
        raise ValueError(f"bad KP shapes: xs {tuple(xs.shape)}, K {K}")
    return R, S, L, K, H, W


def penumbra_partials(spheres: torch.Tensor, xs: torch.Tensor, c: Inputs):
    """KP on the card: (Σ coeff · (n̂ · y), its gradient with respect to the
    (S, 4) spheres, with respect to the (R, 3, H, W) receiver points), the
    sums over pixels in a fixed order (one row a thread block, then K2's
    reduce), the same bits on every call.  Raises for a tensor not on a
    card."""
    if not xs.is_cuda:
        raise TypeError("penumbra_partials runs KP on the card: the inputs "
                        "must be CUDA tensors")
    R, S, L, K, H, W = _check(spheres, xs, c)
    fn, max_spheres = _entry()
    if S > max_spheres:
        raise ValueError(f"KP takes at most {max_spheres} occluding spheres; "
                         f"got {S}")
    dev = xs.device
    bx, by = BLOCK
    rows = torch.empty((-(-W // bx) * -(-H // by), 1 + 4 * S),
                       dtype=torch.float32, device=dev)
    gx = torch.empty_like(xs)
    with torch.cuda.device(dev):
        err = fn(xs.data_ptr(), c.planes.data_ptr(), c.ints.data_ptr(),
                 c.dl.data_ptr(), c.mats.data_ptr(), spheres.data_ptr(),
                 c.sphere_obj.data_ptr(), c.lights.data_ptr(),
                 c.light_obj.data_ptr(), c.cs.data_ptr(), R, S, L, K,
                 rows.data_ptr(), gx.data_ptr(), H, W,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"KP launch failed: cudaError_t {err}")
    mk.count_launch(penumbra_partials)
    out = mk.reduce_grad_rows(rows)
    return out[0], out[1:].view(S, 4), gx


penumbra_partials.launches = 0


class _Penumbra(torch.autograd.Function):
    """Σ coeff · (n̂ · y) of the live spheres (S, 4) and receiver points
    (R, 3, H, W); the backward is `partials`' gradient."""

    @staticmethod
    def forward(ctx, spheres, xs, inputs, partials):
        value, g_s, g_x = partials(spheres.detach().contiguous(),
                                   xs.detach().contiguous(), inputs)
        ctx.save_for_backward(g_s, g_x)
        return value

    @staticmethod
    def backward(ctx, g):
        g_s, g_x = ctx.saved_tensors
        return g * g_s, g * g_x, None, None


def penumbra_scalar_kernel(pk, pk_d, static, dL: Vec3, receivers,
                           x_live: dict, pairs, K: int,
                           partials=penumbra_partials) -> torch.Tensor:
    """`penumbra_scalar_plain`'s scalar through KP (`partials`: the kernel,
    or a function of the same contract)."""
    sphere_ids, inputs = pack_inputs(pk_d, static, dL, receivers, pairs, K)
    spheres = torch.stack([torch.stack((*pk.objects[i].center,
                                        pk.objects[i].radius))
                           for i in sphere_ids])
    xs = torch.stack([x_live[rc.tag].stack(0) for rc in receivers])
    return _Penumbra.apply(spheres, xs, inputs, partials)


def penumbra_scalar(pk, pk_d, static, dL: Vec3, receivers, x_live: dict,
                    pairs, K: int) -> torch.Tensor:
    """Σ coeff · (n̂ · y_live), the scalar whose gradient is the penumbra
    term: the plain version for CPU tensors, KP for CUDA ones."""
    if dL.x.device.type == "cpu":
        return penumbra_scalar_plain(pk, pk_d, static, dL, receivers, x_live,
                                     pairs, K)
    if not dL.x.is_cuda:
        raise ValueError(f"no KP for device {dL.x.device}")
    return penumbra_scalar_kernel(pk, pk_d, static, dL, receivers, x_live,
                                  pairs, K)
