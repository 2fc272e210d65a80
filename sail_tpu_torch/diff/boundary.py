"""Boundary (silhouette and penumbra) gradients by edge sampling (port of
`sail_tpu/diff/boundary.py`).

Autograd through the path tracer sees only the interior of each pixel's
integral: where a silhouette crosses a pixel, the visibility step has zero
derivative almost everywhere, and the moving edge contributes a boundary
term that reverse mode cannot see.  For a loss L = Σ_p W_p · I_p with I_p
the box-filtered pixel integral, that term is a line integral over each
silhouette curve in screen space,

    dL/dθ |_boundary = ∮ W(x(t)) · Δf(x(t)) · (n̂(t) · dx(t)/dθ) |dx/dt| dt,

with x(t) the projected silhouette point, n̂ the outward screen normal and
Δf = f_inside − f_outside the radiance jump across the edge, estimated by
ray pairs straddling it (an occluded edge sees the same radiance on both
sides, so Δf vanishes there without a visibility test).

Each term builds an "edge scalar" Σ coeff · (n̂ · x_live) whose coefficients
(Δf, the loss adjoint at the edge pixel, the arc length, the normal) are
detached and whose curve points x_live are functions of the live
parameters; its gradient with respect to the flat parameter tensor, taken
by `torch.autograd.grad` through `scene.unflatten`'s views, is the boundary
term, in the flat tensor's (`jax.tree.leaves`) order.  A term with no
silhouette, or whose scalar carries no graph, gives zeros.

Scope, as the JAX package's: primary-visibility edges of spheres (the
analytic tangent circle), box-like shapes (12 straight edges) and surfaces
of revolution (rim circles and the closed-form smooth silhouettes); sphere
silhouettes seen in planar mirrors (virtual spheres) and in sphere mirrors
(a per-azimuth Alhazen root solve with an implicit-function live step);
NEE penumbras of sphere occluders under rectangle area lights at receivers
seen directly, through one mirror bounce, or through one diffuse bounce;
and the secondary-vertex silhouette (`indirect_silhouette_term`).  Not
modelled there either: visibility two or more specular bounces deep,
curved-mirror silhouettes of other shapes, and glass chains.

Everything runs on the device of the parameters it is given, in their
dtype; every clip of a live value goes through `core.vecmath.clip`, so the
gradient splits at a tie as JAX's does.
"""
from __future__ import annotations

import collections
import functools
import math
import operator

import torch

from .. import constants as C
from ..core import rng
from ..core import vecmath as vm
from ..core.camera import CameraParams, rays_for_pixels
from ..core.vecmath import Vec3
from ..ops import intersect as isect
from ..ops import materials as mat_ops
from ..ops import textures as tex_ops
from ..ops.cuda import alhazen, penumbra, receivers
from ..ops.cuda.megakernel import trace_rays
from ..scene.scene import param_offsets, unflatten
from ..utils.graphs import Replay
from ..utils.metrics import span, spanned

TWO_PI = 2.0 * math.pi


def _detach(v):
    """A tensor, Vec3 or parameter row with every tensor detached
    (`jax.lax.stop_gradient` over a pytree)."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    return type(v)(*(_detach(f) for f in v))


def _adjoint(d_loss_d_image, like: torch.Tensor) -> Vec3:
    """The loss adjoint as a Vec3 of (H, W) tensors on `like`'s device: an
    (H, W, 3) array or tensor, or a Vec3 as it is."""
    if isinstance(d_loss_d_image, Vec3):
        return d_loss_d_image
    a = torch.as_tensor(d_loss_d_image, dtype=like.dtype, device=like.device)
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def _pixel_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """`jnp.clip(x.astype(jnp.int32), 0, n - 1)` as int64: XLA's conversion
    saturates and gives 0 for NaN, which truncating after the clip
    reproduces for every input."""
    x = torch.nan_to_num(x.detach(), nan=0.0)
    return vm.clip(x, 0.0, float(n - 1)).to(torch.int64)


def _edge_grad(edge_scalar, params: torch.Tensor, static) -> torch.Tensor:
    """d edge_scalar(pk, pk_detached) / d params, with pk the structured view
    of a leaf copy of `params` and pk_detached that of `params` detached;
    zeros where the scalar carries no graph."""
    p = params.detach().requires_grad_()
    with torch.enable_grad():
        total = edge_scalar(unflatten(p, static),
                            unflatten(params.detach(), static))
    if not (isinstance(total, torch.Tensor) and total.requires_grad):
        return torch.zeros_like(params)
    with span("sail.edge_backward"):
        (grad,) = torch.autograd.grad(total, p, allow_unused=True)
    return torch.zeros_like(params) if grad is None else grad


def _arange(n: int, like: torch.Tensor, shift: float = 0.0,
            div: int = None) -> torch.Tensor:
    """(arange(n) + shift) / div (default n) in `like`'s dtype and
    device."""
    return ((torch.arange(n, dtype=like.dtype, device=like.device) + shift)
            / (n if div is None else div))


def screen_project(cam: CameraParams, p: Vec3, height: int, width: int):
    """World point → continuous pixel coordinates (col, row, depth): the
    inverse of `rays_for_pixels` (a ray through (row, col) with zero jitter
    passes through `p`); `depth` is the distance along the viewing axis,
    positive in front."""
    v = p - cam.eye
    t = -v.dot(cam.back)
    sx = v.dot(cam.right) / t
    sy = v.dot(cam.up) / t
    ndc_x = sx / (cam.tan_half_fovy * cam.aspect)
    ndc_y = sy / cam.tan_half_fovy
    col = (ndc_x + 1.0) * (width / 2.0)
    row = (1.0 - ndc_y) * (height / 2.0)
    return col, row, t


def sphere_silhouette(cam: CameraParams, center: Vec3, radius, ts):
    """Points s(t) of a sphere's tangent (silhouette) circle seen from the
    camera's eye, for `ts` in [0, 1)."""
    w = center - cam.eye
    d = w.length()
    w_hat = w / d
    ratio = vm.clip(radius / d, 0.0, 1.0 - 1e-6)
    rho = radius * torch.sqrt(1.0 - ratio * ratio)
    m = center - w_hat * (radius * ratio)
    e1 = vm.ortho(w_hat).normalize()
    e2 = w_hat.cross(e1)
    ang = TWO_PI * ts
    return m + (e1 * torch.cos(ang) + e2 * torch.sin(ang)) * rho


def _edge_radiance_delta(params, static, cols, rows, normals, height, width,
                         seed, n_noise, delta_px, max_bounces):
    """Δf = f_inside − f_outside at screen edge points, from ray pairs offset
    ∓delta_px (a number, or a tensor of one offset per point) along the
    screen normal, both sides drawing the same random numbers (the edge
    pixel's streams), through the scene of the flat tensor `params`.  The
    `n_noise` passes are stacked on a leading axis and traced in one
    `trace_rays` call (KR on the card), then added in pass order.  A Vec3
    of (M,) tensors, detached."""
    nx, ny = normals
    with torch.no_grad():
        off = torch.stack([cols - delta_px * nx, cols + delta_px * nx])
        orr = torch.stack([rows - delta_px * ny, rows + delta_px * ny])
        shape = (n_noise, *off.shape)                          # (n, 2, M)
        ii = _pixel_index(rows, height).broadcast_to(shape)
        jj = _pixel_index(cols, width).broadcast_to(shape)
        samples = 7919 + torch.arange(n_noise, device=cols.device)
        noise = rng.pixel_noise(seed, samples[:, None, None], ii=ii, jj=jj)
        ro, rd = rays_for_pixels(unflatten(params, static).camera, orr, off,
                                 height, width, jitter_x=0.0, jitter_y=0.0)
        color = trace_rays(params, static, ro.broadcast_to(shape),
                           rd.broadcast_to(shape), noise, max_bounces)
        acc = Vec3(*(c[0] for c in color))
        for k in range(1, n_noise):
            acc = acc + Vec3(*(c[k] for c in color))
        f = acc * (1.0 / n_noise)
    # index 0 inside, 1 outside
    return Vec3(f.x[0] - f.x[1], f.y[0] - f.y[1], f.z[0] - f.z[1])


class _Straddles:
    """The straddle points of one `boundary_term` call's silhouette sites
    and their Δf.  Each site `add`s its points (and a second set at δ/4
    where it extrapolates) and reads its Δf back by the handle `add`
    returned once `trace` has run.  Batched, `trace` runs one
    `_edge_radiance_delta` over the concatenation of every site's points,
    one offset per point, and splits the result back: every ray's random
    numbers key on its own pixel, so each Δf is the one its site would
    get alone.  Unbatched, each `add` calls it at once for that site's
    points alone (the per-site path the batch is held against)."""

    def __init__(self, params, static, height, width, seed, n_noise,
                 max_bounces, batched: bool):
        self.trace_args = (params.detach(), static)
        self.kw = dict(height=height, width=width, seed=seed,
                       n_noise=n_noise, max_bounces=max_bounces)
        self.batched = batched
        self.points = []       # (cols, rows, nx, ny, delta_px) per request
        self.df = []

    def add(self, cols, rows, normals, delta_px: float) -> int:
        if self.batched:
            self.points.append((cols, rows, *normals, delta_px))
            return len(self.points) - 1
        self.df.append(_edge_radiance_delta(
            *self.trace_args, cols, rows, normals, delta_px=delta_px,
            **self.kw))
        return len(self.df) - 1

    def trace(self):
        if not (self.batched and self.points):
            return
        with torch.no_grad():
            sizes = [p[0].numel() for p in self.points]
            cols, rows, nx, ny = (torch.cat([p[i] for p in self.points])
                                  for i in range(4))
            delta = torch.cat([torch.full_like(p[0], p[4])
                               for p in self.points])
            df = _edge_radiance_delta(*self.trace_args, cols, rows, (nx, ny),
                                      delta_px=delta, **self.kw)
            self.df = [Vec3(*parts) for parts in
                       zip(*(c.split(sizes) for c in df))]

    def __getitem__(self, handle: int) -> Vec3:
        return self.df[handle]


def _gather(d_loss_d_image: Vec3, df: Vec3, pi, pj):
    """Σ_c W_c[pi, pj] · Δf_c: the loss adjoint at the edge pixels times the
    radiance jump."""
    return (d_loss_d_image.x[pi, pj] * df.x + d_loss_d_image.y[pi, pj] * df.y
            + d_loss_d_image.z[pi, pj] * df.z)


def _box_edge_endpoints(bmin: Vec3, bmax: Vec3):
    """Endpoints (A, B) of the 12 edges of an axis-aligned box, Vec3s of
    (12,) tensors, differentiable in bmin and bmax."""
    lo = (bmin.x, bmin.y, bmin.z)
    hi = (bmax.x, bmax.y, bmax.z)
    a_comp = [[], [], []]
    b_comp = [[], [], []]
    for axis in range(3):
        o1, _ = [(1, 2), (0, 2), (0, 1)][axis]
        for s1 in (lo, hi):
            for s2 in (lo, hi):
                for c in range(3):
                    if c == axis:
                        a_comp[c].append(lo[c])
                        b_comp[c].append(hi[c])
                    elif c == o1:
                        a_comp[c].append(s1[c])
                        b_comp[c].append(s1[c])
                    else:
                        a_comp[c].append(s2[c])
                        b_comp[c].append(s2[c])
    return (Vec3(*(torch.stack(a_comp[c]) for c in range(3))),
            Vec3(*(torch.stack(b_comp[c]) for c in range(3))))


def _box_edge_site(pk, pk_detached, static, obj_idx: int, height: int,
                   width: int, delta_px: float, k_per_edge: int,
                   scale: float, straddles: _Straddles):
    """Edge scalar of one box-like object's 12 straight edges (Cube,
    Rectangle, Cornellbox), each sampled at `k_per_edge` midpoints; only
    the projected midpoints stay live.  A straight segment projects to a
    straight one, so differences of the projected interval boundaries give
    the exact tangent and arc length.  `scale` is 0.5 for a Rectangle: a
    flat box enumerates each of its edges twice.  With Δf = f(x − δn) −
    f(x + δn) for either unit normal n, flipping n flips both factors, so
    no orientation step is needed.

    The geometry runs here and the straddle points go to `straddles`; the
    returned function takes the loss adjoint and, once `straddles` has
    traced, gives the scalar."""
    sp = pk.objects[obj_idx]
    A, B = _box_edge_endpoints(sp.bmin, sp.bmax)
    like = A.x
    k = k_per_edge
    tm = _arange(k, like, 0.5)[None, :]
    tb = _arange(k + 1, like, div=k)[None, :]
    AB = B - A
    mid = Vec3(A.x[:, None] + AB.x[:, None] * tm,
               A.y[:, None] + AB.y[:, None] * tm,
               A.z[:, None] + AB.z[:, None] * tm)
    col, row, depth = screen_project(pk.camera, mid, height, width)

    bnd = Vec3(*(a.detach()[:, None] + ab.detach()[:, None] * tb
                 for a, ab in zip(A, AB)))
    colb, rowb, depthb = screen_project(pk_detached.camera, bnd, height,
                                        width)
    tx = colb[:, 1:] - colb[:, :-1]
    ty = rowb[:, 1:] - rowb[:, :-1]
    dl = torch.sqrt(tx * tx + ty * ty)
    nlen = vm.clip(dl, 1e-12)
    nx, ny = ty / nlen, -tx / nlen

    col_d, row_d = col.detach(), row.detach()
    in_front = ((depth.detach() > 0.0) & (depthb[:, 1:] > 0.0)
                & (depthb[:, :-1] > 0.0))
    handle = straddles.add(col_d.reshape(-1), row_d.reshape(-1),
                           (nx.reshape(-1), ny.reshape(-1)), delta_px)

    def finish(d_loss_d_image: Vec3):
        df = Vec3(*(c.reshape(col_d.shape) for c in straddles[handle]))
        pi = _pixel_index(row_d, height)
        pj = _pixel_index(col_d, width)
        inside_img = ((row_d >= 0) & (row_d < height) & (col_d >= 0)
                      & (col_d < width) & in_front)
        w_df = _gather(d_loss_d_image, df, pi, pj)
        coeff = torch.where(inside_img, w_df * dl * scale, 0.0)
        return torch.sum(coeff * (nx * col + ny * row))
    return finish


_BOX_CATEGORIES = (C.CUBE, C.RECTANGLE, C.CORNELLBOX)
_REVOLUTION_CATEGORIES = (C.CONE, C.CYLINDER, C.DISK, C.PARABOLOID,
                          C.HYPERBOLOID)


def _curve_edge_site(pk, pk_detached, pts_fn, n_pts: int, height: int,
                     width: int, delta_px: float, grazing: bool,
                     extrapolate: bool, straddles: _Straddles):
    """Edge scalar of one parametric silhouette curve `pts_fn(pk, ts) ->
    (points, mask)` for ts in [0, 1] (a closed curve wraps at 1), in the
    two stages of `_box_edge_site`.  Live: the curve points (of the
    shape's parameters and the camera).  Detached: the screen tangents and
    arc lengths (from interval boundaries), Δf and the mask.  `grazing`: a
    smooth silhouette, whose inside straddle ray lands ~√δ from the rim,
    so Δf takes the 2·Δf(δ/4) − Δf(δ) extrapolation; sharp rims land O(δ)
    away and skip it."""
    like = pk.camera.eye.x
    tm = _arange(n_pts, like, 0.5)
    tb = _arange(n_pts + 1, like, div=n_pts)
    if hasattr(pts_fn, "pair"):           # one solve for both point sets
        (mid, mmask), (bnd, _) = pts_fn.pair(pk, tm, pk_detached, tb)
    else:
        mid, mmask = pts_fn(pk, tm)
        bnd, _ = pts_fn(pk_detached, tb)
    col, row, depth = screen_project(pk.camera, mid, height, width)
    colb, rowb, depthb = screen_project(pk_detached.camera, _detach(bnd),
                                        height, width)
    tx = colb[1:] - colb[:-1]
    ty = rowb[1:] - rowb[:-1]
    dl = torch.sqrt(tx * tx + ty * ty)
    nlen = vm.clip(dl, 1e-12)
    nx, ny = ty / nlen, -tx / nlen

    col_d, row_d = col.detach(), row.detach()
    in_front = ((depth.detach() > 0.0) & (depthb[1:] > 0.0)
                & (depthb[:-1] > 0.0))
    handle = straddles.add(col_d, row_d, (nx, ny), delta_px)
    quarter = (straddles.add(col_d, row_d, (nx, ny), delta_px / 4.0)
               if grazing and extrapolate else None)

    def finish(d_loss_d_image: Vec3):
        df = straddles[handle]
        if quarter is not None:
            df = straddles[quarter] * 2.0 - df
        pi = _pixel_index(row_d, height)
        pj = _pixel_index(col_d, width)
        ok = ((row_d >= 0) & (row_d < height) & (col_d >= 0)
              & (col_d < width) & in_front & (mmask.detach() > 0.5))
        w_df = _gather(d_loss_d_image, df, pi, pj)
        coeff = torch.where(ok, w_df * dl, 0.0)
        return torch.sum(coeff * (nx * col + ny * row))
    return finish


def _sphere_edge_site(pk, i: int, ts: torch.Tensor, height: int, width: int,
                      delta_px: float, extrapolate: bool,
                      straddles: _Straddles):
    """Edge scalar of sphere `i`'s tangent circle, in the two stages of
    `_box_edge_site`: the screen tangent by central differences over the
    closed circle's samples, the normal outward from the projected
    center, and the 2·Δf(δ/4) − Δf(δ) extrapolation (the inside ray
    grazes the sphere ~√δ from the rim: Δf(δ) = Δf(0) + a·√δ + O(δ))."""
    sp = pk.objects[i]
    s = sphere_silhouette(pk.camera, sp.center, sp.radius, ts)
    col, row, depth = screen_project(pk.camera, s, height, width)

    # -- detached coefficients ---------------------------------------------
    col_d, row_d = col.detach(), row.detach()
    # a difference spans two samples
    tx = torch.roll(col_d, -1, 0) - torch.roll(col_d, 1, 0)
    ty = torch.roll(row_d, -1, 0) - torch.roll(row_d, 1, 0)
    dl = 0.5 * torch.sqrt(tx * tx + ty * ty)
    ccol, crow, _ = screen_project(pk.camera, _detach(sp.center), height,
                                   width)
    nx, ny = ty, -tx
    nlen = torch.sqrt(nx * nx + ny * ny) + 1e-12
    nx, ny = nx / nlen, ny / nlen
    flip = torch.sign((col_d - ccol) * nx + (row_d - crow) * ny)
    nx, ny = nx * flip, ny * flip
    in_front = depth.detach() > 0.0
    handle = straddles.add(col_d, row_d, (nx, ny), delta_px)
    quarter = (straddles.add(col_d, row_d, (nx, ny), delta_px / 4.0)
               if extrapolate else None)

    def finish(d_loss_d_image: Vec3):
        df = straddles[handle]
        if quarter is not None:
            df = straddles[quarter] * 2.0 - df
        # the loss adjoint at the edge pixel (box filter: floor gather)
        pi = _pixel_index(row_d, height)
        pj = _pixel_index(col_d, width)
        inside_img = ((row_d >= 0) & (row_d < height) & (col_d >= 0)
                      & (col_d < width) & in_front)
        coeff = torch.where(inside_img,
                            _gather(d_loss_d_image, df, pi, pj) * dl, 0.0)
        # live: the edge's screen position
        return torch.sum(coeff * (nx * col + ny * row))
    return finish


def _fill(z, ts: torch.Tensor) -> torch.Tensor:
    """`jnp.broadcast_to(z, ts.shape)` for a number or a 0-d tensor."""
    if isinstance(z, torch.Tensor):
        return z.broadcast_to(ts.shape)
    return torch.full_like(ts, z)


def _revolution_curves(static, i: int, n_edge_samples: int):
    """Silhouette curves of object `i`, a surface of revolution about its
    local z axis (world +y, `ops/intersect.to_object`): a list of (pts_fn,
    n_pts, grazing) for `_curve_edge_site`.  Rim circles are sharp edges
    where the clipped surface ends; the smooth silhouettes are the
    view-tangency curves: the cone's two generator lines at azimuths
    φ₀ ± acos(−tanα·v_z/ρ) (v the eye from the apex), the cylinder's at
    φ₀ ± acos(r/ρ), the paraboloid's exact circle (x−uₓ)²+(y−u_y)² =
    ρ²−u_z/k lifted onto z = k(x²+y²), and the hyperboloid's polar plane
    ah(uₓx+u_y y) − ch u_z z = 1 cut with the surface per z (two
    branches)."""
    cat = static.object_categories[i]
    n_circ = max(16, n_edge_samples // 2)
    n_gen = max(8, n_edge_samples // 8)

    def circle(radius_of, z_of, mask_of=None):
        def fn(pk, ts):
            sp = pk.objects[i]
            r = radius_of(sp)
            ang = TWO_PI * ts
            local = Vec3(r * torch.cos(ang), r * torch.sin(ang),
                         _fill(z_of(sp), ts))
            pts = isect.from_object(local) + sp.p
            m = (torch.ones_like(ts) if mask_of is None
                 else mask_of(sp, local))
            return pts, m
        return fn

    def eye_local(pk, sp):
        return isect.to_object(pk.camera.eye - sp.p)

    if cat == C.DISK:
        return [(circle(lambda sp: sp.r, lambda sp: 0.0), n_circ, False),
                (circle(lambda sp: sp.inner_r, lambda sp: 0.0), n_circ,
                 False)]

    if cat == C.CYLINDER:
        def gen(sign):
            def fn(pk, ts):
                sp = pk.objects[i]
                u = eye_local(pk, sp)
                rho = torch.sqrt(vm.clip(u.x * u.x + u.y * u.y, 1e-12))
                phi0 = torch.atan2(u.y, u.x)
                a = sp.r / rho
                exists = a < 1.0 - 1e-6
                dphi = torch.acos(vm.clip(a, -1.0 + 1e-6, 1.0 - 1e-6))
                phi = phi0 + sign * dphi
                local = Vec3((sp.r * torch.cos(phi)).broadcast_to(ts.shape),
                             (sp.r * torch.sin(phi)).broadcast_to(ts.shape),
                             sp.h * ts)
                pts = isect.from_object(local) + sp.p
                return pts, exists.to(ts.dtype).broadcast_to(ts.shape)
            return fn
        return [(circle(lambda sp: sp.r, lambda sp: 0.0), n_circ, False),
                (circle(lambda sp: sp.r, lambda sp: sp.h), n_circ, False),
                (gen(1.0), n_gen, True), (gen(-1.0), n_gen, True)]

    if cat == C.CONE:
        def gen(sign):
            def fn(pk, ts):
                sp = pk.objects[i]
                u = eye_local(pk, sp)
                v = Vec3(u.x, u.y, u.z - sp.h)     # the eye from the apex
                rho = torch.sqrt(vm.clip(v.x * v.x + v.y * v.y, 1e-12))
                phi0 = torch.atan2(v.y, v.x)
                tan_a = sp.r / vm.clip(sp.h, 1e-9)
                a = -tan_a * v.z / rho
                exists = torch.abs(a) < 1.0 - 1e-6
                dphi = torch.acos(vm.clip(a, -1.0 + 1e-6, 1.0 - 1e-6))
                phi = phi0 + sign * dphi
                # apex (0, 0, h) → base rim point (r cos φ, r sin φ, 0)
                local = Vec3(sp.r * torch.cos(phi) * ts,
                             sp.r * torch.sin(phi) * ts,
                             sp.h * (1.0 - ts))
                pts = isect.from_object(local) + sp.p
                return pts, exists.to(ts.dtype).broadcast_to(ts.shape)
            return fn
        return [(circle(lambda sp: sp.r, lambda sp: 0.0), n_circ, False),
                (gen(1.0), n_gen, True), (gen(-1.0), n_gen, True)]

    if cat == C.PARABOLOID:
        def zminmax(sp):
            return torch.minimum(sp.z0, sp.z1), torch.maximum(sp.z0, sp.z1)

        def kof(sp):
            _, zmax = zminmax(sp)
            return zmax / vm.clip(sp.r * sp.r, 1e-12)

        def rim_r(sp, z):
            return torch.sqrt(vm.clip(z / kof(sp), 0.0))

        def smooth(pk, ts):
            sp = pk.objects[i]
            zmin, zmax = zminmax(sp)
            k = kof(sp)
            u = eye_local(pk, sp)
            r2 = u.x * u.x + u.y * u.y - u.z / k
            exists = r2 > 1e-9
            rr = torch.sqrt(vm.clip(r2, 1e-9))
            ang = TWO_PI * ts
            x = u.x + rr * torch.cos(ang)
            y = u.y + rr * torch.sin(ang)
            z = k * (x * x + y * y)
            pts = isect.from_object(Vec3(x, y, z)) + sp.p
            m = (exists & (z >= zmin) & (z <= zmax)).to(ts.dtype)
            return pts, m
        return [(circle(lambda sp: rim_r(sp, zminmax(sp)[0]),
                        lambda sp: zminmax(sp)[0]), n_circ, False),
                (circle(lambda sp: rim_r(sp, zminmax(sp)[1]),
                        lambda sp: zminmax(sp)[1]), n_circ, False),
                (smooth, n_circ, True)]

    if cat == C.HYPERBOLOID:
        def rim(which):
            def radius_of(sp):
                q = getattr(sp, which)
                return torch.sqrt(vm.clip(q.x * q.x + q.y * q.y, 1e-12))
            return circle(radius_of, lambda sp: getattr(sp, which).z)

        def smooth(sign):
            """The lateral silhouette of ah(x²+y²) − ch z² = 1 from the
            local eye u: the polar plane of u cut with the surface per z
            (a line and a circle), clipped to [z1, z2] by the ts range and
            to existence by the mask."""
            def fn(pk, ts):
                sp = pk.objects[i]
                u = eye_local(pk, sp)
                zmin = torch.minimum(sp.p1.z, sp.p2.z)
                zmax = torch.maximum(sp.p1.z, sp.p2.z)
                z = zmin + (zmax - zmin) * ts
                a = sp.ah * u.x
                b = sp.ah * u.y
                d = 1.0 + sp.ch * u.z * z
                q2 = vm.clip(a * a + b * b, 1e-12)
                q = torch.sqrt(q2)
                r2 = (1.0 + sp.ch * z * z) / vm.clip(sp.ah, 1e-12)
                h2 = r2 - d * d / q2
                exists = h2 > 1e-9
                s = torch.sqrt(vm.clip(h2, 1e-9))
                fx = a * d / q2
                fy = b * d / q2
                local = Vec3(fx + sign * (-b) * s / q, fy + sign * a * s / q,
                             z)
                pts = isect.from_object(local) + sp.p
                return pts, exists.to(ts.dtype)
            return fn

        return [(rim("p1"), n_circ, False), (rim("p2"), n_circ, False),
                (smooth(1.0), n_gen, True), (smooth(-1.0), n_gen, True)]

    return []


def _mirror_sphere_silhouette_fn(m_idx: int, s_idx: int):
    """pts_fn of the silhouette of sphere `s_idx` seen reflected in the
    sphere mirror `m_idx` (the Alhazen configuration), which has no closed
    form, so each azimuth runs a root solve (`ops/cuda/alhazen.py`):

      1. Alhazen center: bisect the in-plane alignment h(ψ) for the mirror
         point reflecting eye → center of S; it anchors the image's center.
      2. Radial: per azimuth φ about it, bisect g(β) = (distance of the
         reflected ray from S's center) − r over the view angle β, from the
         first sign change inside the mirror.  An azimuth whose bracket
         leaves the mirror first is masked (that jump is the mirror's own
         rim, which its direct term already counts).

    Both solves are detached (`alhazen.solve`: eager torch on the CPU, KA
    on the card); one Newton step from the detached root with the live
    residual and a detached slope, x_live = x0 − f_live(x0)/f'(x0), has the
    implicit-function derivative at the root, so gradients reach S, the
    mirror and the camera.  Points lie at unit distance from the eye along
    the discontinuity ray (the projection needs only the direction).

    `pts_fn.pair(pk, tm, pk_detached, tb)` gives `(pts_fn(pk, tm),
    pts_fn(pk_detached, tb))` from one solve over the azimuths of both (the
    two views hold the same values, and the solve reads only their
    detached values)."""
    def solve(pairs):
        frames = [alhazen.frame(pk, m_idx, s_idx) for pk, _ in pairs]
        f_d = _detach(frames[0])
        sizes = [ts.shape[0] for _, ts in pairs]
        ts_all = torch.cat([ts for _, ts in pairs])
        ang = TWO_PI * ts_all
        cphi_all, sphi_all = torch.cos(ang), torch.sin(ang)
        psi0, dh, beta0, gp, mask = alhazen.solve(f_d, cphi_all, sphi_all)

        out = []
        parts = zip(beta0.split(sizes), gp.split(sizes), mask.split(sizes),
                    cphi_all.split(sizes), sphi_all.split(sizes))
        for f, (beta0_i, gp_i, mask_i, cphi, sphi) in zip(frames, parts):
            a, e1, e2 = alhazen.center_frame(f, f_d.pn, psi0, dh)
            g_live, _ = alhazen.radial_residual(f, a, e1, e2, cphi, sphi,
                                                beta0_i)
            beta_live = beta0_i - g_live / gp_i.detach()
            v_live = (a * torch.cos(beta_live)
                      + (e1 * cphi + e2 * sphi) * torch.sin(beta_live))
            out.append((f.e + v_live, mask_i.to(ts_all.dtype)))
        return out

    def pts_fn(pk, ts):
        return solve([(pk, ts)])[0]

    pts_fn.pair = lambda pk, tm, pk_detached, tb: tuple(
        solve([(pk, tm), (pk_detached, tb)]))
    return pts_fn


def _planar_mirror_silhouette_fn(m_idx: int, s_idx: int):
    """pts_fn of sphere `s_idx` seen in the planar mirror (a Mirror
    Rectangle) `m_idx`: the tangent circle of its virtual sphere, reflected
    across the mirror's plane.  Δf gates it to the mirror's unoccluded
    screen extent, where alone there is a jump."""
    def pts_fn(pk, ts):
        mp = pk.objects[m_idx]
        _, _, n_hat = isect.rectangle_frame(mp)
        sp = pk.objects[s_idx]
        dist = (sp.center - mp.bmin).dot(n_hat)
        c_virt = sp.center - n_hat * (2.0 * dist)
        return (sphere_silhouette(pk.camera, c_virt, sp.radius, ts),
                torch.ones_like(ts))
    return pts_fn


def _categories(static, cats):
    return [i for i, cat in enumerate(static.object_categories)
            if cat in cats]


def _material_of(static, i: int) -> int:
    return static.material_categories[static.object_mat_rows[i]]


@spanned("sail.silhouette")
def boundary_term(params: torch.Tensor, static, d_loss_d_image,
                  height: int, width: int, n_edge_samples: int = 256,
                  n_noise: int = 4, delta_px: float = 0.35, seed: int = 0,
                  max_bounces: int = C.MAX_BOUNCES,
                  extrapolate: bool = True,
                  batched: bool = True) -> torch.Tensor:
    """The primary-visibility boundary contribution to dL/d(params) for a
    loss with per-pixel, per-channel adjoint `d_loss_d_image` (a Vec3 of
    (H, W) tensors or an (H, W, 3) array: ∂L/∂image, e.g. 2·(img −
    target)/N for the mean squared error).  A flat tensor like `params`,
    zero for parameters without a handled silhouette; add it to the
    interior (autograd) gradient.

    Each silhouette site (a box's edges, a curve, a sphere's circle) first
    runs its geometry and hands its straddle points to one `_Straddles`;
    `batched` traces them all in one `trace_rays` call, else site by site;
    then each site finishes its scalar, added in site order."""
    dL = _adjoint(d_loss_d_image, params)
    sphere_ids = _categories(static, (C.SPHERE,))
    box_ids = _categories(static, _BOX_CATEGORIES)
    rev_ids = _categories(static, _REVOLUTION_CATEGORIES)
    # objects seen in planar mirrors have image-space silhouettes too (the
    # virtual sphere's); sphere mirrors take the Alhazen solve
    mirror_rect_ids = [i for i in _categories(static, (C.RECTANGLE,))
                       if _material_of(static, i) == C.MIRROR]
    mirror_sphere_ids = [i for i in sphere_ids
                         if _material_of(static, i) == C.MIRROR]
    if not sphere_ids and not box_ids and not rev_ids:
        return torch.zeros_like(params)

    ts = _arange(n_edge_samples, params, 0.5)
    # straight edges need no √δ extrapolation: one Δf batch per box
    k_per_edge = max(4, n_edge_samples // 24)
    n_mirror = max(16, n_edge_samples // 2)
    size = dict(height=height, width=width, delta_px=delta_px)

    def edge_scalar(pk, pk_detached):
        straddles = _Straddles(params, static, height, width, seed,
                               n_noise, max_bounces, batched)
        sites = []
        for i in box_ids:
            scale = 0.5 if static.object_categories[i] == C.RECTANGLE else 1.0
            sites.append(_box_edge_site(pk, pk_detached, static, i,
                                        k_per_edge=k_per_edge, scale=scale,
                                        straddles=straddles, **size))
        for i in rev_ids:
            for pts_fn, n_pts, grazing in _revolution_curves(static, i,
                                                             n_edge_samples):
                sites.append(_curve_edge_site(
                    pk, pk_detached, pts_fn, n_pts, grazing=grazing,
                    extrapolate=extrapolate, straddles=straddles, **size))
        for silhouette_in, mirror_ids in (
                (_planar_mirror_silhouette_fn, mirror_rect_ids),
                (_mirror_sphere_silhouette_fn, mirror_sphere_ids)):
            for m_idx in mirror_ids:
                for s_idx in sphere_ids:
                    if s_idx != m_idx:
                        sites.append(_curve_edge_site(
                            pk, pk_detached, silhouette_in(m_idx, s_idx),
                            n_mirror, grazing=True, extrapolate=extrapolate,
                            straddles=straddles, **size))
        for i in sphere_ids:
            sites.append(_sphere_edge_site(pk, i, ts, extrapolate=extrapolate,
                                           straddles=straddles, **size))
        straddles.trace()
        total = torch.zeros((), dtype=params.dtype, device=params.device)
        for finish in sites:
            total = total + finish(dL)
        return total

    return _edge_grad(edge_scalar, params, static)


@functools.lru_cache(maxsize=64)
def _material_rows(static, category: int, device) -> torch.Tensor:
    """Whether each material row is of `category`, a bool tensor on
    `device` copied there once per scene structure, so a call copies
    nothing from the host."""
    return torch.tensor([c == category for c in static.material_categories],
                        device=device)


def _shading_frame(h, d: Vec3):
    """(ss, ts, wo) of hits `h` reached along `d`, as the integrator's
    bounce builds them."""
    dpdu_ok = h.dpdu.length_sq() > 1e-16
    ss = vm.where(dpdu_ok, h.dpdu, vm.ortho(h.n)).normalize()
    ss = (ss - h.n * ss.dot(h.n)).normalize()
    ts = h.n.cross(ss)
    return ss, ts, vm.world_to_local(-d, h.n, ss, ts)


def _surface_color(pk, static, h) -> Vec3:
    return tex_ops.surface_color(pk.textures, static, h.tex_row, h.p, h.u,
                                 h.v, h.sc_override, h.use_override)


def _pixel_rays(cam, height: int, width: int, like: torch.Tensor):
    """Float (row, col) grids of the image and the pixel-center rays."""
    ii = torch.arange(height, dtype=like.dtype, device=like.device)[:, None] \
        .expand(height, width)
    jj = torch.arange(width, dtype=like.dtype, device=like.device)[None, :] \
        .expand(height, width)
    return (ii, jj), rays_for_pixels(cam, ii, jj, height, width)


@spanned("sail.penumbra")
def shadow_boundary_term(params: torch.Tensor, static, d_loss_d_image,
                         height: int, width: int, n_curve_samples: int = 16,
                         seed: int = 0,
                         n_indirect_dirs: int = 0) -> torch.Tensor:
    """The NEE-visibility (penumbra) boundary term of sphere occluders.

    The direct light at a receiver x, D(x) = ∫_A f·Le·cosθ_s·cosθ_l/d² ·
    V(x, y) dA(y), jumps across the penumbra curve Γ_x: the sphere's
    tangent circle seen from x, projected onto the light.  This evaluates
    dD/dθ = −∮_{Γ_x∩A} h(y) (n̂·dy/dθ) dl per pixel, h the unoccluded
    integrand, at K = `n_curve_samples` points of each curve; no ray is
    traced for it.  The term itself is `ops/cuda/penumbra`'s: on the CPU
    the plain version over (K, H, W) tensors, on the card KP, one kernel
    with its adjoint.  The receivers are torch's on the CPU
    (`_shadow_term_plain`); on the card the primary and mirror receivers
    are KH's, one kernel with its adjoint (`ops/cuda/receivers.py`,
    `_shadow_term_kernel`).

    Receivers: matte surfaces seen directly or through one Mirror bounce
    (planar or curved, weighted by the mirror's kr·texture tint), and with
    `n_indirect_dirs` > 0 those reached through one diffuse bounce (the
    BSDF-sampled directions of each matte primary hit, weighted by the
    bounce's throughput, averaged; their points detached).  Lights:
    rectangle area lights.  Gradients reach the occluding spheres' centers
    and radii and the camera (primary and mirror receivers follow the live
    camera rays through the detached scene).  A flat tensor like
    `params`."""
    dL = _adjoint(d_loss_d_image, params)
    sphere_ids = _categories(static, (C.SPHERE,))
    rect_lights = [
        (li, static.area_light_objects[li])
        for li, lcat in enumerate(static.light_categories)
        if lcat == C.AREA and static.object_categories[
            static.area_light_objects[li]] == C.RECTANGLE]
    if not sphere_ids or not rect_lights:
        return torch.zeros_like(params)
    pairs = [(i, li, obj_idx) for i in sphere_ids
             for li, obj_idx in rect_lights
             if obj_idx != i]   # a light does not shadow itself
    term = _shadow_term_kernel if params.is_cuda else _shadow_term_plain
    return term(params, static, dL, height, width, n_curve_samples, seed,
                n_indirect_dirs, pairs)


def _indirect_receivers(pk_d, static, hit, rd, ii, jj, seed: int,
                        n_indirect_dirs: int, receiver_data):
    """The one-diffuse-bounce receivers of the primary hits `hit` (along
    `rd`, pixels (ii, jj)): [(tag, hits, direction, tint)] and their
    detached points by tag."""
    like = rd.x
    ss0, ts0, wo0, sc0, prim_matte = receiver_data(hit, rd)
    ii_i, jj_i = ii.to(torch.int32), jj.to(torch.int32)
    half = torch.full(like.shape, 0.5, dtype=like.dtype, device=like.device)
    receivers, x_static = [], {}
    for k in range(n_indirect_dirs):
        # per-pixel decorrelated directions (the counter RNG): shared
        # strata correlate the quadrature error across the image
        nk = rng.pixel_noise(seed, 52361 + k, ii=ii_i, jj=jj_i)
        u1k, u2k, _ = nk.uniform3(0, rng.TAG_BSDF)
        ms0 = mat_ops.sample_material(pk_d.materials, static, hit.mat_row,
                                      sc0, u1k, u2k, half, wo0, hit.into)
        wi_w = vm.local_to_world(ms0.wi, hit.n, ss0, ts0)
        outdot = hit.n.dot(wi_w)
        ro2k = hit.p + hit.n * torch.where(outdot > 0.0, 1e-4, -1e-4)
        hit2k = isect.intersect_scene(pk_d.objects, static, ro2k, wi_w)
        tint_k = Vec3(*(torch.where(prim_matte, w / n_indirect_dirs, 0.0)
                        for w in ms0.weight.clip(0.0, 1.0)))
        tag = f"ind{k}"
        x_static[tag] = _detach(hit2k.p)
        receivers.append((tag, hit2k._replace(valid=hit2k.valid
                                              & prim_matte),
                          wi_w, tint_k))
    return receivers, x_static


def _receiver_data(pk_d, static, device):
    """`receiver_data(h, d)`: (ss, ts, wo, surface color, mask) of hits `h`
    reached along `d`, the mask a valid, matte, not emissive hit."""
    matte_rows = _material_rows(static, C.MATTE, device)

    def receiver_data(h, d):
        ss, ts_f, wo = _shading_frame(h, d)
        sc = _surface_color(pk_d, static, h)
        rec = h.valid & matte_rows[h.mat_row.long()] & (h.emissive == 0)
        return ss, ts_f, wo, sc, rec
    return receiver_data


def _shadow_term_plain(params, static, dL: Vec3, height: int, width: int,
                       n_curve_samples: int, seed: int, n_indirect_dirs: int,
                       pairs) -> torch.Tensor:
    """`shadow_boundary_term` with torch's receivers: the detached hits of
    the pixel rays and their mirror bounce, then, under autograd, the same
    hits of the live camera's rays for the points (`_live_points`), and
    `penumbra.penumbra_scalar`."""
    pk_d = unflatten(params.detach(), static)
    dev = params.device
    (ii, jj), (ro, rd) = _pixel_rays(pk_d.camera, height, width, params)
    hit = isect.intersect_scene(pk_d.objects, static, ro, rd)
    mirror_rows = _material_rows(static, C.MIRROR, dev)
    receiver_data = _receiver_data(pk_d, static, dev)

    one = torch.ones((height, width), dtype=params.dtype, device=dev)
    receivers = [("primary", hit, rd, Vec3(one, one, one))]

    # -- one specular bounce: shadows seen in a mirror, weighted by its tint
    if any(c == C.MIRROR for c in static.material_categories):
        spec1 = hit.valid & mirror_rows[hit.mat_row.long()]
        rd2 = (rd - hit.n * (2.0 * hit.n.dot(rd))).normalize()
        ro2 = hit.p + hit.n * 1e-4
        hit2 = isect.intersect_scene(pk_d.objects, static, ro2, rd2)
        sc1 = _surface_color(pk_d, static, hit)
        _, _, wo1 = _shading_frame(hit, rd)
        half = torch.full((height, width), 0.5, dtype=params.dtype,
                          device=dev)
        ms1 = mat_ops.sample_material(pk_d.materials, static, hit.mat_row,
                                      sc1, half, half, half, wo1, hit.into)
        tint = Vec3(*(torch.where(spec1, w, 0.0)
                      for w in ms1.weight.clip(0.0, 1.0)))
        receivers.append(("mirror", hit2._replace(valid=hit2.valid & spec1),
                          rd2, tint))

    # -- one diffuse bounce: indirect shadows, through the bounce's weight
    x_static = {}
    if n_indirect_dirs > 0:
        indirect, x_static = _indirect_receivers(
            pk_d, static, hit, rd, ii, jj, seed, n_indirect_dirs,
            receiver_data)
        receivers += indirect

    recv = [penumbra.Receiver(tag, rhit, tint, *receiver_data(rhit, rdir))
            for tag, rhit, rdir, tint in receivers]

    def edge_scalar(pk, _):
        # live: the curve's position, of the occluder's parameters and the
        # receiver point, re-derived from live camera rays against the
        # detached scene (x stays on the fixed receiver surface while moving
        # with the eye); mirror receivers follow the live ray through the
        # detached mirror; indirect receivers stay detached
        x_live = _live_points(pk.camera, pk_d, static, height, width, params,
                              "mirror" in {rc.tag for rc in recv})
        x_live.update(x_static)
        return penumbra.penumbra_scalar(pk, pk_d, static, dL, recv, x_live,
                                        pairs, n_curve_samples)

    return _edge_grad(edge_scalar, params, static)


def _live_points(cam, pk_d, static, height: int, width: int,
                 like: torch.Tensor, mirror: bool) -> dict:
    """The primary receivers' points (and with `mirror` the mirror
    receivers') of the camera `cam`'s pixel rays against the detached scene
    `pk_d`, by tag: the points KH (`ops/cuda/receivers.py`) computes, and
    whose gradient with respect to the camera its adjoint is."""
    _, (ro_l, rd_l) = _pixel_rays(cam, height, width, like)
    h1 = isect.intersect_scene(pk_d.objects, static, ro_l, rd_l)
    x_live = {"primary": h1.p}
    if mirror:
        rd2_l = (rd_l - h1.n * (2.0 * h1.n.dot(rd_l))).normalize()
        x_live["mirror"] = isect.intersect_scene(
            pk_d.objects, static, h1.p + h1.n * 1e-4, rd2_l).p
    return x_live


def _shadow_term_kernel(params, static, dL: Vec3, height: int, width: int,
                        n_curve_samples: int, seed: int,
                        n_indirect_dirs: int, pairs) -> torch.Tensor:
    """`shadow_boundary_term` on the card: the primary and mirror receivers
    from KH, live in the camera's parameters (a slice of the flat tensor),
    and with `n_indirect_dirs` > 0 the diffuse-bounce receivers from torch
    (detached) after them; the term through KP
    (`penumbra.penumbra_scalar_packed`), live in the spheres' centers and
    radii (slices too)."""
    params_d = params.detach()
    pk_d = unflatten(params_d, static)
    off = param_offsets(static)
    R = 2 if any(c == C.MIRROR for c in static.material_categories) else 1
    extra = None
    if n_indirect_dirs > 0:
        (ii, jj), (ro, rd) = _pixel_rays(pk_d.camera, height, width, params)
        hit = isect.intersect_scene(pk_d.objects, static, ro, rd)
        receiver_data = _receiver_data(pk_d, static, params.device)
        indirect, x_static = _indirect_receivers(
            pk_d, static, hit, rd, ii, jj, seed, n_indirect_dirs,
            receiver_data)
        recv = [penumbra.Receiver(tag, rhit, tint, *receiver_data(rhit, rd_k))
                for tag, rhit, rd_k, tint in indirect]
        extra = (*penumbra.receiver_planes(recv),
                 torch.stack([x_static[rc.tag].stack(0) for rc in recv]))
    sphere_ids = list(dict.fromkeys(i for i, _, _ in pairs))
    p = params.detach().requires_grad_()
    with torch.enable_grad():
        xs, planes, ints = receivers.live_receivers(
            p[off.camera:off.size], params_d, static, height, width, R)
        if extra is not None:
            planes, ints, xs = (torch.cat((a, b))
                                for a, b in zip((planes, ints, xs), extra))
        spheres = torch.stack([p[off.objects[i]:off.objects[i] + 4]
                               for i in sphere_ids])
        total = penumbra.penumbra_scalar_packed(
            spheres, xs, pk_d, static, dL, planes, ints, pairs,
            n_curve_samples)
    with span("sail.edge_backward"):
        (grad,) = torch.autograd.grad(total, p)
    return grad


def indirect_silhouette_term(params: torch.Tensor, static, d_loss_d_image,
                             height: int, width: int, n_dir_samples: int = 8,
                             n_noise: int = 2, seed: int = 0,
                             max_bounces: int = C.MAX_BOUNCES,
                             delta_rad: float = 6e-3) -> torch.Tensor:
    """The secondary-vertex silhouette term: the other half of
    one-diffuse-bounce visibility.  At a matte primary hit x the radiance
    ∫ f·cosθ·L_in(x, ω) dω jumps across the tangent cone of every sphere
    seen from x; this is the occluder sweeping across the BSDF-sampled
    segment itself, apart from the NEE penumbra.

    Per (sphere, pixel): the cone's circle ω(t) = cosβ·ŵ + sinβ·(e1 cos 2πt
    + e2 sin 2πt), β = asin(r/d), live in the sphere's center and radius
    (x detached).  Detached: the matte BSDF × cosθ at ω, the loss adjoint,
    the arc element sinβ·2π/K and Δf = L(β−δ) − L(β+δ) from straddle pairs
    traced from x with common random numbers (the 2·Δf(δ/4) − Δf(δ)
    extrapolation, as the inside ray grazes).  The scalar is Σ coeff ·
    (n̂·ω_live) with n̂ = ∂ω/∂β.  A flat tensor like `params`.  Each
    `trace_rays` call here already holds K·H·W rays, so its calls are not
    batched as `boundary_term`'s are: a batch would multiply memory that
    is already the image's times K."""
    dL = _adjoint(d_loss_d_image, params)
    sphere_ids = _categories(static, (C.SPHERE,))
    if not sphere_ids:
        return torch.zeros_like(params)

    pk_d = unflatten(params.detach(), static)
    (ii, jj), (ro, rd) = _pixel_rays(pk_d.camera, height, width, params)
    hit = isect.intersect_scene(pk_d.objects, static, ro, rd)
    receiver = (hit.valid & _material_rows(static, C.MATTE, params.device)[
        hit.mat_row.long()] & (hit.emissive == 0))
    x = _detach(hit.p)
    n_A = hit.n
    ss, ts_f, wo = _shading_frame(hit, rd)
    sc = _surface_color(pk_d, static, hit)

    K = n_dir_samples
    ang = TWO_PI * _arange(K, params, 0.5)[:, None, None]
    ca, sa = torch.cos(ang), torch.sin(ang)
    kshape = (K, height, width)
    origin = (x + n_A * 1e-4).broadcast_to(kshape)
    ii_i = ii.to(torch.int32).broadcast_to(kshape)
    jj_i = jj.to(torch.int32).broadcast_to(kshape)

    def cone_dirs(sp, x):
        """(ω, ∂ω/∂β, sinβ, d) of sphere sp's tangent cone from points x, ω
        of shape (K, H, W) in sp's center and radius (and x)."""
        w = sp.center - x
        d = w.length()
        w_hat = w * (1.0 / vm.clip(d, 1e-9))
        ratio = vm.clip(sp.radius / vm.clip(d, 1e-9), 0.0, 1.0 - 1e-6)
        sinb = ratio
        cosb = torch.sqrt(vm.clip(1.0 - ratio * ratio, 1e-12))
        e1 = vm.ortho(w_hat).normalize()
        e2 = w_hat.cross(e1)
        radial = e1 * ca + e2 * sa
        omega = w_hat.broadcast_to(kshape) * cosb + radial * sinb
        # outward in direction space, away from the cone's axis
        n_dir = radial * cosb - w_hat.broadcast_to(kshape) * sinb
        return omega, n_dir, sinb, d

    def delta_f(omega, n_dir, delta):
        """L(β − δ) − L(β + δ) by straddle pairs, `n_noise` passes."""
        cd, sd = math.cos(delta), math.sin(delta)
        acc = None
        for k in range(n_noise):
            noise = rng.pixel_noise(seed, 60013 + k, ii=ii_i, jj=jj_i)
            df_k = None
            for sign, w_side in ((-1.0, 1.0), (1.0, -1.0)):
                dirs = (omega * cd + n_dir * (sign * sd)).normalize()
                color = trace_rays(params.detach(), static, origin, dirs,
                                   noise, max(max_bounces - 1, 1)) * w_side
                df_k = color if df_k is None else df_k + color
            acc = df_k if acc is None else acc + df_k
        return acc * (1.0 / n_noise)

    saved = []
    with torch.no_grad():
        for i in sphere_ids:
            sp_d = pk_d.objects[i]
            omega_d, n_dir_d, sinb, d_cx = cone_dirs(sp_d, x)
            df = (delta_f(omega_d, n_dir_d, delta_rad / 4) * 2.0
                  - delta_f(omega_d, n_dir_d, delta_rad))
            wi_local = vm.world_to_local(omega_d, n_A, ss, ts_f)
            f = mat_ops.eval_matte_f(pk_d.materials, static, hit.mat_row, sc,
                                     wo, wi_local)
            cos_s = vm.clip(omega_d.dot(n_A), 0.0)
            w_df = (dL.x * f.x * df.x + dL.y * f.y * df.y
                    + dL.z * f.z * df.z) * cos_s
            dl = sinb * (TWO_PI / K)
            valid = (receiver & (hit.obj_id != i)
                     & (d_cx > sp_d.radius * (1.0 + 1e-4)))
            saved.append((i, torch.where(valid, w_df * dl, 0.0), n_dir_d))

    def edge_scalar(pk, _):
        total = torch.zeros((), dtype=params.dtype, device=params.device)
        for i, coeff, n_dir in saved:
            omega_live, _, _, _ = cone_dirs(pk.objects[i], x)
            total = total + torch.sum(coeff * n_dir.dot(omega_live))
        return total

    return _edge_grad(edge_scalar, params, static)


def _full_boundary_term(params: torch.Tensor, static, d_loss_d_image,
                        height: int, width: int, n_edge_samples: int = 256,
                        n_noise: int = 4, seed: int = 0,
                        max_bounces: int = C.MAX_BOUNCES,
                        n_curve_samples: int = 32, shadow: bool = True,
                        n_indirect_dirs: int = 0,
                        indirect_silhouette: bool = False) -> torch.Tensor:
    """`full_boundary_term`, eagerly: its terms op by op."""
    bnd = boundary_term(params, static, d_loss_d_image, height, width,
                        n_edge_samples=n_edge_samples, n_noise=n_noise,
                        seed=seed, max_bounces=max_bounces)
    if shadow:
        bnd = bnd + shadow_boundary_term(
            params, static, d_loss_d_image, height, width,
            n_curve_samples=n_curve_samples, seed=seed,
            n_indirect_dirs=n_indirect_dirs)
    if indirect_silhouette:
        bnd = bnd + indirect_silhouette_term(
            params, static, d_loss_d_image, height, width, seed=seed,
            max_bounces=max_bounces)
    return bnd


# full_boundary_term's graphs by key, the most recently used last; a key
# seen once holds None (its first call ran eagerly)
_GRAPHS = collections.OrderedDict()
_MAX_GRAPHS = 16


@spanned("sail.edge_terms")
def full_boundary_term(params: torch.Tensor, static, d_loss_d_image,
                       height: int, width: int, n_edge_samples: int = 256,
                       n_noise: int = 4, seed: int = 0,
                       max_bounces: int = C.MAX_BOUNCES,
                       n_curve_samples: int = 32, shadow: bool = True,
                       n_indirect_dirs: int = 0,
                       indirect_silhouette: bool = False) -> torch.Tensor:
    """The silhouette term plus (`shadow`) the NEE-penumbra term, with
    `n_indirect_dirs` > 0 its one-diffuse-bounce receivers, and
    (`indirect_silhouette`) the secondary-vertex silhouette term: the
    whole edge-gradient correction modelled, for any per-pixel loss
    adjoint.  A flat tensor like `params`.

    On a CUDA device the term is one CUDA graph, keyed on what decides its
    kernels: the device, `static`, the shapes and dtypes of `params` and
    the adjoint, and every other argument.  A key's first call runs
    eagerly (it builds KR and KP and fills the cached tables); its second
    captures the whole term, autograd included, over static copies of the
    params and the (3, H, W) adjoint (`utils/graphs.Replay`); every later
    call copies them in and replays (span `sail.edge_replay`).  Each
    replay runs the eager call's kernels on the same inputs.  CPU tensors
    run eagerly.
    `full_boundary_term.eager`, `.captures` and `.replays` count each; the
    kernel wrappers' `launches` count the eager calls' launches only (a
    capture launches nothing, and a replay's kernels are the graph's)."""
    kw = dict(n_edge_samples=n_edge_samples, n_noise=n_noise, seed=seed,
              max_bounces=max_bounces, n_curve_samples=n_curve_samples,
              shadow=shadow, n_indirect_dirs=n_indirect_dirs,
              indirect_silhouette=indirect_silhouette)
    if not params.is_cuda:
        full_boundary_term.eager += 1
        return _full_boundary_term(params, static, d_loss_d_image, height,
                                   width, **kw)
    adj = torch.stack(tuple(_adjoint(d_loss_d_image, params)))
    key = (params.device, static, params.shape, params.dtype, adj.shape,
           adj.dtype, height, width, operator.index(seed),
           *(v for k, v in kw.items() if k != "seed"))
    if key not in _GRAPHS:
        _GRAPHS[key] = None
        if len(_GRAPHS) > _MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        full_boundary_term.eager += 1
        return _full_boundary_term(params, static, d_loss_d_image, height,
                                   width, **kw)
    _GRAPHS.move_to_end(key)
    if _GRAPHS[key] is None:
        _GRAPHS[key] = Replay(
            lambda p, a: _full_boundary_term(p, static, Vec3(*a), height,
                                             width, **kw),
            (params, adj))
        full_boundary_term.captures += 1
    with span("sail.edge_replay"):
        out = _GRAPHS[key].replay(params, adj)
    full_boundary_term.replays += 1
    return out


full_boundary_term.eager = 0
full_boundary_term.captures = 0
full_boundary_term.replays = 0


def mse_adjoint(img: Vec3, target: Vec3) -> Vec3:
    """∂L/∂image of L = mean((img − target)²) over pixels and channels,
    detached."""
    n = img.x.numel() * 3
    return Vec3(*((a.detach() - b) * (2.0 / n) for a, b in zip(img, target)))


def grad_with_boundary(loss_fn, params: torch.Tensor, static,
                       render_kwargs: dict, target: Vec3,
                       n_edge_samples: int = 256, n_noise: int = 4,
                       seed: int = 0, shadow: bool = True):
    """(interior + boundary gradient, image) of `loss_fn(params) -> (loss,
    img)` for the mean squared error against `target`: the interior by
    autograd, the silhouette and penumbra terms by `full_boundary_term`.
    `render_kwargs` holds the render's height and width (and may hold
    max_bounces)."""
    height = render_kwargs["height"]
    width = render_kwargs["width"]
    max_bounces = render_kwargs.get("max_bounces", C.MAX_BOUNCES)
    p = params.detach().requires_grad_()
    with torch.enable_grad():
        loss, img = loss_fn(p)
        (interior,) = torch.autograd.grad(loss, p)
    bnd = full_boundary_term(params, static, mse_adjoint(img, target),
                             height, width, n_edge_samples=n_edge_samples,
                             n_noise=n_noise, seed=seed,
                             max_bounces=max_bounces, shadow=shadow)
    return interior + bnd, _detach(img)
