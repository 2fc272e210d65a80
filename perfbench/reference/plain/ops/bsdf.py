"""BSDFs: Fresnel terms, the microfacet distributions, and the four material
categories (Matte, Mirror, Metal, Glass), plus the Lambertian transmission
the JAX package keeps as a library function.

Port of `sail_tpu/ops/bsdf.py`, operation by operation.  All functions work
in the local shading frame (z = shading normal); branches are masks.  Every
clip of a differentiable value goes through `vm.clip` (JAX's gradient at a
tie), and `x ** 2` is written `x * x`, as JAX's integer power computes it.
`csrc/bsdf.cuh` carries the same functions for the kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..core import fastmath
from ..core import samplers
from ..core import vecmath as vm
from ..core.vecmath import Vec3

_EPS = C.EPSILON


class BSDFSample(NamedTuple):
    wi: Vec3            # sampled direction, local frame
    weight: Vec3        # f * |cos θi| / pdf  (path throughput multiplier)
    f_nee: Vec3         # BSDF value for light-sampling (0 for specular)
    is_specular: torch.Tensor  # int32 0/1 per ray


def _flags(shape, value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.int32, device=like.device)


# -- Fresnel ------------------------------------------------------------------

def fr_dielectric(cos_theta_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance; a negative cosθi means the
    ray exits the medium, and the indices swap."""
    cos_i = vm.clip(cos_theta_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    cos_i = torch.abs(cos_i)

    sin_i = torch.sqrt(vm.clip(1.0 - cos_i * cos_i, 1e-12))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.where(tir, 1.0,
                                   vm.clip(1.0 - sin_t * sin_t, 1e-12)))
    ti = et * cos_i
    it = ei * cos_t
    ii = ei * cos_i
    tt = et * cos_t
    r_parl = (ti - it) / vm.clip(ti + it, 1e-20)
    r_perp = (ii - tt) / vm.clip(ii + tt, 1e-20)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def _sqrt0(x):
    return torch.sqrt(vm.clip(x, 0.0))


def fr_conductor(cos_theta_i, eta_i: Vec3, eta_t: Vec3, k: Vec3) -> Vec3:
    """Conductor Fresnel reflectance, per channel."""
    cos_i = vm.clip(torch.abs(cos_theta_i), 0.0, 1.0)
    eta = eta_t / eta_i
    etak = k / eta_i

    cos2 = cos_i * cos_i
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    etak2 = etak * etak

    t0 = eta2 - etak2 - sin2
    a2b2_sq = t0 * t0 + eta2 * etak2 * 4.0
    a2b2 = Vec3(*(_sqrt0(c) for c in a2b2_sq))
    t1 = a2b2 + cos2
    half = (a2b2 + t0) * 0.5
    a = Vec3(*(_sqrt0(c) for c in half))
    t2 = a * (2.0 * cos_i)
    rs = (t1 - t2) / (t1 + t2)
    t3 = a2b2 * cos2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * ((t3 - t4) / (t3 + t4))
    return (rp + rs) * 0.5


# -- microfacet distributions -------------------------------------------------

def _sample_wh(u1, u2, alphax, alphay, wo: Vec3, kind: int) -> Vec3:
    """A half-vector drawn from D(wh)|cosθh|; `kind` (BECKMANN or
    TROWBRIDGE_REITZ) is static.  Both the isotropic and the anisotropic
    formula are computed and one is selected by |ax - ay| (1e-3 for
    Beckmann, 1e-7 for GGX)."""
    ax, ay = alphax, alphay
    if kind == C.BECKMANN:
        log_sample = torch.log(vm.clip(u1, 1e-20))
        tan2_i = -ax * ax * log_sample
        phi_i = u2 * 2.0 * C.PI
        phi_a = fastmath.atan(ay / ax * fastmath.tan(2.0 * C.PI * u1
                                                     + 0.5 * C.PI))
        phi_a = torch.where(u1 > 0.5, phi_a + C.PI, phi_a)
        sp, cp = torch.sin(phi_a), torch.cos(phi_a)
        tan2_a = -log_sample / (cp * cp / (ax * ax) + sp * sp / (ay * ay))
        is_iso = torch.abs(ax - ay) < 1e-3
    else:
        phi_i = 2.0 * C.PI * u2
        tan2_i = ax * ax * u1 / vm.clip(1.0 - u1, 1e-7)
        phi_a = fastmath.atan(ay / ax * fastmath.tan(C.PI_OVER_2
                                                     + 2.0 * C.PI * u1))
        phi_a = torch.where(u1 > 0.5, phi_a + C.PI, phi_a)
        sp, cp = torch.sin(phi_a), torch.cos(phi_a)
        alpha2 = 1.0 / (cp * cp / (ax * ax) + sp * sp / (ay * ay))
        tan2_a = alpha2 * u1 / vm.clip(1.0 - u1, 1e-7)
        is_iso = torch.abs(ax - ay) < 1e-7
    tan2 = torch.where(is_iso, tan2_i, tan2_a)
    phi = torch.where(is_iso, phi_i, phi_a)

    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(vm.clip(1.0 - cos_t * cos_t, 1e-12))
    wh = vm.spherical_direction(sin_t, cos_t, phi)
    flip = ~vm.same_hemisphere(wo, wh)
    return vm.where(flip, -wh, wh)


def _distribution_d(wh: Vec3, alphax, alphay, kind: int):
    """D(wh), 0 where tan²θ reaches C.INF.  There the formula's inputs are
    replaced by harmless ones before it is evaluated (a double `where`):
    the same values, and the backward pass does not meet 0/0 in the
    division's derivative, which its squared denominator underflows to
    where cos⁴θ sits on its 1e-20 floor."""
    tan2 = vm.tan2_theta(wh)
    c2 = vm.cos2_theta(wh)
    flat = tan2 >= C.INF
    tan2_s = torch.where(flat, 0.0, tan2)
    c2 = torch.where(flat, 1.0, c2)
    cos4 = c2 * c2
    term = vm.cos2_phi(wh) / (alphax * alphax) \
        + vm.sin2_phi(wh) / (alphay * alphay)
    if kind == C.BECKMANN:
        d = torch.exp(-tan2_s * term) / (C.PI * alphax * alphay
                                         * vm.clip(cos4, 1e-20))
    else:
        e1 = 1.0 + term * tan2_s
        d = 1.0 / (C.PI * alphax * alphay * vm.clip(cos4 * (e1 * e1), 1e-20))
    return torch.where(flat, 0.0, d)


def _distribution_pdf(wo: Vec3, wh: Vec3, alphax, alphay, kind: int):
    """pdf of wh under D(wh)|cosθh| sampling."""
    return _distribution_d(wh, alphax, alphay, kind) * vm.abs_cos_theta(wh)


# -- Matte: Lambertian / Oren–Nayar -------------------------------------------

def oren_nayar_ab(sigma):
    """Oren–Nayar A/B from sigma in radians."""
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    return a, b


def matte_f(kd, sigma, sc: Vec3, wo: Vec3, wi: Vec3) -> Vec3:
    """Matte BSDF value; Lambertian for sigma≈0 else Oren–Nayar (both are
    evaluated, as in the JAX version)."""
    r = sc * kd
    lam = r * C.INV_PI

    a, b = oren_nayar_ab(sigma)
    sin_ti = vm.sin_theta(wi)
    sin_to = vm.sin_theta(wo)
    d_cos = vm.cos_phi(wi) * vm.cos_phi(wo) + vm.sin_phi(wi) * vm.sin_phi(wo)
    max_cos = torch.where((sin_ti > _EPS) & (sin_to > _EPS),
                          vm.clip(d_cos, 0.0), 0.0)
    aci = vm.abs_cos_theta(wi)
    aco = vm.abs_cos_theta(wo)
    wi_steeper = aci > aco
    sin_alpha = torch.where(wi_steeper, sin_to, sin_ti)
    tan_beta = torch.where(wi_steeper, sin_ti / vm.clip(aci, 1e-7),
                           sin_to / vm.clip(aco, 1e-7))
    on = r * (C.INV_PI * (a + b * max_cos * sin_alpha * tan_beta))
    return vm.where(sigma < _EPS, lam, on)


def lambertian_t_f(t: Vec3, wo: Vec3, wi: Vec3) -> Vec3:
    """Lambertian transmission: T/π between opposite hemispheres, else 0.
    A library function: no material row dispatches to it."""
    opposite = ~vm.same_hemisphere(wo, wi)
    val = t * C.INV_PI
    return vm.where(opposite, val, vm.zeros_vec(wo.shape, wo.z))


def lambertian_t_pdf(wo: Vec3, wi: Vec3):
    """Cosine pdf on the transmission hemisphere."""
    opposite = ~vm.same_hemisphere(wo, wi)
    return torch.where(opposite, vm.abs_cos_theta(wi) * C.INV_PI, 0.0)


def lambertian_t_sample(t: Vec3, u1, u2, wo: Vec3) -> BSDFSample:
    """Cosine-weighted on the hemisphere opposite wo: weight = T."""
    wi = samplers.cosine_hemisphere(u1, u2)
    wi = vm.where(wo.z > 0.0, Vec3(wi.x, wi.y, -wi.z), wi)
    pdf = lambertian_t_pdf(wo, wi)
    f = lambertian_t_f(t, wo, wi)
    w = f * torch.where(pdf > 0.0,
                        vm.abs_cos_theta(wi) / vm.clip(pdf, 1e-20), 0.0)
    return BSDFSample(wi, w, f, _flags(wo.shape, 0, wo.z))


def matte_sample(kd, sigma, sc: Vec3, u1, u2, wo: Vec3) -> BSDFSample:
    wi = samplers.cosine_hemisphere(u1, u2)
    # Sampled below the horizon ⇒ pdf 0 ⇒ zero weight (mask, not NaN).
    same = vm.same_hemisphere(wo, wi)
    pdf = torch.where(same, vm.abs_cos_theta(wi) * C.INV_PI, 0.0)
    f = matte_f(kd, sigma, sc, wo, wi)
    w = f * torch.where(pdf > 0.0,
                        vm.abs_cos_theta(wi) / vm.clip(pdf, 1e-20), 0.0)
    return BSDFSample(wi, w, f, _flags(wo.shape, 0, wo.z))


# -- Mirror: perfect specular reflection --------------------------------------

def mirror_sample(kr, sc: Vec3, wo: Vec3) -> BSDFSample:
    wi = Vec3(-wo.x, -wo.y, wo.z)
    weight = sc * kr  # noop Fresnel: f = R/|cos|, pdf = 1 ⇒ weight = R
    shape = wo.shape
    return BSDFSample(wi, weight, vm.zeros_vec(shape, wo.z),
                      _flags(shape, 1, wo.z))


# -- Metal: conductor microfacet reflection -----------------------------------

def microfacet_r_f(r: Vec3, wo: Vec3, wi: Vec3, alphax, alphay, kind: int,
                   fresnel_fn) -> Vec3:
    cos_o = vm.abs_cos_theta(wo)
    cos_i = vm.abs_cos_theta(wi)
    wh = wo + wi
    degenerate = (cos_i < _EPS) | (cos_o < _EPS) | (wh.length_sq() < 1e-12)
    wh = wh.normalize()
    f = fresnel_fn(wi.dot(wh))
    d = _distribution_d(wh, alphax, alphay, kind)
    val = r * f * (d / vm.clip(4.0 * cos_i * cos_o, 1e-12))
    return vm.where(degenerate, vm.zeros_vec(wo.shape, wo.z), val)


def microfacet_r_sample(r: Vec3, u1, u2, wo: Vec3, alphax, alphay, kind: int,
                        fresnel_fn) -> BSDFSample:
    shape = wo.shape
    wh = _sample_wh(u1, u2, alphax, alphay, wo, kind)
    wi = vm.reflect(wo, wh)
    ok = (wo.z >= _EPS) & vm.same_hemisphere(wo, wi)
    pdf = _distribution_pdf(wo, wh, alphax, alphay, kind) / \
        vm.clip(4.0 * wo.dot(wh), 1e-12)
    f = microfacet_r_f(r, wo, wi, alphax, alphay, kind, fresnel_fn)
    w = f * torch.where(ok & (pdf > 1e-12),
                        vm.abs_cos_theta(wi) / vm.clip(pdf, 1e-12), 0.0)
    return BSDFSample(wi, w, vm.where(ok, f, vm.zeros_vec(shape, wo.z)),
                      _flags(shape, 0, wo.z))


def metal_sample(p, sc: Vec3, u1, u2, wo: Vec3,
                 kind: int = C.TROWBRIDGE_REITZ) -> BSDFSample:
    """p: MetalP.  Microfacet conductor; `kind` selects the distribution."""
    one = torch.ones((), dtype=wo.z.dtype, device=wo.z.device)
    ones = Vec3(one, one, one)
    ax = vm.clip(p.uroughness, 1e-4)
    ay = vm.clip(p.vroughness, 1e-4)
    return microfacet_r_sample(sc, u1, u2, wo, ax, ay, kind,
                               lambda ci: fr_conductor(ci, ones, p.eta, p.k))


# -- Glass: specular or rough dielectric --------------------------------------

def _specular_glass_sample(kr, kt, eta, sc: Vec3, u_lobe, wo: Vec3,
                           into) -> BSDFSample:
    shape = wo.shape
    black = vm.zeros_vec(shape, wo.z)
    f_refl = fr_dielectric(vm.cos_theta(wo), 1.0, eta)
    pick_reflect = u_lobe < f_refl

    wi_r = Vec3(-wo.x, -wo.y, wo.z)
    w_r = sc * kr  # F·R/|cos| / (pdf=F) · |cos| = R

    eta_i = torch.where(into, 1.0, eta)
    eta_t = torch.where(into, eta, 1.0)
    rel = eta_i / eta_t
    zero = torch.zeros_like(wo.x)
    n = Vec3(zero, zero, torch.where(wo.z >= 0.0, 1.0, -1.0).to(wo.z.dtype))
    wi_t, tir = vm.refract_dir(-wo, n, rel)
    # radiance transport scaling (etaI/etaT)²
    w_t = vm.where(tir, black, sc * (kt * rel * rel))

    wi = vm.where(pick_reflect, wi_r, wi_t)
    w = vm.where(pick_reflect, w_r, w_t)
    return BSDFSample(wi, w, black, _flags(shape, 1, wo.z))


def microfacet_t_f(t_col: Vec3, wo: Vec3, wi: Vec3, eta, into, alphax,
                   alphay, kind: int) -> Vec3:
    """Rough dielectric transmission BTDF, with the radiance eta² factor."""
    cos_o = vm.cos_theta(wo)
    cos_i = vm.cos_theta(wi)
    bad = vm.same_hemisphere(wo, wi) | (torch.abs(cos_i) < 1e-3) \
        | (torch.abs(cos_o) < 1e-3)
    eta_rel = torch.where(into, eta / 1.0, 1.0 / eta)  # etaB/etaA on entry
    wh = (wo + wi * eta_rel).normalize()
    wh = vm.where(wh.z < 0.0, -wh, wh)
    f = fr_dielectric(wo.dot(wh), 1.0, eta)
    denom = wo.dot(wh) + eta_rel * wi.dot(wh)
    d = _distribution_d(wh, alphax, alphay, kind)
    den = cos_i * cos_o * denom * denom
    factor = torch.abs(d * eta_rel * eta_rel * torch.abs(wi.dot(wh))
                       * torch.abs(wo.dot(wh))
                       / torch.where(torch.abs(den) < 1e-12, 1e-12, den))
    val = t_col * ((1.0 - f) * factor / vm.clip(eta_rel * eta_rel, 1e-12))
    return vm.where(bad, vm.zeros_vec(wo.shape, wo.z), val)


def microfacet_t_pdf(wo: Vec3, wi: Vec3, eta, into, alphax, alphay,
                     kind: int):
    bad = vm.same_hemisphere(wo, wi)
    eta_rel = torch.where(into, eta / 1.0, 1.0 / eta)
    wh = (wo + wi * eta_rel).normalize()
    denom = wo.dot(wh) + eta_rel * wi.dot(wh)
    d2 = denom * denom
    dwh_dwi = torch.abs(eta_rel * eta_rel * wi.dot(wh)
                        / torch.where(torch.abs(d2) < 1e-12, 1e-12, d2))
    pdf = _distribution_pdf(wo, wh, alphax, alphay, kind) * dwh_dwi
    return torch.where(bad, 0.0, pdf)


def _rough_glass_sample(p, sc: Vec3, u1, u2, u_lobe, wo: Vec3, into,
                        kind: int = C.TROWBRIDGE_REITZ) -> BSDFSample:
    shape = wo.shape
    ax = vm.clip(p.uroughness, 1e-4)
    ay = vm.clip(p.vroughness, 1e-4)

    # 50/50 lobe choice; each branch's weight doubled
    def fres(ci):
        f = fr_dielectric(ci, 1.0, p.eta)
        return Vec3(f, f, f)

    refl = microfacet_r_sample(sc * p.kr, u1, u2, wo, ax, ay, kind, fres)

    wh = _sample_wh(u1, u2, ax, ay, wo, kind)
    eta_rel_in = torch.where(into, 1.0 / p.eta, p.eta)  # etaA/etaB
    wi_t, tir = vm.refract_dir(-wo, vm.where(wo.dot(wh) < 0, -wh, wh),
                               eta_rel_in)
    f_t = microfacet_t_f(sc * p.kt, wo, wi_t, p.eta, into, ax, ay, kind)
    pdf_t = microfacet_t_pdf(wo, wi_t, p.eta, into, ax, ay, kind)
    w_t = f_t * torch.where(pdf_t > 1e-9, vm.abs_cos_theta(wi_t)
                            / vm.clip(pdf_t, 1e-9), 0.0)
    w_t = vm.where(tir, vm.zeros_vec(shape, wo.z), w_t)

    pick_t = u_lobe >= 0.5
    wi = vm.where(pick_t, wi_t, refl.wi)
    w = vm.where(pick_t, w_t * 2.0, refl.weight * 2.0)
    return BSDFSample(wi, w, vm.zeros_vec(shape, wo.z),
                      _flags(shape, 0, wo.z))


def glass_sample(p, sc: Vec3, u1, u2, u_lobe, wo: Vec3, into,
                 kind: int = C.TROWBRIDGE_REITZ) -> BSDFSample:
    """p: GlassP.  Specular where both roughnesses are below EPSILON, else
    rough.  The JAX version computes both variants and selects by value;
    the selection depends on parameters only, so this computes the one it
    selects: the same values and gradients, and no 0 × ∞ from the other
    variant's derivative (with zero roughness the rough variant's
    distribution overflows)."""
    is_spec = bool((p.uroughness < _EPS) & (p.vroughness < _EPS))
    if is_spec:
        return _specular_glass_sample(p.kr, p.kt, p.eta, sc, u_lobe, wo,
                                      into)
    return _rough_glass_sample(p, sc, u1, u2, u_lobe, wo, into, kind)
