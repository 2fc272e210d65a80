"""BSDFs of the slice: Matte (Lambertian / Oren–Nayar) and Mirror.

Port of the matching part of `sail_tpu/ops/bsdf.py`.  All functions work in
the local shading frame (z = shading normal); branches are masks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..core import samplers
from ..core import vecmath as vm
from ..core.vecmath import Vec3

_EPS = C.EPSILON


class BSDFSample(NamedTuple):
    wi: Vec3            # sampled direction, local frame
    weight: Vec3        # f * |cos θi| / pdf  (path throughput multiplier)
    f_nee: Vec3         # BSDF value for light-sampling (0 for specular)
    is_specular: torch.Tensor  # int32 0/1 per ray


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
                          torch.clamp(d_cos, min=0.0), 0.0)
    aci = vm.abs_cos_theta(wi)
    aco = vm.abs_cos_theta(wo)
    wi_steeper = aci > aco
    sin_alpha = torch.where(wi_steeper, sin_to, sin_ti)
    tan_beta = torch.where(wi_steeper, sin_ti / torch.clamp(aci, min=1e-7),
                           sin_to / torch.clamp(aco, min=1e-7))
    on = r * (C.INV_PI * (a + b * max_cos * sin_alpha * tan_beta))
    return vm.where(sigma < _EPS, lam, on)


def matte_sample(kd, sigma, sc: Vec3, u1, u2, wo: Vec3) -> BSDFSample:
    wi = samplers.cosine_hemisphere(u1, u2)
    # Sampled below the horizon ⇒ pdf 0 ⇒ zero weight (mask, not NaN).
    same = vm.same_hemisphere(wo, wi)
    pdf = torch.where(same, vm.abs_cos_theta(wi) * C.INV_PI, 0.0)
    f = matte_f(kd, sigma, sc, wo, wi)
    w = f * torch.where(pdf > 0.0,
                        vm.abs_cos_theta(wi) / torch.clamp(pdf, min=1e-20), 0.0)
    return BSDFSample(wi, w, f, torch.zeros(wo.shape, dtype=torch.int32,
                                            device=wo.z.device))


def mirror_sample(kr, sc: Vec3, wo: Vec3) -> BSDFSample:
    wi = Vec3(-wo.x, -wo.y, wo.z)
    weight = sc * kr  # noop Fresnel: f = R/|cos|, pdf = 1 ⇒ weight = R
    shape = wo.shape
    return BSDFSample(wi, weight, vm.zeros_vec(shape, wo.z),
                      torch.ones(shape, dtype=torch.int32, device=wo.z.device))
