"""Per-ray material dispatch over the scene's material rows (port of
`sail_tpu/ops/materials.py`): every row's sample is computed and selected
by the ray's row mask; a metal or glass row samples the distribution its
variant names (TROWBRIDGE_REITZ where the variant is 0)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..core import vecmath as vm
from ..core.vecmath import Vec3
from . import bsdf


class MaterialSample(NamedTuple):
    wi: Vec3             # local frame
    weight: Vec3         # f·|cosθi|/pdf
    f_nee: Vec3          # BSDF value for NEE (zero for non-matte)
    is_matte: torch.Tensor  # int32 0/1
    is_specular: torch.Tensor  # int32 0/1


def sample_material(materials: tuple, static, mat_row, sc: Vec3,
                    u1, u2, u_lobe, wo: Vec3, into) -> MaterialSample:
    shape = wo.shape
    zero = vm.zeros_vec(shape, wo.z)
    izero = torch.zeros(shape, dtype=torch.int32, device=wo.z.device)
    out = MaterialSample(zero, zero, zero, izero, izero)
    for row, (cat, p) in enumerate(zip(static.material_categories, materials)):
        mask = mat_row == row
        kind = static.material_variants[row] or C.TROWBRIDGE_REITZ
        if cat == C.MATTE:
            s = bsdf.matte_sample(p.kd, p.sigma, sc, u1, u2, wo)
        elif cat == C.MIRROR:
            s = bsdf.mirror_sample(p.kr, sc, wo)
        elif cat == C.METAL:
            s = bsdf.metal_sample(p, sc, u1, u2, wo, kind=kind)
        elif cat == C.GLASS:
            s = bsdf.glass_sample(p, sc, u1, u2, u_lobe, wo, into, kind=kind)
        else:  # refused earlier by scene.check_supported
            raise ValueError(f"unknown material category {cat}")
        out = MaterialSample(
            vm.where(mask, s.wi, out.wi),
            vm.where(mask, s.weight, out.weight),
            vm.where(mask, s.f_nee, out.f_nee),
            torch.where(mask, int(cat == C.MATTE), out.is_matte),
            torch.where(mask, s.is_specular, out.is_specular),
        )
    return out


def eval_matte_f(materials: tuple, static, mat_row, sc: Vec3,
                 wo: Vec3, wi: Vec3) -> Vec3:
    """Matte BSDF value at an arbitrary direction (weights NEE at the true
    light direction)."""
    f = vm.zeros_vec(wo.shape, wo.z)
    for row, (cat, p) in enumerate(zip(static.material_categories, materials)):
        if cat != C.MATTE:
            continue
        mask = (mat_row == row) & vm.same_hemisphere(wo, wi)
        f = vm.where(mask, bsdf.matte_f(p.kd, p.sigma, sc, wo, wi), f)
    return f
