"""Monte-Carlo direction and point samplers (port of
`sail_tpu/core/samplers.py`)."""
from __future__ import annotations

import torch

from ..constants import PI, PI_OVER_2, PI_OVER_4
from .vecmath import Vec3, clip


def uniform_sphere(u1, u2) -> Vec3:
    """Uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(clip(1.0 - z * z, 1e-12))
    angle = 2.0 * PI * u2
    return Vec3(r * torch.cos(angle), r * torch.sin(angle), z)


def cosine_hemisphere(u1, u2) -> Vec3:
    """Cosine-weighted hemisphere (+z) direction."""
    r = torch.sqrt(u1)
    angle = 2.0 * PI * u2
    z = torch.sqrt(clip(1.0 - u1, 1e-12))
    return Vec3(r * torch.cos(angle), r * torch.sin(angle), z)


def uniform_disk(u1, u2):
    """Uniform point (x, y) on the unit disk (polar mapping)."""
    r = torch.sqrt(u1)
    theta = 2.0 * PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def concentric_disk(u1, u2):
    """Concentric (Shirley) mapping of the unit square onto the unit disk.
    The divisions read a 1e-20 in place of a 0 denominator (where the other
    branch is taken), so no lane divides by 0."""
    uo = 2.0 * u1 - 1.0
    vo = 2.0 * u2 - 1.0
    at_origin = (uo == 0.0) & (vo == 0.0)
    use_u = torch.abs(uo) > torch.abs(vo)
    uo_safe = torch.where(uo == 0.0, 1e-20, uo)
    vo_safe = torch.where(vo == 0.0, 1e-20, vo)
    r = torch.where(use_u, uo, vo)
    theta = torch.where(use_u, (vo / uo_safe) * PI_OVER_4,
                        PI_OVER_2 - (uo / vo_safe) * PI_OVER_4)
    x = torch.where(at_origin, 0.0, r * torch.cos(theta))
    y = torch.where(at_origin, 0.0, r * torch.sin(theta))
    return x, y


def uniform_cone(u1, u2, cos_theta_max) -> Vec3:
    """Uniform direction in the +z cone of half-angle acos(cos_theta_max)."""
    ct = (1.0 - u1) + u1 * cos_theta_max
    st = torch.sqrt(clip(1.0 - ct * ct, 1e-12))
    phi = 2.0 * PI * u2
    return Vec3(torch.cos(phi) * st, torch.sin(phi) * st, ct)


def uniform_triangle(u1, u2):
    """Uniform barycentric coordinates (b0, b1) on a triangle."""
    su0 = torch.sqrt(u1)
    return 1.0 - su0, u2 * su0
