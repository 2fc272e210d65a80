"""Monte-Carlo direction samplers (port of `sail_tpu/core/samplers.py`,
the one sampler the slice uses)."""
from __future__ import annotations

import torch

from ..constants import PI
from .vecmath import Vec3


def cosine_hemisphere(u1, u2) -> Vec3:
    """Cosine-weighted hemisphere (+z) direction."""
    r = torch.sqrt(u1)
    angle = 2.0 * PI * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=1e-12))
    return Vec3(r * torch.cos(angle), r * torch.sin(angle), z)
