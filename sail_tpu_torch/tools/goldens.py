"""Hold a render against a committed golden image of the JAX package
(`tests/goldens/*.npy`, made by `tools/make_goldens.py`: 64², 4 spp, seed 0,
the mean radiance as (H, W, 3)).

The JAX package rendered the goldens with XLA:CPU, which fuses
multiply-adds; the port's plain version and K1 (built `-fmad=false`) do not,
so a camera ray may differ from JAX's in its last bit.  Where a primary ray
grazes a sphere, |b² - 4ac| below GRAZE · b² (a few float32 ulps of the
discriminant), that bit decides hit or miss, and the pixel may differ by a
whole path.  `golden_check` holds every pixel at atol = rtol = 1e-4 and
excuses only such grazing pixels, by name.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..core.camera import rays_for_pixels
from ..core.rng import TAG_PIXEL_JITTER, PixelNoise
from ..render.integrator import pixel_grid
from ..scene.scene import unflatten

GRAZE = 1e-6
TOL = 1e-4


def grazing_pixels(params: torch.Tensor, static, height: int, width: int,
                   spp: int, seed: int = 0) -> set:
    """(row, col) of every pixel one of whose `spp` primary rays grazes a
    sphere of the scene (|b² - 4ac| < GRAZE · b², in float64)."""
    scene = unflatten(params.detach().cpu().double(), static)
    ii, jj = pixel_grid(height, width, 0, "cpu")
    hit = torch.zeros((height, width), dtype=torch.bool)
    for s in range(spp):
        noise = PixelNoise(seed, s, ii, jj)
        jx, jy, _ = noise.uniform3(0, TAG_PIXEL_JITTER)
        ro, rd = rays_for_pixels(scene.camera, ii.double(), jj.double(),
                                 height, width, jx.double(), jy.double())
        for cat, obj in zip(static.object_categories, scene.objects):
            if cat != C.SPHERE:
                continue
            o = ro - obj.center
            b = 2.0 * o.dot(rd)
            disc = b * b - 4.0 * rd.dot(rd) * (o.dot(o) - obj.radius ** 2)
            hit |= disc.abs() < GRAZE * b * b
    return {tuple(map(int, p)) for p in torch.nonzero(hit).tolist()}


def golden_check(img: np.ndarray, ref: np.ndarray, params: torch.Tensor,
                 static, spp: int, seed: int = 0) -> dict:
    """`img` against the golden `ref`, both (H, W, 3): the largest
    difference, the pixels outside atol = rtol = TOL, those of them whose
    primary ray grazes a sphere (excused) and the rest (`unexplained`,
    which a caller fails on), and the largest difference elsewhere."""
    d = np.abs(img.astype(np.float64) - ref)
    out = d > TOL + TOL * np.abs(ref)
    bad = {tuple(map(int, p)) for p in np.argwhere(out.any(-1))}
    graze = grazing_pixels(params, static, ref.shape[0], ref.shape[1], spp,
                           seed) if bad else set()
    keep = np.ones(ref.shape[:2], dtype=bool)
    for p in bad & graze:
        keep[p] = False
    return dict(max_abs=float(d.max()), outside=sorted(bad),
                excused=sorted(bad & graze), unexplained=sorted(bad - graze),
                max_abs_elsewhere=float(d[keep].max()))
