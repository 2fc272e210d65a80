"""Per-ray surface color (port of `sail_tpu/ops/textures.surface_color` for
UNIFORM_COLOR rows plus the Cornell-wall override)."""
from __future__ import annotations

from .. import constants as C
from ..core import vecmath as vm
from ..core.vecmath import Vec3


def surface_color(textures: tuple, static, tex_row, hit_p: Vec3, uv_u, uv_v,
                  sc_override: Vec3, use_override) -> Vec3:
    shape = uv_u.shape
    sc = vm.zeros_vec(shape, uv_u)   # C.BLACK where no row matches
    for row, (cat, params) in enumerate(zip(static.texture_categories,
                                            textures)):
        if cat != C.UNIFORM_COLOR:  # refused earlier by scene.check_supported
            raise NotImplementedError(f"texture category {cat}")
        sc = vm.where(tex_row == row, params.color.broadcast_to(shape), sc)
    return vm.where(use_override > 0, sc_override, sc)
