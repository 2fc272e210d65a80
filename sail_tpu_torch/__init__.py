"""sail_tpu_torch — the differentiable path tracer on PyTorch and CUDA (H100).

A port of `sail_tpu` (JAX on a TPU), which stays beside it as the
reference.  This package imports torch and never jax.  It covers the forward
serving path — `Renderer.update` → `render_spp` → `output` — and the
gradient path (`ops.cuda.megakernel.render_image_fast`) for scenes of every
shape category, in any number, with every material (matte, mirror, metal,
glass) and texture category and rectangle area lights; on a CUDA device
`render_spp` is one launch of the hand-written K1 megakernel
(`csrc/megakernel.cu`).
"""

from . import constants
from .constants import MAX_BOUNCES
from .core.vecmath import Vec3
from .scene.geometry import (Cone, Cornellbox, Cube, Cylinder, Disk,
                             Hyperboloid, Object3D, Paraboloid, Rectangle,
                             Sphere)
from .scene.light import AreaLight, Light
from .scene.material import Glass, Material, Matte, Metal, Mirror
from .scene.scene import Camera, Scene, SceneStatic
from .scene.texture import (UV, Bilerp, Checkerboard, Checkerboard2, Color,
                            Mix, ScaleT, Texture, UniformColor)

__all__ = [
    "constants", "MAX_BOUNCES", "Vec3",
    "Scene", "Camera", "SceneStatic",
    "Object3D", "Sphere", "Rectangle", "Cornellbox", "Cube", "Cone",
    "Cylinder", "Disk", "Hyperboloid", "Paraboloid",
    "Material", "Matte", "Mirror", "Metal", "Glass", "Light", "AreaLight",
    "Texture", "UniformColor", "Checkerboard", "Checkerboard2", "Bilerp",
    "Mix", "ScaleT", "UV", "Color", "Renderer",
]


def __getattr__(name):
    # The renderer pulls in the integrator and the kernel wrapper; keep
    # `import sail_tpu_torch` light for scene building.
    if name == "Renderer":
        from .render.renderer import Renderer
        return Renderer
    raise AttributeError(f"module 'sail_tpu_torch' has no attribute {name!r}")
