"""sail_tpu_torch — the differentiable path tracer on PyTorch and CUDA (H100).

A port of `sail_tpu` (JAX on a TPU), which stays beside it as the
reference.  This package imports torch and never jax.  It covers the
serving path — `Renderer.update` → `render_spp` → `output` with every
display filter, the lazy G-buffer and the selection overlay, checkpoints,
picking, dragging and the orbit `Control` — and the gradient path
(`ops.cuda.megakernel.render_image_fast`) for scenes of every shape
category, in any number, with every material (matte, mirror, metal, glass)
and texture category and every light (area lights over any shape but a
Cornell box, point and spot lights); on a CUDA device `render_spp` is one
launch of the hand-written K1 megakernel (`csrc/megakernel.cu`).  A
render or a train step splits over a mesh of ranks (`parallel/`: several
ranks on one card, or processes joined by torch.distributed), and
`ElasticRenderer` finishes a render on the ranks left after a failure.
Its top-level names are the JAX package's.
"""

from . import constants
from .constants import MAX_BOUNCES
from .core.camera import CameraParams, generate_rays, make_camera
from .core.vecmath import Vec3, vec3
from .scene.geometry import (Cone, Cornellbox, Cube, Cylinder, Disk,
                             Hyperboloid, Object3D, Paraboloid, Rectangle,
                             Sphere)
from .scene.light import AreaLight, Light, PointLight, SpotLight
from .scene.material import Glass, Material, Matte, Metal, Mirror
from .scene.scene import Camera, PackedScene, Scene, SceneStatic
from .scene.texture import (UV, Bilerp, Checkerboard, Checkerboard2, Color,
                            Mix, ScaleT, Texture, UniformColor)
from .utils.matrix import Matrix, Vector

# The texture's reference name; `ScaleT` keeps clear of `Matrix.Scale`.
Scale = ScaleT

__all__ = [
    "constants", "MAX_BOUNCES",
    "Vec3", "vec3", "CameraParams", "make_camera", "generate_rays",
    "Scene", "Camera", "PackedScene", "SceneStatic",
    "Object3D", "Cube", "Sphere", "Rectangle", "Cone", "Cylinder", "Disk",
    "Hyperboloid", "Paraboloid", "Cornellbox",
    "Material", "Matte", "Mirror", "Metal", "Glass",
    "Light", "AreaLight", "PointLight", "SpotLight",
    "Texture", "UniformColor", "Checkerboard", "Checkerboard2", "Bilerp",
    "Mix", "ScaleT", "Scale", "UV", "Color",
    "Matrix", "Vector",
    "Renderer", "Control", "ElasticRenderer",
]


def __getattr__(name):
    # The renderer pulls in the integrator and the kernel wrapper; keep
    # `import sail_tpu_torch` light for scene building.
    if name == "Renderer":
        from .render.renderer import Renderer
        return Renderer
    if name == "Control":
        from .render.control import Control
        return Control
    if name == "ElasticRenderer":
        from .parallel.elastic import ElasticRenderer
        return ElasticRenderer
    raise AttributeError(f"module 'sail_tpu_torch' has no attribute {name!r}")
