"""A frozen copy of the port's plain PyTorch path tracer: the scene classes
and their packing, the counter-based RNG, the masked bounce loop, the
display filters and the edge terms, each as `sail_tpu_torch` held it when
this benchmark was written, with no CUDA kernel (the straddle rays go
through the plain integrator, the penumbra term through its plain sum).
It is the benchmark's reference: it never changes with the program, and it
imports nothing of it.  The subpackages keep the program's layout so that
a reader can set each file beside the module it was copied from."""

from .constants import MAX_BOUNCES
from .scene.geometry import (Cone, Cornellbox, Cube, Cylinder, Disk,
                             Hyperboloid, Paraboloid, Rectangle, Sphere)
from .scene.light import AreaLight, PointLight, SpotLight
from .scene.material import Glass, Matte, Metal, Mirror
from .scene.scene import Camera, Scene
from .scene.texture import (UV, Bilerp, Checkerboard, Checkerboard2, Mix,
                            ScaleT, UniformColor)

Scale = ScaleT
