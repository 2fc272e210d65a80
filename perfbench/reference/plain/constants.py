"""Global constants of the PyTorch/CUDA port.

A copy of `sail_tpu/constants.py` (importing that module goes through the
`sail_tpu` package, which imports jax): category ids, epsilons and the bounce
budget of the reference renderer's `define.glsl`.  The CUDA megakernel
(`csrc/megakernel.cu`) repeats the ids and epsilons it needs; the two must
agree.
"""

MAX_DISTANCE = 1e5
MAX_BOUNCES = 5
EPSILON = 1e-5
ONE_MINUS_EPSILON = 0.9999
INF = 1e5

PI = 3.141592653589793
INV_PI = 0.3183098861837907
INV_2PI = 0.159154943091895
INV_4PI = 0.079577471545947
PI_OVER_2 = 1.570796326794896
PI_OVER_4 = 0.785398163397448
SQRT_2 = 1.414213562373095

# Shape categories (ref: const/define.glsl:18-26)
CUBE = 1
SPHERE = 2
RECTANGLE = 3
CONE = 4
CYLINDER = 5
DISK = 6
HYPERBOLOID = 7
PARABOLOID = 8
CORNELLBOX = 9

SHAPE_NAMES = {
    CUBE: "cube",
    SPHERE: "sphere",
    RECTANGLE: "rectangle",
    CONE: "cone",
    CYLINDER: "cylinder",
    DISK: "disk",
    HYPERBOLOID: "hyperboloid",
    PARABOLOID: "paraboloid",
    CORNELLBOX: "cornellbox",
}

# Light categories (ref: const/define.glsl:28-30)
AREA = 0
POINT = 1
SPOT = 2

# Material categories (ref: const/define.glsl:32-35)
MATTE = 1
MIRROR = 2
METAL = 3
GLASS = 4

# Texture categories (ref: const/define.glsl:37-44)
UNIFORM_COLOR = 0
CHECKERBOARD = 5
CHECKERBOARD2 = 7
BILERP = 8
MIXF = 9
SCALE = 10
UVF = 11

# Named colors (ref: const/define.glsl:46-51)
BLACK = (0.0, 0.0, 0.0)
WHITE = (1.0, 1.0, 1.0)
GREY = (0.5, 0.5, 0.5)
RED = (0.75, 0.25, 0.25)
BLUE = (0.25, 0.25, 0.75)
GREEN = (0.25, 0.75, 0.25)

# Fresnel types (ref: const/define.glsl:55-57)
FRESNEL_NOOP = 0
FRESNEL_CONDUCTOR = 1
FRESNEL_DIELECTRIC = 2

# Microfacet distribution types (ref: const/define.glsl:59-60)
BECKMANN = 1
TROWBRIDGE_REITZ = 2
