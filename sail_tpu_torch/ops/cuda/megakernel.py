"""The render megakernels, K1 (forward) and K2 (backward): wrappers, launch
counts, plain versions, and the autograd Functions that join them.

K1 replaces `render_block_pallas` (`sail_tpu/ops/pallas/megakernel.py:159`),
its many-object form included (the batched winner-fold, whose order the
scene table's rows follow, and the opt-in cluster cull, `cull=True`); its
kernel is `csrc/megakernel.cu`.  K2 replaces `render_grad_block_pallas`
(`megakernel.py:262`); its kernels are `csrc/megakernel_grad.cu` (the
per-pixel path adjoint, one row of block partials per thread block) and
`csrc/reduce_grad_rows.cu`, a second small pass that sums the rows in a
fixed order.  Both are CUDA C++
for sm_90a (the sources' headers say what bounds them and how the design
answers), built by `utils/build.py` and bound through plain C entry points
with ctypes.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; it never falls back from one to the other.
`render_block.launches`, `render_grad_block.launches` (K2, launched by
`render_grad_rows`) and `reduce_grad_rows.launches` count kernel launches
(`count_launch`: not those captured into a CUDA graph).
K1 is built for eight scene kinds (`render_block_kernel<ALL, CULL, MATS,
0>`, `csrc/render_block.cuh`; the last argument strips no phase), one
library.  K2 (`render_grad_kernel<CAP, ALL, MATS, 0, MIN_BLOCKS, LIGHTS>`,
`csrc/render_grad.cuh`) has seventeen builds (`GRAD_BUILDS`), one library
each, compiled the first time a call needs it: where each thread keeps its
gradient (CAP: in shared memory up to SHARED_GRAD_MAX_PARAMS parameters,
else in a local array of GRAD_CAPS floats), MATS, configs 1-2's kind at two
blocks per SM, and LIGHTS at every CAP for a light other than AREA over a
RECTANGLE.  `grad_build` alone decides which build a scene runs; the
numbers it decides with are defined here and given to nvcc as defines
(`GradBuild.defines`).

`render_tile_fast` is the JAX package's `custom_vjp`s
(`megakernel.py:497-569`) as one `torch.autograd.Function`: forward K1,
backward K2; `render_image_fast` is it over the whole image, times 1/spp.

KR (`trace_rays`, `csrc/trace_rays.cu`) traces a flat batch of given rays
with K1's own per-bounce loop: the edge terms' straddle rays
(`diff/boundary.py`), which the JAX package leaves to its XLA integrator
inside the jitted step.  It replaces no TPU kernel; `trace_rays.launches`
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import operator
from typing import NamedTuple

import torch

from ... import constants as C
from ...core.vecmath import Vec3
from ...ops import intersect as isect
from ...render import integrator
from ...scene.scene import Offsets, SceneStatic, param_offsets, unflatten
from ...utils import build

_SOURCE = "megakernel"
_GRAD_SOURCE = "megakernel_grad"
_REDUCE_SOURCE = "reduce_grad_rows"
_RAYS_SOURCE = "trace_rays"


def _int32(v) -> int:
    """A Python int as the int32 the kernel takes (wrapping, like JAX's)."""
    return (operator.index(v) + (1 << 31)) % (1 << 32) - (1 << 31)


def count_launch(wrapper) -> None:
    """One launch more on `wrapper.launches`, unless the current stream is
    capturing a CUDA graph: a capture launches nothing, and the graph's
    replays are not the wrapper's calls."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


class Table(NamedTuple):
    """The kernels' int32 scene table and what the C entries are told of
    it."""
    ints: tuple        # the table (path.cuh `make_scene`)
    offsets: Offsets   # parameter offsets
    order: tuple       # scene index of each object row: the fold order
    n_plain: int       # rows of small categories, before the groups
    n_groups: int      # batched groups
    n_clusters: int    # cull clusters over all groups
    all_shapes: bool   # a shape other than the benchmark scenes' three, or
    #                    `lights`: K1's and K2's ALL builds
    materials: bool    # a material beyond matte and mirror, or a texture
    #                    beyond a uniform color
    n_frames: int      # rows up to the last rectangle: K1 stages their frames
    lights: bool       # a light other than AREA over a RECTANGLE: K2's
    #                    LIGHTS builds


# The shapes K1's smaller build takes (path.cuh's `ALL`): those of the
# benchmark scenes; a light other than AREA over a RECTANGLE takes the ALL
# build too (K1 compiles the other lights only there; K2 in its LIGHTS
# builds).  The materials and textures the kernels' smaller build
# takes (path.cuh's `MATS`): those of configs 1 and 2.
_FEW_SHAPES = frozenset((C.SPHERE, C.RECTANGLE, C.CORNELLBOX))
_FEW_MATERIALS = frozenset((C.MATTE, C.MIRROR))
# The fewest cull clusters at which `render_block` culls by itself: the
# many-object sweep (chip_smoke.py phase 5, 512² x 8 spp x 3 bounces, an
# H100) measured the cull 3-11% slower on 16 spheres (2 clusters), 5%
# faster on 32 (4 clusters) and 20-25% faster on 64 (8 clusters).
AUTO_CULL_CLUSTERS = 4


@functools.lru_cache(maxsize=64)
def scene_table(static: SceneStatic) -> Table:
    """The kernels' int32 scene table.  Object rows (category, param offset,
    material row, texture row, emissive, scene index) come in the
    closest-hit fold order of `intersect.fold_groups`; then (first row,
    count) per batched group, (category, offset) per material and texture
    row, and (category, object row, offset) per light, the object row -1
    for a light with no object (POINT, SPOT).  Raises for structure outside
    the slice."""
    off = param_offsets(static)
    plain, batched = isect.fold_groups(static)
    order = tuple(plain) + tuple(i for _, idxs in batched for i in idxs)
    row_of = {i: r for r, i in enumerate(order)}
    table = []
    for i in order:
        table += [static.object_categories[i], off.objects[i],
                  static.object_mat_rows[i], static.object_tex_rows[i],
                  int(static.object_emissive[i]), i]
    first = len(plain)
    for _, idxs in batched:
        table += [first, len(idxs)]
        first += len(idxs)
    for cat, o, var in zip(static.material_categories, off.materials,
                           static.material_variants):
        table += [cat, o, var or C.TROWBRIDGE_REITZ]
    for cat, o in zip(static.texture_categories, off.textures):
        table += [cat, o]
    for cat, obj, o in zip(static.light_categories, static.area_light_objects,
                           off.lights):
        table += [cat, row_of[obj] if cat == C.AREA else -1, o]
    n_clusters = sum(-(-len(idxs) // isect.CLUSTER) for _, idxs in batched)
    n_frames = 1 + max((r for r, i in enumerate(order)
                        if static.object_categories[i] == C.RECTANGLE),
                       default=-1)
    lights = any(cat != C.AREA or static.object_categories[obj] != C.RECTANGLE
                 for cat, obj in zip(static.light_categories,
                                     static.area_light_objects))
    return Table(tuple(table), off, order, len(plain), len(batched),
                 n_clusters,
                 lights or not _FEW_SHAPES.issuperset(
                     static.object_categories),
                 not (_FEW_MATERIALS.issuperset(static.material_categories)
                      and set(static.texture_categories) <= {C.UNIFORM_COLOR}),
                 n_frames, lights)


@functools.lru_cache(maxsize=64)
def _device_table(static: SceneStatic, device: torch.device) -> torch.Tensor:
    """The scene table on `device`, copied there once per scene structure,
    so a render call copies nothing from the host."""
    return torch.tensor(scene_table(static).ints, dtype=torch.int32,
                        device=device)


# K2's numbers, each defined here once and given to nvcc as a define
# (`GradBuild.defines`).  Its thread block (columns, rows) and the most
# bounces a thread stores.
GRAD_BLOCK = (16, 16)
MAX_GRAD_BOUNCES = 8
# CAP of the build that keeps each thread's gradient in its column of a
# block-wide (n_params, threads) array in dynamic shared memory; any other
# CAP is a local array of CAP floats, of the smallest of GRAD_CAPS that
# holds the scene (352: every scene of a few objects; 4,096: the 256-sphere
# scene, 13 N + 47 = 3,375 parameters).
SHARED_GRAD = 0
GRAD_CAPS = (352, 1024, 4096)
# The shared build takes (threads + warps) x n_params floats, the columns
# and the warps' partial sums: within the 232,448 bytes a block may have on
# Hopper, 220 parameters.  Two blocks fit on one SM (233,472 bytes, of
# which each resident block reserves 1 KB) up to 109: configs 1-2's kind
# (spheres, rectangles and a Cornell box; matte, mirror and uniform colors;
# path.cuh's ALL and MATS false) up to that size runs a shared build of its
# own at `__launch_bounds__(threads, 2)` (at most 128 registers, some
# spilled), which config 2 measured 17% faster than at (threads, 1) (an
# H100).  Every other build takes one block per SM, and ALL: every shape.
MAX_BLOCK_SMEM, SM_SMEM, BLOCK_RESERVED_SMEM = 232448, 233472, 1024
_GRAD_THREADS = GRAD_BLOCK[0] * GRAD_BLOCK[1]
_GRAD_PARAM_BYTES = 4 * (_GRAD_THREADS + _GRAD_THREADS // 32)
SHARED_GRAD_MAX_PARAMS = MAX_BLOCK_SMEM // _GRAD_PARAM_BYTES
TWO_BLOCK_MAX_PARAMS = (SM_SMEM // 2 - BLOCK_RESERVED_SMEM) \
    // _GRAD_PARAM_BYTES


def _cbool(b: bool) -> str:
    return "true" if b else "false"


class GradBuild(NamedTuple):
    """One build of K2, `render_grad_kernel<cap, all_shapes, materials, 0,
    min_blocks, lights>`: `csrc/megakernel_grad.cu` compiled with
    `defines`, a library of its own."""
    cap: int           # SHARED_GRAD or a local array's floats
    all_shapes: bool   # path.cuh's ALL: every shape's code
    materials: bool    # path.cuh's MATS: metal, glass, the uv textures
    min_blocks: int    # the launch bound: blocks per SM
    lights: bool       # the lights beyond AREA over a RECTANGLE

    @property
    def max_params(self) -> int:
        """The most parameters the build takes."""
        if self.min_blocks == 2:
            return TWO_BLOCK_MAX_PARAMS
        return SHARED_GRAD_MAX_PARAMS if self.cap == SHARED_GRAD \
            else self.cap

    @property
    def kernel(self) -> str:
        """The kernel's name as the profiler and `build.kernel_name` give
        it."""
        return (f"render_grad_kernel<{self.cap}, {_cbool(self.all_shapes)}, "
                f"{_cbool(self.materials)}, 0, {self.min_blocks}, "
                f"{_cbool(self.lights)}>")

    @property
    def defines(self) -> tuple:
        """The nvcc defines that make this build of K2's sources."""
        return (f"GRAD_CAP={self.cap}", f"GRAD_ALL={_cbool(self.all_shapes)}",
                f"GRAD_MATS={_cbool(self.materials)}",
                f"GRAD_MIN_BLOCKS={self.min_blocks}",
                f"GRAD_LIGHTS={_cbool(self.lights)}",
                f"GRAD_MAX_PARAMS={self.max_params}",
                f"GRAD_BLOCK_X={GRAD_BLOCK[0]}",
                f"GRAD_BLOCK_Y={GRAD_BLOCK[1]}",
                f"SHARED_GRAD={SHARED_GRAD}",
                f"MAX_GRAD_BOUNCES={MAX_GRAD_BOUNCES}")


def grad_build(n_params: int, all_shapes: bool, materials: bool,
               lights: bool) -> GradBuild:
    """The K2 build a scene of `n_params` parameters and this kind
    (`scene_table`'s flags) runs: the gradient in shared memory up to
    SHARED_GRAD_MAX_PARAMS, else in the smallest of GRAD_CAPS that holds
    it; configs 1-2's kind up to TWO_BLOCK_MAX_PARAMS at two blocks per SM
    without ALL, every other scene at one with ALL; MATS and LIGHTS as the
    scene.  Raises above the largest array."""
    if n_params <= SHARED_GRAD_MAX_PARAMS:
        cap = SHARED_GRAD
    else:
        cap = next((c for c in GRAD_CAPS if n_params <= c), None)
        if cap is None:
            raise ValueError(f"K2 takes at most {GRAD_CAPS[-1]} scene "
                             f"parameters; the scene has {n_params}")
    if cap == SHARED_GRAD and n_params <= TWO_BLOCK_MAX_PARAMS \
            and not (all_shapes or materials or lights):
        return GradBuild(SHARED_GRAD, False, False, 2, False)
    return GradBuild(cap, True, bool(materials), 1, bool(lights))


# Every K2 build, each once, as `grad_build` gives them: the two-block
# build, then by LIGHTS, CAP and MATS.
GRAD_BUILDS = tuple(sorted(
    {grad_build(n, *kind) for n in (1, *GRAD_CAPS)
     for kind in itertools.product((False, True), repeat=3)},
    key=lambda b: (b.all_shapes, b.lights, b.cap, b.materials)))


def _check_block(params, static, height, width, spp, max_bounces, row0,
                 image_height):
    """Raise on what the kernels do not take; return the param offsets."""
    if not (isinstance(params, torch.Tensor) and params.dtype == torch.float32
            and params.dim() == 1 and params.is_contiguous()):
        raise TypeError("params must be a contiguous 1-D float32 tensor")
    if min(height, width, spp) < 1 or max_bounces < 0 or row0 < 0 \
            or row0 + height > image_height:
        raise ValueError(f"bad block: {height}x{width}, spp={spp}, "
                         f"max_bounces={max_bounces}, rows {row0}+{height} "
                         f"of {image_height}")
    off = scene_table(static).offsets   # raises NotImplementedError off the slice
    if params.numel() != off.size:
        raise ValueError(f"scene needs {off.size} params, got {params.numel()}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no megakernel for device {params.device}")
    return off


def render_block_plain(params: torch.Tensor, static: SceneStatic, height: int,
                       width: int, spp: int, seed, sample0,
                       max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
                       image_height: int = None, cull: bool = False,
                       early_exit: bool = False) -> Vec3:
    """The plain PyTorch version of K1 on any device: spp-SUM of radiance
    of an H×W block whose first row is global row `row0`."""
    return integrator.render_sum(unflatten(params, static), static, height,
                                 width, spp, seed, sample0, max_bounces,
                                 row0=row0, image_height=image_height,
                                 cull=cull, early_exit=early_exit)


def _bind(lib, name: str, argtypes):
    """The C entry point `name` of a library (`build.load`'s: a source name
    or a (name, defines) pair), built at first use."""
    fn = getattr(build.load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# The C entries' argument types, in their order (csrc/*.cu `extern "C"`).
K1_ARGTYPES = [_PTR] * 2 + [_INT] * 11 + [_PTR] * 3 + [_INT] * 8 + [_PTR]
K2_ARGTYPES = [_PTR] * 2 + [_INT] * 11 + [_PTR] * 4 + [_INT] * 8 + [_PTR]
REDUCE_ARGTYPES = [_PTR, _INT, _INT, _PTR, _PTR]


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _bind(_SOURCE, "sail_render_block", K1_ARGTYPES)
    return fn, build.load(_SOURCE).sail_max_clusters()


def _counts(static: SceneStatic):
    """Objects, rows before the groups, batched groups, material rows,
    texture rows, lights: the table's sections."""
    t = scene_table(static)
    return (len(static.object_categories), t.n_plain, t.n_groups,
            len(static.material_categories), len(static.texture_categories),
            len(static.light_categories))


def cull_clusters(static: SceneStatic, cull: bool = None,
                  max_clusters: int = None) -> int:
    """The cluster bound boxes K1 builds for `render_block(cull=)`: all of
    the scene's, or 0 (no cull).  `cull=None` culls from AUTO_CULL_CLUSTERS
    clusters up to the `max_clusters` the kernel takes; `cull=True` above
    that raises."""
    n = scene_table(static).n_clusters
    if cull is None:
        cull = AUTO_CULL_CLUSTERS <= n and (max_clusters is None
                                            or n <= max_clusters)
    if cull and max_clusters is not None and n > max_clusters:
        raise ValueError(f"the cull takes at most {max_clusters} clusters of "
                         f"{isect.CLUSTER} objects; the scene has {n}")
    return n if cull else 0


def render_block(params: torch.Tensor, static: SceneStatic, height: int,
                 width: int, spp: int, seed, sample0,
                 max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
                 image_height: int = None, cull: bool = None,
                 early_exit: bool = False) -> Vec3:
    """Forward render of an H×W block: the SUM of `spp` samples (divide by
    spp for the mean), as a Vec3 of (H, W) float32 tensors on params' device.

    `row0`/`image_height`: the block's global first row and the full image
    height, so a tile draws the same RNG streams and camera rays as the
    whole image.  `cull`: each ray skips the clusters of CLUSTER
    consecutive objects of a batched group whose bound box it cannot reach
    (`render_block_pallas(cull=)`); the image is the same.  By default
    (None) the kernel culls where the scene has AUTO_CULL_CLUSTERS clusters
    or more (and no more than the kernel takes), and the plain version (the
    CPU) does not cull.  `early_exit` (K1-ee, `render_block_pallas(
    early_exit=True)`): the plain version skips the bounces no ray of its
    batch needs; K1 needs no other build for it, as each thread already
    starts its next sample when its path misses or dies, a finer form of
    the TPU kernel's tile-level skip.  Either way the image is the same
    bit for bit."""
    image_height = height if image_height is None else image_height
    if params.requires_grad and torch.is_grad_enabled():
        raise TypeError(
            "render_block gives no gradient: render through render_image_fast "
            "or render_tile_fast to differentiate, or detach params")
    off = _check_block(params, static, height, width, spp, max_bounces, row0,
                       image_height)

    if params.device.type == "cpu":
        return render_block_plain(params, static, height, width, spp, seed,
                                  sample0, max_bounces, row0, image_height,
                                  bool(cull), early_exit)

    dev = params.device
    table_t = _device_table(static, dev)
    fn, max_clusters = _entry()
    table = scene_table(static)
    n_clusters = cull_clusters(static, cull, max_clusters)
    out = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):   # the C launch goes to the current device
        err = fn(
            params.data_ptr(), table_t.data_ptr(), *_counts(static),
            off.camera, int(table.all_shapes), int(table.materials),
            n_clusters, table.n_frames, out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), height, width, spp,
            _int32(seed), _int32(sample0), max_bounces, row0, image_height,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {err}")
    count_launch(render_block)
    return Vec3(out[0], out[1], out[2])


render_block.launches = 0


# ------------------------------------------------------------------- KR ----

KR_ARGTYPES = [_PTR] * 2 + [_INT] * 8 + [_PTR] * 12 + [_INT] * 3 + [_PTR]


@functools.lru_cache(maxsize=None)
def _rays_entry():
    return _bind(_RAYS_SOURCE, "sail_trace_rays", KR_ARGTYPES)


def _ray_ints(v, shape, device) -> torch.Tensor:
    """A number or an integer tensor as a contiguous int32 tensor of
    `shape` on `device`, wrapped as the kernel's uint32; a number is
    filled in on the device (no host copy)."""
    if not isinstance(v, torch.Tensor):
        return torch.full(shape, _int32(v), dtype=torch.int32, device=device)
    t = v.to(device=device, dtype=torch.int64)
    t = (t + (1 << 31)) % (1 << 32) - (1 << 31)
    return t.to(torch.int32).broadcast_to(shape).contiguous()


def trace_rays(params: torch.Tensor, static: SceneStatic, ro: Vec3, rd: Vec3,
               noise, max_bounces: int = C.MAX_BOUNCES) -> Vec3:
    """The radiance of a batch of rays (`integrator.trace_rays` with a
    PixelNoise: `noise.seed`, each ray's `noise.sample` and its pixel
    `noise.ii`, `noise.jj`, all broadcast to the rays' shape), as a Vec3 of
    float32 tensors of that shape.  `params` is the flat scene tensor.  A
    CPU tensor runs the plain integrator; a CUDA tensor launches KR
    (`csrc/trace_rays.cu`), the plain version's value bit for bit.
    `trace_rays.launches` counts its launches."""
    if not (isinstance(params, torch.Tensor) and params.dtype == torch.float32
            and params.dim() == 1):
        raise TypeError("params must be a 1-D float32 tensor")
    if max_bounces < 0:
        raise ValueError(f"max_bounces must be >= 0, got {max_bounces}")
    if params.device.type == "cpu":
        return integrator.trace_rays(unflatten(params, static), static, ro,
                                     rd, noise, max_bounces)
    if not params.is_cuda:
        raise ValueError(f"no KR for device {params.device}")
    off = scene_table(static).offsets
    if params.numel() != off.size:
        raise ValueError(f"scene needs {off.size} params, got "
                         f"{params.numel()}")
    dev = params.device
    shape = torch.broadcast_shapes(ro.shape, rd.shape, noise.ii.shape,
                                   noise.jj.shape)
    rays = []
    for c in (*ro, *rd):
        if not (c.dtype == torch.float32 and c.device == dev):
            raise TypeError(f"rays must be float32 tensors on {dev}")
        rays.append(c.broadcast_to(shape).contiguous().view(-1))
    ints = [_ray_ints(v, shape, dev).view(-1)
            for v in (noise.sample, noise.ii, noise.jj)]
    n = rays[0].numel()
    out = torch.zeros((3, n), dtype=torch.float32, device=dev)
    if n and max_bounces > 0:
        table = scene_table(static)
        params = params.contiguous()
        with torch.cuda.device(dev):
            err = _rays_entry()(
                params.data_ptr(), _device_table(static, dev).data_ptr(),
                *_counts(static), off.camera, table.n_frames,
                *(t.data_ptr() for t in rays + ints),
                *(out[c].data_ptr() for c in range(3)), n,
                _int32(noise.seed), max_bounces,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"KR launch failed: cudaError_t {err}")
        count_launch(trace_rays)
    return Vec3(*(out[c].view(shape) for c in range(3)))


trace_rays.launches = 0


# ------------------------------------------------------------------- K2 ----

def render_grad_block_plain(params: torch.Tensor, static: SceneStatic,
                            g: Vec3, height: int, width: int, spp: int, seed,
                            sample0, max_bounces: int = C.MAX_BOUNCES,
                            row0: int = 0, image_height: int = None
                            ) -> torch.Tensor:
    """The plain PyTorch version of K2 on any device: dL/d(params) for
    L = Σ_pixels g · (spp-SUM of radiance), by torch autograd through the
    plain integrator (checkpointed per sample), as a flat tensor in
    `jax.tree.leaves` order."""
    p = params.detach().requires_grad_()
    with torch.enable_grad():
        img = render_block_plain(p, static, height, width, spp, seed, sample0,
                                 max_bounces, row0, image_height)
        loss = (img.x * g.x + img.y * g.y + img.z * g.z).sum()
        (grad,) = torch.autograd.grad(loss, p)
    return grad


@functools.lru_cache(maxsize=None)
def _grad_entry(b: GradBuild):
    """The C entry of K2's build `b`, its library built at first use."""
    return _bind((_GRAD_SOURCE, b.defines), "sail_render_grad_block",
                 K2_ARGTYPES)


@functools.lru_cache(maxsize=None)
def _reduce_entry():
    return _bind(_REDUCE_SOURCE, "sail_reduce_grad_rows", REDUCE_ARGTYPES)


# The partials of K2's reduce: partial t sums rows t, t + 256, ... in order.
REDUCE_PARTIALS = 256


def reduce_grad_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2's reduce, on any device: for each
    parameter, REDUCE_PARTIALS partials, partial t the rows t, t + 256, ...
    added in row order to 0, then a halving tree (partial t += partial
    t + h for h = 128 ... 1).  The kernel's sum bit for bit: every add is
    one float32 add in the same order (the rows padded with +0, which
    changes no partial)."""
    n, width = rows.shape
    k = -(-n // REDUCE_PARTIALS)
    pad = rows.new_zeros((k * REDUCE_PARTIALS, width))
    pad[:n] = rows
    pad = pad.view(k, REDUCE_PARTIALS, width)
    part = rows.new_zeros((REDUCE_PARTIALS, width))
    for i in range(k):
        part = part + pad[i]
    h = REDUCE_PARTIALS // 2
    while h > 0:
        part = torch.cat((part[:h] + part[h:2 * h], part[2 * h:]))
        h //= 2
    return part[0]


def reduce_grad_rows(rows: torch.Tensor) -> torch.Tensor:
    """Sum the (n_blocks, n_params) partials K2 writes over blocks into one
    (n_params,) gradient in a fixed order (`reduce_grad_rows_plain`'s): K2's
    second pass on the card, its plain version for a CPU tensor."""
    if not (rows.dtype == torch.float32 and rows.dim() == 2
            and rows.is_contiguous()):
        raise TypeError("rows must be a contiguous 2-D float32 tensor")
    if rows.device.type == "cpu":
        return reduce_grad_rows_plain(rows)
    if not rows.is_cuda:
        raise ValueError(f"no reduce for device {rows.device}")
    out = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        err = _reduce_entry()(
            rows.data_ptr(), rows.shape[0], rows.shape[1], out.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 reduce launch failed: cudaError_t {err}")
    count_launch(reduce_grad_rows)
    return out


reduce_grad_rows.launches = 0


def render_grad_block(params: torch.Tensor, static: SceneStatic, g: Vec3,
                      height: int, width: int, spp: int, seed, sample0,
                      max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
                      image_height: int = None) -> torch.Tensor:
    """dL/d(params) for L = Σ_pixels g · image_sum, where image_sum is the
    spp-SUM `render_block` gives for the same arguments; `g` is a Vec3 of
    (H, W) float32 tensors on params' device.  Returns the flat gradient in
    `jax.tree.leaves` order.  Repeated calls give bit-identical results."""
    if params.device.type == "cpu":
        image_height = height if image_height is None else image_height
        _check_grad_block(params, static, g, height, width, spp, max_bounces,
                          row0, image_height)
        return render_grad_block_plain(params, static, g, height, width, spp,
                                       seed, sample0, max_bounces, row0,
                                       image_height)
    return reduce_grad_rows(render_grad_rows(
        params, static, g, height, width, spp, seed, sample0, max_bounces,
        row0, image_height))


def _check_grad_block(params, static, g, height, width, spp, max_bounces,
                      row0, image_height):
    """Raise on what K2 does not take; return the param offsets."""
    off = _check_block(params, static, height, width, spp, max_bounces, row0,
                       image_height)
    for c in g:
        if not (isinstance(c, torch.Tensor) and c.dtype == torch.float32
                and c.shape == (height, width) and c.is_contiguous()
                and c.device == params.device):
            raise TypeError(f"g must be three contiguous float32 "
                            f"({height}, {width}) tensors on {params.device}")
    return off


def render_grad_rows(params: torch.Tensor, static: SceneStatic, g: Vec3,
                     height: int, width: int, spp: int, seed, sample0,
                     max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
                     image_height: int = None) -> torch.Tensor:
    """K2's first pass on the card: the (n_blocks, n_params) partial
    gradients of its thread blocks (GRAD_BLOCK pixels each,
    row-major over the block grid), which `reduce_grad_rows` sums into
    `render_grad_block`'s result.  A row holds only its block's pixels, so
    a cotangent on one pixel of every block gives each of those pixels'
    own gradient.  Launches the build `grad_build` picks; counts on
    `render_grad_block.launches`."""
    image_height = height if image_height is None else image_height
    off = _check_grad_block(params, static, g, height, width, spp,
                            max_bounces, row0, image_height)
    table = scene_table(static)
    if not params.is_cuda:
        raise TypeError("render_grad_rows runs K2 on the card: params must "
                        "be a CUDA tensor")
    if max_bounces > MAX_GRAD_BOUNCES:
        raise ValueError(f"K2 takes at most {MAX_GRAD_BOUNCES} bounces; got "
                         f"{max_bounces}")
    grad_fn = _grad_entry(grad_build(off.size, table.all_shapes,
                                     table.materials, table.lights))
    dev = params.device
    bx, by = GRAD_BLOCK
    n_blocks = -(-width // bx) * -(-height // by)
    rows = torch.empty((n_blocks, off.size), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = grad_fn(
            params.data_ptr(), _device_table(static, dev).data_ptr(),
            *_counts(static), off.camera, off.size, int(table.all_shapes),
            int(table.materials), int(table.lights), g.x.data_ptr(),
            g.y.data_ptr(), g.z.data_ptr(), rows.data_ptr(), height, width,
            spp, _int32(seed), _int32(sample0), max_bounces, row0,
            image_height, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError_t {err}")
    count_launch(render_grad_block)
    return rows


render_grad_block.launches = 0


# ------------------------------------------------- autograd Functions ----

class _RenderTileFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, seed, sample0, row0, static, rows, width, spp,
                image_height, max_bounces):
        ctx.save_for_backward(params)
        ctx.args = (seed, sample0, row0, static, rows, width, spp,
                    image_height, max_bounces)
        return tuple(render_block(params, static, rows, width, spp, seed,
                                  sample0, max_bounces, row0=row0,
                                  image_height=image_height))

    @staticmethod
    def backward(ctx, gx, gy, gz):
        (params,) = ctx.saved_tensors
        (seed, sample0, row0, static, rows, width, spp, image_height,
         max_bounces) = ctx.args
        g = Vec3(*(c.contiguous() for c in (gx, gy, gz)))
        d = render_grad_block(params.detach(), static, g, rows, width, spp,
                              seed, sample0, max_bounces, row0=row0,
                              image_height=image_height)
        return (d,) + (None,) * 9


def render_image_fast(params: torch.Tensor, seed, static: SceneStatic,
                      height: int, width: int, spp: int,
                      max_bounces: int = C.MAX_BOUNCES) -> Vec3:
    """Mean image over `spp` samples through K1, differentiable in `params`
    through K2 (the same estimator: the backward re-traces the same paths
    with the same RNG): `render_tile_fast` over the whole image, times
    1/spp.  `seed` takes no gradient."""
    acc = render_tile_fast(params, seed, 0, 0, static, height, width, spp,
                           height, max_bounces)
    return Vec3(*(c * (1.0 / spp) for c in acc))


def render_tile_fast(params: torch.Tensor, seed, sample0, row0,
                     static: SceneStatic, rows: int, width: int, spp: int,
                     image_height: int,
                     max_bounces: int = C.MAX_BOUNCES) -> Vec3:
    """The spp-SUM of a `rows`×`width` block whose global first row is
    `row0`, inside an image `image_height` tall, through K1; differentiable
    in `params` through K2.  `seed`, `sample0` and `row0` take no
    gradient."""
    return Vec3(*_RenderTileFast.apply(params, seed, sample0, row0, static,
                                       rows, width, spp, image_height,
                                       max_bounces))
