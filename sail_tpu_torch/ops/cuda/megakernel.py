"""The render megakernels, K1 (forward) and K2 (backward): wrappers, launch
counts, plain versions, and the autograd Functions that join them.

K1 replaces `render_block_pallas` (`sail_tpu/ops/pallas/megakernel.py:159`),
its many-object form included (the batched winner-fold, whose order the
scene table's rows follow, and the opt-in cluster cull, `cull=True`); its
kernel is `csrc/megakernel.cu`.  K2 replaces `render_grad_block_pallas`
(`megakernel.py:262`); its kernels are `csrc/megakernel_grad.cu` (the
per-pixel path adjoint, one row of block partials per thread block; with
`csrc/megakernel_grad_lights.cu`, a library of its own, for the lit
scenes of more than 352 parameters) and a second small pass that sums the
rows in a fixed order.  Both are CUDA C++
for sm_90a (the sources' headers say what bounds them and how the design
answers), built by `utils/build.py` and bound through plain C entry points
with ctypes.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; it never falls back from one to the other.
`render_block.launches`, `render_grad_block.launches` (K2, launched by
`render_grad_rows`) and `reduce_grad_rows.launches` count kernel launches.
K1 is built for eight scene kinds (`render_block_kernel<ALL, CULL, MATS,
0>`, `csrc/render_block.cuh`; the last argument strips no phase) and K2
(`render_grad_kernel<CAP, ALL, MATS, 0, MIN_BLOCKS>`,
`csrc/render_grad.cuh`) for where each thread keeps its gradient (CAP: in
shared memory up to SHARED_GRAD_MAX_PARAMS parameters, else in a local
array of GRAD_CAPS floats, `grad_build`), for MATS, for configs 1-2's
kind at two blocks per SM (the C entry's choice, `csrc/grad_build.h`;
`grad_launch_bound` reports it) and, for a light other than AREA over a
RECTANGLE, with LIGHTS at every CAP (those of LIGHTS_CAPS in
`csrc/megakernel_grad_lights.cu`); the table says which kind a scene
is.

`render_image_fast` / `render_tile_fast` are the JAX package's
`custom_vjp`s (`megakernel.py:497-569`) as `torch.autograd.Function`s:
forward K1, backward K2.

KR (`trace_rays`, `csrc/trace_rays.cu`) traces a flat batch of given rays
with K1's own per-bounce loop: the edge terms' straddle rays
(`diff/boundary.py`), which the JAX package leaves to its XLA integrator
inside the jitted step.  It replaces no TPU kernel; `trace_rays.launches`
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
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
_GRAD_LIGHTS_SOURCE = "megakernel_grad_lights"
_RAYS_SOURCE = "trace_rays"


def _int32(v) -> int:
    """A Python int as the int32 the kernel takes (wrapping, like JAX's)."""
    return (operator.index(v) + (1 << 31)) % (1 << 32) - (1 << 31)


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


def _bind(source: str, name: str, argtypes):
    """The C entry point `name` of csrc/<source>.cu (built at first use)."""
    fn = getattr(build.load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# The C entries' argument types, in their order (csrc/*.cu `extern "C"`).
K1_ARGTYPES = [_PTR] * 2 + [_INT] * 11 + [_PTR] * 3 + [_INT] * 8 + [_PTR]
K2_ARGTYPES = [_PTR] * 2 + [_INT] * 12 + [_PTR] * 4 + [_INT] * 8 + [_PTR]
REDUCE_ARGTYPES = [_PTR, _INT, _INT, _PTR, _PTR]
MIN_BLOCKS_ARGTYPES = [_INT] * 4


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
    render_block.launches += 1
    return Vec3(out[0], out[1], out[2])


render_block.launches = 0


# ------------------------------------------------------------------- KR ----

KR_ARGTYPES = [_PTR] * 2 + [_INT] * 8 + [_PTR] * 12 + [_INT] * 3 + [_PTR]


@functools.lru_cache(maxsize=None)
def _rays_entry():
    return _bind(_RAYS_SOURCE, "sail_trace_rays", KR_ARGTYPES)


def _ray_ints(v, shape, device) -> torch.Tensor:
    """A number or an integer tensor as a contiguous int32 tensor of
    `shape` on `device`, wrapped as the kernel's uint32."""
    t = torch.as_tensor(v, device=device).to(torch.int64)
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
        trace_rays.launches += 1
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


# The local gradient-array sizes K2 is built for (`grad_build.h` CAPS), the
# build that keeps the gradient in shared memory instead (SHARED_GRAD), the most parameters it takes
# (SHARED_MAX_PARAMS: 256 + 8 floats a parameter in 232,448 bytes).
GRAD_CAPS = (352, 1024, 4096)
GRAD_BLOCK = (16, 16)   # K2's thread block: columns, rows
SHARED_GRAD = 0
SHARED_GRAD_MAX_PARAMS = 220
# The largest K2 build with a light other than AREA over a RECTANGLE
# (`megakernel_grad.cu` LIGHTS_MAX_CAP): such scenes take as many parameters
# as any other.  `megakernel_grad.cu` builds LIGHTS for the shared array
# and GRAD_CAPS[0]; `megakernel_grad_lights.cu` (LIGHTS_CAPS) for the rest.
LIGHTS_MAX_CAP = 4096
LIGHTS_CAPS = GRAD_CAPS[1:]


def grad_cap(n_params: int, caps=GRAD_CAPS) -> int:
    """The local K2 build that holds `n_params` parameters: the smallest
    cap that holds them.  Raises above the largest."""
    for cap in caps:
        if n_params <= cap:
            return cap
    raise ValueError(f"K2 takes at most {max(caps)} scene parameters; the "
                     f"scene has {n_params}")


def grad_build(n_params: int) -> int:
    """The K2 build a scene of `n_params` parameters runs: SHARED_GRAD (the
    gradient in shared memory) up to SHARED_GRAD_MAX_PARAMS, else the local
    build of `grad_cap`.  Raises above the largest."""
    return SHARED_GRAD if n_params <= SHARED_GRAD_MAX_PARAMS \
        else grad_cap(n_params)


@functools.lru_cache(maxsize=None)
def _grad_entries():
    lib = build.load(_GRAD_SOURCE)
    limits = (ctypes.c_int * 16)()
    lib.sail_grad_limits(limits)
    n_caps = limits[3]
    built = (tuple(limits[:2]), tuple(limits[4:4 + n_caps]),
             limits[4 + n_caps], limits[5 + n_caps])
    want = (GRAD_BLOCK, GRAD_CAPS, SHARED_GRAD_MAX_PARAMS, LIGHTS_MAX_CAP)
    if built != want:
        raise RuntimeError(f"K2 was built for (block, caps, the shared "
                           f"build's parameters, the largest build with "
                           f"lights) {built}, the wrapper expects {want}")
    return (_bind(_GRAD_SOURCE, "sail_render_grad_block", K2_ARGTYPES),
            _bind(_GRAD_SOURCE, "sail_reduce_grad_rows", REDUCE_ARGTYPES),
            tuple(limits[:3]),
            _bind(_GRAD_SOURCE, "sail_grad_min_blocks", MIN_BLOCKS_ARGTYPES))


@functools.lru_cache(maxsize=None)
def _grad_lights_entry():
    """The C entry of K2's LIGHTS builds above GRAD_CAPS[0]
    (`csrc/megakernel_grad_lights.cu`), built at the first lit scene that
    needs it."""
    lib = build.load(_GRAD_LIGHTS_SOURCE)
    caps = (ctypes.c_int * 8)()
    lib.sail_grad_lights_caps(caps)
    built = tuple(caps[1:1 + caps[0]])
    if built != LIGHTS_CAPS:
        raise RuntimeError(f"K2's LIGHTS library was built for the local "
                           f"arrays {built}, the wrapper expects "
                           f"{LIGHTS_CAPS}")
    return _bind(_GRAD_LIGHTS_SOURCE, "sail_render_grad_lights", K2_ARGTYPES)


def grad_limits() -> dict:
    """K2's compile-time bounds, read from the built library: its thread
    block (columns, rows), the most bounces a thread can store, and the
    local gradient-array sizes it is built for."""
    bx, by, max_bounces = _grad_entries()[2]
    return dict(block=(bx, by), max_bounces=max_bounces, caps=GRAD_CAPS)


def grad_launch_bound(n_params: int, static: SceneStatic) -> int:
    """The blocks per SM of the K2 build `render_grad_rows` launches for a
    scene of `n_params` parameters (its launch bound), as the C entry
    chooses it (`csrc/grad_build.h`): 2 for configs 1-2's kind where two
    blocks' shared memory fit on an SM, else 1.  Reads the built library."""
    table = scene_table(static)
    return _grad_entries()[3](n_params, grad_build(n_params),
                              int(table.all_shapes), int(table.materials))


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
        err = _grad_entries()[1](
            rows.data_ptr(), rows.shape[0], rows.shape[1], out.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 reduce launch failed: cudaError_t {err}")
    reduce_grad_rows.launches += 1
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
    gradients of its thread blocks (`grad_limits()["block"]` pixels each,
    row-major over the block grid), which `reduce_grad_rows` sums into
    `render_grad_block`'s result.  A row holds only its block's pixels, so
    a cotangent on one pixel of every block gives each of those pixels'
    own gradient.  Counts on `render_grad_block.launches`."""
    image_height = height if image_height is None else image_height
    off = _check_grad_block(params, static, g, height, width, spp,
                            max_bounces, row0, image_height)
    table = scene_table(static)
    if not params.is_cuda:
        raise TypeError("render_grad_rows runs K2 on the card: params must "
                        "be a CUDA tensor")
    grad_fn, _, (bx, by, max_bounces_cap), _ = _grad_entries()
    if max_bounces > max_bounces_cap:
        raise ValueError(f"K2 takes at most {max_bounces_cap} bounces; got "
                         f"{max_bounces}")
    cap = grad_build(off.size)
    if table.lights and cap in LIGHTS_CAPS:
        grad_fn = _grad_lights_entry()
    dev = params.device
    n_blocks = -(-width // bx) * -(-height // by)
    rows = torch.empty((n_blocks, off.size), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = grad_fn(
            params.data_ptr(), _device_table(static, dev).data_ptr(),
            *_counts(static), off.camera, off.size, cap,
            int(table.all_shapes), int(table.materials), int(table.lights),
            g.x.data_ptr(),
            g.y.data_ptr(), g.z.data_ptr(), rows.data_ptr(), height, width,
            spp, _int32(seed), _int32(sample0), max_bounces, row0,
            image_height, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError_t {err}")
    render_grad_block.launches += 1
    return rows


render_grad_block.launches = 0


# ------------------------------------------------- autograd Functions ----

class _RenderImageFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, seed, static, height, width, spp, max_bounces):
        ctx.save_for_backward(params)
        ctx.args = (seed, static, height, width, spp, max_bounces)
        acc = render_block(params, static, height, width, spp, seed, 0,
                           max_bounces)
        return tuple(c * (1.0 / spp) for c in acc)

    @staticmethod
    def backward(ctx, gx, gy, gz):
        (params,) = ctx.saved_tensors
        seed, static, height, width, spp, max_bounces = ctx.args
        # the forward returned mean = sum/spp: scale the cotangent onto the sum
        g = Vec3(*((c * (1.0 / spp)).contiguous() for c in (gx, gy, gz)))
        d = render_grad_block(params.detach(), static, g, height, width, spp,
                              seed, 0, max_bounces)
        return (d,) + (None,) * 6


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
    with the same RNG).  `seed` takes no gradient."""
    return Vec3(*_RenderImageFast.apply(params, seed, static, height, width,
                                        spp, max_bounces))


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
