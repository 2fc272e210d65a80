"""K1, the forward path-tracing megakernel: wrapper, launch count, plain version.

Replaces `render_block_pallas` (`sail_tpu/ops/pallas/megakernel.py:159`).
The kernel is `csrc/megakernel.cu` (CUDA C++ for sm_90a, one thread per
pixel; its header says what bounds it and how the design answers), built by
`utils/build.py` and bound through its plain C entry point with ctypes.

`render_block` launches the kernel for a CUDA tensor and runs the plain
version (`render_block_plain`: the torch integrator, summed over samples in
sample order) for a CPU tensor; it never falls back from one to the other.
`render_block.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from ... import constants as C
from ...core.vecmath import Vec3
from ...render import integrator
from ...scene.scene import SceneStatic, param_offsets, unflatten
from ...utils import build

_SOURCE = "megakernel"


def _int32(v) -> int:
    """A Python int as the int32 the kernel takes (wrapping, like JAX's)."""
    return (operator.index(v) + (1 << 31)) % (1 << 32) - (1 << 31)


@functools.lru_cache(maxsize=64)
def scene_table(static: SceneStatic):
    """(table, offsets): the kernel's int32 scene table — 5 ints per object
    (category, param offset, material row, texture row, emissive), 2 per
    material row (category, offset), 2 per texture row (category, offset),
    3 per light (category, object, offset) — and the parameter offsets.
    Raises for structure outside the slice."""
    off = param_offsets(static)
    table = []
    for i, cat in enumerate(static.object_categories):
        table += [cat, off.objects[i], static.object_mat_rows[i],
                  static.object_tex_rows[i], int(static.object_emissive[i])]
    for cat, o in zip(static.material_categories, off.materials):
        table += [cat, o]
    for cat, o in zip(static.texture_categories, off.textures):
        table += [cat, o]
    for cat, obj, o in zip(static.light_categories, static.area_light_objects,
                           off.lights):
        table += [cat, obj, o]
    return tuple(table), off


@functools.lru_cache(maxsize=64)
def _device_table(static: SceneStatic, device: torch.device) -> torch.Tensor:
    """The scene table on `device`, copied there once per scene structure,
    so a render call copies nothing from the host."""
    return torch.tensor(scene_table(static)[0], dtype=torch.int32,
                        device=device)


def render_block_plain(params: torch.Tensor, static: SceneStatic, height: int,
                       width: int, spp: int, seed, sample0,
                       max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
                       image_height: int = None) -> Vec3:
    """The plain PyTorch version of K1 on any device: spp-SUM of radiance
    of an H×W block whose first row is global row `row0`."""
    return integrator.render_sum(unflatten(params, static), static, height,
                                 width, spp, seed, sample0, max_bounces,
                                 row0=row0, image_height=image_height)


def _entry():
    fn = build.load(_SOURCE).sail_render_block
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def render_block(params: torch.Tensor, static: SceneStatic, height: int,
                 width: int, spp: int, seed, sample0,
                 max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
                 image_height: int = None) -> Vec3:
    """Forward render of an H×W block: the SUM of `spp` samples (divide by
    spp for the mean), as a Vec3 of (H, W) float32 tensors on params' device.

    `row0`/`image_height`: the block's global first row and the full image
    height, so a tile draws the same RNG streams and camera rays as the
    whole image."""
    image_height = height if image_height is None else image_height
    if not (isinstance(params, torch.Tensor) and params.dtype == torch.float32
            and params.dim() == 1 and params.is_contiguous()):
        raise TypeError("params must be a contiguous 1-D float32 tensor")
    if min(height, width, spp) < 1 or max_bounces < 0 or row0 < 0 \
            or row0 + height > image_height:
        raise ValueError(f"bad block: {height}x{width}, spp={spp}, "
                         f"max_bounces={max_bounces}, rows {row0}+{height} "
                         f"of {image_height}")
    _, off = scene_table(static)   # raises NotImplementedError off the slice
    if params.numel() != off.size:
        raise ValueError(f"scene needs {off.size} params, got {params.numel()}")

    if params.device.type == "cpu":
        return render_block_plain(params, static, height, width, spp, seed,
                                  sample0, max_bounces, row0, image_height)
    if params.device.type != "cuda":
        raise ValueError(f"no K1 for device {params.device}")
    if params.requires_grad:
        raise NotImplementedError(
            "K2 backward megakernel: not ported yet (ROADMAP.md queue 2)")

    dev = params.device
    table_t = _device_table(static, dev)
    out = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):   # the C launch goes to the current device
        err = _entry()(
            params.data_ptr(), table_t.data_ptr(),
            len(static.object_categories), len(static.material_categories),
            len(static.texture_categories), len(static.light_categories),
            off.camera, out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), height, width, spp, _int32(seed),
            _int32(sample0), max_bounces, row0, image_height,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {err}")
    render_block.launches += 1
    return Vec3(out[0], out[1], out[2])


render_block.launches = 0
