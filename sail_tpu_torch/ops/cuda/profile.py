"""The profiling kernels: wrappers, launch counts and plain versions.

- K5a, `isect_only_block`: the intersect-only path of
  `tools/profile_megakernel.py:380` (`isect_kernel_call`, pl.pallas_call at
  :413): per pixel, the sum over spp samples of the closest hit's t over
  `max_bounces` mirror bounces.  The phase split's floor: K1's rays with no
  shading, light sampling or RNG after the camera.
- K5b, `alu_peak`: `run_kernel` of `vpu_peak_section` (:519, call at :532),
  K iterations of `fma_mix` or `integrator_mix` per element; K5c,
  `alu_peak_ilp8` (`run_kernel_ilp8`, :572, call at :588), 8 independent
  `integrator_mix` chains.  They read the FP32 and SFU issue rates the card
  reaches.
- K1 with one phase stripped, `render_block_stripped`: the counterparts of
  the patches of `phases_section` (:325-350), so that K1's time splits by
  subtraction.  It is K1's own kernel template (`csrc/render_block.cuh`)
  with a strip bit set, built for config 2's scene kind.
- K2 with a phase stripped, `render_grad_stripped` (the forward sweep
  alone; the sweep and the replay without the adjoint): K2's own kernel
  template (`csrc/render_grad.cuh`) for configs 1-2's scene kind, so that
  K2's time splits by subtraction.

The first four are CUDA C++ for sm_90a in `csrc/profile.cu`, K2's builds
in `csrc/profile_grad.cu` (their headers say what bounds each and how the
design answers), bound through plain C entry points with ctypes.  A wrapper
launches its kernel for a CUDA tensor (`alu_peak` and `alu_peak_ilp8`,
which take no tensor, for `device="cuda"`, the default) and runs the plain
version on the CPU; it never falls back from one to the other.
`isect_only_block.launches`, `alu_peak.launches`, `alu_peak_ilp8.launches`,
`render_block_stripped.launches` and `render_grad_stripped.launches` count
kernel launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from ...core import rng
from ...core import vecmath as vm
from ...core.camera import rays_for_pixels
from ...core.vecmath import Vec3
from ...ops import intersect as isect
from ...ops import lights, textures
from ...render import integrator
from ...scene.scene import SceneStatic, unflatten
from . import megakernel as mk

_SOURCE = "profile"

# path.cuh's STRIP_* bits: each the counterpart of one patch of
# `phases_section`.
STRIPS = {"const_rng": 1, "const_texture": 2, "no_shadow_scan": 4,
          "no_nee": 8}
# profile.cu's MIX_*: the two mixes of `vpu_peak_section` (:539-553).
MIXES = {"fma": 0, "integrator_mix": 1}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# The C entries' argument types, in their order (csrc/profile.cu).
ISECT_ARGTYPES = [_PTR] * 2 + [_INT] * 9 + [_PTR] + [_INT] * 6 + [_PTR]
ALU_ARGTYPES = [_INT, _PTR] + [_INT] * 4 + [_PTR]
ALU_ILP8_ARGTYPES = [_PTR] + [_INT] * 4 + [_PTR]
STRIPPED_ARGTYPES = [_INT] + mk.K1_ARGTYPES


@functools.lru_cache(maxsize=None)
def _entries():
    return {name: mk._bind(_SOURCE, name, argtypes) for name, argtypes in (
        ("sail_isect_only", ISECT_ARGTYPES),
        ("sail_alu_peak", ALU_ARGTYPES),
        ("sail_alu_peak_ilp8", ALU_ILP8_ARGTYPES),
        ("sail_render_block_stripped", STRIPPED_ARGTYPES))}


def _launch(name: str, dev, *args) -> None:
    with torch.cuda.device(dev):   # the C launch goes to the current device
        err = _entries()[name](*args, torch.cuda.current_stream(dev)
                               .cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


# ------------------------------------------------------------------ K5a ----

def isect_only_plain(params: torch.Tensor, static: SceneStatic, height: int,
                     width: int, spp: int, max_bounces: int, row0: int = 0,
                     image_height: int = None, tally: list = None
                     ) -> torch.Tensor:
    """The plain PyTorch version of K5a: an (H, W) tensor, per pixel the
    sum over `spp` samples of Σ over the bounces of the closest hit's t
    where the ray hits; the ray then reflects about the hit's normal and
    restarts at p + n·1e-4 (a miss: t = 1e5, p = 0, n = -0, so it restarts
    at the world origin).  Every sample traces the same rays, so the bounce
    loop runs once and is added spp times in sample order.  `tally` (a
    list) receives each bounce's (winner object, hit mask)."""
    image_height = height if image_height is None else image_height
    scene = unflatten(params, static)
    ii, jj = integrator.pixel_grid(height, width, row0, params.device)
    noise = rng.PixelNoise(0, 0, ii, jj)
    jx, jy, _ = noise.uniform3(0, rng.TAG_PIXEL_JITTER)
    ro, rd = rays_for_pixels(scene.camera, ii.to(params.dtype),
                             jj.to(params.dtype), image_height, width, jx, jy)
    a = vm.full((height, width), 0.0, params)
    for _ in range(max_bounces):
        hit = isect.intersect_scene(scene.objects, static, ro, rd)
        if tally is not None:
            tally.append((hit.obj_id, hit.valid))
        a = a + torch.where(hit.valid, hit.t, 0.0)
        rd = (rd - hit.n * (2.0 * hit.n.dot(rd))).normalize()
        ro = hit.p + hit.n * 1e-4
    acc = vm.full((height, width), 0.0, params)
    for _ in range(spp):
        acc = acc + a
    return acc


def isect_only_block(params: torch.Tensor, static: SceneStatic, height: int,
                     width: int, spp: int, max_bounces: int, row0: int = 0,
                     image_height: int = None) -> torch.Tensor:
    """K5a on an H×W block whose first row is global row `row0` of an image
    `image_height` rows tall: an (H, W) float32 tensor on params' device."""
    image_height = height if image_height is None else image_height
    off = mk._check_block(params, static, height, width, spp, max_bounces,
                          row0, image_height)
    if params.device.type == "cpu":
        return isect_only_plain(params, static, height, width, spp,
                                max_bounces, row0, image_height)
    dev = params.device
    out = torch.empty((height, width), dtype=torch.float32, device=dev)
    table = mk.scene_table(static)
    _launch("sail_isect_only", dev, params.data_ptr(),
            mk._device_table(static, dev).data_ptr(), *mk._counts(static),
            off.camera, int(table.all_shapes), table.n_frames,
            out.data_ptr(), height, width, spp, max_bounces, row0,
            image_height)
    isect_only_block.launches += 1
    return out


isect_only_block.launches = 0


# ------------------------------------------------------------- K5b, K5c ----

def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as the 0-d float32 the kernels round it to."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _start(rows: int, cols: int, device):
    """a = col·1e-3 + 1 and b = 0.5·a + 0.25 over an (R, Cn) block."""
    col = torch.arange(cols, dtype=torch.float32, device=device)
    a = (col * _f32(1e-3, col) + _f32(1.0, col)).expand(rows, cols)
    return a, a * _f32(0.5, a) + _f32(0.25, a)


def _fma(a, b, c):
    """a·b + c rounded once to float64 and then to float32: FFMA's value
    but where the two roundings differ (rarely, by 1 ulp)."""
    return (a.double() * b.double() + c.double()).float()


def fma_mix(a, b):
    """`fma_mix` (tools/profile_megakernel.py:539-544): 8 fused mul-adds."""
    c1, c2 = _f32(1.000001, a), _f32(0.999999, a)
    for _ in range(4):
        a = _fma(a, b, c1)
        b = _fma(b, a, c2)
    return a, b


def integrator_mix(a, b):
    """`integrator_mix` (:546-553): mul, add, max, compare and select,
    |·|, rsqrt, twice."""
    c1, one = _f32(1.000001, a), _f32(1.0, a)
    for _ in range(2):
        a = a * b + c1
        m = torch.maximum(a, b)
        s = torch.where(a > b, a, b * c1)
        b = torch.rsqrt(torch.abs(m * s) + one)
    return a, b


_MIX_FNS = {"fma": fma_mix, "integrator_mix": integrator_mix}


def _check_alu(mix, rows, cols, grid, iters):
    if mix is not None and mix not in MIXES:
        raise ValueError(f"mix must be one of {tuple(MIXES)}, not {mix!r}")
    if min(rows, cols, grid) < 1 or iters < 0:
        raise ValueError(f"bad geometry: rows {rows}, cols {cols}, grid "
                         f"{grid}, iterations {iters}")


def alu_peak_plain(mix: str, rows: int, cols: int, grid: int, iters: int,
                   device="cpu") -> torch.Tensor:
    """The plain PyTorch version of K5b: the (R, Cn) block after `iters`
    iterations of `mix`, a + b.  Every grid step writes this same block, so
    it is computed once."""
    _check_alu(mix, rows, cols, grid, iters)
    a, b = _start(rows, cols, device)
    for _ in range(iters):
        a, b = _MIX_FNS[mix](a, b)
    return a + b


def alu_peak(mix: str, rows: int, cols: int, grid: int, iters: int,
             device="cuda") -> torch.Tensor:
    """K5b: G·R·Cn threads each run `iters` iterations of `mix` on their
    element and store it into the (R, Cn) block; returns the block.  On
    `device="cpu"` the plain version."""
    _check_alu(mix, rows, cols, grid, iters)
    dev = torch.device(device)
    if dev.type == "cpu":
        return alu_peak_plain(mix, rows, cols, grid, iters)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    _launch("sail_alu_peak", dev, MIXES[mix], out.data_ptr(), rows, cols,
            grid, iters)
    alu_peak.launches += 1
    return out


alu_peak.launches = 0


def alu_peak_ilp8_plain(rows: int, cols: int, grid: int, iters: int,
                        device="cpu") -> torch.Tensor:
    """The plain PyTorch version of K5c: 8 `integrator_mix` chains from
    (base·(1 + 0.01c), 0.5·base + 0.25), summed as
    tools/profile_megakernel.py:583-586 sums them."""
    _check_alu(None, rows, cols, grid, iters)
    base, b0 = _start(rows, cols, device)
    chains = [(base * _f32(1.0 + 0.01 * c, base), b0) for c in range(8)]
    for _ in range(iters):
        chains = [integrator_mix(a, b) for a, b in chains]
    acc = chains[0][0]
    for a, b in chains[1:]:
        acc = acc + a + b
    return acc + chains[0][1]


def alu_peak_ilp8(rows: int, cols: int, grid: int, iters: int,
                  device="cuda") -> torch.Tensor:
    """K5c: as `alu_peak` with 8 independent `integrator_mix` chains per
    element.  On `device="cpu"` the plain version."""
    _check_alu(None, rows, cols, grid, iters)
    dev = torch.device(device)
    if dev.type == "cpu":
        return alu_peak_ilp8_plain(rows, cols, grid, iters)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    _launch("sail_alu_peak_ilp8", dev, out.data_ptr(), rows, cols, grid,
            iters)
    alu_peak_ilp8.launches += 1
    return out


alu_peak_ilp8.launches = 0


# -------------------------------------------------- K1, phase stripped ----

def _const_uniform3(self, bounce, tag):
    h = torch.full(self.ii.shape, 0.5, dtype=torch.float32,
                   device=self.ii.device)
    return h, h, h


def _const_surface_color(textures_, static, tex_row, hit_p, uv_u, uv_v,
                         sc_override, use_override):
    one = vm.full(uv_u.shape, 1.0, uv_u)
    return Vec3(one, one, one)


def _no_occluder(objects, static, ro, rd, max_t, cull=False, tally=None):
    occ = torch.zeros(max_t.shape, dtype=torch.bool, device=max_t.device)
    if tally is not None:   # the light is still sampled: a scan of no tests
        tally["shadow"], tally["occluded"] = {}, occ
    return occ


def _no_light(objects, lights_, static, hit_p, hit_n, u1, u2, light_idx,
              cull=False, tally=None):
    zero = vm.full(hit_p.shape, 0.0, hit_p.x)
    return Vec3(zero, zero, zero), Vec3(zero, zero, zero + 1.0)


# (object, attribute, replacement) per strip: the patches of
# tools/profile_megakernel.py:326-350, on the port's modules
_PATCHES = {
    "const_rng": (rng.PixelNoise, "uniform3", _const_uniform3),
    "const_texture": (textures, "surface_color", _const_surface_color),
    "no_shadow_scan": (isect, "occluded", _no_occluder),
    "no_nee": (lights, "sample_direct", _no_light),
}


@contextlib.contextmanager
def stripped(strip: str):
    """The plain version with one phase stripped, while the block runs:
    const_rng (every uniform3 gives 0.5, the pixel jitter included),
    const_texture (the surface color is 1, the Cornell walls' included),
    no_shadow_scan (no light sample is occluded) or no_nee (no light sample
    adds radiance; the next bounce still skips its emission where the
    bounce did NEE)."""
    if strip not in STRIPS:
        raise ValueError(f"strip must be one of {tuple(STRIPS)}, not "
                         f"{strip!r}")
    obj, attr, new = _PATCHES[strip]
    saved = getattr(obj, attr)
    setattr(obj, attr, new)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def render_block_stripped_plain(strip: str, params: torch.Tensor,
                                static: SceneStatic, height: int, width: int,
                                spp: int, seed, sample0, max_bounces: int,
                                row0: int = 0, image_height: int = None
                                ) -> Vec3:
    """The plain version of K1 with `strip` stripped, on any scene."""
    with stripped(strip):
        return mk.render_block_plain(params, static, height, width, spp, seed,
                                     sample0, max_bounces, row0, image_height)


def render_block_stripped(strip: str, params: torch.Tensor,
                          static: SceneStatic, height: int, width: int,
                          spp: int, seed, sample0, max_bounces: int,
                          row0: int = 0, image_height: int = None) -> Vec3:
    """K1 with `strip` (a key of STRIPS) stripped: the spp-SUM of an H×W
    block as `render_block` gives it.  On the card it is built for config
    2's scene kind (spheres, rectangles and a Cornell box; matte and
    mirror; uniform colors; no cull) and raises for another scene."""
    image_height = height if image_height is None else image_height
    if strip not in STRIPS:
        raise ValueError(f"strip must be one of {tuple(STRIPS)}, not "
                         f"{strip!r}")
    off = mk._check_block(params, static, height, width, spp, max_bounces,
                          row0, image_height)
    if params.device.type == "cpu":
        return render_block_stripped_plain(strip, params, static, height,
                                           width, spp, seed, sample0,
                                           max_bounces, row0, image_height)
    table = mk.scene_table(static)
    if table.all_shapes or table.materials:
        raise ValueError("render_block_stripped runs on the card for config "
                         "2's scene kind only (spheres, rectangles, a Cornell"
                         " box; matte and mirror; uniform colors)")
    dev = params.device
    out = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    _launch("sail_render_block_stripped", dev, STRIPS[strip],
            params.data_ptr(), mk._device_table(static, dev).data_ptr(),
            *mk._counts(static), off.camera, 0, 0, 0, table.n_frames,
            out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), height, width, spp,
            mk._int32(seed), mk._int32(sample0), max_bounces, row0,
            image_height)
    render_block_stripped.launches += 1
    return Vec3(out[0], out[1], out[2])


render_block_stripped.launches = 0


# ------------------------------------------------------------ K2 phases ----
# csrc/profile_grad.cu: K2's own template (csrc/render_grad.cuh) for configs
# 1-2's scene kind with a phase stripped (adjoint.cuh's GRAD_NO_* bits),
# compiled with the defines of the production build that kind runs, at two
# blocks per SM.
GRAD_LIBRARY = ("profile_grad", mk.grad_build(1, False, False, False).defines)
GRAD_STRIPS = {"forward_only": 0, "no_adjoint": 1}
GRAD_PROFILE_ARGTYPES = [_INT] + [_PTR] * 2 + [_INT] * 10 + [_PTR] * 4 \
    + [_INT] * 8 + [_PTR]


@functools.lru_cache(maxsize=None)
def _grad_entry():
    return mk._bind(GRAD_LIBRARY, "sail_render_grad_profile",
                    GRAD_PROFILE_ARGTYPES)


def _grad_profile_rows(variant: int, what: str, params, static, g, height,
                       width, spp, seed, sample0, max_bounces, row0,
                       image_height) -> torch.Tensor:
    """One launch of a profile_grad.cu variant: K2's (n_blocks, n_params)
    rows.  The C entry refuses a scene off configs 1-2's kind (the scenes
    K2 runs at two blocks per SM), and this raises."""
    off = mk._check_grad_block(params, static, g, height, width, spp,
                               max_bounces, row0, image_height)
    table = mk.scene_table(static)
    bx, by = mk.GRAD_BLOCK
    dev = params.device
    rows = torch.empty((-(-width // bx) * -(-height // by), off.size),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _grad_entry()(
            variant, params.data_ptr(),
            mk._device_table(static, dev).data_ptr(), *mk._counts(static),
            off.camera, off.size, int(table.all_shapes),
            int(table.materials), g.x.data_ptr(), g.y.data_ptr(),
            g.z.data_ptr(), rows.data_ptr(), height, width, spp,
            mk._int32(seed), mk._int32(sample0), max_bounces, row0,
            image_height, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err} (on "
                           f"the card it runs configs 1-2's scene kind "
                           f"only: spheres, rectangles, a Cornell box; "
                           f"matte and mirror; uniform colors; the "
                           f"parameters two blocks per SM hold)")
    return rows


def block_sums(x: torch.Tensor) -> torch.Tensor:
    """Sums of an (H, W) tensor over K2's thread blocks (GRAD_BLOCK pixels,
    the ragged edge padded with zeros), one per block in launch order."""
    bx, by = mk.GRAD_BLOCK
    h, w = x.shape
    pad = torch.zeros((-(-h // by) * by, -(-w // bx) * bx), dtype=x.dtype,
                      device=x.device)
    pad[:h, :w] = x
    return pad.reshape(pad.shape[0] // by, by, pad.shape[1] // bx, bx) \
        .sum(dim=(1, 3)).reshape(-1)


def render_grad_stripped_plain(strip: str, params: torch.Tensor,
                               static: SceneStatic, g: Vec3, height: int,
                               width: int, spp: int, seed, sample0,
                               max_bounces: int, row0: int = 0,
                               image_height: int = None) -> torch.Tensor:
    """The plain version of K2 with `strip` stripped, on any scene: K2's
    rows, zero but for column 0 (and, for no_adjoint, column 2): each
    block's Σ g · (spp-SUM of radiance), from the plain forward render;
    column 1 (the replayed states that differ from the recorded ones) is
    0."""
    if strip not in GRAD_STRIPS:
        raise ValueError(f"strip must be one of {tuple(GRAD_STRIPS)}, not "
                         f"{strip!r}")
    img = mk.render_block_plain(params, static, height, width, spp, seed,
                                sample0, max_bounces, row0, image_height)
    loss = block_sums(img.x * g.x + img.y * g.y + img.z * g.z)
    rows = torch.zeros((loss.numel(), params.numel()), dtype=params.dtype,
                       device=params.device)
    rows[:, 0] = loss
    if strip == "no_adjoint":
        rows[:, 2] = loss
    return rows


def render_grad_stripped(strip: str, params: torch.Tensor,
                         static: SceneStatic, g: Vec3, height: int,
                         width: int, spp: int, seed, sample0,
                         max_bounces: int, row0: int = 0,
                         image_height: int = None) -> torch.Tensor:
    """K2 with `strip` (a key of GRAD_STRIPS) stripped, as the rows
    `render_grad_rows` gives: forward_only runs K2's forward sweep alone,
    no_adjoint the sweep and the reverse sweep's replay without the adjoint
    (`render_grad_stripped_plain` says what the rows hold).  On the card it
    is built for configs 1-2's scene kind and raises for another scene."""
    image_height = height if image_height is None else image_height
    if strip not in GRAD_STRIPS:
        raise ValueError(f"strip must be one of {tuple(GRAD_STRIPS)}, not "
                         f"{strip!r}")
    if params.device.type == "cpu":
        mk._check_grad_block(params, static, g, height, width, spp,
                             max_bounces, row0, image_height)
        return render_grad_stripped_plain(strip, params, static, g, height,
                                          width, spp, seed, sample0,
                                          max_bounces, row0, image_height)
    rows = _grad_profile_rows(GRAD_STRIPS[strip], "render_grad_stripped",
                              params, static, g, height, width, spp, seed,
                              sample0, max_bounces, row0, image_height)
    render_grad_stripped.launches += 1
    return rows


render_grad_stripped.launches = 0


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 units in the last place between two
    float32 tensors (equal infinities are 0 apart)."""
    ia = a.contiguous().cpu().numpy().view(np.int32).astype(np.int64)
    ib = b.contiguous().cpu().numpy().view(np.int32).astype(np.int64)
    # order the bit patterns as the floats are ordered
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0
