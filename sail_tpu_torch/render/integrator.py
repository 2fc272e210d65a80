"""Path-tracing integrator, plain PyTorch (port of
`sail_tpu/render/integrator.py`: the masked bounce loop).

This is the plain version of the whole trace: it runs on any device, is the
CPU path of the port, and is what the CUDA megakernel
(`ops/cuda/megakernel.py`) is held against.  All rays advance one bounce per
step over whole tensors; dead rays are masked, not branched.

Estimator (the JAX package's): NEE on matte, non-emissive hits only; the next
bounce's emission pickup is skipped where the previous bounce did NEE; BSDF
weights are clipped to [0, 1]; RNG is the counter-based per-pixel hash, so
every pixel draws the JAX package's streams.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..core import rng
from ..core import vecmath as vm
from ..core.camera import rays_for_pixels
from ..core.rng import PixelNoise
from ..core.vecmath import Vec3
from ..ops import intersect as isect
from ..ops import lights as lights_ops
from ..ops import materials as mat_ops
from ..ops import textures as tex_ops


class _PathState(NamedTuple):
    """Per-lane state carried across bounces."""
    ro: Vec3
    rd: Vec3
    e: Vec3
    throughput: Vec3
    alive: torch.Tensor
    skip_emission: torch.Tensor


def _bounce_step(scene, state: _PathState, noise: PixelNoise, *, static,
                 bounce: int) -> _PathState:
    """One bounce: intersect → shade → NEE → continue."""
    hit = isect.intersect_scene(scene.objects, static, state.ro, state.rd)
    alive = state.alive & hit.valid
    return _bounce_shade(scene, state, hit, alive, noise, static=static,
                         bounce=bounce)


def _bounce_shade(scene, state: _PathState, hit, alive, noise: PixelNoise,
                  *, static, bounce: int) -> _PathState:
    """Shade + NEE + path continuation for an already-intersected bounce."""
    rd = state.rd
    shape = rd.shape
    black = vm.zeros_vec(shape, rd.x)
    n_lights = len(scene.lights)

    # Shading frame: ss from dpdu (any tangent where dpdu is degenerate),
    # orthogonalized against n; ts completes the basis.
    dpdu_ok = hit.dpdu.length_sq() > 1e-16
    ss = vm.where(dpdu_ok, hit.dpdu, vm.ortho(hit.n)).normalize()
    ss = (ss - hit.n * ss.dot(hit.n)).normalize()
    ts = hit.n.cross(ss)
    wo = vm.world_to_local(-rd, hit.n, ss, ts)

    sc = tex_ops.surface_color(scene.textures, static, hit.tex_row, hit.p,
                               hit.u, hit.v, hit.sc_override, hit.use_override)

    u1, u2, u_lobe = noise.uniform3(bounce, rng.TAG_BSDF)
    ms = mat_ops.sample_material(scene.materials, static, hit.mat_row, sc,
                                 u1, u2, u_lobe, wo, hit.into)

    weight = ms.weight.clip(0.0, 1.0)

    # Emission pickup; skipped if the previous bounce's NEE already
    # accounted for direct light onto this path vertex.
    contrib = vm.where(state.skip_emission & (hit.emissive > 0), black,
                       hit.emission)

    did_nee = torch.zeros(shape, dtype=torch.bool, device=rd.x.device)
    if n_lights > 0:
        lu1, lu2, lr = noise.uniform3(bounce, rng.TAG_LIGHT_U)
        lidx = torch.clamp((lr * n_lights).to(torch.int32), max=n_lights - 1)
        nee_mask = (ms.is_matte > 0) & (hit.emissive == 0) & alive
        direct, wi_light = lights_ops.sample_direct(
            scene.objects, scene.lights, static, hit.p, hit.n, lu1, lu2, lidx)
        wi_light_local = vm.world_to_local(wi_light, hit.n, ss, ts)
        f_light = mat_ops.eval_matte_f(scene.materials, static, hit.mat_row,
                                       sc, wo, wi_light_local)
        contrib = contrib + vm.where(nee_mask, direct * f_light, black)
        did_nee = nee_mask

    e = state.e + state.throughput * vm.where(alive, contrib, black)
    throughput = state.throughput * weight

    # Continue the path: offset origin along ±normal.
    wi_world = vm.local_to_world(ms.wi, hit.n, ss, ts)
    outdot = hit.n.dot(wi_world)
    ro = hit.p + hit.n * torch.where(outdot > C.EPSILON, 1e-4, -1e-4)
    alive = alive & (throughput.max_component() > 0.0)
    return _PathState(ro, wi_world, e, throughput, alive, did_nee)


def trace_rays(scene, static, ro: Vec3, rd: Vec3, noise: PixelNoise,
               max_bounces: int = C.MAX_BOUNCES) -> Vec3:
    """Radiance of a batch of rays traced through the packed scene (`scene`
    a PackedScene view, `static` a SceneStatic), every bounce masked."""
    shape = torch.broadcast_shapes(ro.shape, rd.shape)
    ro = ro.broadcast_to(shape)
    rd = rd.broadcast_to(shape)
    black = vm.zeros_vec(shape, rd.x)
    one = vm.full(shape, 1.0, rd.x)
    dev = rd.x.device
    state = _PathState(ro, rd, black, Vec3(one, one, one),
                       torch.ones(shape, dtype=torch.bool, device=dev),
                       torch.zeros(shape, dtype=torch.bool, device=dev))
    for bounce in range(max_bounces):
        state = _bounce_step(scene, state, noise, static=static,
                             bounce=bounce)
    return state.e


def pixel_grid(height: int, width: int, row0: int, device):
    """Global (row, col) int32 index grids of an H×W block starting at row0."""
    ii = (row0 + torch.arange(height, dtype=torch.int32, device=device))
    jj = torch.arange(width, dtype=torch.int32, device=device)
    return (ii[:, None].expand(height, width),
            jj[None, :].expand(height, width))


def render_sample(scene, static, height: int, width: int, seed, sample_idx,
                  max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
                  image_height: int = None) -> Vec3:
    """Radiance of one 1-spp pass over an H×W block whose first row is
    global row `row0` of an image `image_height` rows tall (default
    `height`)."""
    image_height = height if image_height is None else image_height
    ii, jj = pixel_grid(height, width, row0, scene.camera.eye.x.device)
    noise = PixelNoise(seed, sample_idx, ii, jj)
    jx, jy, _ = noise.uniform3(0, rng.TAG_PIXEL_JITTER)
    ro, rd = rays_for_pixels(scene.camera, ii.to(torch.float32),
                             jj.to(torch.float32), image_height, width, jx, jy)
    return trace_rays(scene, static, ro, rd, noise, max_bounces)


def render_sum(scene, static, height: int, width: int, spp: int, seed,
               sample0, max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
               image_height: int = None) -> Vec3:
    """SUM of `spp` passes (samples sample0, sample0+1, ...), added in
    sample order: the plain version of the K1 megakernel."""
    acc = vm.zeros_vec((height, width), scene.camera.eye.x)
    for s in range(spp):
        acc = acc + render_sample(scene, static, height, width, seed,
                                  sample0 + s, max_bounces, row0=row0,
                                  image_height=image_height)
    return acc


def render_image(scene, static, height: int, width: int, spp: int, seed=0,
                 max_bounces: int = C.MAX_BOUNCES) -> Vec3:
    """Mean of `spp` progressive passes."""
    return render_sum(scene, static, height, width, spp, seed, 0,
                      max_bounces) * (1.0 / spp)
