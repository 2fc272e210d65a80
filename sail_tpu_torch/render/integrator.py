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

`early_exit` (default off) skips work no ray of the batch needs, with the
JAX package's semantics: bounce 0 always intersects, and its shading is
skipped when no ray hit; a later bounce is skipped when every ray is dead.
Dead rays add exactly +0, so the image is the masked loop's bit for bit.
`rand_override` and `clamp_weight` serve the numpy oracle's parity test.

`cull` (default off) lets the closest-hit and shadow scans skip the clusters
of a batched object group whose bound box a ray cannot reach
(`ops/intersect.py`); it never changes an image.  `tally` (a dict) collects
each bounce's masks and the tests its scans ran, from which
`utils/opcount.py` counts the work the inputs need; it never changes a value
either.  The plain version runs in the parameters' dtype, so float64
parameters give a float64 witness of the same estimator.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

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

# Rays one pass of `render_sum` traces: it takes as many samples together as
# fit (one at a time from 512² up) and adds them in sample order.
RAYS_PER_PASS = 1 << 17


class _PathState(NamedTuple):
    """Per-lane state carried across bounces."""
    ro: Vec3
    rd: Vec3
    e: Vec3
    throughput: Vec3
    alive: torch.Tensor
    skip_emission: torch.Tensor


def _bounce_step(scene, state: _PathState, noise: PixelNoise, *, static,
                 bounce: int, clamp_weight: bool = True, rand_override=None,
                 cull: bool = False, tally: dict = None,
                 skip_dead_shade: bool = False) -> _PathState:
    """One bounce: intersect → shade → NEE → continue.  With
    `skip_dead_shade`, the shading is skipped when no ray hit (the rays
    that missed add nothing and are dead after it)."""
    hit = isect.intersect_scene(scene.objects, static, state.ro, state.rd,
                                cull=cull, tally=tally)
    alive = state.alive & hit.valid
    if skip_dead_shade and not bool(alive.any()):
        # every ray is dead now; skip_emission (all False) is the tally's
        # record that no ray sampled a light
        out = state._replace(alive=alive, skip_emission=alive)
    else:
        out = _bounce_shade(scene, state, hit, alive, noise, static=static,
                            bounce=bounce, clamp_weight=clamp_weight,
                            rand_override=rand_override, cull=cull,
                            tally=tally)
    if tally is not None:   # the scans' tests move into the bounce's record
        tally.setdefault("bounces", []).append(dict(
            scan=tally.pop("scan"), shadow=tally.pop("shadow", None),
            occluded=tally.pop("occluded", None), entered=state.alive,
            alive=alive, obj_id=hit.obj_id, mat_row=hit.mat_row,
            nee=out.skip_emission, light=tally.pop("light", None)))
    return out


def _bounce_shade(scene, state: _PathState, hit, alive, noise: PixelNoise,
                  *, static, bounce: int, clamp_weight: bool = True,
                  rand_override=None, cull: bool = False,
                  tally: dict = None) -> _PathState:
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

    if rand_override is not None:
        rb = rand_override[bounce]
        u1, u2, u_lobe = rb["u1"], rb["u2"], rb["u_lobe"]
    else:
        u1, u2, u_lobe = noise.uniform3(bounce, rng.TAG_BSDF)
    ms = mat_ops.sample_material(scene.materials, static, hit.mat_row, sc,
                                 u1, u2, u_lobe, wo, hit.into)

    weight = ms.weight.clip(0.0, 1.0) if clamp_weight else ms.weight

    # Emission pickup; skipped if the previous bounce's NEE already
    # accounted for direct light onto this path vertex.
    contrib = vm.where(state.skip_emission & (hit.emissive > 0), black,
                       hit.emission)

    did_nee = torch.zeros(shape, dtype=torch.bool, device=rd.x.device)
    if n_lights > 0:
        if rand_override is not None:
            rb = rand_override[bounce]
            lu1, lu2, lidx = rb["lu1"], rb["lu2"], rb["lidx"]
        else:
            lu1, lu2, lr = noise.uniform3(bounce, rng.TAG_LIGHT_U)
            lidx = torch.clamp((lr * n_lights).to(torch.int32),
                               max=n_lights - 1)
        if tally is not None:   # the light each ray samples
            tally["light"] = lidx
        nee_mask = (ms.is_matte > 0) & (hit.emissive == 0) & alive
        direct, wi_light = lights_ops.sample_direct(
            scene.objects, scene.lights, static, hit.p, hit.n, lu1, lu2, lidx,
            cull=cull, tally=tally)
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


def _initial_state(ro: Vec3, rd: Vec3) -> _PathState:
    shape = torch.broadcast_shapes(ro.shape, rd.shape)
    black = vm.zeros_vec(shape, rd.x)
    one = vm.full(shape, 1.0, rd.x)
    dev = rd.x.device
    return _PathState(ro.broadcast_to(shape), rd.broadcast_to(shape), black,
                      Vec3(one, one, one),
                      torch.ones(shape, dtype=torch.bool, device=dev),
                      torch.zeros(shape, dtype=torch.bool, device=dev))


def trace_rays(scene, static, ro: Vec3, rd: Vec3, noise: PixelNoise,
               max_bounces: int = C.MAX_BOUNCES, clamp_weight: bool = True,
               rand_override=None, early_exit: bool = False,
               cull: bool = False, tally: dict = None) -> Vec3:
    """Radiance of a batch of rays traced through the packed scene (`scene`
    a PackedScene view, `static` a SceneStatic), every bounce masked.

    `rand_override`: per bounce a dict of u1, u2, u_lobe, lu1, lu2, lidx
    fields that replace the RNG's (the oracle's parity test);
    `clamp_weight=False` leaves the BSDF weights unclipped, as the oracle
    does.  `early_exit`: see the module's docstring."""
    state = _initial_state(ro, rd)
    for bounce in range(max_bounces):
        if early_exit and bounce > 0 and not bool(state.alive.any()):
            continue      # every ray is dead: the bounce would add +0
        state = _bounce_step(scene, state, noise, static=static,
                             bounce=bounce, clamp_weight=clamp_weight,
                             rand_override=rand_override, cull=cull,
                             tally=tally,
                             skip_dead_shade=early_exit and bounce == 0)
    return state.e


def alive_fractions(scene, static, ro: Vec3, rd: Vec3, noise: PixelNoise,
                    max_bounces: int = C.MAX_BOUNCES,
                    weak_threshold: float = 1e-2):
    """Per-bounce occupancy: (alive, weak) tensors of shape (max_bounces,),
    alive[b] the fraction of rays still alive after bounce b and weak[b]
    the fraction alive with a throughput max-component below
    `weak_threshold` (what Russian roulette would also reclaim)."""
    state = _initial_state(ro, rd)
    alive, weak = [], []
    for bounce in range(max_bounces):
        state = _bounce_step(scene, state, noise, static=static,
                             bounce=bounce)
        alive.append(state.alive.to(rd.x.dtype).mean())
        tp = state.throughput.max_component()
        weak.append((state.alive & (tp < weak_threshold)).to(rd.x.dtype)
                    .mean())
    return torch.stack(alive), torch.stack(weak)


def pixel_grid(height: int, width: int, row0: int, device):
    """Global (row, col) int32 index grids of an H×W block starting at row0."""
    ii = (row0 + torch.arange(height, dtype=torch.int32, device=device))
    jj = torch.arange(width, dtype=torch.int32, device=device)
    return (ii[:, None].expand(height, width),
            jj[None, :].expand(height, width))


def render_sample(scene, static, height: int, width: int, seed, sample_idx,
                  max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
                  image_height: int = None, cull: bool = False,
                  tally: dict = None, n_samples: int = None,
                  early_exit: bool = False) -> Vec3:
    """Radiance of one 1-spp pass over an H×W block whose first row is
    global row `row0` of an image `image_height` rows tall (default
    `height`).  With `n_samples`, the passes of samples sample_idx,
    sample_idx + 1, ... traced together, as (n_samples, H, W) tensors."""
    image_height = height if image_height is None else image_height
    like = scene.camera.eye.x
    ii, jj = pixel_grid(height, width, row0, like.device)
    if n_samples is not None:
        shape = (n_samples, height, width)
        ii, jj = ii.expand(shape), jj.expand(shape)
        sample_idx = sample_idx + torch.arange(
            n_samples, dtype=torch.int64, device=like.device).view(-1, 1, 1)
    noise = PixelNoise(seed, sample_idx, ii, jj)
    jx, jy, _ = noise.uniform3(0, rng.TAG_PIXEL_JITTER)
    ro, rd = rays_for_pixels(scene.camera, ii.to(like.dtype),
                             jj.to(like.dtype), image_height, width, jx, jy)
    return trace_rays(scene, static, ro, rd, noise, max_bounces, cull=cull,
                      tally=tally, early_exit=early_exit)


def render_sum(scene, static, height: int, width: int, spp: int, seed,
               sample0, max_bounces: int = C.MAX_BOUNCES, row0: int = 0,
               image_height: int = None, cull: bool = False,
               early_exit: bool = False) -> Vec3:
    """SUM of `spp` passes (samples sample0, sample0+1, ...), added in
    sample order: the plain version of the K1 megakernel.  Samples are
    traced together, up to RAYS_PER_PASS rays at once.

    Under autograd each pass is checkpointed (`jax.checkpoint` in the JAX
    package): the backward re-traces a pass instead of keeping every
    pass's graph, so a 1024² backward holds one sample's graph, not
    spp of them.  Values are the same either way."""
    acc = vm.zeros_vec((height, width), scene.camera.eye.x)
    # every leaf is a view of one flat tensor, so one leaf tells
    grad = torch.is_grad_enabled() and scene.camera.eye.x.requires_grad
    per_pass = max(1, min(spp, RAYS_PER_PASS // (height * width)))
    for s in range(0, spp, per_pass):
        n = min(per_pass, spp - s)
        one = functools.partial(render_sample, scene, static, height, width,
                                seed, sample0 + s, max_bounces, row0=row0,
                                image_height=image_height, cull=cull,
                                n_samples=n, early_exit=early_exit)
        if grad:
            one = functools.partial(checkpoint, one, use_reentrant=False)
        rad = one()
        for k in range(n):
            acc = acc + Vec3(rad.x[k], rad.y[k], rad.z[k])
    return acc


def render_image(scene, static, height: int, width: int, spp: int, seed=0,
                 max_bounces: int = C.MAX_BOUNCES) -> Vec3:
    """Mean of `spp` progressive passes."""
    return render_sum(scene, static, height, width, spp, seed, 0,
                      max_bounces) * (1.0 / spp)
