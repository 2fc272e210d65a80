"""FP32 operation counts of the render megakernels, for their bound.

The constants are counted by hand from the device code (`csrc/path.cuh`,
`csrc/adjoint.cuh`): every float add, subtract, multiply, divide, square
root, min, max, absolute value and comparison is one operation; integer work
(the RNG, the table walk) and selects are not counted.  `live_ops` runs the
plain torch version (`render/integrator.py`) with a tally of the masks and
tests of each bounce and adds up the work the inputs actually need: a dead
path does no bounce, a shadow scan stops at its first occluder, a culled
cluster costs one slab test.  What depends on an object alone (a
rectangle's frame, a light's area) is counted once per object per launch,
not on every test that the kernels recompute it for, and K2's work is one
forward plus the adjoint (not the re-run its design adds).  The bound is
then ops / 67 TFLOP/s (the H100 SXM's FP32 rate outside the tensor cores,
which counts an FMA as two; the kernels are built without FMA contraction,
so one instruction does one operation and half that rate is their
instruction ceiling).
"""
from __future__ import annotations

import torch

from .. import constants as C

H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
# The SFU (rsqrt, sin, cos, exp2, log2; MUFU): 16 results per SM per clock
# on the H100's 132 SMs (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0); its rate is that times the SM clock.
H100_SMS = 132
SFU_PER_SM_CLOCK = 16

# t-only intersection test per object, by category (path.cuh `object_t`),
# without what depends on the object alone (OBJECT_OPS)
T_OPS = {
    C.SPHERE: 37,
    C.CUBE: 42,
    C.RECTANGLE: 50,
    C.CONE: 67,
    C.CYLINDER: 50,
    C.DISK: 25,
    C.HYPERBOLOID: 68,
    C.PARABOLOID: 55,
    C.CORNELLBOX: 36,
}
# per object, once per launch: the rectangle's frame (`rect_frame`: edges,
# normal, lengths, tangents), the sphere's r², the cone's (r/h)², the
# paraboloid's z range and curvature, the hyperboloid's z range
OBJECT_OPS = {C.RECTANGLE: 51, C.SPHERE: 1, C.CONE: 2, C.PARABOLOID: 5,
              C.HYPERBOLOID: 2}
# K2, per rectangle, once per launch: the frame's adjoint (`rect_frame_adj`)
# onto its corners, from cotangents summed per object (counted in the hit
# and light adjoints below)
OBJECT_ADJ_OPS = {C.RECTANGLE: 120}
# one cluster bound-box slab test (`closest`/`occluded` with cull)
SLAB_OPS = 36
# the winner's hit record beyond its t test (path.cuh `object_hit`)
HIT_OPS = {
    C.SPHERE: 80,
    C.CUBE: 70,
    C.RECTANGLE: 22,
    C.CONE: 120,
    C.CYLINDER: 100,
    C.DISK: 80,
    C.HYPERBOLOID: 180,
    C.PARABOLOID: 130,
    C.CORNELLBOX: 70,
}
# shading frame, BSDF sample and path update of a hit (path.cuh `bounce`;
# metal and glass in bsdf.cuh: the microfacet half-vector, reflection or
# refraction, D twice, the Fresnel term and the pdf, an isotropic GGX sample's
# count; glass the mean of its specular and rough lobes)
SHADE_OPS = {C.MATTE: 130, C.MIRROR: 90, C.METAL: 350, C.GLASS: 300}
# the surface color of a uv texture (bsdf.cuh `texture_color`)
TEX_OPS = {C.UNIFORM_COLOR: 0, C.CHECKERBOARD: 14, C.CHECKERBOARD2: 8,
           C.BILERP: 29, C.MIXF: 12, C.SCALE: 3, C.UVF: 4}
# light sample, geometry terms and the light's BSDF value (before the scan)
# of an AREA light over a RECTANGLE
NEE_OPS = 100
# per light, once per launch: a rectangle light's area pdf and oriented
# normal
LIGHT_OPS = 20
# the same for every other light (path.cuh `light_sample_other`), by its
# category or, for AREA, the shape it samples: the part every light shares
# (to the light, d², the direction, the surface cosine, the shadow ray and
# the BSDF value toward it) is 69; a full-precision cosf or sinf counts 10.
# POINT: uniform_sphere (29) and the jittered origin; SPOT: the falloff; an
# area light its sampler, normal, pdf (per sample here) and cos_l:
# uniform_sphere, concentric_disk (38), the cube's face pick (34), the
# lateral surface (49 and its band: cone 11, cylinder 5, paraboloid 18,
# hyperboloid 16)
NEE_LIGHT_OPS = {C.POINT: 109, C.SPOT: 84}
NEE_AREA_OPS = {C.SPHERE: 126, C.DISK: 133,
                C.CUBE: 122, C.CONE: 145, C.CYLINDER: 139,
                C.PARABOLOID: 152, C.HYPERBOLOID: 150}
# pixel jitter to a normalised camera ray, and the sample's sum
CAMERA_OPS = 30
# K5a (csrc/profile.cu `isect_only_kernel`), per path-bounce beyond the t
# tests and the winner's hit record: the facing test (a dot and a
# comparison), the reflection (a dot, 2·, n·s, a subtraction), its
# normalisation (a dot, a max, a sqrt, a divide, 3 multiplies), the next
# origin (3 multiplies, 3 adds) and the sum of t
ISECT_BOUNCE_OPS = 6 + 12 + 11 + 6 + 1
# K5b/K5c (`fma_mix`, `integrator_mix`), per element-iteration: FP32
# operations under the FLOP convention (a fused mul-add 2; for
# integrator_mix two of each of mul, add, max, compare, mul, mul, |x|, add;
# selects not counted), SFU operations (rsqrt), and the TPU tool's own count
# (tools/profile_megakernel.py:602-603, a mul-add 1)
MIX_OPS = {"fma": dict(fp32=16, sfu=0, tpu=8),
           "integrator_mix": dict(fp32=16, sfu=2, tpu=10)}
# K5c: independent chains per element
ILP = 8
# K2: the adjoint of one hit bounce beyond its forward, by winner category
# (adjoint.cuh `bounce_adj`, shape adjoints), and of the camera
# (metal and glass: three times their forward, what a reverse sweep of the
# sample costs, not the forward-mode tangents `material_adj` runs)
ADJ_SHADE_OPS = {C.MATTE: 420, C.MIRROR: 200, C.METAL: 3 * 350,
                 C.GLASS: 3 * 300}
# a texture's adjoint (`texture_adj`), with the hit's u, v adjoint through
# the shape (an atan2 and, on a sphere, an acos) where the texture reads them
ADJ_TEX_OPS = {C.UNIFORM_COLOR: 3, C.CHECKERBOARD: 0, C.CHECKERBOARD2: 11,
               C.BILERP: 50 + 90, C.MIXF: 15, C.SCALE: 6, C.UVF: 2 + 90}
# an unoccluded light sample's adjoint, AREA over a RECTANGLE (the frame's
# adjoint once per object: OBJECT_ADJ_OPS), then every other light
# (adjoint.cuh `light_adj`: the part they share 163, the sampler recomputed
# from lu1, lu2 and its adjoint)
ADJ_NEE_OPS = 225
ADJ_NEE_LIGHT_OPS = {C.POINT: 206, C.SPOT: 192}
ADJ_NEE_AREA_OPS = {C.SPHERE: 237, C.DISK: 238,
                    C.CUBE: 269, C.CONE: 300, C.CYLINDER: 282,
                    C.PARABOLOID: 322, C.HYPERBOLOID: 320}
ADJ_HIT_OPS = {
    C.SPHERE: 110,
    C.CUBE: 60,
    C.RECTANGLE: 140,
    C.CONE: 260,
    C.CYLINDER: 230,
    C.DISK: 90,
    C.HYPERBOLOID: 330,
    C.PARABOLOID: 270,
    C.CORNELLBOX: 60,
}
ADJ_CAMERA_OPS = 50


def bound_ms(ops: float, nbytes: float = 0.0) -> tuple:
    """(least time in ms, what bounds it): the larger of ops over the FP32
    rate and bytes over the memory rate."""
    t_ops = ops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _table(ops: dict, like):
    tab = torch.zeros(max(ops) + 1, dtype=torch.float64, device=like.device)
    for k, v in ops.items():
        tab[k] = float(v)
    return tab


def _test_ops(tests: dict) -> torch.Tensor:
    """FP32 work per ray of a scan's tests (intersect.py's tally)."""
    return sum(v * float(SLAB_OPS if k == "slab" else T_OPS[k])
               for k, v in tests.items())


def bounce_ops(static, r: dict) -> tuple:
    """(K1's, K2's adjoint's) FP32 operations of one bounce record of the
    integrator's tally: `entered` paths ran the closest-hit scan, `alive`
    ones hit, `nee` ones sampled a light and scanned for its occluders."""
    dev = r["alive"].device
    f64 = torch.float64
    cat = torch.tensor(static.object_categories, dtype=torch.long,
                       device=dev)[r["obj_id"].long().clamp(min=0)]
    mat = torch.tensor(static.material_categories, dtype=torch.long,
                       device=dev)[r["mat_row"].long()]
    obj = r["obj_id"].long().clamp(min=0)
    tex = torch.tensor([static.texture_categories[t]
                        for t in static.object_tex_rows], dtype=torch.long,
                       device=dev)[obj]
    # the Cornell box's walls take their color from the wall, not a texture
    tex = torch.where(cat == C.CORNELLBOX, C.UNIFORM_COLOR, tex)
    alive = r["alive"].to(f64)
    k1 = _test_ops(r["scan"]) * r["entered"] + (
        _table(HIT_OPS, cat)[cat] + _table(SHADE_OPS, mat)[mat]
        + _table(TEX_OPS, tex)[tex]) * alive
    adj = (_table(ADJ_HIT_OPS, cat)[cat] + _table(ADJ_SHADE_OPS, mat)[mat]
           + _table(ADJ_TEX_OPS, tex)[tex]) * alive
    if r["shadow"] is not None:
        nee = r["nee"].to(f64)
        fwd, back = light_ops(static)
        li = r["light"].long()
        k1 = k1 + (torch.tensor(fwd, dtype=f64, device=dev)[li]
                   + _test_ops(r["shadow"])) * nee
        adj = adj + torch.tensor(back, dtype=f64, device=dev)[li] * (
            r["nee"] & ~r["occluded"])
    return float(k1.sum()), float(adj.sum())


def light_ops(static) -> tuple:
    """(K1's, K2's adjoint's) FP32 operations of one light sample of each
    of the scene's lights, in light order."""
    fwd, back = [], []
    for cat, obj in zip(static.light_categories, static.area_light_objects):
        shape = static.object_categories[obj] if cat == C.AREA else None
        if shape == C.RECTANGLE:
            fwd.append(NEE_OPS)
            back.append(ADJ_NEE_OPS)
        elif cat == C.AREA:
            fwd.append(NEE_AREA_OPS[shape])
            back.append(ADJ_NEE_AREA_OPS[shape])
        else:
            fwd.append(NEE_LIGHT_OPS[cat])
            back.append(ADJ_NEE_LIGHT_OPS[cat])
    return fwd, back


def live_ops(params, static, height: int, width: int, spp: int, seed,
             max_bounces: int, cull: bool = False, samples: int = None,
             row0: int = 0, image_height: int = None, row_step: int = 1):
    """(K1 ops, K2 ops) the plain version's masks give for these inputs (a
    block whose first row is global row `row0` of an `image_height`-row
    image, as the kernels take it): `samples` of the `spp` samples are
    traced (all by default), and every `row_step`-th row of the block, and
    the count is scaled to the block's spp and rows."""
    from ..core.camera import rays_for_pixels
    from ..core.rng import TAG_PIXEL_JITTER, PixelNoise
    from ..render import integrator
    from ..scene.scene import unflatten
    samples = spp if samples is None else min(samples, spp)
    image_height = height if image_height is None else image_height
    scene = unflatten(params.detach(), static)
    dev = params.device
    ii = row0 + torch.arange(0, height, row_step, dtype=torch.int32,
                             device=dev)
    jj = torch.arange(width, dtype=torch.int32, device=dev)
    ii, jj = (ii[:, None].expand(len(ii), width),
              jj[None, :].expand(len(ii), width))
    k1 = adj = 0.0
    with torch.no_grad():
        for s in range(samples):   # render_sample over the traced rows
            noise = PixelNoise(seed, s, ii, jj)
            jx, jy, _ = noise.uniform3(0, TAG_PIXEL_JITTER)
            ro, rd = rays_for_pixels(scene.camera, ii.to(params.dtype),
                                     jj.to(params.dtype), image_height,
                                     width, jx, jy)
            tally = {}
            integrator.trace_rays(scene, static, ro, rd, noise, max_bounces,
                                  cull=cull, tally=tally)
            for r in tally.get("bounces", ()):
                a, b = bounce_ops(static, r)
                k1, adj = k1 + a, adj + b
    scale = spp / samples * height / ii.shape[0]
    pixels = float(height * width * spp)
    cats = static.object_categories
    once = float(sum(OBJECT_OPS.get(c, 0) for c in cats)
                 + LIGHT_OPS * sum(
                     cat == C.AREA and cats[obj] == C.RECTANGLE
                     for cat, obj in zip(static.light_categories,
                                         static.area_light_objects)))
    k1 = k1 * scale + CAMERA_OPS * pixels + once
    k2 = k1 + adj * scale + ADJ_CAMERA_OPS * pixels \
        + float(sum(OBJECT_ADJ_OPS.get(c, 0) for c in cats))
    return k1, k2


def ray_ops(params, static, ro, rd, noise,
            max_bounces: int) -> float:
    """KR's FP32 operations on a batch of given rays
    (`ops/cuda/megakernel.trace_rays`): K1's per-bounce count of the
    plain version's masks for these rays, with no camera ray, and each
    object's and light's once-per-launch work."""
    from ..render import integrator
    from ..scene.scene import unflatten
    tally = {}
    with torch.no_grad():
        integrator.trace_rays(unflatten(params.detach(), static), static, ro,
                              rd, noise, max_bounces, tally=tally)
    ops = sum(bounce_ops(static, r)[0] for r in tally.get("bounces", ()))
    cats = static.object_categories
    once = sum(OBJECT_OPS.get(c, 0) for c in cats) + LIGHT_OPS * sum(
        cat == C.AREA and cats[obj] == C.RECTANGLE
        for cat, obj in zip(static.light_categories,
                            static.area_light_objects))
    return ops + float(once)


# KP (csrc/penumbra.cuh `penumbra_pixel`), counted as above: per (pixel,
# receiver, sphere) where the pixel is a receiver, the occluder's frame
# (`occluder`, 60) and, once, the adjoint of what the samples share (80);
# per light of it the projected center and the numerator (34); per curve
# point (K + 1 a light) 35; per sample its mask (49); per sample that lights
# the receiver the coefficient (Lambert's matte_f, h, the tangent, n̂ and
# its side: 80) and its adjoint and value (90)
PENUMBRA_UNIT_OPS = 60 + 80
PENUMBRA_LIGHT_OPS = 34
PENUMBRA_POINT_OPS = 35
PENUMBRA_SAMPLE_OPS = 49
PENUMBRA_VALID_OPS = 80 + 90


def penumbra_ops(tally: dict, n_curve_samples: int) -> float:
    """KP's FP32 operations on the inputs whose plain version
    (`ops/cuda/penumbra.penumbra_scalar_plain(..., tally=)`) filled
    `tally`: its receiver pixels per (receiver, sphere, light) and its
    samples that light the receiver."""
    K = n_curve_samples
    per_light = (PENUMBRA_LIGHT_OPS + (K + 1) * PENUMBRA_POINT_OPS
                 + K * PENUMBRA_SAMPLE_OPS)
    return float(tally["units"] * PENUMBRA_UNIT_OPS
                 + tally["unit_lights"] * per_light
                 + tally["valid"] * PENUMBRA_VALID_OPS)


# KA (csrc/alhazen.cuh): one evaluation of the centre's alignment h
# (`ka_h`) and of the radial residual g (`ka_g`), each cosf and sinf one
# operation; the centre evaluates h 64 + 1 + 30 + 2 + 1 times (its scan,
# the bracket's low end, the halvings, the slope, the Newton step), once per
# pair however many blocks repeat it, and each azimuth g once per radial
# scan sample up to its first positive one, then 1 + 30 + 2 times
ALHAZEN_H_OPS = 79
ALHAZEN_G_OPS = 87
ALHAZEN_CENTER_EVALS = 98
ALHAZEN_AZIMUTH_EVALS = 33


def alhazen_ops(tally: dict) -> float:
    """KA's FP32 operations on the inputs whose plain version
    (`ops/cuda/alhazen.solve_plain(..., tally=)`) filled `tally`."""
    return float(ALHAZEN_H_OPS * ALHAZEN_CENTER_EVALS
                 + ALHAZEN_G_OPS * (tally["radial_scan"]
                                    + ALHAZEN_AZIMUTH_EVALS
                                    * tally["azimuths"]))


def isect_only_ops(params, static, height: int, width: int, spp: int,
                   max_bounces: int, row0: int = 0,
                   image_height: int = None) -> float:
    """K5a's FP32 operations on these inputs: every path runs every bounce
    (no early exit) and tests every object (no cull); a hit adds its
    winner's record; each sample repeats the same rays, so one sample's
    count is scaled by spp, and the camera ray is computed once per
    pixel."""
    from ..ops.cuda.profile import isect_only_plain
    tally = []
    with torch.no_grad():
        isect_only_plain(params.detach(), static, height, width, 1,
                         max_bounces, row0, image_height, tally=tally)
    cats = static.object_categories
    tests = float(sum(T_OPS[c] for c in cats))
    ops = 0.0
    for obj, valid in tally:
        cat = torch.tensor(cats, dtype=torch.long,
                           device=obj.device)[obj.long().clamp(min=0)]
        ops += (tests + ISECT_BOUNCE_OPS) * obj.numel() + float(
            (_table(HIT_OPS, cat)[cat] * valid).sum())
    once = float(sum(OBJECT_OPS.get(c, 0) for c in cats))
    return ops * spp + CAMERA_OPS * height * width + once


def alu_bound_ms(mix: str, elem_iters: float, sm_clock_mhz: float,
                 chains: int = 1) -> dict:
    """K5b's (or, with `chains`=ILP, K5c's) least time for `elem_iters`
    element-iterations of `mix`: the larger of its FP32 operations over
    H100_FP32_FLOPS and its SFU operations over the SFU's rate at
    `sm_clock_mhz`."""
    m = MIX_OPS[mix]
    n = elem_iters * chains
    fp32_ms = m["fp32"] * n / H100_FP32_FLOPS * 1e3
    sfu_ms = m["sfu"] * n / (H100_SMS * SFU_PER_SM_CLOCK
                             * sm_clock_mhz * 1e6) * 1e3
    return {"bound_ms": max(fp32_ms, sfu_ms), "bound_by": "operations",
            "pipe": "sfu" if sfu_ms > fp32_ms else "fp32",
            "fp32_ms": fp32_ms, "sfu_ms": sfu_ms,
            "fp32_flops": m["fp32"] * n, "sfu_ops": m["sfu"] * n,
            "tpu_ops": m["tpu"] * n}
