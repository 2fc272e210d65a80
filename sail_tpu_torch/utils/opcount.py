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
# shading frame, BSDF sample and path update of a hit (path.cuh `bounce`)
SHADE_OPS = {C.MATTE: 130, C.MIRROR: 90}
# light sample, geometry terms and the light's BSDF value (before the scan)
NEE_OPS = 100
# per light, once per launch: its area pdf and oriented normal
LIGHT_OPS = 20
# pixel jitter to a normalised camera ray, and the sample's sum
CAMERA_OPS = 30
# K2: the adjoint of one hit bounce beyond its forward, by winner category
# (adjoint.cuh `bounce_adj`, shape adjoints), and of the camera
ADJ_SHADE_OPS = {C.MATTE: 420, C.MIRROR: 200}
ADJ_NEE_OPS = 225
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
    alive = r["alive"].to(f64)
    k1 = _test_ops(r["scan"]) * r["entered"] + (
        _table(HIT_OPS, cat)[cat] + _table(SHADE_OPS, mat)[mat]) * alive
    adj = (_table(ADJ_HIT_OPS, cat)[cat] + _table(ADJ_SHADE_OPS, mat)[mat]) \
        * alive
    if r["shadow"] is not None:
        nee = r["nee"].to(f64)
        k1 = k1 + (NEE_OPS + _test_ops(r["shadow"])) * nee
        adj = adj + ADJ_NEE_OPS * (r["nee"] & ~r["occluded"])
    return float(k1.sum()), float(adj.sum())


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
                 + LIGHT_OPS * len(static.light_categories))
    k1 = k1 * scale + CAMERA_OPS * pixels + once
    k2 = k1 + adj * scale + ADJ_CAMERA_OPS * pixels \
        + float(sum(OBJECT_ADJ_OPS.get(c, 0) for c in cats))
    return k1, k2
