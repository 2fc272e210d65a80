"""End-to-end smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device and build: torch, CUDA, nvcc, the card's name and power limit;
     builds K1 (csrc/megakernel.cu, eight scene kinds), K2's seventeen
     builds (csrc/megakernel_grad.cu once per build of
     ops/cuda/megakernel.py GRAD_BUILDS: the gradient in shared memory or
     in local arrays of three sizes, with and without MATS and LIGHTS,
     and configs 1-2's kind at two blocks per SM), K2's reduce
     (csrc/reduce_grad_rows.cu), the profiling kernels (csrc/profile.cu:
     K5a, K5b, K5c, K1 with each of four phases stripped), K2's stripped
     builds (csrc/profile_grad.cu), KR (csrc/trace_rays.cu), KP
     (csrc/penumbra.cu) and KA (csrc/alhazen.cu), one nvcc each, as many
     at once as the host has cores, and reports each kernel's registers,
     stack, spills and static shared memory (nvcc -Xptxas -v): K1's per
     build, render_block_kernel<ALL, CULL, MATS, STRIP>.
  2. kernel vs plain on the card: K1 against its plain torch version on the
     same CUDA tensors (cornell_matte, cornell_mirror, a row tile, a ragged
     block with another seed, whose threads past the image's edge take part
     in every barrier of K1's loop, and open_lights: misses, Oren-Nayar, an
     emissive sphere, a reversed light, two lights, a 3:2 image), and the
     committed golden images tests/goldens/config{1,2}*.npy.
  3. the forward path: Renderer(1024, 1024, seed=0, max_bounces=5,
     device="cuda") -> update(cornell_mirror) -> render_spp(64) ->
     output(gamma), which must go through exactly one K1 launch; then K1
     held against the plain version at that shape, both timed, and a
     progressive frame (render(), 1 spp) timed.
  4. the gradient path (bench.py's fwd+bwd step): K2 against its plain
     version (torch autograd) at 64² on three scenes and a row tile, and at
     1024² x 4 spp, in relative L-inf and per leaf; K2 bit-identical on
     repeat; its reduce pass bit for bit against its plain version (the
     same sums in the same order) and against a float64 sum, on config
     2's rows (4,096 x 72) and the 256-sphere scene's (4,096 x 3,375),
     timed per launch queued behind a sleeping kernel beside the plain
     version and sum(0); then
     render_image_fast(params, seed, static, 1024, 1024, 64, 5) ->
     mean(x + y + z) -> backward(), through exactly one K1, one K2 and one
     reduce launch, timed; K2 at that shape bit for bit against the step's
     gradient, and against its plain version on a full-width row tile of
     the step (relative L-inf and per leaf with the pixel term); then 5
     Adam steps on the materials and lights from a perturbed scene toward a
     target image, whose loss must fall.
  5. every shape and many objects, forward: K1 against its plain version at
     64² on the quadrics scene (one of each new shape), 9 cubes and 8 disks
     (two batched groups of new shapes), 12 and 64 spheres, and the 8 flat
     rectangles with the cull (whose padded bound boxes must keep every
     rectangle); then Renderer(1024, 1024, seed=0, max_bounces=5) ->
     update(16 spheres: the batched fold; then 64: the fold and the cull,
     which render_block turns on by itself from 4 clusters) ->
     render_spp(64) -> output, each through exactly one K1 launch, timed,
     and K1 held against its plain version on a full-width row tile at the
     path's 64 spp and 5 bounces; then the many-object sweep of
     sail_tpu_torch/tools/many_object_bench.py (4 to 256 spheres, with and
     without the cull, 512² x 8 spp x 3 bounces; the two images equal bit
     for bit), printed as one JSON line.
  6. gradients on the new shapes and many objects: K2 against its plain
     version (relative L-inf and per leaf) on the quadrics and 12-sphere
     scenes at 64², bit-identical on repeat; then render_image_fast on 64
     spheres (879 parameters) at 1024² x 64 spp x 5 bounces and on 256
     (3,375) at 1 spp ->
     mean(x+y+z) -> backward(), each through exactly one K1, one K2 and one
     reduce launch, timed, its gradient K2's at the same arguments bit for
     bit; K2 (and the 256-sphere step's K1) held against the plain version
     on a full-width row tile of each step at its spp and bounces, the
     worst leaf split into its per-pixel contributions on both sides
     (sail_tpu_torch/tools/grad_localise.py).
  7. materials and early exit (BASELINE config 3): K1 against its plain
     version at 64² x 4 spp x 3 bounces on material_demo, its open twin
     material_demo_open and the check scene material_check (Beckmann and
     anisotropic GGX metal, rough glass of both distributions, each uv
     texture), and golden config3 (the open twin's paths end at different
     bounces, so K1's threads regenerate paths out of step); then
     Renderer(1024, 1024, seed=0,
     max_bounces=5) -> update(material_demo) -> render_spp(64) -> output
     through exactly one K1 launch, timed, its K1 held against the plain
     version on a full-width row tile; Renderer(..., early_exit=True) on
     material_demo_open, bit-identical to early_exit=False, its tile held
     against the plain version with early_exit=True, and the fraction of
     paths alive after each bounce from the plain version's masks; then
     render_image_fast(material_demo, 1024², 64 spp, 5 bounces) ->
     mean(x+y+z) -> backward() through one K1, one K2 and one reduce
     launch, its gradient K2's bit for bit, K2 held against the plain
     version on a row tile of the step (relative L-inf and per leaf with
     the pixel term) and at 64² x 4 spp on material_check, where u and v
     carry gradient.
  8. the profiling path: K5a (the intersect-only path) bit for bit against
     its plain version at 64² x 4 spp x 5 bounces on cornell_mirror,
     material_demo_open (misses) and 16 spheres (the batched fold), and on
     a full-width row tile at 1024² x 64 x 5; each stripped K1 build bit for
     bit against its stripped plain version at 64² x 4 x 3 and different
     from the full image, and on a full-width row tile at 1024² x 64 x 5;
     K5b and K5c against their plain versions at K = 1, 2, 3 and at full
     K (fma within 1 ulp, the rsqrt mixes within MIX_RTOL); then the sections `phases` (1024² x 64 x 5) and `vpu_peak`
     of sail_tpu_torch/tools/profile_megakernel.py, their launches counted,
     where K5a at 64 spp must take 50 times its 1-spp time and every
     stripped image must differ from the full one, printed as one JSON
     line; then tools/determinism_check.py at 256² x 8 x 5, which must
     pass, and tools/occupancy_study.py at 256² x 4 x 5, one JSON line each.
  9. K2's phase split: its two stripped builds (the forward sweep alone;
     the sweep and the replay of the recorded decisions without the
     adjoint) against their plain versions at 64² x 4 x 3 and on a
     full-width row tile at 1024² x 64 x 5; then, counted, K2 and both
     stripped builds on config 2 at 1024² x {4, 16, 64} spp x 5 bounces
     (ms and ms per sample), printed as one JSON line with K2's resources
     (-Xptxas -v).
 10. lights (BASELINE config 4, lights_and_quadrics: an area, a point and a
     spot light over a cone, a metal cylinder, a disk and a paraboloid; and
     the check scene area_lights: an area light over each of seven other
     shapes): K1 against its plain version bit for bit at 64² x 4 spp x 3
     bounces and on a full-width row tile at 1024² x 64 x 5, golden
     config4; K2 against its plain version on a full-width row tile of each
     at the step's 64 spp (relative L-inf and per leaf with the pixel
     term), bit-identical on repeat; then Renderer(1024, 1024, seed=0,
     max_bounces=5) -> update(lights_and_quadrics) -> render_spp(256) ->
     output through exactly one K1 launch, timed, its K1 bit for bit
     against the plain version on a row tile at 256 spp; then
     render_image_fast(lights_and_quadrics, 1024², 64 spp, 5 bounces) ->
     mean(x+y+z) -> backward() through one K1, one K2 and one reduce
     launch, timed, its gradient K2's bit for bit; then K2's LIGHTS builds
     at 1,024 and 4,096 floats on 24 and 80 spheres with a point light
     (lit_spheres) against their plain version at 16² x 1 spp x 2 bounces
     (relative L-inf and per leaf with the pixel term), bit-identical on
     repeat, and the fwd+bwd step of each (24 spheres at 1024² x 64 x 5,
     80 at 1024² x 1 x 5) through one K1, one K2 and one reduce launch,
     timed, its gradient K2's bit for bit.
 11. display and runtime: BASELINE config 4 whole, Renderer(1024, 1024,
     seed=0, max_bounces=5) -> update(lights_and_quadrics with its Gaussian
     filter) -> render_spp(256) through one K1 launch -> output, K1 and
     output timed, the frame held against the same filter on the CPU from
     the same accumulation; config 2 at 1024² x 64 x 5: the lazy G-buffer
     fill timed and held against the CPU's (excusing only pixels whose
     ray grazes a sphere), and output() for each of the 11 filters timed
     and held against the filter on the CPU; a fresh Renderer that loads a
     32-spp checkpoint and renders 32 more equal to the render that went
     on, and to one render_spp(64); the viewer's loop at 256² (Control:
     a pick and an 8-move drag of the matte sphere, 8 orbit moves, a zoom;
     each event a frame: render_spp(1) + output(gamma) with the selection
     box + png_bytes), timed by part, and pick on the card against the CPU
     on a 16 x 16 grid of pixels.
 12. inverse rendering (BASELINE config 5, cornell_mirror perturbed) at
     1024² x 16 spp x 4 bounces: the target through one K1 launch, five
     train steps with the edge terms, each one K1, one K2, one KR (the
     silhouette term's straddle rays in one batch, csrc/trace_rays.cu),
     one KP (the penumbra term and its adjoint, csrc/penumbra.cu) and two
     reduce launches (K2's and KP's rows) and no call of the plain
     integrator's trace_rays, the loss falling, timed on the host clock
     and by CUDA events; the kernels a step with and without the edge
     terms (torch.profiler, utils/metrics.profile_trace); the split: the
     silhouette term (its trace_rays call and its bisections), the
     penumbra term, the step without them; the batched silhouette term
     against the same sites traced one by one (within 1e-6 of the largest
     leaf); KR against the plain trace_rays on the step's straddle rays
     bit for bit, and KP's penumbra term against the plain version's per
     leaf (within 1e-4 of the largest leaf), each timed; the interior
     gradient K2's bit for bit, K1 and K2 against their plain versions on
     a row tile, the edge terms on the card against the CPU at 64², a
     central difference.
 13. the multi-device parallel/ on the one card: (a) render_sharded
     (cornell_mirror, 1024² x 64 x 5) over make_mesh(8, spp_axis=2) of
     ranks on cuda:0 through exactly 8 K1 launches, within relative 1e-5
     of the one-rank image, the 8 x 1 layout bit for bit, timed (median
     of 3) beside one rank, K1 held against its plain version on a row
     tile of a rank's block; (b) the ElasticRenderer on those ranks at
     256² x 16 x 5, chunk 4, half the ranks lost at chunk 1: bit for bit
     the same render without the loss, the events naming the shrink; (c)
     config 5's train step at 1024² x 16 x 4 over 2 ranks: without the
     edge terms (2, 2, 2) K1/K2/reduce launches a step, the gradient
     within relative 1e-5 and the loss 1e-6 of the one-rank step's; with
     them 3 steps timed, each one KR and one KP launch a rank; (d) NCCL
     at world size 1 (a tcp://127.0.0.1 free port): (a)'s render through
     the collectives bit for bit, then the process group destroyed.
 14. the last modules: tools/gpu_checks.py on the card (K1 bit for bit, K2
     against autograd through the plain version, the one-rank sharded
     render and gradient; its JSON line), the native image codec built
     (utils/native.py) with its PNG pixels against the Python encoder's,
     a 256² viewer frame of examples/viewer.py by part (K1, output, PNG)
     served to a localhost request, examples/render_scenes.py at 64² x 4
     on each of its scenes and examples/inverse_render.py for 3 steps at
     64², their launches counted (a step of the latter: one K1, K2 and
     reduce; the edge terms' KR, KP and reduce eager at the first step,
     then captured and replayed as one CUDA graph, which the wrappers do
     not count).
Every kernel's bound is computed from this run's inputs: the FP32
operations the plain version's masks say these paths need
(sail_tpu_torch/utils/opcount.py) over 67 TFLOP/s, or the bytes over
3.35 TB/s, whichever is larger; K5b's and K5c's, the slower of their FP32
operations over 67 TFLOP/s and their rsqrts over the SFU's 16 per SM per
clock at the card's maximum SM clock; each row of the `kernels` line gives
the bound's share of the kernel's time.  The last two lines are a JSON
object per kernel and the JSON result.  Imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H = W = 1024
SPP = 64
BOUNCES = 5
TOL = 1e-4          # atol = rtol, as tests/test_goldens.py
TIMED_RUNS = 5
# K2 vs its plain version, relative L-inf (max |diff| / max |plain|).  At
# 64²: the gate of tools/tpu_checks.py.  At 1024² x 4 and x 64 spp (the
# main path's shape) the same bound: the two sum 4M and 67M path samples'
# gradients in different float32 orders (a per-thread sum over the samples,
# then fixed trees, against torch's reductions); both are deterministic, and
# an earlier run measured 9.5e-8 at 4 spp, so 1e-5 leaves two orders of
# magnitude for the ordering.
GRAD_TOL = 1e-5
# ... and per leaf |diff| <= LEAF_RTOL·|plain| + LEAF_ATOL·max|plain|
# (sail_tpu_torch/tools/grad_localise.py), so a small leaf (a camera or
# light adjoint) cannot hide under the largest one
ADAM_STEPS = 5
# phases 5-6: the many-object scene's sphere counts on the driven paths (the
# Renderer on FEW spheres runs the batched fold alone, on MANY the fold and,
# by render_block's own choice, the cull; the fwd+bwd step on MANY at the
# main path's spp and on MOST at 1 spp), the sweep (the shape of
# tools/many_object_bench.py, and 32 for the cull's crossover), and the
# full-width row tiles at which each path's kernels are held against their
# plain versions (the plain K2 keeps one pass's autograd graph, ~70 KB a ray
# at 64 spheres; its runs and their per-pixel split took 217 of phase 6's
# 244 s on an H100, with checks at 32² on 64 and 256 spheres beside the
# steps' tiles of the same builds; on 256 spheres the plain version costs
# its launches, not its pixels, 8 rows as long as 16, so those builds are
# held on the steps' tiles alone): (rows, first row) of the 1024-row image
FEW, MANY, MOST = 16, 64, 256
SWEEP_COUNTS = (4, 16, 32, 64, 128, 256)
SWEEP_SIZE, SWEEP_SPP, SWEEP_BOUNCES = 512, 8, 3
K1_TILE = (32, 496)
K2_TILE = {MANY: (2, 511), MOST: (8, 508), "material_demo": (8, 508),
           "cornell_mirror": (32, 496)}
# phase 7: the check scenes' shape (the goldens'), and the samples of the
# open scene's alive fractions at the main path's size
CHECK = (64, 4, 3)
ALIVE_SAMPLES = 4
# phase 10: config 4's forward at BASELINE's samples per pixel; K2's LIGHTS
# builds at 1,024 and 4,096 floats on `lit_spheres(n)` (sphere count: the
# build), held against the plain version at LIT_CHECK (size, spp, bounces:
# every light sampled, a path that bounces once), and the fwd+bwd step of
# each at (spp, bounces): the 1,024 build at the main path's shape, the
# 4,096 one at 1 spp as the 256-sphere step of phase 6
LIGHTS_SPP = 256
LIT_SPHERES = {24: 1024, 80: 4096}
LIT_CHECK = (16, 1, 2)
LIT_STEP = {24: (SPP, BOUNCES), 80: (1, BOUNCES)}
# phase 11: the display filters' bound against their run on the CPU (atol =
# rtol; the same float32 ops on both, exp and pow within an ulp), the
# checkpoint's halves, and the viewer's frame size (examples/viewer.py)
# with its picking grid and drag, orbit and zoom events
FILTER_TOL = 1e-5
RESUME_SPP = 32
VIEWER = 256
PICK_GRID = 16
DRAG_MOVES = ORBIT_MOVES = 8
# phase 12: BASELINE config 5 (inverse rendering; tools/inverse_artifact.py)
# at its spec size, the train steps run and their learning rate; the edge
# terms held on the card against the CPU at BND_CHECK² with the step's
# settings (per leaf |diff| <= BND_RTOL·|cpu| + BND_ATOL·max|cpu|: the same
# float32 operations on both, a transcendental an ulp apart); and the
# central difference's step, as inverse_artifact's own checks take it
INV_SIZE, INV_SPP, INV_BOUNCES = 1024, 16, 4
INV_STEPS = 5
INV_LR = 0.025
BND_CHECK = 64
BND_RTOL, BND_ATOL = 1e-4, 1e-4
# KP's penumbra term against the plain version's on the card, per leaf:
# |diff| <= KP_TOL·max|plain| (the same float32 operations for the
# coefficients; the adjoint written out against autograd's, each summed in
# its own order: tests/test_torch_edge_kernels.py)
KP_TOL = 1e-4
# KA's roots and slopes against the plain solve's on the card, elementwise
# relative (the same float32 operations; tests/test_torch_alhazen.py)
KA_RTOL = 1e-5
# KH's planes and points against the plain receivers' on the card,
# elementwise absolute (the same float32 operations: bit for bit expected;
# tests/test_torch_receivers.py holds the host build to it), and its camera
# partials against autograd's: |diff| <= KH_TOL·max|autograd|
KH_PLANE_TOL = 1e-5
KH_TOL = 2.7e-5
FD_EPS = 1e-2
# the batched silhouette term against the same sites traced one by one:
# |diff| <= BATCH_TOL·max|per-site| (the same float32 operations on the same
# points; bit for bit on the CPU, tests/test_torch_boundary_batch.py)
BATCH_TOL = 1e-6
# phase 13: the multi-device parallel/ on one card: config 2 over MESH
# (ranks, spp axis) at the main path's shape; the elastic renderer on those
# ranks at ELASTIC (size, spp, bounces, chunk spp), half of them lost at
# chunk 1; config 5's train step over MESH5 (ranks, spp axis: rows only)
# at its spec size, MESH_STEPS steps with the edge terms timed; timings the
# median of MESH_RUNS; the plain K2 on a row tile of a rank's block (rows,
# first row)
MESH = (8, 2)
ELASTIC = (256, 16, 5, 4)
MESH5 = (2, 1)
MESH_STEPS = MESH_RUNS = 3
MESH_K2_TILE = (8, 504)
# phase 8: K5a's check shape (size, spp, bounces), the stripped builds',
# K5b/K5c's tolerance for the rsqrt mixes (rsqrtf against torch.rsqrt,
# relative, elementwise), and the tools' shapes (size, spp, bounces)
PROF_CHECK = (64, 4, 5)
STRIP_CHECK = (64, 4, 3)
MIX_RTOL = 1e-6
DET_SHAPE = (256, 8, 5)
OCC_SHAPE = (256, 4, 5)
# phase 14: gpu_checks' shape (size, spp, bounces), the viewer's frames
# timed by part, render_scenes' shape (size, spp) and inverse_render's
# (size, steps)
GPU_CHECKS = (128, 2, 5)
VIEWER_FRAMES = 8
EXAMPLE_SHAPE = (64, 4)
INVERSE_EXAMPLE = (64, 3)
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
# profiler traces and the examples' images: in the checkout's build/
# (gitignored)
TRACES = os.path.join(ROOT, "build", "traces")
EXAMPLES_OUT = os.path.join(ROOT, "build", "examples")


def mrays(ms: float, spp: int = SPP) -> float:
    """Mrays/s under the repo's convention rays = H·W·spp·bounces·2."""
    return H * W * spp * BOUNCES * 2 / (ms * 1e-3) / 1e6


def compare(a, b):
    """(max abs diff, count of elements outside atol = rtol = TOL)."""
    a = torch.stack(tuple(a)).double()
    b = torch.stack(tuple(b)).double()
    d = (a - b).abs()
    return float(d.max()), int((d > TOL + TOL * b.abs()).sum())


def grad_check(label: str, got, want, static, per_leaf: bool = True):
    """Hold K2's flat gradient against its plain version: relative L-inf
    below GRAD_TOL, all finite, and (`per_leaf`) every leaf within its
    bound.  Returns (summary, relative L-inf, max abs diff, worst leaf);
    raises."""
    from sail_tpu_torch.tools.grad_localise import leaf_excess, leaf_name
    d = (got - want).abs().double()
    excess = leaf_excess(got, want)
    k = int(excess.argmax())
    err = float(d.max() / want.abs().max().double())
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    summary = (f"{label}: rel Linf {err:.3g}, worst leaf {leaf_name(static, k)}"
               f" plain {float(want[k]):.6g} |diff| {float(d[k]):.3g} = "
               f"{float(excess[k]):.3g} of its bound")
    if not (err < GRAD_TOL and (float(excess[k]) <= 1 or not per_leaf)
            and finite):
        raise AssertionError(f"K2 disagrees with its plain version or is not "
                             f"finite: {summary}, finite {finite}")
    return summary, err, float(d.max()), k


def cuda_ms(fn, *args, **kw):
    """(result, ms) of one call between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = fn(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def median_ms(fn, *args, **kw) -> float:
    """Median of TIMED_RUNS calls between CUDA events, after one warm-up."""
    cuda_ms(fn, *args, **kw)
    return statistics.median(cuda_ms(fn, *args, **kw)[1]
                             for _ in range(TIMED_RUNS))


def reduce_check(dev, shape) -> dict:
    """K2's reduce on seeded rows of `shape` against its plain version bit
    for bit, and against a float64 sum; its time (one call between events,
    as the wrapper runs it, and per launch queued), the plain version's and
    `sum(0)`'s.  Raises."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.tools.k2_compare import queued_ms
    rows = torch.randn(shape, generator=torch.Generator().manual_seed(0)
                       ).to(dev)
    got, call_ms = cuda_ms(mk.reduce_grad_rows, rows)
    want = mk.reduce_grad_rows_plain(rows)
    err = float((got.double() - rows.double().sum(0)).abs().max())
    if not torch.equal(got, want) or err > 1e-3:
        raise AssertionError(f"the reduce on {shape} is not its plain "
                             f"version bit for bit, or off a float64 sum by "
                             f"{err}")
    return dict(shape=shape, max_abs_vs_f64=err, call_ms=call_ms,
                ms=queued_ms(mk.reduce_grad_rows, rows, runs=TIMED_RUNS),
                plain_ms=queued_ms(mk.reduce_grad_rows_plain, rows, n=5,
                                   runs=TIMED_RUNS),
                sum_ms=queued_ms(lambda r: r.sum(0), rows, runs=TIMED_RUNS),
                bytes=4 * (rows.numel() + rows.shape[1]))


def bound(params, static, height: int, width: int, spp: int, bounces: int,
          grad: bool = False, cull: bool = False, samples: int = 2,
          row_step: int = 1) -> dict:
    """The least time the card could take for one K1 (or K2, `grad`) call on
    these inputs: the larger of the FP32 operations their paths need
    (`opcount.live_ops`, from `samples` of the spp samples and every
    `row_step`-th row, scaled) over
    the FP32 rate and the bytes read and written once over the memory rate
    (K1: parameters and table in, three planes out; K2: parameters, table
    and three cotangent planes in, the gradient out)."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.utils import opcount
    k1, k2 = opcount.live_ops(params, static, height, width, spp, 0, bounces,
                              cull=cull, samples=samples, row_step=row_step)
    small = 4 * (params.numel() + len(mk.scene_table(static).ints))
    nbytes = small + 12 * height * width + (4 * params.numel() if grad else 0)
    ms, by = opcount.bound_ms(k2 if grad else k1, nbytes)
    return {"bound_ms": ms, "bound_by": by, "ops": k2 if grad else k1}


def grad_build_of(n_params: int, static):
    """K2's build for a scene (`megakernel.grad_build`)."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    t = mk.scene_table(static)
    return mk.grad_build(n_params, t.all_shapes, t.materials, t.lights)


def k2_build(n_params: int, static) -> str:
    """K2's build for a scene: "shared" (the gradient in shared memory) or
    "local <cap>", and its blocks per SM."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    b = grad_build_of(n_params, static)
    return (("shared" if b.cap == mk.SHARED_GRAD else f"local {b.cap}")
            + f", {b.min_blocks} blocks/SM")


def kernel_row(name: str, source: str, replaces: str, launches: int,
               max_abs_err: float, ms: float, plain_ms: float, b: dict,
               shape: str, library_ms: float = None, **extra) -> dict:
    """One entry of the `kernels` line: `ms`, the bound at `shape` and its
    share of `ms`; where the plain version ran on a row tile of it
    (`plain_shape`), `tile_ms` is the kernel's time there."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": library_ms, "shape": shape,
            "share_of_bound": b["bound_ms"] / ms, **extra}


def gradient_path(dev, card: str) -> list:
    """Phase 4: K2 against its plain version, then bench.py's fwd+bwd step
    and a few Adam steps.  Returns the kernels' JSON entries."""
    from sail_tpu_torch import scenes
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.scene.scene import param_offsets

    rng = np.random.default_rng(0)
    results = []
    # (scene, rows, cols, spp, row0, image_height): 1 spp at 64², then the
    # main path's image at 4 spp with bench.py's cotangent 1/(H·W·spp)
    for name, rows, cols, spp, row0, image_h in (
            ("cornell_matte", 64, 64, 1, 0, 64),
            ("cornell_mirror", 64, 64, 1, 0, 64),
            ("open_lights", 64, 96, 1, 0, 64),
            ("cornell_mirror", 32, 64, 1, 32, 64),         # a row tile
            ("cornell_mirror", H, W, 4, 0, H)):
        params, static = getattr(scenes, name)().pack()
        if rows == H:
            g = Vec3(*(torch.full((H, W), 1.0 / (H * W * spp), device=dev),)
                     * 3)
        else:
            g = Vec3(*(torch.from_numpy(rng.uniform(0.1, 1.0, (rows, cols))
                                        .astype(np.float32)).to(dev)
                       for _ in range(3)))
        args = (params.to(dev), static, g, rows, cols, spp, 0, 0, BOUNCES)
        kw = dict(row0=row0, image_height=image_h)
        got = mk.render_grad_block(*args, **kw)
        want = mk.render_grad_block_plain(*args, **kw)
        again = mk.render_grad_block(*args, **kw)
        torch.cuda.synchronize()
        summary = grad_check(f"{name} rows {row0}-{row0 + rows - 1} of "
                             f"{image_h} x {cols} spp{spp} b{BOUNCES}", got,
                             want, static)[0]
        if not torch.equal(got, again):
            raise AssertionError(f"K2 is not repeatable: {summary}")
        results.append(summary + ", bit-identical on repeat")

    # the reduce pass bit for bit against its plain version and against a
    # float64 sum, at the step's row count: config 2's parameters and the
    # 256-sphere scene's (13 n + 47)
    bx, by = mk.GRAD_BLOCK
    n_rows = -(-W // bx) * -(-H // by)
    red = [reduce_check(dev, (n_rows, len(got))),
           reduce_check(dev, (n_rows, 13 * MOST + 47))]
    red_err = max(r["max_abs_vs_f64"] for r in red)

    # -- the step: bench.py's fwd+bwd through one K1 and one K2 launch ------
    params, static = scenes.cornell_mirror().pack()
    params = params.to(dev)

    def step(p, seed):
        img = mk.render_image_fast(p, seed, static, H, W, SPP, BOUNCES)
        loss = (img.x + img.y + img.z).mean()
        loss.backward()
        return loss

    p = params.clone().requires_grad_()
    mk.render_block.launches = mk.render_grad_block.launches = 0
    mk.reduce_grad_rows.launches = 0
    loss = step(p, 0)
    torch.cuda.synchronize()
    launches = (mk.render_block.launches, mk.render_grad_block.launches,
                mk.reduce_grad_rows.launches)
    if launches != (1, 1, 1):
        raise AssertionError(f"the step made {launches} K1/K2/reduce launches"
                             f", not one each")
    if not (torch.isfinite(p.grad).all() and p.grad.abs().max() > 0
            and torch.isfinite(loss)):
        raise AssertionError("the step's loss or gradient is not finite")
    step_grad = p.grad.clone()
    step_ms = []
    for k in range(TIMED_RUNS):
        p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(p, k + 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(step_ms)
    # K2 at the step's own shape and cotangent: 1/(H·W) from the mean, times
    # the Function's 1/spp, both powers of two, so the step's gradient is
    # this call's bit for bit; and against the plain version at 64 spp on a
    # full-width row tile of the step (the whole image's plain K2 takes a
    # minute or more), per leaf with the pixel term
    from sail_tpu_torch.tools import grad_localise
    g = Vec3(*(torch.full((H, W), 1.0 / (H * W * SPP), device=dev),) * 3)
    k2_args = (params, static, g, H, W, SPP, 0, 0, BOUNCES)
    k2_runs = [cuda_ms(mk.render_grad_block, *k2_args)
               for _ in range(TIMED_RUNS)]
    k2_ms = statistics.median(ms for _, ms in k2_runs)
    got = k2_runs[0][0]
    if not all(torch.equal(got, r) for r, _ in k2_runs):
        raise AssertionError("K2 is not repeatable at the step's shape")
    if not torch.equal(step_grad, got):
        raise AssertionError(
            f"the step's gradient is not K2's at the same arguments: max abs "
            f"diff {float((step_grad - got).abs().max()):.3g}")
    t_rows, t_row0 = K2_TILE["cornell_mirror"]
    gt = Vec3(*(torch.full((t_rows, W), 1.0 / (H * W * SPP), device=dev),)
              * 3)
    t_args = (params, static, gt, t_rows, W, SPP, 0, 0, BOUNCES)
    kw = dict(row0=t_row0, image_height=H)
    t_got = mk.render_grad_block(*t_args, **kw)
    tile_ms = median_ms(mk.render_grad_block, *t_args, **kw)
    want, k2_plain_ms = cuda_ms(mk.render_grad_block_plain, *t_args, **kw)
    tile = (f"cornell_mirror rows {t_row0}-{t_row0 + t_rows - 1} of {H} x "
            f"{W} spp{SPP} b{BOUNCES}")
    summary, grad_err, grad_abs, _ = grad_check(tile + " (a tile of the step)",
                                                t_got, want, static,
                                                per_leaf=False)
    where = grad_localise.check(*t_args, t_row0, H, t_got, want)
    if where["excess"] > 1:
        raise AssertionError(f"K2 disagrees with its plain version on a leaf:"
                             f" {summary}, {where}")
    results.append(summary + f"; per leaf with the pixel term: worst "
                   f"{where['leaf_name']} = {where['excess']:.3g} of its "
                   f"bound; K2 {tile_ms:.2f} ms on the tile; at the step's "
                   f"shape bit-identical over {TIMED_RUNS} calls and to the "
                   f"step's gradient")

    # -- 5 Adam steps on the materials and lights (diff/inverse.py's default
    # set) from a perturbed scene toward a target at the true parameters ----
    off = param_offsets(static)
    trainable = torch.zeros(off.size, dtype=torch.bool, device=dev)
    trainable[off.materials[0]:off.textures[0]] = True
    trainable[off.lights[0]:off.camera] = True
    with torch.no_grad():
        target = mk.render_image_fast(params, 1000, static, H, W, SPP,
                                      BOUNCES)
    start = params.clone()
    start[off.materials[2]] = 0.6                  # matte sphere kd 1.0
    start[off.lights[0]:off.lights[0] + 3] *= 0.7  # light emission 5.0
    p = start.clone().requires_grad_()
    opt = torch.optim.Adam([p], lr=5e-2)
    losses = []
    for k in range(ADAM_STEPS):
        opt.zero_grad()
        img = mk.render_image_fast(p, k, static, H, W, SPP, BOUNCES)
        loss = sum(((a - b) ** 2).mean() for a, b in zip(img, target))
        loss.backward()
        p.grad[~trainable] = 0.0
        opt.step()
        losses.append(float(loss.detach()))
    fitted = p.detach()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"Adam's loss did not fall: {losses}")

    print(f"phase 4 gradient path: K2 vs plain: " + "; ".join(results)
          + f" | reduce pass vs plain sum max_abs {red_err:.3g} | step "
          f"render_image_fast cornell_mirror {W}x{H} spp{SPP} b{BOUNCES} -> "
          f"mean(x+y+z) -> backward: {launches[0]} K1, {launches[1]} K2, "
          f"{launches[2]} reduce launch, loss {float(loss.detach()):.6f} | fwd+bwd "
          f"{step_ms:.2f} ms = {mrays(step_ms):.1f} Mrays/s (median of "
          f"{TIMED_RUNS}) | K2 {k2_ms:.2f} ms (median of {TIMED_RUNS}) | "
          f"plain K2 {k2_plain_ms:.1f} ms on the tile (one run) | reduce, "
          f"bit for bit its plain version: " + "; ".join(
              f"{r['shape'][0]} x {r['shape'][1]}: {r['ms']:.4f} ms a launch "
              f"queued, {r['call_ms']:.4f} ms a call, plain "
              f"{r['plain_ms']:.4f} ms, sum(0) {r['sum_ms']:.4f} ms"
              for r in red) + f" | Adam lr 5e-2 x{ADAM_STEPS}: "
          f"loss {' '.join(f'{x:.6g}' for x in losses)}; sphere kd 0.6 -> "
          f"{float(fitted[off.materials[2]]):.4f} (true 1.0), light "
          f"emission 3.5 -> {float(fitted[off.lights[0]]):.4f} (true 5.0) | "
          f"{card}", flush=True)
    k2_bound = bound(params, static, H, W, SPP, BOUNCES, grad=True)
    shape = f"cornell_mirror {W}x{H} spp{SPP} b{BOUNCES}"
    return [
        kernel_row("K2 render_grad_block (backward megakernel)",
                   "sail_tpu_torch/csrc/megakernel_grad.cu + render_grad.cuh "
                   "+ adjoint.cuh",
                   "sail_tpu/ops/pallas/megakernel.py:262", launches[1],
                   grad_abs, k2_ms, k2_plain_ms, k2_bound, shape,
                   rel_linf=grad_err, plain_shape=tile, tile_ms=tile_ms,
                   localised=where, build=k2_build(params.numel(), static)),
        kernel_row(
            "K2 reduce_grad_rows (K2's cross-block sum)",
            "sail_tpu_torch/csrc/reduce_grad_rows.cu",
            "sail_tpu/ops/pallas/megakernel.py:459", launches[2],
            red[0]["max_abs_vs_f64"], red[0]["ms"], red[0]["plain_ms"],
            reduce_bound(red[0]), f"{n_rows} rows x {len(got)} params "
            f"(config 2's step)", library_ms=red[0]["sum_ms"],
            call_ms=red[0]["call_ms"],
            timing="ms, plain_ms, library_ms: per launch, queued behind a "
            "sleeping kernel; call_ms: one call between events",
            at_many_spheres=dict(
                {k: red[1][k] for k in ("shape", "ms", "plain_ms", "sum_ms",
                                        "call_ms")},
                **reduce_bound(red[1]), spheres=MOST))]


def reduce_bound(r: dict) -> dict:
    """The reduce's bound: its bytes (the rows read once, the sum written
    once) over the memory rate."""
    from sail_tpu_torch.utils import opcount
    return dict(zip(("bound_ms", "bound_by"),
                    opcount.bound_ms(0.0, r["bytes"])))


def scene_of(name: str):
    """A scene of `sail_tpu_torch.scenes` by name; `spheres<n>` is the
    many-object scene with n spheres."""
    from sail_tpu_torch import scenes
    if name.startswith("spheres"):
        return scenes.many_spheres(int(name[len("spheres"):]))
    return getattr(scenes, name)()


def renderer_path(dev, name: str, label: str, early_exit: bool = False,
                  spp: int = SPP):
    """Renderer(W, H, seed=0, max_bounces=BOUNCES, early_exit=) ->
    update(scene `name`) -> render_spp(spp) -> output, through exactly one
    K1 launch (counted from 0 just before), then timed.  Returns (launches,
    output, render_spp ms, params, static, renderer)."""
    from sail_tpu_torch import Renderer
    from sail_tpu_torch.ops.cuda import megakernel as mk
    scene = scene_of(name)
    scene.filter = "gamma"
    r = Renderer(W, H, seed=0, max_bounces=BOUNCES,   # the card, by default
                 early_exit=early_exit)
    r.update(scene)
    mk.render_block.launches = 0
    r.render_spp(scene, spp)
    out = r.output(scene)
    launches = mk.render_block.launches
    if launches != 1 or out.shape != (H, W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"{label}: {launches} K1 launches, output "
                             f"{out.shape}, finite {np.isfinite(out).all()}")
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_spp(scene, spp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    params, static = scene.pack()
    return (launches, out, statistics.median(times), params.to(dev), static,
            r)


def k1_tile(name: str, params, static, spp: int, early_exit: bool = False):
    """K1 (the cull as render_block chooses it) against its plain version
    (no cull: an object the cull dropped would show; `early_exit` as
    given) on a full-width row tile of the W x H image at `spp`: (text, max
    abs diff, K1 ms median, plain ms, shape).  Raises outside TOL."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    rows, row0 = K1_TILE
    args = (params, static, rows, W, spp, 0, 0, BOUNCES)
    kw = dict(row0=row0, image_height=H, early_exit=early_exit)
    got = mk.render_block(*args, **kw)
    k1_ms = median_ms(mk.render_block, *args, **kw)
    want, plain_ms = cuda_ms(mk.render_block_plain, *args, **kw)
    err, bad = compare(got, want)
    bit = torch.equal(got.stack(), want.stack())
    shape = (f"{name} rows {row0}-{row0 + rows - 1} of {H} x {W} spp{spp} "
             f"b{BOUNCES}")
    text = (f"{shape}: max_abs {err:.3g}, {bad} over {TOL:g}, "
            f"{'bit-identical' if bit else 'not bit-identical'}, K1 "
            f"{k1_ms:.3f} ms, plain {plain_ms:.1f} ms")
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {text}")
    return text, err, k1_ms, plain_ms, shape


def many_objects(dev, card: str) -> list:
    """Phase 5: K1 on every shape and on many objects; the Renderer's path
    on FEW and MANY spheres, each held against the plain version on a row
    tile at its own spp and bounces; and the many-object sweep.  Returns
    the kernels' JSON entries."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.tools import many_object_bench as mob

    results = []
    for name, cull in (("quadrics", False), ("cubes_and_disks", False),
                       ("spheres12", False), (f"spheres{MANY}", False),
                       ("flat_rectangles", True)):
        params, static = scene_of(name).pack()
        args = (params.to(dev), static, 64, 64, 4, 0, 0, BOUNCES)
        got = mk.render_block(*args, cull=cull)
        # the plain version without the cull: an object the cull dropped
        # would show as a difference
        want = mk.render_block_plain(*args)
        err, bad = compare(got, want)
        bit = torch.equal(got.stack(), want.stack())
        text = (f"{name}{' cull=True' if cull else ''} 64x64 spp4 b{BOUNCES}"
                f": max_abs {err:.3g}, {bad} over {TOL:g}, "
                f"{'bit-identical' if bit else 'not bit-identical'}, mean "
                f"{float(want.stack().mean()):.4f}")
        if cull:
            same = torch.equal(got.stack(),
                               mk.render_block(*args, cull=False).stack())
            text += f", equal to cull=False bit for bit: {same}"
            bad += 0 if same else 1
        results.append(text)
        if bad or not float(want.stack().max()) > 0:
            raise AssertionError(f"K1 disagrees with its plain version or "
                                 f"renders black: {text}")

    # -- the Renderer's path on FEW spheres (the batched fold) and on MANY
    # (the fold and the cull, render_block's own choice), each through
    # exactly one K1 launch; K1 at the path's shape, and on a row tile at
    # the path's spp and bounces beside its plain version --------------------
    paths, rows = [], []
    for n in (FEW, MANY):
        label = f"Renderer spheres{n} {W}x{H} spp{SPP} b{BOUNCES}"
        launches, out, step_ms, params, static, _ = renderer_path(
            dev, f"spheres{n}", label)
        full = (params, static, H, W, SPP, 0, 0, BOUNCES)
        k1_ms = median_ms(mk.render_block, *full)
        table = mk.scene_table(static)
        cull = mk.cull_clusters(static) > 0
        text, err, tile_ms, plain_ms, tile = k1_tile(f"spheres{n}", params,
                                                     static, SPP)
        # the bound at the path's shape, from one sample of every 32nd row
        b = bound(params, static, H, W, SPP, BOUNCES, cull=cull, samples=1,
                  row_step=32)
        extra = ""
        if n == MANY:   # the two sides of render_block's choice
            off, on = (median_ms(mk.render_block, *full, cull=c)
                       for c in (False, True))
            extra = f", K1 cull=False {off:.2f} ms, cull=True {on:.2f} ms"
        paths.append(f"{label} ({table.n_clusters} clusters, cull "
                     f"{'on' if cull else 'off'}): {launches} K1 launch, "
                     f"output {out.shape} finite, mean {out.mean():.4f}, "
                     f"render_spp {step_ms:.2f} ms = {mrays(step_ms):.1f} "
                     f"Mrays/s (median of {TIMED_RUNS}), K1 {k1_ms:.2f} ms"
                     f"{extra}, bound {b['bound_ms']:.3f} ms "
                     f"({b['bound_by']}) | K1 vs plain on {text}")
        what = "batched fold and cluster cull" if cull else "batched fold"
        rows.append(kernel_row(
            f"K1-many render_block ({what}, {n} spheres)",
            "sail_tpu_torch/csrc/megakernel.cu + path.cuh",
            "sail_tpu/ops/intersect.py:705" if cull else
            "sail_tpu/ops/intersect.py:593", launches, err, k1_ms, plain_ms,
            b, f"spheres{n} {W}x{H} spp{SPP} b{BOUNCES}",
            launches_counted_on=label, plain_shape=tile, tile_ms=tile_ms))

    # -- the many-object sweep (explicit cull off and on) ---------------------
    sweep = mob.sweep(SWEEP_COUNTS, SWEEP_SIZE, SWEEP_SPP, SWEEP_BOUNCES,
                      TIMED_RUNS, dev)
    for x in sweep["rows"]:    # each count's bound, from one of its samples
        p_n, s_n = scene_of(f"spheres{x['n_spheres']}").pack()
        for mode, cull in mob.MODES.items():
            b = bound(p_n.to(dev), s_n, SWEEP_SIZE, SWEEP_SIZE, SWEEP_SPP,
                      SWEEP_BOUNCES, cull=cull, samples=1, row_step=8)
            x[mode].update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                           share=b["bound_ms"] / x[mode]["ms"])
    sweep["card"] = card
    print(json.dumps({"many_object_sweep": sweep}), flush=True)
    print(f"phase 5 shapes and many objects: K1 vs plain: "
          + "; ".join(results) + " | " + " | ".join(paths) + f" | sweep "
          f"{SWEEP_SIZE}x{SWEEP_SIZE} spp{SWEEP_SPP} b{SWEEP_BOUNCES}: "
          + ", ".join(f"{x['n_spheres']}: {x['kernel']['ms']:.3f} / "
                      f"{x['kernel_cull']['ms']:.3f} ms"
                      for x in sweep["rows"])
          + f" (cull off / on), cull=True bit-identical at every count | "
          f"{card}", flush=True)
    return rows


def many_gradients(dev, card: str) -> list:
    """Phase 6: K2 on every shape and on many objects, and the fwd+bwd step
    on MANY spheres at SPP and on MOST at 1 spp, each held against the
    plain version on a row tile at its own spp and bounces.  Returns the
    kernels' JSON entries."""
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.tools import grad_localise

    rng = np.random.default_rng(1)
    results = []
    for name, size in (("quadrics", 64), ("spheres12", 64)):
        params, static = scene_of(name).pack()
        g = Vec3(*(torch.from_numpy(rng.uniform(0.1, 1.0, (size, size))
                                    .astype(np.float32)).to(dev)
                   for _ in range(3)))
        args = (params.to(dev), static, g, size, size, 1, 0, 0, BOUNCES)
        got = mk.render_grad_block(*args)
        again = mk.render_grad_block(*args)
        want = mk.render_grad_block_plain(*args)
        torch.cuda.synchronize()
        summary = grad_check(f"{name} {size}x{size} spp1 b{BOUNCES} "
                             f"({params.numel()} params, K2 build "
                             f"{k2_build(params.numel(), static)})", got,
                             want,
                             static)[0]
        if not torch.equal(got, again):
            raise AssertionError(f"K2 is not repeatable: {summary}")
        results.append(summary + ", bit-identical on repeat")

    def step(p, static, spp, seed):
        img = mk.render_image_fast(p, seed, static, H, W, spp, BOUNCES)
        loss = (img.x + img.y + img.z).mean()
        loss.backward()
        return loss

    # -- the fwd+bwd step on MANY spheres at SPP and on MOST at 1 spp, each
    # through one K1, one K2 and one reduce launch; its gradient K2's bit for
    # bit; K2 (and, on MOST, K1) on a row tile of the step against the plain
    # version, the worst leaf localised pixel by pixel -----------------------
    steps, rows = [], []
    for n, spp in ((MANY, SPP), (MOST, 1)):
        params, static = scene_of(f"spheres{n}").pack()
        params = params.to(dev)
        p = params.clone().requires_grad_()
        mk.render_block.launches = mk.render_grad_block.launches = 0
        mk.reduce_grad_rows.launches = 0
        loss = step(p, static, spp, 0)
        torch.cuda.synchronize()
        launches = (mk.render_block.launches, mk.render_grad_block.launches,
                    mk.reduce_grad_rows.launches)
        if launches != (1, 1, 1) or not (torch.isfinite(p.grad).all()
                                         and p.grad.abs().max() > 0
                                         and torch.isfinite(loss)):
            raise AssertionError(f"the step on {n} spheres made {launches} "
                                 f"K1/K2/reduce launches, loss "
                                 f"{float(loss.detach())}, finite grad "
                                 f"{bool(torch.isfinite(p.grad).all())}")
        step_grad = p.grad.clone()
        times = []
        for k in range(TIMED_RUNS):
            p.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(p, static, spp, k + 1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(times)
        # K2 at the step's own arguments: 1/(H·W) from the mean times the
        # Function's 1/spp, powers of two, so the step's gradient is this
        # call's bit for bit
        g = Vec3(*(torch.full((H, W), 1.0 / (H * W * spp), device=dev),) * 3)
        full = [cuda_ms(mk.render_grad_block, params, static, g, H, W, spp,
                        0, 0, BOUNCES) for _ in range(TIMED_RUNS)]
        k2_ms = statistics.median(ms for _, ms in full)
        if not all(torch.equal(step_grad, r) for r, _ in full):
            raise AssertionError(
                f"the step's gradient on {n} spheres is not K2's at the same "
                f"arguments: max abs diff "
                f"{float((step_grad - full[0][0]).abs().max()):.3g}")
        # K2 on a full-width row tile of the step, the same cotangent
        t_rows, row0 = K2_TILE[n]
        gt = Vec3(*(torch.full((t_rows, W), 1.0 / (H * W * spp),
                               device=dev),) * 3)
        args = (params, static, gt, t_rows, W, spp, 0, 0, BOUNCES)
        kw = dict(row0=row0, image_height=H)
        got = mk.render_grad_block(*args, **kw)
        tile_ms = median_ms(mk.render_grad_block, *args, **kw)
        if not torch.equal(got, mk.render_grad_block(*args, **kw)):
            raise AssertionError(f"K2 is not repeatable on {n} spheres")
        want, plain_ms = cuda_ms(mk.render_grad_block_plain, *args, **kw)
        shape = (f"spheres{n} rows {row0}-{row0 + t_rows - 1} of {H} x {W} "
                 f"spp{spp} b{BOUNCES}")
        # relative L-inf here; per leaf below, with the pixel term
        summary, err, abs_err, _ = grad_check(shape, got, want, static,
                                              per_leaf=False)
        where = grad_localise.check(*args, row0, H, got, want)
        top = where["top_pixels"][0]
        # the bound at the step's shape, from one sample of every 32nd row
        b = bound(params, static, H, W, spp, BOUNCES, grad=True, samples=1,
                  row_step=32)
        path = f"spheres{n} {W}x{H} spp{spp} b{BOUNCES}"
        k1_text = ""
        if n == MOST:   # the step's K1 (the cull, render_block's choice)
            k1_text, k1_err, k1_tile_ms, k1_plain_ms, k1_shape = k1_tile(
                f"spheres{n}", params, static, spp)
            k1_ms = median_ms(mk.render_block, params, static, H, W, spp, 0,
                              0, BOUNCES)
            k1_b = bound(params, static, H, W, spp, BOUNCES, samples=1,
                         cull=mk.cull_clusters(static) > 0, row_step=32)
            k1_text = (f" | K1 {k1_ms:.3f} ms, bound {k1_b['bound_ms']:.4f} "
                       f"ms ({k1_b['bound_by']}); vs plain on {k1_text}")
            rows.append(kernel_row(
                f"K1-many render_block (batched fold and cluster cull, {n} "
                f"spheres)", "sail_tpu_torch/csrc/megakernel.cu + path.cuh",
                "sail_tpu/ops/intersect.py:705", launches[0], k1_err, k1_ms,
                k1_plain_ms, k1_b, path,
                launches_counted_on=f"the fwd+bwd step on {n} spheres",
                plain_shape=k1_shape, tile_ms=k1_tile_ms))
        steps.append(
            f"spheres{n} ({params.numel()} params, K2 build "
            f"{k2_build(params.numel(), static)}) {W}x{H} spp{spp} "
            f"b{BOUNCES}: "
            f"{launches[0]} K1, {launches[1]} K2, {launches[2]} reduce launch"
            f", loss {float(loss.detach()):.6g}, fwd+bwd {step_ms:.1f} ms "
            f"(median of {TIMED_RUNS}), K2 {k2_ms:.1f} ms, the step's "
            f"gradient K2's bit for bit | {summary}, bit-identical on repeat;"
            f" per leaf with the pixel term: worst {where['leaf_name']} K2 "
            f"{where['k2']:.6g} plain {where['plain']:.6g} = "
            f"{where['excess']:.3g} of its bound ("
            f"{where['excess_without_pixels']:.3g} without the pixel term; "
            f"worst of all leaves without it "
            f"{where['max_excess_without_pixels']:.3g}); its pixels: K2 "
            f"{where['pixel_sum_k2']:.6g} / plain (forward mode) "
            f"{where['pixel_sum_plain']:.6g} over "
            f"{where['pixels_with_contribution']} pixels (mass "
            f"{where['mass']:.4g}, largest {where['largest_pixel']:.4g}), "
            f"90% of the |diff| in {where['pixels_for_90pct_of_abs_diff']} "
            f"pixel(s), the largest at ({top['row']}, {top['col']}): K2 "
            f"{top['k2']:.6g} plain {top['plain']:.6g}; K2 {tile_ms:.2f} ms, "
            f"plain {plain_ms:.1f} ms on the tile; K2's bound at the step's "
            f"shape {b['bound_ms']:.3f} ms ({b['bound_by']})" + k1_text)
        if where["excess"] > 1:
            raise AssertionError(f"K2 disagrees with its plain version on a "
                                 f"leaf: {steps[-1]}")
        rows.append(kernel_row(
            f"K2 render_grad_block ({n} spheres, "
            f"{grad_build_of(params.numel(), static).cap}-parameter build)",
            "sail_tpu_torch/csrc/megakernel_grad.cu + render_grad.cuh + "
            "adjoint.cuh",
            "sail_tpu/ops/pallas/megakernel.py:262", launches[1], abs_err,
            k2_ms, plain_ms, b, path, rel_linf=err,
            launches_counted_on=f"the fwd+bwd step on {n} spheres",
            plain_shape=shape, tile_ms=tile_ms, localised=where,
            build=k2_build(params.numel(), static)))
    print(f"phase 6 gradients, every shape and many objects: K2 vs plain: "
          + "; ".join(results) + " | steps render_image_fast -> mean(x+y+z)"
          " -> backward: " + " | ".join(steps) + f" | {card}", flush=True)
    return rows


def materials_path(dev, card: str) -> list:
    """Phase 7: K1 on config 3, its open twin and the check scene against
    the plain version, golden config3; the Renderer on material_demo and,
    with early_exit, on material_demo_open; the fwd+bwd step on
    material_demo; K2 on the check scene.  Returns the kernels' JSON
    entries."""
    from sail_tpu_torch.core.camera import rays_for_pixels
    from sail_tpu_torch.core.rng import TAG_PIXEL_JITTER, PixelNoise
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.render import integrator
    from sail_tpu_torch.scene.scene import unflatten
    from sail_tpu_torch.tools import grad_localise

    size, spp, bounces = CHECK
    results = []
    for name in ("material_demo", "material_demo_open", "material_check"):
        params, static = scene_of(name).pack()
        args = (params.to(dev), static, size, size, spp, 0, 0, bounces)
        got = mk.render_block(*args)
        want = mk.render_block_plain(*args)
        err, bad = compare(got, want)
        bit = torch.equal(got.stack(), want.stack())
        results.append(f"{name} {size}x{size} spp{spp} b{bounces}: max_abs "
                       f"{err:.3g}, {bad} over {TOL:g}, "
                       f"{'bit-identical' if bit else 'not bit-identical'}"
                       f", mean {float(want.stack().mean()):.4f}")
        if bad or not float(want.stack().max()) > 0:
            raise AssertionError(f"K1 disagrees with its plain version or "
                                 f"renders black: {results[-1]}")
    # golden config3 at TOL, but for the pixels whose primary ray grazes a
    # sphere within float32 rounding (sail_tpu_torch/tools/goldens.py)
    from sail_tpu_torch.tools.goldens import golden_check
    ref = np.load(os.path.join(GOLDENS, "config3_material_demo.npy"))
    params, static = scene_of("material_demo").pack()
    img = mk.render_block(params.to(dev), static, size, size, spp, 0, 0,
                          bounces)
    img = (img.stack() * (1.0 / spp)).cpu().numpy()
    gold = golden_check(img, ref, params, static, spp)
    results.append(f"golden config3_material_demo max_abs "
                   f"{gold['max_abs']:.3g}, pixels over {TOL:g}: "
                   f"{gold['outside']}, of them grazing a sphere: "
                   f"{gold['excused']}; elsewhere max_abs "
                   f"{gold['max_abs_elsewhere']:.3g}")
    if gold["unexplained"]:
        raise AssertionError(f"K1 disagrees with golden config3: {gold}")

    # -- the Renderer on config 3, and with early_exit on its open twin ----
    paths, rows = [], []
    for name, ee in (("material_demo", False), ("material_demo_open", True)):
        label = (f"Renderer{'(early_exit=True)' if ee else ''} {name} "
                 f"{W}x{H} spp{SPP} b{BOUNCES}")
        launches, out, step_ms, params, static, r = renderer_path(
            dev, name, label, early_exit=ee)
        full = (params, static, H, W, SPP, 0, 0, BOUNCES)
        k1_ms = median_ms(mk.render_block, *full, early_exit=ee)
        text, err, tile_ms, plain_ms, tile = k1_tile(name, params, static,
                                                     SPP, early_exit=ee)
        b = bound(params, static, H, W, SPP, BOUNCES, samples=1, row_step=32)
        extra = ""
        if ee:   # the same image as early_exit=False, bit for bit
            r.early_exit = False
            r.reset()
            r.render_spp(scene_of(name), SPP)
            off_img = r.current().stack()
            r.early_exit = True
            r.reset()
            r.render_spp(scene_of(name), SPP)
            same = torch.equal(off_img, r.current().stack())
            if not same:
                raise AssertionError(f"{label}: not bit-identical to "
                                     f"early_exit=False")
            # the fraction of paths alive after each bounce (the plain
            # version's masks), over ALIVE_SAMPLES samples of the image
            scene = unflatten(params, static)
            ii, jj = integrator.pixel_grid(H, W, 0, dev)
            alive = torch.zeros(BOUNCES, dtype=torch.float64, device=dev)
            with torch.no_grad():
                for k in range(ALIVE_SAMPLES):
                    noise = PixelNoise(0, k, ii, jj)
                    jx, jy, _ = noise.uniform3(0, TAG_PIXEL_JITTER)
                    ro, rd = rays_for_pixels(scene.camera, ii.float(),
                                             jj.float(), H, W, jx, jy)
                    alive += integrator.alive_fractions(
                        scene, static, ro, rd, noise, BOUNCES)[0].double()
            alive = (alive / ALIVE_SAMPLES).tolist()
            extra = (f", bit-identical to early_exit=False; alive after "
                     f"each bounce (plain masks, {ALIVE_SAMPLES} samples): "
                     + "/".join(f"{100 * a:.1f}%" for a in alive))
        paths.append(f"{label}: {launches} K1 launch, output {out.shape} "
                     f"finite, mean {out.mean():.4f}, render_spp "
                     f"{step_ms:.2f} ms = {mrays(step_ms):.1f} Mrays/s "
                     f"(median of {TIMED_RUNS}), K1 {k1_ms:.2f} ms, bound "
                     f"{b['bound_ms']:.3f} ms ({b['bound_by']}){extra} | K1 "
                     f"vs plain on {text}")
        entry = dict(launches_counted_on=label, plain_shape=tile,
                     tile_ms=tile_ms)
        if ee:
            entry["alive_after_bounce"] = alive
        rows.append(kernel_row(
            f"K1-ee render_block(early_exit=True) ({name})" if ee else
            f"K1 render_block ({name}: metal, glass, checkerboard)",
            "sail_tpu_torch/csrc/megakernel.cu + path.cuh + bsdf.cuh",
            "sail_tpu/render/integrator.py:227" if ee else
            "sail_tpu/ops/pallas/megakernel.py:159", launches, err, k1_ms,
            plain_ms, b, f"{name} {W}x{H} spp{SPP} b{BOUNCES}", **entry))

    # -- the fwd+bwd step on config 3 ----------------------------------------
    params, static = scene_of("material_demo").pack()
    params = params.to(dev)
    p = params.clone().requires_grad_()

    def step(p, seed):
        img = mk.render_image_fast(p, seed, static, H, W, SPP, BOUNCES)
        loss = (img.x + img.y + img.z).mean()
        loss.backward()
        return loss

    mk.render_block.launches = mk.render_grad_block.launches = 0
    mk.reduce_grad_rows.launches = 0
    loss = step(p, 0)
    torch.cuda.synchronize()
    launches = (mk.render_block.launches, mk.render_grad_block.launches,
                mk.reduce_grad_rows.launches)
    if launches != (1, 1, 1) or not (torch.isfinite(p.grad).all()
                                     and p.grad.abs().max() > 0
                                     and torch.isfinite(loss)):
        raise AssertionError(f"the step on material_demo made {launches} "
                             f"K1/K2/reduce launches, loss "
                             f"{float(loss.detach())}, finite grad "
                             f"{bool(torch.isfinite(p.grad).all())}")
    step_grad = p.grad.clone()
    times = []
    for k in range(TIMED_RUNS):
        p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(p, k + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    g = Vec3(*(torch.full((H, W), 1.0 / (H * W * SPP), device=dev),) * 3)
    full = [cuda_ms(mk.render_grad_block, params, static, g, H, W, SPP, 0, 0,
                    BOUNCES) for _ in range(TIMED_RUNS)]
    k2_ms = statistics.median(ms for _, ms in full)
    if not all(torch.equal(step_grad, r) for r, _ in full):
        raise AssertionError(
            f"the step's gradient on material_demo is not K2's at the same "
            f"arguments: max abs diff "
            f"{float((step_grad - full[0][0]).abs().max()):.3g}")
    t_rows, row0 = K2_TILE["material_demo"]
    gt = Vec3(*(torch.full((t_rows, W), 1.0 / (H * W * SPP), device=dev),)
              * 3)
    args = (params, static, gt, t_rows, W, SPP, 0, 0, BOUNCES)
    kw = dict(row0=row0, image_height=H)
    got = mk.render_grad_block(*args, **kw)
    tile_ms = median_ms(mk.render_grad_block, *args, **kw)
    want, plain_ms = cuda_ms(mk.render_grad_block_plain, *args, **kw)
    shape = (f"material_demo rows {row0}-{row0 + t_rows - 1} of {H} x {W} "
             f"spp{SPP} b{BOUNCES}")
    summary, err, abs_err, _ = grad_check(shape, got, want, static,
                                          per_leaf=False)
    where = grad_localise.check(*args, row0, H, got, want)
    if where["excess"] > 1:
        raise AssertionError(f"K2 disagrees with its plain version on a leaf:"
                             f" {summary}, {where}")
    b = bound(params, static, H, W, SPP, BOUNCES, grad=True, samples=1,
              row_step=32)
    # K2 on the check scene, where u and v carry gradient
    rng = np.random.default_rng(2)
    c_params, c_static = scene_of("material_check").pack()
    gc = Vec3(*(torch.from_numpy(rng.uniform(0.1, 1.0, (size, size))
                                 .astype(np.float32)).to(dev)
                for _ in range(3)))
    c_args = (c_params.to(dev), c_static, gc, size, size, spp, 0, 0, bounces)
    c_got = mk.render_grad_block(*c_args)
    c_again = mk.render_grad_block(*c_args)
    c_want = mk.render_grad_block_plain(*c_args)
    c_summary = grad_check(f"material_check {size}x{size} spp{spp} "
                           f"b{bounces} ({c_params.numel()} params, K2 build "
                           f"{k2_build(c_params.numel(), c_static)})", c_got,
                           c_want,
                           c_static)[0]
    if not torch.equal(c_got, c_again):
        raise AssertionError(f"K2 is not repeatable: {c_summary}")
    c_summary += ", bit-identical on repeat"
    print(f"phase 7 materials and early exit: K1 vs plain: "
          + "; ".join(results) + " | " + " | ".join(paths) + f" | step "
          f"render_image_fast material_demo {W}x{H} spp{SPP} b{BOUNCES} -> "
          f"mean(x+y+z) -> backward: {launches[0]} K1, {launches[1]} K2, "
          f"{launches[2]} reduce launch, loss {float(loss.detach()):.6g}, "
          f"fwd+bwd {step_ms:.1f} ms = {mrays(step_ms):.1f} Mrays/s (median "
          f"of {TIMED_RUNS}), K2 {k2_ms:.1f} ms, bound {b['bound_ms']:.3f} ms"
          f" ({b['bound_by']}), the step's gradient K2's bit for bit | "
          f"{summary}; per leaf with the pixel term: worst "
          f"{where['leaf_name']} K2 {where['k2']:.6g} plain "
          f"{where['plain']:.6g} = {where['excess']:.3g} of its bound; K2 "
          f"{tile_ms:.2f} ms, plain {plain_ms:.1f} ms on the tile | K2 vs "
          f"plain: {c_summary} | {card}", flush=True)
    rows.append(kernel_row(
        "K2 render_grad_block (material_demo: metal, glass, checkerboard)",
        "sail_tpu_torch/csrc/megakernel_grad.cu + render_grad.cuh + "
        "adjoint.cuh + bsdf.cuh",
        "sail_tpu/ops/pallas/megakernel.py:262", launches[1], abs_err, k2_ms,
        plain_ms, b, f"material_demo {W}x{H} spp{SPP} b{BOUNCES}",
        rel_linf=err, launches_counted_on="the fwd+bwd step on "
        "material_demo", plain_shape=shape, tile_ms=tile_ms, localised=where,
        build=k2_build(params.numel(), static)))
    return rows


def profiling_path(dev, card: str) -> list:
    """Phase 8: the profiling path.  K5a, each stripped K1 build and K5b/K5c
    against their plain versions; then the sections `phases` and
    `vpu_peak` of sail_tpu_torch/tools/profile_megakernel.py at full size,
    whose launches are counted; then determinism_check and occupancy_study,
    one JSON line each.  Returns the kernels' JSON entries."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.ops.cuda import profile as pf
    from sail_tpu_torch.tools import determinism_check as det
    from sail_tpu_torch.tools import occupancy_study as occ
    from sail_tpu_torch.tools import profile_megakernel as prof
    from sail_tpu_torch.utils import opcount

    results = []
    size, spp, bounces = PROF_CHECK
    k5a_err = 0.0
    # K5a bit for bit: a closed scene, an open one (misses restart at the
    # origin), the batched fold; then a full-width row tile of the main shape
    for name, rows, row0, image_h, n, b in (
            ("cornell_mirror", size, 0, size, spp, bounces),
            ("material_demo_open", size, 0, size, spp, bounces),
            (f"spheres{FEW}", size, 0, size, spp, bounces),
            ("cornell_mirror", K1_TILE[0], K1_TILE[1], H, SPP, BOUNCES)):
        params, static = scene_of(name).pack()
        width = W if image_h == H else size
        args = (params.to(dev), static, rows, width, n, b, row0, image_h)
        got = pf.isect_only_block(*args)
        want = pf.isect_only_plain(*args)
        err = float((got - want).abs().max())
        k5a_err = max(k5a_err, err)
        results.append(f"K5a {name} rows {row0}-{row0 + rows - 1} of "
                       f"{image_h} x {width} spp{n} b{b}: max_abs {err:.3g}, "
                       f"mean {float(want.mean()):.4f}")
        if not torch.equal(got, want) or not float(want.max()) > 0:
            raise AssertionError(f"K5a is not its plain version bit for bit "
                                 f"or sees nothing: {results[-1]}")

    # each stripped K1 build against its stripped plain version, and not the
    # full image (else the strip did not take)
    size, spp, bounces = STRIP_CHECK
    params, static = scene_of("cornell_mirror").pack()
    args = (params.to(dev), static, size, size, spp, 0, 0, bounces)
    full = mk.render_block(*args).stack()
    for strip in pf.STRIPS:
        got = pf.render_block_stripped(strip, *args).stack()
        want = pf.render_block_stripped_plain(strip, *args).stack()
        bit, differs = torch.equal(got, want), not torch.equal(got, full)
        results.append(f"K1 {strip} cornell_mirror {size}x{size} spp{spp} "
                       f"b{bounces}: bit-identical {bit}, differs from full "
                       f"K1 {differs} (mean {float(got.mean()):.4f} against "
                       f"{float(full.mean()):.4f})")
        if not (bit and differs):
            raise AssertionError(f"a stripped K1 build: {results[-1]}")

    # K5b/K5c against their plain versions before and after the values
    # settle (fma_mix overflows to +inf from its 2nd iteration,
    # integrator_mix reaches its fixed point in ~5): fma within 1 ulp, the
    # rsqrt mixes (rsqrtf against torch.rsqrt) within MIX_RTOL
    alu_err, plain_alu = {}, {}
    for key, mix, (r, cn, g, k), chains in prof.ALU_CASES:
        for iters in (1, 2, 3, k):
            if chains == 1:
                got = pf.alu_peak(mix, r, cn, g, iters, device=dev)
                call = (pf.alu_peak_plain, mix, r, cn, g, iters, dev)
            else:
                got = pf.alu_peak_ilp8(r, cn, g, iters, device=dev)
                call = (pf.alu_peak_ilp8_plain, r, cn, g, iters, dev)
            want, ms = cuda_ms(*call)
            same = got == want   # +inf == +inf
            d = torch.where(same, 0.0, (got - want).abs())
            ulp = pf.ulp_diff(got, want)
            rel = float((d / want.abs()).max())
            ok = ulp <= 1 if mix == "fma" else rel <= MIX_RTOL
            if iters == k:
                alu_err[key], plain_alu[key] = float(d.max()), ms
            results.append(f"{key} K={iters}: max_abs {float(d.max()):.3g}, "
                           f"rel {rel:.3g}, {ulp} ulp, +inf "
                           f"{int(torch.isinf(got).sum())}/{got.numel()}")
            if not ok or not bool((torch.isinf(got) == torch.isinf(want))
                                  .all()):
                raise AssertionError(f"K5b/K5c disagrees with its plain "
                                     f"version: {results[-1]}")

    print("phase 8 checks: " + "; ".join(results), flush=True)

    # -- the main path: the profile tool's phases and vpu_peak sections ----
    size, spp, bounces = H, SPP, BOUNCES
    for fn in (mk.render_block, pf.render_block_stripped,
               pf.isect_only_block, pf.alu_peak, pf.alu_peak_ilp8):
        fn.launches = 0
    phases = prof.phases_section(dev, size, spp, bounces, iters=TIMED_RUNS)
    peak = prof.vpu_peak_section(dev, TIMED_RUNS)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in (
        mk.render_block, pf.render_block_stripped, pf.isect_only_block,
        pf.alu_peak, pf.alu_peak_ilp8)}
    label = (f"profile_megakernel sections phases (cornell_mirror {W}x{H} "
             f"spp{SPP} b{BOUNCES}) and vpu_peak")
    print(json.dumps({"profile": {"phases": phases, "vpu_peak": peak,
                                  "launches": launches, "card": card}}),
          flush=True)
    ratio = phases["intersect_only_spp_ratio"]
    if min(launches.values()) < 1 or ratio < 50 or not all(
            phases["stripped_differs_from_full"].values()):
        raise AssertionError(f"the profile's sections made {launches} "
                             f"launches, K5a spp{spp}/spp1 time ratio "
                             f"{ratio:.1f}, stripped images differ from the "
                             f"full one: {phases['stripped_differs_from_full']}")

    # -- the kernels' rows: plain versions timed, bounds from these inputs --
    params, static = scene_of("cornell_mirror").pack()
    params = params.to(dev)
    full_args = (params, static, H, W, SPP, BOUNCES)
    _, k5a_plain_ms = cuda_ms(pf.isect_only_plain, *full_args)
    small = 4 * (params.numel() + len(mk.scene_table(static).ints))
    b = dict(zip(("bound_ms", "bound_by"), opcount.bound_ms(
        opcount.isect_only_ops(params, static, H, W, SPP, BOUNCES),
        small + 4 * H * W)))
    shape = f"cornell_mirror {W}x{H} spp{SPP} b{BOUNCES}"
    rows = [kernel_row(
        "K5a isect_only_block (intersect-only path)",
        "sail_tpu_torch/csrc/profile.cu + path.cuh",
        "tools/profile_megakernel.py:380", launches["isect_only_block"],
        k5a_err, phases["intersect_only_ms"], k5a_plain_ms, b, shape,
        launches_counted_on=label, spp1_ms=phases["intersect_only_spp1_ms"],
        spp_ratio=ratio)]
    rows_t, row0 = K1_TILE
    tile = []
    for strip in pf.STRIPS:
        # bit for bit on a full-width row tile of the main shape, all bounces
        targs = (params, static, rows_t, W, SPP, 0, 0, BOUNCES, row0, H)
        tile_ms = median_ms(pf.render_block_stripped, strip, *targs)
        got = pf.render_block_stripped(strip, *targs).stack()
        want, plain_ms = cuda_ms(pf.render_block_stripped_plain, strip,
                                 *targs)
        want = want.stack()
        err = float((got - want).abs().max())
        tile.append(f"K1 {strip} rows {row0}-{row0 + rows_t - 1} of {H} x "
                    f"{W} spp{SPP} b{BOUNCES}: max_abs {err:.3g}")
        if not torch.equal(got, want):
            raise AssertionError(f"a stripped K1 build is not its plain "
                                 f"version bit for bit: {tile[-1]}")
        with pf.stripped(strip):   # the work the stripped paths need
            b = bound(params, static, H, W, SPP, BOUNCES, samples=1,
                      row_step=32)
        rows.append(kernel_row(
            f"K1 render_block_stripped({strip!r})",
            "sail_tpu_torch/csrc/profile.cu + path.cuh",
            "sail_tpu/ops/pallas/megakernel.py:159 under "
            "tools/profile_megakernel.py:325-350",
            launches["render_block_stripped"], err, phases[f"{strip}_ms"],
            plain_ms, b, shape, launches_counted_on=label,
            plain_shape=f"cornell_mirror rows {row0}-{row0 + rows_t - 1} of "
            f"{H} x {W} spp{SPP} b{BOUNCES}", tile_ms=tile_ms,
            full_ms=phases["full_ms"], cost_ms=phases[prof.COSTS[strip]]))
    for key, mix, (r, cn, g, k), chains in prof.ALU_CASES:
        e = peak[key]
        rows.append(kernel_row(
            f"K5c alu_peak_ilp8 ({key})" if chains > 1 else
            f"K5b alu_peak ({key})", "sail_tpu_torch/csrc/profile.cu",
            "tools/profile_megakernel.py:572" if chains > 1 else
            "tools/profile_megakernel.py:519",
            launches["alu_peak_ilp8" if chains > 1 else "alu_peak"],
            alu_err[key], e["ms"], plain_alu[key],
            dict(bound_ms=e["bound_ms"], bound_by="operations"),
            f"R={r} Cn={cn} G={g} K={k}" + (f" x{chains} chains"
                                            if chains > 1 else ""),
            launches_counted_on=label, bound_pipe=e["bound_pipe"],
            achieved_fp32_tflops=e["achieved_fp32_tflops"],
            achieved_sfu_tops=e["achieved_sfu_tops"],
            achieved_tpu_unit_tops=e["achieved_tops_per_s"],
            sm_clock_max_mhz=peak["sm_clock_max_mhz"]))

    # -- the tools -----------------------------------------------------------
    d = det.run(*DET_SHAPE, device=dev)
    print(json.dumps({"determinism_check": d}), flush=True)
    if not d["all_pass"]:
        raise AssertionError(f"determinism_check failed: {d}")
    o = occ.run(*OCC_SHAPE, device=dev)
    print(json.dumps({"occupancy_study": o}), flush=True)
    print(f"phase 8 profiling path: kernels vs plain as above; "
          + "; ".join(tile) + f" | {label}: "
          f"launches {launches}; K1 full {phases['full_ms']:.2f} ms, "
          + ", ".join(f"{s} {phases[s + '_ms']:.2f} ms" for s in pf.STRIPS)
          + f", K5a {phases['intersect_only_ms']:.2f} ms (spp1 "
          f"{phases['intersect_only_spp1_ms']:.3f} ms, ratio {ratio:.1f}); "
          + ", ".join(f"{k} {v['ms']:.3f} ms = {v['achieved_fp32_tflops']:.1f}"
                      f" FP32 TFLOP/s, {v['share_of_bound']:.1%} of bound"
                      for k, v in peak.items() if isinstance(v, dict))
          + f" | determinism_check {DET_SHAPE}: all_pass {d['all_pass']} | "
          f"occupancy_study {OCC_SHAPE} done | {card}", flush=True)
    return rows


def k2_phases(dev, card: str) -> list:
    """Phase 9: K2's phase split.  Its two stripped builds (the forward
    sweep alone; the sweep and the replay without the adjoint), each
    against its plain version; then, as the section's path, K2 and both
    stripped builds on config 2 at 1024² x {4, 16, 64} spp x 5 bounces;
    printed as one JSON line with K2's resources.  Returns the two stripped
    builds' JSON entries."""
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.ops.cuda import profile as pf
    from sail_tpu_torch.utils import build, opcount

    params, static = scene_of("cornell_mirror").pack()
    params = params.to(dev)
    rng = np.random.default_rng(3)
    results = []

    def stripped_check(label, got, want, strip):
        """Columns 0 and 2 (each block's g · radiance, summed in other
        orders) within GRAD_TOL of the largest; column 1 (replayed states
        that differ from the recorded ones) and the rest exactly 0."""
        cols = [0, 2] if strip == "no_adjoint" else [0]
        err = float((got[:, cols] - want[:, cols]).abs().max()
                    / want[:, cols].abs().max())
        rest = torch.ones(got.shape[1], dtype=torch.bool, device=dev)
        rest[cols] = False
        zero = bool((got[:, rest] == 0).all())
        results.append(f"K2 {strip} {label}: rel Linf {err:.3g} (columns "
                       f"{cols}), the other columns zero {zero}, mean "
                       f"{float(got[:, 0].mean()):.6g}")
        if not (err < GRAD_TOL and zero and bool(torch.isfinite(got).all())):
            raise AssertionError(f"a stripped K2 build: {results[-1]}")
        return err, float((got - want).abs().max())

    # the stripped builds at 64² and on a full-width row tile of the path
    size, spp, bounces = STRIP_CHECK
    g = Vec3(*(torch.from_numpy(rng.uniform(0.1, 1.0, (size, size))
                                .astype(np.float32)).to(dev)
               for _ in range(3)))
    args = (params, static, g, size, size, spp, 0, 0, bounces)
    for strip in pf.GRAD_STRIPS:
        stripped_check(f"cornell_mirror {size}x{size} spp{spp} b{bounces}",
                       pf.render_grad_stripped(strip, *args),
                       pf.render_grad_stripped_plain(strip, *args), strip)
    t_rows, t_row0 = K1_TILE
    gt = Vec3(*(torch.full((t_rows, W), 1.0 / (H * W * SPP), device=dev),)
              * 3)
    t_args = (params, static, gt, t_rows, W, SPP, 0, 0, BOUNCES, t_row0, H)
    tile = (f"cornell_mirror rows {t_row0}-{t_row0 + t_rows - 1} of {H} x "
            f"{W} spp{SPP} b{BOUNCES}")
    tiles = {}
    for strip in pf.GRAD_STRIPS:
        want, plain_ms = cuda_ms(pf.render_grad_stripped_plain, strip,
                                 *t_args)
        got = pf.render_grad_stripped(strip, *t_args)
        err, abs_err = stripped_check(tile, got, want, strip)
        tiles[strip] = (abs_err, plain_ms,
                        median_ms(pf.render_grad_stripped, strip, *t_args))
    print("phase 9 checks: " + "; ".join(results), flush=True)

    # -- the section's path: K2 and its stripped builds at 4, 16, 64 spp ---
    mk.render_grad_block.launches = 0
    pf.render_grad_stripped.launches = 0
    split = {}
    for n in (4, 16, SPP):
        gn = Vec3(*(torch.full((H, W), 1.0 / (H * W * n), device=dev),) * 3)
        a = (params, static, gn, H, W, n, 0, 0, BOUNCES)
        ms = {"full": median_ms(mk.render_grad_block, *a)}
        for strip in pf.GRAD_STRIPS:
            ms[strip] = median_ms(pf.render_grad_stripped, strip, *a)
        split[n] = {**{f"{k}_ms": v for k, v in ms.items()},
                    **{f"{k}_ms_per_sample": v / n for k, v in ms.items()},
                    "replay_ms": ms["no_adjoint"] - ms["forward_only"],
                    "adjoint_ms": ms["full"] - ms["no_adjoint"]}
    torch.cuda.synchronize()
    launches = {"render_grad_block": mk.render_grad_block.launches,
                "render_grad_stripped": pf.render_grad_stripped.launches}
    usage = {**build.resource_usage(("megakernel_grad",
                                     grad_build_of(params.numel(),
                                                   static).defines)),
             **build.resource_usage(pf.GRAD_LIBRARY)}
    n_par = params.numel()
    threads = mk.GRAD_BLOCK[0] * mk.GRAD_BLOCK[1]
    label = f"K2 phases (cornell_mirror {W}x{H} spp 4/16/{SPP} b{BOUNCES})"
    out = {"k2_phases": {
        "config": f"cornell_mirror {W}x{H} b{BOUNCES}, {n_par} params, K2 "
                  f"build {k2_build(n_par, static)}",
        "split": split, "resources": usage,
        "dynamic_smem_bytes": {"shared build": (threads + threads // 32)
                               * n_par * 4,
                               "local builds": threads // 32 * n_par * 4},
        "launches": launches, "card": card}}
    print(json.dumps(out), flush=True)
    if min(launches.values()) < 1:
        raise AssertionError(f"K2's phase section made {launches} launches")

    # -- the kernels' rows: bounds from these inputs ------------------------
    shape = f"cornell_mirror {W}x{H} spp{SPP} b{BOUNCES}"
    k1_b = bound(params, static, H, W, SPP, BOUNCES, samples=1, row_step=32)
    # a stripped build's output (each block's g · radiance) needs one
    # forward: K1's operations, K2's bytes
    small = 4 * (n_par + len(mk.scene_table(static).ints))
    rows_bytes = 4 * n_par * (W // 16) * (H // 16)
    s_ms, s_by = opcount.bound_ms(k1_b["ops"], small + 12 * H * W
                                  + rows_bytes)
    rows = []
    for strip in pf.GRAD_STRIPS:
        abs_err, plain_ms, tile_ms = tiles[strip]
        rows.append(kernel_row(
            f"K2 render_grad_stripped({strip!r})",
            "sail_tpu_torch/csrc/profile_grad.cu + render_grad.cuh + "
            "adjoint.cuh", "sail_tpu/ops/pallas/megakernel.py:262 (K2's "
            "phases)", launches["render_grad_stripped"], abs_err,
            split[SPP][f"{strip}_ms"], plain_ms,
            {"bound_ms": s_ms, "bound_by": s_by}, shape,
            launches_counted_on=label, plain_shape=tile, tile_ms=tile_ms))
    print(f"phase 9 K2 phases: " + ", ".join(
        f"spp{n}: full {v['full_ms']:.2f} ms ({v['full_ms_per_sample']:.3f} "
        f"ms/sample), forward_only {v['forward_only_ms']:.2f}, replay "
        f"{v['replay_ms']:.2f}, adjoint {v['adjoint_ms']:.2f}"
        for n, v in split.items()) + f" | launches {launches} | {card}",
        flush=True)
    return rows


def lights_path(dev, card: str) -> list:
    """Phase 10: the lights (BASELINE config 4, `lights_and_quadrics`: an
    area, a point and a spot light; the check scene `area_lights`: an area
    light over each of seven other shapes).  K1 against its plain version
    bit for bit at CHECK and on a full-width row tile at SPP, golden
    config4; K2 against its plain version on a row tile of each at the
    step's spp; then config 4's forward (Renderer, 1024² x LIGHTS_SPP x 5)
    through one K1 launch and its fwd+bwd step (1024² x 64 x 5) through one
    K1, one K2 and one reduce launch, timed.  Returns the kernels' JSON
    entries."""
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.tools import grad_localise
    from sail_tpu_torch.tools.goldens import golden_check

    size, spp, bounces = CHECK
    results = []
    for name in ("lights_and_quadrics", "area_lights"):
        params, static = scene_of(name).pack()
        args = (params.to(dev), static, size, size, spp, 0, 0, bounces)
        got = mk.render_block(*args)
        want = mk.render_block_plain(*args)
        err, _ = compare(got, want)
        results.append(f"{name} {size}x{size} spp{spp} b{bounces}: max_abs "
                       f"{err:.3g}, mean {float(want.stack().mean()):.4f}")
        if not (torch.equal(got.stack(), want.stack())
                and float(want.stack().max()) > 0):
            raise AssertionError(f"K1 is not its plain version bit for bit "
                                 f"or renders black: {results[-1]}")
        text, err, _, _, _ = k1_tile(name, params.to(dev), static, SPP)
        if err != 0:
            raise AssertionError(f"K1 is not its plain version bit for bit "
                                 f"on {text}")
        results.append(text)
    ref = np.load(os.path.join(GOLDENS, "config4_lights_quadrics.npy"))
    params, static = scene_of("lights_and_quadrics").pack()
    img = mk.render_block(params.to(dev), static, size, size, spp, 0, 0,
                          bounces)
    gold = golden_check((img.stack() * (1.0 / spp)).cpu().numpy(), ref,
                        params, static, spp)
    results.append(f"golden config4_lights_quadrics max_abs "
                   f"{gold['max_abs']:.3g}, pixels over {TOL:g}: "
                   f"{gold['outside']}, elsewhere max_abs "
                   f"{gold['max_abs_elsewhere']:.3g}")
    if gold["unexplained"]:
        raise AssertionError(f"K1 disagrees with golden config4: {gold}")

    # K2 on a full-width row tile of each scene at the step's spp and
    # cotangent: relative L-inf, per leaf with the pixel term, repeatable
    grads = {}
    for name in ("lights_and_quadrics", "area_lights"):
        params, static = scene_of(name).pack()
        params = params.to(dev)
        t_rows, row0 = K2_TILE["material_demo"]
        gt = Vec3(*(torch.full((t_rows, W), 1.0 / (H * W * SPP),
                               device=dev),) * 3)
        args = (params, static, gt, t_rows, W, SPP, 0, 0, BOUNCES)
        kw = dict(row0=row0, image_height=H)
        got = mk.render_grad_block(*args, **kw)
        again = mk.render_grad_block(*args, **kw)
        tile_ms = median_ms(mk.render_grad_block, *args, **kw)
        want, plain_ms = cuda_ms(mk.render_grad_block_plain, *args, **kw)
        shape = (f"{name} rows {row0}-{row0 + t_rows - 1} of {H} x {W} "
                 f"spp{SPP} b{BOUNCES}")
        summary, err, abs_err, _ = grad_check(
            f"{shape} ({params.numel()} params, K2 build "
            f"{k2_build(params.numel(), static)})", got, want, static,
            per_leaf=False)
        where = grad_localise.check(*args, row0, H, got, want)
        if where["excess"] > 1 or not torch.equal(got, again):
            raise AssertionError(f"K2 disagrees with its plain version on a "
                                 f"leaf or is not repeatable: {summary}, "
                                 f"{where}")
        grads[name] = dict(shape=shape, err=err, abs_err=abs_err,
                           tile_ms=tile_ms, plain_ms=plain_ms, where=where)
        results.append(f"{summary}; per leaf with the pixel term: worst "
                       f"{where['leaf_name']} = {where['excess']:.3g} of its "
                       f"bound; bit-identical on repeat; K2 {tile_ms:.2f} "
                       f"ms, plain {plain_ms:.1f} ms on the tile")

    # -- config 4's forward path: the Renderer at LIGHTS_SPP -----------------
    name = "lights_and_quadrics"
    label = f"Renderer {name} {W}x{H} spp{LIGHTS_SPP} b{BOUNCES}"
    launches, out, fwd_ms, params, static, _ = renderer_path(
        dev, name, label, spp=LIGHTS_SPP)
    full = (params, static, H, W, LIGHTS_SPP, 0, 0, BOUNCES)
    k1_ms = median_ms(mk.render_block, *full)
    text, k1_err, k1_tile_ms, k1_plain_ms, k1_shape = k1_tile(
        name, params, static, LIGHTS_SPP)
    if k1_err != 0:
        raise AssertionError(f"K1 is not its plain version bit for bit on "
                             f"{text}")
    k1_bound = bound(params, static, H, W, LIGHTS_SPP, BOUNCES, samples=1,
                     row_step=32)

    # -- config 4's fwd+bwd step ---------------------------------------------
    p = params.clone().requires_grad_()

    def step(p, seed):
        img = mk.render_image_fast(p, seed, static, H, W, SPP, BOUNCES)
        loss = (img.x + img.y + img.z).mean()
        loss.backward()
        return loss

    mk.render_block.launches = mk.render_grad_block.launches = 0
    mk.reduce_grad_rows.launches = 0
    loss = step(p, 0)
    torch.cuda.synchronize()
    step_launches = (mk.render_block.launches, mk.render_grad_block.launches,
                     mk.reduce_grad_rows.launches)
    if step_launches != (1, 1, 1) or not (torch.isfinite(p.grad).all()
                                          and p.grad.abs().max() > 0
                                          and torch.isfinite(loss)):
        raise AssertionError(f"the step on {name} made {step_launches} "
                             f"K1/K2/reduce launches, loss "
                             f"{float(loss.detach())}, finite grad "
                             f"{bool(torch.isfinite(p.grad).all())}")
    step_grad = p.grad.clone()
    times = []
    for k in range(TIMED_RUNS):
        p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(p, k + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    g = Vec3(*(torch.full((H, W), 1.0 / (H * W * SPP), device=dev),) * 3)
    runs = [cuda_ms(mk.render_grad_block, params, static, g, H, W, SPP, 0,
                    0, BOUNCES) for _ in range(TIMED_RUNS)]
    k2_ms = statistics.median(ms for _, ms in runs)
    if not all(torch.equal(step_grad, r) for r, _ in runs):
        raise AssertionError(f"the step's gradient on {name} is not K2's at "
                             f"the same arguments")
    k2_bound = bound(params, static, H, W, SPP, BOUNCES, grad=True,
                     samples=1, row_step=32)
    c4 = grads[name]
    print(f"phase 10 lights: K1 vs plain: " + "; ".join(results[:5])
          + " | K2 vs plain: " + "; ".join(results[5:]) + f" | {label}: "
          f"{launches} K1 launch, output {out.shape} finite, mean "
          f"{out.mean():.4f}, render_spp {fwd_ms:.2f} ms = "
          f"{mrays(fwd_ms, LIGHTS_SPP):.1f} Mrays/s (median of {TIMED_RUNS}),"
          f" K1 {k1_ms:.2f} ms, bound {k1_bound['bound_ms']:.3f} ms "
          f"({k1_bound['bound_by']}) | K1 vs plain on {text} | step "
          f"render_image_fast {name} {W}x{H} spp{SPP} b{BOUNCES} -> "
          f"mean(x+y+z) -> backward: {step_launches[0]} K1, "
          f"{step_launches[1]} K2, {step_launches[2]} reduce launch, loss "
          f"{float(loss.detach()):.6g}, fwd+bwd {step_ms:.1f} ms = "
          f"{mrays(step_ms):.1f} Mrays/s (median of {TIMED_RUNS}), K2 "
          f"{k2_ms:.1f} ms, bound {k2_bound['bound_ms']:.3f} ms "
          f"({k2_bound['bound_by']}), the step's gradient K2's bit for bit "
          f"| {card}", flush=True)
    return [
        kernel_row(f"K1 render_block ({name}: area, point and spot lights, "
                   f"quadrics, metal)",
                   "sail_tpu_torch/csrc/megakernel.cu + path.cuh + bsdf.cuh",
                   "sail_tpu/ops/pallas/megakernel.py:159", launches,
                   k1_err, k1_ms, k1_plain_ms, k1_bound,
                   f"{name} {W}x{H} spp{LIGHTS_SPP} b{BOUNCES}",
                   launches_counted_on=label, plain_shape=k1_shape,
                   tile_ms=k1_tile_ms),
        kernel_row(f"K2 render_grad_block ({name}: the LIGHTS build)",
                   "sail_tpu_torch/csrc/megakernel_grad.cu + render_grad.cuh "
                   "+ adjoint.cuh + bsdf.cuh",
                   "sail_tpu/ops/pallas/megakernel.py:262", step_launches[1],
                   c4["abs_err"], k2_ms, c4["plain_ms"], k2_bound,
                   f"{name} {W}x{H} spp{SPP} b{BOUNCES}", rel_linf=c4["err"],
                   launches_counted_on=f"the fwd+bwd step on {name}",
                   plain_shape=c4["shape"], tile_ms=c4["tile_ms"],
                   localised=c4["where"],
                   build=k2_build(params.numel(), static))] \
        + lit_spheres(dev, card)


def lit_spheres(dev, card: str) -> list:
    """Phase 10, K2's LIGHTS builds at 1,024 and 4,096 floats on many
    spheres and a point light:
    each against its plain version at LIT_CHECK (relative L-inf and per
    leaf with the pixel term) and bit-identical on repeat, then
    render_image_fast at LIT_STEP -> mean(x+y+z) -> backward() through
    one K1, one K2 and one reduce launch, timed, its gradient K2's bit for
    bit.  Returns the two builds' JSON entries."""
    from sail_tpu_torch import scenes
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.tools import grad_localise

    size, c_spp, c_bounces = LIT_CHECK
    rows, texts = [], []
    for n, cap in LIT_SPHERES.items():
        params, static = scenes.lit_spheres(n).pack()
        params = params.to(dev)
        b = grad_build_of(params.numel(), static)
        if b.cap != cap or not b.lights:
            raise AssertionError(f"lit_spheres({n}) does not take K2's "
                                 f"LIGHTS {cap} build")
        gen = torch.Generator().manual_seed(n)
        g = Vec3(*(torch.rand(size, size, generator=gen).to(dev)
                   for _ in range(3)))
        args = (params, static, g, size, size, c_spp, 0, 0, c_bounces)
        got, check_ms = cuda_ms(mk.render_grad_block, *args)
        again = mk.render_grad_block(*args)
        want, plain_ms = cuda_ms(mk.render_grad_block_plain, *args)
        shape = f"lit_spheres({n}) {size}x{size} spp{c_spp} b{c_bounces}"
        summary, err, abs_err, _ = grad_check(
            f"{shape} ({params.numel()} params, K2 build "
            f"{k2_build(params.numel(), static)})", got, want, static,
            per_leaf=False)
        where = grad_localise.check(*args, 0, size, got, want)
        if where["excess"] > 1 or not torch.equal(got, again):
            raise AssertionError(f"K2 disagrees with its plain version on a "
                                 f"leaf or is not repeatable: {summary}, "
                                 f"{where}")

        spp, bounces = LIT_STEP[n]
        p = params.clone().requires_grad_()

        def step(seed):
            img = mk.render_image_fast(p, seed, static, H, W, spp, bounces)
            loss = (img.x + img.y + img.z).mean()
            loss.backward()
            return loss

        mk.render_block.launches = mk.render_grad_block.launches = 0
        mk.reduce_grad_rows.launches = 0
        loss = step(0)
        torch.cuda.synchronize()
        launches = (mk.render_block.launches, mk.render_grad_block.launches,
                    mk.reduce_grad_rows.launches)
        if launches != (1, 1, 1) or not (torch.isfinite(p.grad).all()
                                         and p.grad.abs().max() > 0):
            raise AssertionError(f"the step on lit_spheres({n}) made "
                                 f"{launches} K1/K2/reduce launches, finite "
                                 f"grad {bool(torch.isfinite(p.grad).all())}")
        step_grad = p.grad.clone()

        def timed_step():
            p.grad = None
            step(1)

        step_ms = host_ms(timed_step, runs=TIMED_RUNS)[1]
        gs = Vec3(*(torch.full((H, W), 1.0 / (H * W * spp), device=dev),)
                  * 3)
        runs = [cuda_ms(mk.render_grad_block, params, static, gs, H, W, spp,
                        0, 0, bounces) for _ in range(TIMED_RUNS)]
        k2_ms = statistics.median(ms for _, ms in runs)
        if not all(torch.equal(step_grad, r) for r, _ in runs):
            raise AssertionError(f"the step's gradient on lit_spheres({n}) "
                                 f"is not K2's at the same arguments")
        k2_bound = bound(params, static, H, W, spp, bounces, grad=True,
                         samples=1, row_step=32)
        step_shape = f"lit_spheres({n}) {W}x{H} spp{spp} b{bounces}"
        texts.append(f"{summary}; per leaf with the pixel term: worst "
                     f"{where['leaf_name']} = {where['excess']:.3g} of its "
                     f"bound; bit-identical on repeat; K2 {check_ms:.2f} ms, "
                     f"plain {plain_ms:.1f} ms | step render_image_fast "
                     f"{step_shape} -> mean(x+y+z) -> backward: "
                     f"{launches[0]} K1, {launches[1]} K2, {launches[2]} "
                     f"reduce launch, loss {float(loss.detach()):.6g}, "
                     f"fwd+bwd {step_ms:.1f} ms (median of {TIMED_RUNS}), K2 "
                     f"{k2_ms:.2f} ms, bound {k2_bound['bound_ms']:.3f} ms "
                     f"({k2_bound['bound_by']}), the step's gradient K2's "
                     f"bit for bit")
        rows.append(kernel_row(
            f"K2 render_grad_block (lit_spheres({n}): the LIGHTS {cap} "
            f"build)", "sail_tpu_torch/csrc/megakernel_grad.cu + "
            "render_grad.cuh + adjoint.cuh",
            "sail_tpu/ops/pallas/megakernel.py:262", launches[1], abs_err,
            k2_ms, plain_ms, k2_bound, step_shape, rel_linf=err,
            launches_counted_on=f"the fwd+bwd step on lit_spheres({n})",
            plain_shape=shape, tile_ms=check_ms, localised=where,
            build=k2_build(params.numel(), static), step_ms=step_ms))
    print("phase 10 K2's LIGHTS builds: " + " || ".join(texts)
          + f" | {card}", flush=True)
    return rows


def host_ms(fn, *args, runs: int = 1, **kw):
    """(last result, median ms) of `runs` calls on the host clock, each
    ending in torch.cuda.synchronize()."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return res, statistics.median(times)


# KR, KP, the K2 reduce, KA and KH's forward and adjoint as the profiler
# names their kernels
EDGE_KERNEL_NAMES = ("trace_rays_kernel", "penumbra_kernel",
                     "reduce_grad_rows_kernel", "alhazen_kernel",
                     "receivers_kernel", "receivers_grad_kernel")


class CallPatch:
    """`module.name` replaced by a wrapper until `restore()`: `calls`
    counts its calls and `args` keeps each call's positional arguments;
    with `parts`, each call is also timed to a synchronize on both sides
    into `parts[name]` (calls, ms, and for trace_rays the rays)."""

    def __init__(self, module, name: str, parts: dict = None):
        self.module, self.name, self.calls, self.args = module, name, 0, []
        self.fn = fn = getattr(module, name)

        def wrapper(*args, **kw):
            self.calls += 1
            self.args.append(args)
            if parts is None:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            part = parts.setdefault(name, {"calls": 0, "ms": 0.0, "rays": 0})
            part["calls"] += 1
            part["ms"] += (time.perf_counter() - t0) * 1e3
            if name == "trace_rays":          # (scene, static, ro, ...)
                part["rays"] += args[2].x.numel()
            return res

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def display_path(dev, card: str) -> list:
    """Phase 11: display and runtime.  BASELINE config 4 whole (its Gaussian
    filter), every filter and the lazy G-buffer on config 2, the fresh
    Renderer's resume, and the viewer's loop at VIEWER², each held against
    the CPU.  K1 is the only kernel (phases 3 and 10 give its rows)."""
    import tempfile

    from sail_tpu_torch import Renderer, scenes
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.ops import filters
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.render import integrator, overlay, picking
    from sail_tpu_torch.render.control import Control
    from sail_tpu_torch.scene.scene import VALID_FILTERS, unflatten
    from sail_tpu_torch.tools.goldens import grazing_pixels
    from sail_tpu_torch.utils.imageio import png_bytes

    def cpu(v):
        return Vec3(*(t.cpu() for t in v))

    def held(label, got, want, tol=FILTER_TOL):
        d = np.abs(got.astype(np.float64) - want)
        bad = int((d > tol + tol * np.abs(want)).sum())
        if bad or got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: {bad} values outside {tol:g} of "
                                 f"the CPU, max_abs {d.max():.3g}")
        return float(d.max())

    out_line = []
    mk.render_block.launches = 0
    # -- BASELINE config 4 whole: its Gaussian filter -------------------------
    scene = scenes.lights_and_quadrics()
    scene.filter = "gaussian"
    r = Renderer(W, H, seed=0, max_bounces=BOUNCES)
    r.update(scene)
    _, k1_ms = cuda_ms(r.render_spp, scene, LIGHTS_SPP)
    launches4 = mk.render_block.launches
    out, out_ms = host_ms(r.output, scene, runs=TIMED_RUNS + 1)
    want = filters.apply_filter("gaussian", cpu(r.current())).stack().numpy()
    err = held("config 4 gaussian", out, want)
    if launches4 != 1:
        raise AssertionError(f"config 4 made {launches4} K1 launches, not 1")
    out_line.append(
        f"config 4 lights_and_quadrics {W}x{H} spp{LIGHTS_SPP} b{BOUNCES} "
        f"gaussian: {launches4} K1 launch, render_spp {k1_ms:.2f} ms, "
        f"output {out_ms:.2f} ms (median of {TIMED_RUNS + 1}), frame mean "
        f"{out.mean():.4f}, vs CPU max_abs {err:.3g}")

    # -- config 2: the lazy G-buffer and every filter ---------------------------
    scene = scenes.cornell_mirror()
    r = Renderer(W, H, seed=0, max_bounces=BOUNCES)
    r.update(scene)
    r.render_spp(scene, SPP)
    scene.filter = "normal"
    _, first_ms = host_ms(r.output, scene)       # fills the G-buffer
    packed = unflatten(r._params, r._static)
    gbuf, fill_ms = host_ms(integrator.gbuffer, packed, r._static, H, W, 0,
                            0, runs=TIMED_RUNS)
    params, static = scene.pack()
    want_gb = integrator.gbuffer(unflatten(params, static), static, H, W, 0,
                                 0)
    for a, b in zip(gbuf, (r._normal, r._position)):
        if not torch.equal(a.stack(), b.stack()):
            raise AssertionError("the G-buffer is not the same on repeat")
    d = np.zeros((H, W), bool)
    gb_err = 0.0
    for a, b in zip(gbuf, want_gb):
        a, b = a.stack().cpu().numpy(), b.stack().numpy()
        diff = np.abs(a.astype(np.float64) - b)
        d |= (diff > TOL + TOL * np.abs(b)).any(-1)
        gb_err = max(gb_err, float(diff.max()))
    bad = {tuple(map(int, p)) for p in np.argwhere(d)}
    graze = grazing_pixels(params, static, H, W, 1) if bad else set()
    if bad - graze:
        raise AssertionError(f"the card's G-buffer is off the CPU's at "
                             f"{len(bad - graze)} pixels that do not graze a "
                             f"sphere: {sorted(bad - graze)[:8]}")
    gnormal, gposition = cpu(r._normal), cpu(r._position)
    current = cpu(r.current())
    per_filter = []
    for name in VALID_FILTERS:
        scene.filter = name
        out, ms = host_ms(r.output, scene, runs=TIMED_RUNS)
        _, filter_ms = host_ms(filters.apply_filter, name, r.current(),
                               r._normal, r._position, runs=TIMED_RUNS)
        want = filters.apply_filter(name, current, gnormal,
                                    gposition).stack().numpy()
        per_filter.append(f"{name} {ms:.2f} ms (the filter {filter_ms:.2f}; "
                          f"max_abs {held(name, out, want):.2g})")
    out_line.append(
        f"config 2 cornell_mirror {W}x{H} spp{SPP} b{BOUNCES}: first "
        f"output(normal) {first_ms:.2f} ms with the G-buffer fill, the fill "
        f"{fill_ms:.2f} ms (median of {TIMED_RUNS}), vs CPU max_abs "
        f"{gb_err:.3g}, {len(bad)} pixels over {TOL:g}, all grazing a "
        f"sphere; output per filter (median of {TIMED_RUNS}; the filter "
        f"alone on the card; vs the CPU at {FILTER_TOL:g}): "
        + ", ".join(per_filter))

    # -- checkpoint: a fresh Renderer resumes ----------------------------------
    scene = scenes.cornell_mirror()
    r = Renderer(W, H, seed=0, max_bounces=BOUNCES)
    r.update(scene)
    r.render_spp(scene, RESUME_SPP)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        r.save(path)
        r.render_spp(scene, RESUME_SPP)
        fresh = Renderer(W, H, seed=0, max_bounces=BOUNCES)
        fresh.load(path)
    fresh.render_spp(scene, RESUME_SPP)
    one = Renderer(W, H, seed=0, max_bounces=BOUNCES)
    one.update(scene)
    one.render_spp(scene, 2 * RESUME_SPP)
    resumed = fresh.current().stack()
    rel = {}
    # against the render that went on: the same sums (the checkpoint's
    # mean times its count is exact, a power of two); against one launch
    # the last RESUME_SPP nonnegative samples are added in another order,
    # at most 2 * RESUME_SPP roundings of 2^-24 of the sum apart
    for label, other, rtol in (("went on", r, 1e-6),
                               ("one launch", one, 2 * RESUME_SPP * 2**-24)):
        ref = other.current().stack()
        rel[label] = float(((resumed - ref).abs() / ref.abs().clamp(
            min=1e-30)).max())
        if fresh.sample_count != 2 * RESUME_SPP or not torch.allclose(
                resumed, ref, rtol=rtol, atol=0):
            raise AssertionError(f"the fresh Renderer's resume is off the "
                                 f"render that {label} by {rel[label]:.3g} "
                                 f"relative ({fresh.sample_count} samples)")
    out_line.append(
        f"resume cornell_mirror {W}x{H}: render_spp({RESUME_SPP}) -> save -> "
        f"fresh Renderer load -> render_spp({RESUME_SPP}): max rel diff "
        f"{rel['went on']:.3g} against the render that went on (bound "
        f"1e-6), {rel['one launch']:.3g} against one "
        f"render_spp({2 * RESUME_SPP}) (bound {2 * RESUME_SPP * 2**-24:.3g})")

    # -- the viewer's loop ----------------------------------------------------
    scene = scenes.cornell_mirror()
    scene.filter = "gamma"
    r = Renderer(VIEWER, VIEWER, seed=0, max_bounces=BOUNCES)
    r.update(scene)
    ctl = Control(scene, VIEWER, VIEWER)
    matte = 2
    xy, _ = overlay.project_points(
        scene.camera, np.asarray([scene.objects[matte].center]), VIEWER,
        VIEWER)
    x, y = float(xy[0, 0]), float(xy[0, 1])
    parts = {"frame": [], "K1": [], "output": [], "overlay": [], "png": []}
    png = b""

    def frame():
        nonlocal png
        t0 = time.perf_counter()
        _, k1 = host_ms(r.render_spp, scene, 1)
        img, o = host_ms(r.output, scene)
        _, ov = host_ms(overlay.draw_selection, img.copy(), scene,
                        scene.select)
        png, p = host_ms(png_bytes, img)
        parts["frame"].append((time.perf_counter() - t0) * 1e3)
        for k, v in (("K1", k1), ("output", o), ("overlay", ov), ("png", p)):
            parts[k].append(v)
        if img.shape != (VIEWER, VIEWER, 3) or not np.isfinite(img).all():
            raise AssertionError(f"viewer frame {img.shape} not finite")

    c0 = scene.objects[matte].center
    if not ctl.mouse_down(x, y) or scene.select != matte:
        raise AssertionError(f"mouse_down at ({x:.1f}, {y:.1f}) picked "
                             f"{scene.select}, not the matte sphere")
    frame()
    for k in range(1, DRAG_MOVES + 1):
        ctl.mouse_move(x + 2 * k, y - k)
        frame()
    ctl.mouse_up()
    if scene.objects[matte].center == c0 or scene.moving:
        raise AssertionError("the drag left the matte sphere where it was "
                             "or the scene moving")
    frame()
    for _ in range(ORBIT_MOVES):
        ctl.orbit(6, 2)
        frame()
    ctl.zoom(+1)
    frame()
    if not png.startswith(b"\x89PNG"):
        raise AssertionError("png_bytes gave no PNG")
    step = VIEWER // PICK_GRID
    grid = [(step // 2 + step * i, step // 2 + step * j)
            for i in range(PICK_GRID) for j in range(PICK_GRID)]
    on_card = [picking.pick(scene, px, py, VIEWER, VIEWER)
               for px, py in grid]
    on_cpu = [picking.pick(scene, px, py, VIEWER, VIEWER, device="cpu")
              for px, py in grid]
    if on_card != on_cpu:
        raise AssertionError(f"pick on the card differs from the CPU at "
                             f"{sum(a != b for a, b in zip(on_card, on_cpu))} "
                             f"pixels")
    med = {k: statistics.median(v) for k, v in parts.items()}
    out_line.append(
        f"viewer cornell_mirror {VIEWER}x{VIEWER} b{BOUNCES}, "
        f"{len(parts['frame'])} frames (a pick, {DRAG_MOVES} drag moves, "
        f"release, {ORBIT_MOVES} orbit moves, a zoom): median frame "
        f"{med['frame']:.2f} ms = K1 (render_spp(1)) {med['K1']:.3f} + "
        f"output (gamma + overlay) {med['output']:.3f} + PNG "
        f"{med['png']:.3f} ms, the overlay alone {med['overlay']:.3f} ms, "
        f"PNG {len(png)} B; pick on the card = CPU on "
        f"{PICK_GRID}x{PICK_GRID} pixels "
        f"({sum(i is not None for i in on_card)} on an object)")
    # one each for config 4 and config 2, four for the resume, one a frame
    launches = mk.render_block.launches
    if launches != 6 + len(parts["frame"]):
        raise AssertionError(f"phase 11 made {launches} K1 launches, not "
                             f"{6 + len(parts['frame'])}")
    print(f"phase 11 display and runtime: {launches} K1 launches | "
          + " | ".join(out_line) + f" | {card}", flush=True)
    return []


def edge_kernels(q, static, dL, n: int, edge_kw: dict,
                 launches=(0, 0, 0, 0, 0), on: str = None) -> tuple:
    """KR, KP, KA and KH at config 5's step inputs (`q`, the loss adjoint
    `dL`, the step's edge settings): KR against the plain integrator's
    trace_rays on the silhouette term's straddle rays bit for bit; the
    penumbra term (shadow_boundary_term: KH's receivers and KP) against
    the plain version's on the card per leaf within KP_TOL of the largest
    leaf, and KP's partials in the receiver points too; KH's planes, ints
    and points against the plain receivers' bit for bit, its camera
    partials against autograd's through the plain live points within
    KH_TOL; KA against the plain Alhazen solve on the silhouette term's
    mirror pair (the masks equal, the roots and slopes within KA_RTOL);
    each timed beside its plain version, its bound from these inputs.
    `launches`: each kernel's launches in the main path's run (KR, KP, KA,
    KH's forward, its adjoint).  Returns (summary, the four kernels'
    entries).  Raises."""
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.diff import boundary
    from sail_tpu_torch.ops.cuda import alhazen as ka
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.core.camera import CameraParams
    from sail_tpu_torch.ops import intersect as isect
    from sail_tpu_torch.ops.cuda import penumbra as kp
    from sail_tpu_torch.ops.cuda import receivers as kh
    from sail_tpu_torch.render import integrator
    from sail_tpu_torch.scene.scene import leaf_paths, param_offsets, unflatten
    from sail_tpu_torch.tools.k2_compare import queued_ms
    from sail_tpu_torch.utils import opcount

    # -- KR: the silhouette term's one trace_rays call ----------------------
    sil_kw = {k: edge_kw[k] for k in ("n_edge_samples", "n_noise", "seed",
                                      "max_bounces")}
    tap = CallPatch(boundary, "trace_rays")
    ka_tap = CallPatch(ka, "solve")
    try:
        boundary.boundary_term(q, static, dL, n, n, **sil_kw)
    finally:
        tap.restore()
        ka_tap.restore()
    (kr_args,) = tap.args
    pp, st, ro, rd, noise, mb = kr_args

    def plain_rays():
        return integrator.trace_rays(unflatten(pp, st), st, ro, rd, noise, mb)

    got, kr_call_ms = cuda_ms(mk.trace_rays, *kr_args)
    want, kr_plain_ms = cuda_ms(plain_rays)
    got, want = got.stack(), want.stack()
    kr_err = float((got - want).abs().max())
    n_rays = got.numel() // 3
    if not (torch.equal(got, want) and bool(torch.isfinite(got).all())):
        raise AssertionError(f"KR is not the plain trace_rays bit for bit on "
                             f"config 5's {n_rays} straddle rays: max_abs "
                             f"{kr_err:.3g}")
    kr_ms = queued_ms(mk.trace_rays, *kr_args, runs=TIMED_RUNS)
    kr_plain_ms = min(kr_plain_ms, cuda_ms(plain_rays)[1])
    kr_ops = opcount.ray_ops(pp, st, ro, rd, noise, mb)
    kr_b = dict(zip(("bound_ms", "bound_by"),
                    opcount.bound_ms(kr_ops, 44 * n_rays)))

    # -- KP: the penumbra term ------------------------------------------------
    # with the plain receivers on the card (their KP call captured), then
    # with the plain receivers and the plain KP, then as the step runs it
    # (KH's receivers and KP)
    pen_kw = dict(n_curve_samples=edge_kw["n_curve_samples"],
                  seed=edge_kw["seed"])
    kernel_term = boundary._shadow_term_kernel
    kernel_scalar = kp.penumbra_scalar
    boundary._shadow_term_kernel = boundary._shadow_term_plain
    tap = CallPatch(kp, "penumbra_scalar")
    try:
        g_recv, recv_term_ms = host_ms(boundary.shadow_boundary_term, q,
                                       static, dL, n, n, **pen_kw)
        tap.restore()
        kp.penumbra_scalar = kp.penumbra_scalar_plain
        g_plain, term_plain_ms = host_ms(boundary.shadow_boundary_term, q,
                                         static, dL, n, n, **pen_kw)
    finally:
        tap.restore()
        kp.penumbra_scalar = kernel_scalar
        boundary._shadow_term_kernel = kernel_term
    (kp_args,) = tap.args
    g_kp, term_ms = host_ms(boundary.shadow_boundary_term, q, static, dL, n,
                            n, runs=3, **pen_kw)
    d = (g_kp - g_plain).abs()
    top = float(g_plain.abs().max())
    worst = int(d.argmax())
    paths = leaf_paths(static)
    kp_text = (f"penumbra term at {n}x{n} (K {pen_kw['n_curve_samples']}), "
               f"KH and KP vs plain: max |diff| {float(d.max()):.3g} = "
               f"{float(d.max()) / top:.3g} of the largest leaf "
               f"({top:.4g}), worst leaf {paths[worst]} plain "
               f"{float(g_plain[worst]):.6g} KP {float(g_kp[worst]):.6g}")
    if not (float(d.max()) <= KP_TOL * top and top > 0
            and bool(torch.isfinite(g_kp).all())):
        raise AssertionError(f"KP disagrees with its plain version: "
                             f"{kp_text}")
    # the kernel alone on the inputs the step gave it, and the plain
    # version of the same function: the scalar and autograd's partials
    pk, pk_d, st, dl_, recv, x_live, pairs, K = kp_args
    ids, inputs = kp.pack_inputs(pk_d, st, dl_, *kp.receiver_planes(recv),
                                 pairs, K)
    spheres = torch.stack([torch.stack((*pk_d.objects[i].center,
                                        pk_d.objects[i].radius))
                           for i in ids]).contiguous()
    xs = torch.stack([x_live[rc.tag].stack(0).detach()
                      for rc in recv]).contiguous()
    (_, _, gx_kp), _ = cuda_ms(kp.penumbra_partials, spheres, xs, inputs)
    kp_ms = median_ms(kp.penumbra_partials, spheres, xs, inputs)

    def plain_partials():
        p = q.detach().clone().requires_grad_()
        xl = xs.clone().requires_grad_()
        live = {rc.tag: Vec3(*xl[r]) for r, rc in enumerate(recv)}
        value = kp.penumbra_scalar_plain(unflatten(p, st), pk_d, st, dl_,
                                         recv, live, pairs, K)
        return torch.autograd.grad(value, (p, xl))

    (_, gx_plain), kp_plain_ms = cuda_ms(plain_partials)
    gx_err = float((gx_kp - gx_plain).abs().max())
    gx_top = float(gx_plain.abs().max())
    if not gx_err <= KP_TOL * gx_top:
        raise AssertionError(f"KP's gradient in the receiver points is "
                             f"{gx_err:.3g} off autograd's (max "
                             f"{gx_top:.3g})")
    tally = {}
    with torch.no_grad():
        kp.penumbra_scalar_plain(pk_d, pk_d, st, dl_, recv, x_live, pairs, K,
                                 tally=tally)
    kp_bytes = 4 * (2 * xs.numel() + inputs.planes.numel()
                    + inputs.ints.numel() + inputs.dl.numel())
    kp_b = dict(zip(("bound_ms", "bound_by"), opcount.bound_ms(
        opcount.penumbra_ops(tally, K), kp_bytes)))

    # -- KH: the primary and mirror receivers --------------------------------
    R = len(recv)
    planes_p, ints_p = kp.receiver_planes(recv)
    planes_p = planes_p.contiguous()
    (xs_h, planes_h, ints_h), kh_call_ms = cuda_ms(kh.trace_receivers, q,
                                                   static, n, n, R)
    kh_bits = all(torch.equal(a.contiguous().view(torch.int32),
                              b.contiguous().view(torch.int32))
                  for a, b in ((planes_h, planes_p), (xs_h, xs)))
    kh_err = max(float((planes_h - planes_p).abs().max()),
                 float((xs_h - xs).abs().max()))
    per_plane = (planes_h - planes_p).abs().amax(dim=(0, 2, 3))
    kh_text = (f"KH vs the plain receivers ({R} receivers at {n}x{n}): ints "
               f"{'equal' if torch.equal(ints_h, ints_p) else 'DIFFER'}, "
               f"planes and points max |diff| {kh_err:.3g}, "
               f"{'bit-identical' if kh_bits else 'not bit-identical'}")
    if not kh_bits:
        kh_text += (f" (each plane's largest difference, n ss ts wo sc tint "
                    f"each x y z: "
                    f"{[f'{float(v):.3g}' for v in per_plane]})")
    if not (torch.equal(ints_h, ints_p) and kh_err <= KH_PLANE_TOL
            and bool(torch.isfinite(planes_h).all())):
        raise AssertionError(f"KH disagrees with the plain receivers: "
                             f"{kh_text}")
    # the adjoint at KP's cotangent, against autograd through the plain
    # live points
    off = param_offsets(st)
    g_x = gx_kp.contiguous()
    cam_kh, kh_adj_call_ms = cuda_ms(kh.receivers_adjoint, q, st, g_x)

    def plain_camera():
        c = q[off.camera:off.size].clone().requires_grad_()
        cam = CameraParams(Vec3(*c[0:3]), Vec3(*c[3:6]), Vec3(*c[6:9]),
                           Vec3(*c[9:12]), c[12], c[13])
        x = boundary._live_points(cam, pk_d, st, n, n, q, R > 1)
        xl = torch.stack([x[rc.tag].stack(0) for rc in recv])
        return torch.autograd.grad((xl * g_x).sum(), c)[0]

    cam_plain = plain_camera()
    cam_top = float(cam_plain.abs().max())
    cam_err = float((cam_kh - cam_plain).abs().max())
    if not (cam_err <= KH_TOL * cam_top and bool(torch.isfinite(cam_kh).all())):
        raise AssertionError(f"KH's camera partials are {cam_err:.3g} off "
                             f"autograd's (max {cam_top:.3g})")
    sphere_leaves = [k for k in range(len(paths))
                     if not paths[k].startswith(".camera")]
    recv_bits = torch.equal(g_kp[sphere_leaves], g_recv[sphere_leaves])
    recv_err = float((g_kp - g_recv).abs().max())
    kh_text += (f"; camera partials at KP's cotangent {cam_err:.3g} of "
                f"{cam_top:.3g} off autograd's; the term with KH vs with the "
                f"plain receivers: max |diff| {recv_err:.3g}, the leaves "
                f"but the camera's "
                f"{'bit-identical' if recv_bits else 'not bit-identical'}")
    kh_fwd_ms = median_ms(kh.trace_receivers, q, static, n, n, R)
    kh_adj_ms = median_ms(kh.receivers_adjoint, q, st, g_x)

    def eager_receivers():
        """The plain receivers on the card, their planes and their
        backward at KP's cotangent: the work KH does (KP stood in)."""
        def stand_in(pk_, pk_d_, st_, dl__, recv_, x_live_, pairs_, k_):
            kp.receiver_planes(recv_)
            xl = torch.stack([x_live_[rc.tag].stack(0) for rc in recv_])
            return (xl * g_x).sum()
        kp.penumbra_scalar = stand_in
        try:
            return boundary._shadow_term_plain(q, st, dl_, n, n, K,
                                               edge_kw["seed"], 0, pairs)
        finally:
            kp.penumbra_scalar = kernel_scalar

    kh_plain_ms = min(cuda_ms(eager_receivers)[1] for _ in range(3))
    # the bound: the bytes KH writes and reads, and the closest-hit tests of
    # its two folds (forward and adjoint) over both bounces
    kh_bytes = 4 * (xs_h.numel() + planes_h.numel() + ints_h.numel()
                    + g_x.numel())
    fold = {}
    with torch.no_grad():
        _, (ro_p, rd_p) = boundary._pixel_rays(pk_d.camera, n, n, q)
        isect.intersect_scene(pk_d.objects, st, ro_p, rd_p, tally=fold)
    kh_ops = 2 * R * n * n * float(opcount._test_ops(fold["scan"]))
    kh_b = dict(zip(("bound_ms", "bound_by"),
                    opcount.bound_ms(kh_ops, kh_bytes)))

    # -- KA: the sphere mirror's Alhazen solve ------------------------------
    (ka_args,) = ka_tap.args
    f, cphi, sphi = ka_args
    got, ka_call_ms = cuda_ms(ka.solve_kernel, f, cphi, sphi)
    want, ka_plain_ms = cuda_ms(ka.solve_plain, f, cphi, sphi)
    ka_plain_ms = min(ka_plain_ms, cuda_ms(ka.solve_plain, f, cphi, sphi)[1])
    n_az = cphi.shape[0]
    ka_bits = all(torch.equal(g, w) for g, w in zip(got, want))
    ka_rel = max(float(((g - w).abs() / w.abs()).max())
                 for g, w in zip(got[:4], want[:4]))
    ka_text = (f"KA vs the plain Alhazen solve on the mirror pair's "
               f"{n_az} azimuths: masks "
               f"{'equal' if torch.equal(got[4], want[4]) else 'DIFFER'} "
               f"({int(want[4].sum())} unmasked), psi0/dh/beta0/gp max rel "
               f"{ka_rel:.3g}, "
               f"{'bit-identical' if ka_bits else 'not bit-identical'}")
    if not (torch.equal(got[4], want[4]) and ka_rel <= KA_RTOL
            and all(bool(torch.isfinite(g).all()) for g in got[:4])):
        raise AssertionError(f"KA disagrees with the plain solve: {ka_text}")
    ka_in = (ka.pack_frame(f), ka.scan_table(cphi.device, cphi.dtype),
             cphi.contiguous(), sphi.contiguous())
    ka_ms = median_ms(ka.alhazen_roots, *ka_in)
    ka_queued_ms = queued_ms(ka.alhazen_roots, *ka_in, runs=TIMED_RUNS)
    ka_tally = {}
    ka.solve_plain(f, cphi, sphi, tally=ka_tally)
    ka_b = dict(zip(("bound_ms", "bound_by"), opcount.bound_ms(
        opcount.alhazen_ops(ka_tally),
        4 * (ka.FRAME_FLOATS + ka.NS + ka.NB + 4 * n_az + 2) + n_az)))

    shape = f"cornell_mirror {n}x{n} (config 5's step)"
    summary = (f"KR vs the plain trace_rays on the step's {n_rays} straddle "
               f"rays ({mb} bounces): bit-identical, KR {kr_ms:.4f} ms a "
               f"launch queued ({kr_call_ms:.3f} ms a call), plain "
               f"{kr_plain_ms:.1f} ms, bound {kr_b['bound_ms']:.4f} ms | "
               f"{kp_text}; in the receiver points {gx_err:.3g} of "
               f"{gx_top:.3g}; KP (with its reduce) {kp_ms:.3f} ms, the "
               f"plain version's partials {kp_plain_ms:.1f} ms, bound "
               f"{kp_b['bound_ms']:.4f} ms ({tally['units']} receiver pixel-"
               f"spheres, {tally['valid']} samples lighting their "
               f"receiver); the whole penumbra term {term_ms:.1f} ms, "
               f"{recv_term_ms:.1f} ms with the plain receivers, "
               f"{term_plain_ms:.1f} ms with the plain version | {kh_text}; "
               f"KH {kh_fwd_ms:.4f} ms and its adjoint (with its reduce) "
               f"{kh_adj_ms:.4f} ms between events (median of {TIMED_RUNS}; "
               f"a call {kh_call_ms:.3f} / {kh_adj_call_ms:.3f} ms), the "
               f"plain receivers with their backward {kh_plain_ms:.1f} ms, "
               f"bound {kh_b['bound_ms']:.4f} ms by {kh_b['bound_by']} | "
               f"{ka_text}; "
               f"KA {ka_ms:.4f} ms a call between events (median of "
               f"{TIMED_RUNS}), {ka_queued_ms:.4f} ms a launch queued, the "
               f"plain solve {ka_plain_ms:.1f} ms, bound "
               f"{ka_b['bound_ms']:.6f} ms (latency-bound: a dependent "
               f"chain of ~{ka.NS + 34} + "
               f"~{ka_tally['radial_scan'] // n_az + 33} curve evaluations "
               f"a thread)")
    no_tpu = ("no TPU kernel: XLA under jax.jit "
              "(sail_tpu/parallel/render_sharded.py:257)")
    rows = [
        kernel_row("KR trace_rays (config 5's straddle rays)",
                   "sail_tpu_torch/csrc/trace_rays.cu + render_block.cuh + "
                   "path.cuh", no_tpu, launches[0], kr_err, kr_ms,
                   kr_plain_ms, kr_b, f"{n_rays} rays x {mb} bounces, "
                   + shape, call_ms=kr_call_ms, launches_counted_on=on,
                   timing="ms: per launch, queued behind a sleeping kernel; "
                   "call_ms: one call between events; plain_ms: the plain "
                   "integrator's trace_rays, one call"),
        kernel_row("KP penumbra_partials (config 5's penumbra term)",
                   "sail_tpu_torch/csrc/penumbra.cu + penumbra.cuh",
                   no_tpu, launches[1], float(d.max()), kp_ms, kp_plain_ms,
                   kp_b, f"{len(recv)} receivers x {len(pairs)} pairs x "
                   f"K {K}, " + shape, launches_counted_on=on,
                   term_ms=term_ms, term_plain_ms=term_plain_ms,
                   timing="ms: penumbra_partials (KP and the reduce of its "
                   "block rows) between events, median; plain_ms: the plain "
                   "version's scalar and autograd's partials, one call; "
                   "max_abs_err: the penumbra term per leaf"),
        kernel_row("KH trace_receivers + receivers_adjoint (config 5's "
                   "penumbra receivers)",
                   "sail_tpu_torch/csrc/receivers.cu + receivers.cuh",
                   no_tpu, launches[3] + launches[4], kh_err,
                   kh_fwd_ms + kh_adj_ms, kh_plain_ms, kh_b,
                   f"{R} receivers, " + shape, launches_counted_on=on,
                   forward_ms=kh_fwd_ms, adjoint_ms=kh_adj_ms,
                   call_ms=kh_call_ms, adjoint_call_ms=kh_adj_call_ms,
                   camera_err=cam_err, camera_max=cam_top,
                   bit_identical=kh_bits,
                   timing="ms: trace_receivers (KH) plus receivers_adjoint "
                   "(its adjoint and the reduce of its rows), each between "
                   f"events, median of {TIMED_RUNS}; plain_ms: the plain "
                   "receivers, their planes and their backward at KP's "
                   "cotangent, best of 3; max_abs_err: the planes and "
                   "points"),
        kernel_row("KA alhazen_roots (config 5's Alhazen solve)",
                   "sail_tpu_torch/csrc/alhazen.cu + alhazen.cuh", no_tpu,
                   launches[2], max(float((g - w).abs().max())
                                    for g, w in zip(got[:4], want[:4])),
                   ka_ms, ka_plain_ms, ka_b, f"1 mirror pair x {n_az} "
                   f"azimuths, " + shape, launches_counted_on=on,
                   queued_ms=ka_queued_ms, call_ms=ka_call_ms,
                   max_rel_err=ka_rel, bit_identical=ka_bits,
                   timing="ms: alhazen_roots (KA) between events, median of "
                   f"{TIMED_RUNS}; queued_ms: per launch queued behind a "
                   "sleeping kernel; call_ms: solve_kernel (packing and KA), "
                   "one call; plain_ms: the plain solve, one call; bound: "
                   "FP32 operations over 67 TFLOP/s, latency-bound")]
    return summary, rows


def inverse_path(dev, card: str) -> list:
    """Phase 12: BASELINE config 5 at 1024² x 16 spp x 4 bounces, boundary
    on.  The target through one K1 launch, then INV_STEPS train steps from
    inverse_artifact's perturbed scene, each one K1, one K2 and one reduce
    launch, the loss falling; the step's time, the edge terms' share and
    the peak memory; the step's interior gradient K2's at the same
    cotangent bit for bit, K1 and K2 against their plain versions on a row
    tile; KR, KP, KA and KH against their plain versions
    (`edge_kernels`);
    full_boundary_term on the card against the CPU; a central
    difference of the matte sphere's center.x beside the interior and
    boundary terms (printed, not held).  Returns the kernels' entries."""
    from sail_tpu_torch import scenes
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.diff import boundary
    from sail_tpu_torch.diff.boundary import (boundary_term,
                                              full_boundary_term,
                                              mse_adjoint,
                                              shadow_boundary_term)
    from sail_tpu_torch.diff.inverse import finite_difference_grad
    from sail_tpu_torch.utils import metrics
    from sail_tpu_torch.ops.cuda import alhazen as ka
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.ops.cuda import penumbra as kp
    from sail_tpu_torch.ops.cuda import receivers as kh
    from sail_tpu_torch.parallel import render_sharded as rs
    from sail_tpu_torch.render import integrator
    from sail_tpu_torch.parallel.mesh import make_mesh
    from sail_tpu_torch.scene.scene import leaf_paths
    from sail_tpu_torch.tools import grad_localise
    from sail_tpu_torch.tools import inverse_artifact as ia

    n, spp, bounces = INV_SIZE, INV_SPP, INV_BOUNCES
    params, static = scenes.cornell_mirror().pack()
    paths = leaf_paths(static)
    start = params.clone()
    for key, v in ia.PERTURBED.items():
        start[paths.index(key)] = v
    mesh = make_mesh(1)
    edge_kw = dict(n_edge_samples=192, n_noise=2, seed=7717,
                   max_bounces=bounces, n_curve_samples=32)

    def counts():
        return (mk.render_block.launches, mk.render_grad_block.launches,
                mk.reduce_grad_rows.launches, mk.trace_rays.launches,
                kp.penumbra_partials.launches, ka.alhazen_roots.launches,
                kh.trace_receivers.launches, kh.receivers_adjoint.launches)

    def zero():
        mk.render_block.launches = mk.render_grad_block.launches = 0
        mk.reduce_grad_rows.launches = mk.trace_rays.launches = 0
        kp.penumbra_partials.launches = ka.alhazen_roots.launches = 0
        kh.trace_receivers.launches = kh.receivers_adjoint.launches = 0

    # -- the main path: the target, then the train steps ---------------------
    zero()
    with torch.no_grad():
        target = rs.render_sharded(params, static, mesh, n, n, spp,
                                   max_bounces=bounces)
    torch.cuda.synchronize()
    if counts() != (1, 0, 0, 0, 0, 0, 0, 0):
        raise AssertionError(f"the target made {counts()} K1/K2/reduce/KR/KP"
                             f"/KA/KH/KH' launches, not one K1")
    p = start.to(dev, copy=True).requires_grad_()
    opt = torch.optim.Adam([p], lr=INV_LR)
    step = rs.make_train_step(static, mesh, n, n, spp, opt,
                              max_bounces=bounces,
                              trainable=rs.trainable_mask(static,
                                                          ia.trainable))
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, step_ev_ms, per_step = [], [], [], []
    traced = CallPatch(boundary, "trace_rays")
    plain_traced = CallPatch(integrator, "trace_rays")
    ran0 = full_boundary_term.eager + full_boundary_term.captures
    eager_steps = []
    for _ in range(INV_STEPS):
        before = counts()
        eager0 = full_boundary_term.eager
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        losses.append(float(step(target)))
        ev1.record()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_ev_ms.append(ev0.elapsed_time(ev1))
        per_step.append(tuple(a - b for a, b in zip(counts(), before)))
        eager_steps.append(full_boundary_term.eager - eager0)
    traced.restore()
    plain_traced.restore()
    launches = counts()
    # the edge terms' Python runs on a key's eager and capture calls; a
    # replay calls no trace_rays (its KR launch is in the graph)
    ran = full_boundary_term.eager + full_boundary_term.captures - ran0
    if traced.calls != ran or plain_traced.calls:
        raise AssertionError(f"{INV_STEPS} train steps made {traced.calls} "
                             f"trace_rays calls in the edge terms, not one "
                             f"a step that ran the term's Python ({ran}), "
                             f"and {plain_traced.calls} calls of the "
                             f"plain integrator's, not none")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    # the wrappers count where they launch: KR, KP, KP's reduce, KA, KH
    # and its adjoint and the adjoint's reduce on the step that ran the edge
    # terms eagerly; a replay's are counted from the profiler below
    want_steps = [(1, 1, 1 + 2 * e, e, e, e, e, e) for e in eager_steps]
    if per_step != want_steps or eager_steps[0] != 1 or sum(eager_steps) != 1:
        raise AssertionError(f"the train steps made {per_step} "
                             f"K1/K2/reduce/KR/KP/KA/KH/KH' launches, not "
                             f"{want_steps} (one K1, K2 and K2's reduce a "
                             f"step, KR, KP, KP's reduce, KA, KH, its "
                             f"adjoint and the adjoint's reduce on the one "
                             f"eager step)")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and torch.isfinite(p.detach()).all()):
        raise AssertionError(f"the loss did not fall or is not finite: "
                             f"{losses}")
    fitted = p.detach()

    # -- the step's parts at the perturbed scene: the interior gradient, K2
    # at the same cotangent (bit for bit), the edge terms timed ------------
    q = start.to(dev)
    acc = mk.render_block(q, static, n, n, spp, 0, 0, bounces)
    a = Vec3(*(c.clone().requires_grad_() for c in acc))
    img = a * (1.0 / spp)
    se = sum((c - t) ** 2 for c, t in zip(img, target))
    (torch.sum(se) / (n * n * 3)).backward()
    g = Vec3(*(c.grad for c in a))
    k2_runs = [cuda_ms(mk.render_grad_block, q, static, g, n, n, spp, 0, 0,
                       bounces) for _ in range(TIMED_RUNS)]
    k2_ms = statistics.median(ms for _, ms in k2_runs)
    pl = q.clone().requires_grad_()
    loss0, img0 = rs.sharded_loss_and_image(pl, target, static, mesh, n, n,
                                            spp, 0, bounces)
    (interior,) = torch.autograd.grad(loss0, pl)
    if not all(torch.equal(interior, r) for r, _ in k2_runs):
        raise AssertionError(
            f"the step's interior gradient is not K2's at its cotangent: max "
            f"abs diff {float((interior - k2_runs[0][0]).abs().max()):.3g}")
    dL = mse_adjoint(img0, target)
    bnd = full_boundary_term(q, static, dL, n, n, **edge_kw)
    sil_kw = {k: edge_kw[k] for k in ("n_edge_samples", "n_noise", "seed",
                                      "max_bounces")}
    sil, sil_ms = host_ms(boundary_term, q, static, dL, n, n, runs=3,
                          **sil_kw)
    pen_ms = host_ms(shadow_boundary_term, q, static, dL, n, n, runs=3,
                     n_curve_samples=edge_kw["n_curve_samples"],
                     seed=edge_kw["seed"])[1]
    step_med = statistics.median(step_ms)
    # the same step without the edge terms: K1, K2, autograd and Adam
    pi = start.to(dev, copy=True).requires_grad_()
    inner = rs.make_train_step(static, mesh, n, n, spp,
                               torch.optim.Adam([pi], lr=INV_LR),
                               max_bounces=bounces, boundary=False)
    interior_ms = host_ms(inner, target, runs=3)[1]
    # the silhouette term's parts: its one trace_rays call and its
    # Alhazen solve (KA), each timed to a synchronize (one instrumented
    # call)
    parts = {}
    timers = [CallPatch(boundary, "trace_rays", parts),
              CallPatch(ka, "solve", parts)]
    _, sil_timed_ms = host_ms(boundary_term, q, static, dL, n, n, **sil_kw)
    for t in timers:
        t.restore()
    # the same sites traced one by one (the primitive per site), and the
    # batch held against them
    traced = CallPatch(boundary, "trace_rays")
    site, site_ms = host_ms(boundary_term, q, static, dL, n, n,
                            batched=False, **sil_kw)
    traced.restore()
    site_calls = traced.calls
    batch_diff = float((sil - site).abs().max())
    batch_bits = bool(torch.equal(sil, site))
    if not (batch_diff <= BATCH_TOL * float(site.abs().max())
            and bool(torch.isfinite(sil).all())):
        raise AssertionError(f"the batched silhouette term is {batch_diff:.3g}"
                             f" off the per-site one (max "
                             f"{float(site.abs().max()):.3g})")
    # kernels a step, with and without the edge terms (torch.profiler)
    pp = start.to(dev, copy=True).requires_grad_()
    prof_step = rs.make_train_step(static, mesh, n, n, spp,
                                   torch.optim.Adam([pp], lr=INV_LR),
                                   max_bounces=bounces,
                                   trainable=rs.trainable_mask(
                                       static, ia.trainable))
    step_launches = {}
    replays0 = full_boundary_term.replays
    for name, fn in (("edge", prof_step), ("interior", inner)):
        with metrics.profile_trace(os.path.join(TRACES, f"config5_{name}")
                                   ) as prof:
            fn(target)
            torch.cuda.synchronize()
        step_launches[name] = metrics.kernel_launches(prof)
        if name == "edge":
            # the step replays the edge terms' graph: its KR, KP, reduces,
            # KA, KH and KH's adjoint, counted on the device by name
            replayed = metrics.kernels_named(prof, EDGE_KERNEL_NAMES)
    if (full_boundary_term.replays != replays0 + 1
            or replayed != (1, 1, 3, 1, 1, 1)):
        raise AssertionError(f"the profiled step replayed the edge terms "
                             f"{full_boundary_term.replays - replays0} "
                             f"times and ran {replayed} KR/KP/reduce/KA/KH/"
                             f"KH' kernels, not one replay with one KR, one "
                             f"KP, three reduces (K2's, KP's and KH's "
                             f"adjoint's), one KA, one KH and one KH "
                             f"adjoint")

    # -- K2 and K1 against their plain versions on a row tile of the step --
    t_rows, t_row0 = K2_TILE["cornell_mirror"]
    gt = Vec3(*(c[t_row0:t_row0 + t_rows].contiguous() for c in g))
    t_args = (q, static, gt, t_rows, n, spp, 0, 0, bounces)
    kw = dict(row0=t_row0, image_height=n)
    t_got = mk.render_grad_block(*t_args, **kw)
    want, k2_plain_ms = cuda_ms(mk.render_grad_block_plain, *t_args, **kw)
    tile = (f"cornell_mirror rows {t_row0}-{t_row0 + t_rows - 1} of {n} x "
            f"{n} spp{spp} b{bounces}")
    k2_text, grad_err, grad_abs, _ = grad_check(tile, t_got, want, static,
                                                per_leaf=False)
    where = grad_localise.check(*t_args, t_row0, n, t_got, want)
    if where["excess"] > 1:
        raise AssertionError(f"K2 disagrees with its plain version on a leaf:"
                             f" {k2_text}, {where}")
    k1_args = (q, static, t_rows, n, spp, 0, 0, bounces)
    k1_got = mk.render_block(*k1_args, **kw)
    k1_want, k1_plain_ms = cuda_ms(mk.render_block_plain, *k1_args, **kw)
    k1_err, k1_bad = compare(k1_got, k1_want)
    if k1_bad:
        raise AssertionError(f"K1 disagrees with its plain version on {tile}:"
                             f" max_abs {k1_err:.3g}")
    k1_bit = torch.equal(k1_got.stack(), k1_want.stack())
    k1_ms = median_ms(mk.render_block, q, static, n, n, spp, 0, 0, bounces)
    bx, by = mk.GRAD_BLOCK
    red = reduce_check(dev, (-(-n // bx) * -(-n // by), q.numel()))
    on = "config 5's target and train steps"
    # -- KR and KP against their plain versions at the step's inputs --------
    edge_text, edge_rows = edge_kernels(q, static, dL, n, edge_kw,
                                        launches[3:], on)

    # -- the edge terms on the card against the CPU, on the same inputs ------
    m = BND_CHECK
    cpu = make_mesh(1, device="cpu")
    with torch.no_grad():
        tgt_m = rs.render_sharded(params, static, cpu, m, m, 4,
                                  max_bounces=bounces)
        img_m = rs.render_sharded(start, static, cpu, m, m, 4,
                                  max_bounces=bounces)
    dL_m = mse_adjoint(img_m, tgt_m)
    b_cpu = full_boundary_term(start, static, dL_m, m, m, **edge_kw)
    # a new key on the card: its eager call, its capture, a replay
    calls0 = (full_boundary_term.eager, full_boundary_term.captures,
              full_boundary_term.replays)
    b_devs = [full_boundary_term(start.to(dev), static,
                                 Vec3(*(c.to(dev) for c in dL_m)), m, m,
                                 **edge_kw).cpu() for _ in range(3)]
    calls = tuple(a - b for a, b in zip(
        (full_boundary_term.eager, full_boundary_term.captures,
         full_boundary_term.replays), calls0))
    if calls != (1, 1, 2):
        raise AssertionError(f"three calls of a new key counted {calls} "
                             f"eager/capture/replay calls, not (1, 1, 2)")
    b_dev = b_devs[2]
    d = (b_dev - b_cpu).abs()
    bound_each = BND_RTOL * b_cpu.abs() + BND_ATOL * b_cpu.abs().max()
    worst = int((d / bound_each.clamp(min=1e-30)).argmax())
    same = all(torch.equal(b, b_dev) for b in b_devs)
    bnd_text = (f"full_boundary_term at {m}x{m}, the card's replay vs CPU: "
                f"rel Linf {float(d.max() / b_cpu.abs().max()):.3g}, worst "
                f"leaf {paths[worst]} cpu {float(b_cpu[worst]):.6g} card "
                f"{float(b_dev[worst]):.6g}, "
                f"{int((d > bound_each).sum())} of {d.numel()} leaves over "
                f"{BND_RTOL:g}·|cpu| + {BND_ATOL:g}·max|cpu|; the eager "
                f"call, the capture and the replay "
                f"{'bit-identical' if same else 'not bit-identical'}")
    if bool((d > bound_each).any()) or not same \
            or not bool(torch.isfinite(b_dev).all()):
        raise AssertionError(f"the edge terms differ on the card: {bnd_text}")

    # -- a reading: the central difference of the matte sphere's center.x
    # beside the interior and boundary terms -------------------------------
    cx = paths.index(".objects[2].center.x")
    fd = finite_difference_grad(
        lambda v: rs.sharded_loss(v, target, static, mesh, n, n, spp, 0,
                                  bounces), q, cx, eps=FD_EPS)
    g_int, g_bnd = float(interior[cx]), float(bnd[cx])

    tr_ms, ka_ms = parts["trace_rays"], parts["solve"]
    print(f"phase 12 inverse rendering: config 5 cornell_mirror {n}x{n} "
          f"spp{spp} b{bounces}, boundary on: the target 1 K1 launch; "
          f"{INV_STEPS} train steps (Adam lr {INV_LR}, inverse_artifact's "
          f"trainable leaves), K1/K2/reduce/KR/KP/KA/KH/KH' launches "
          f"counted by the wrappers {per_step} (the edge terms eager on the "
          f"first step, captured on the second, replayed after), a replayed "
          f"step's KR/KP/reduce/KA/KH/KH' kernels on the device {replayed}, "
          f"loss {' '.join(f'{x:.6g}' for x in losses)}; step "
          f"{' '.join(f'{x:.1f}' for x in step_ms)} ms host clock (median "
          f"{step_med:.1f}), {' '.join(f'{x:.1f}' for x in step_ev_ms)} ms "
          f"CUDA events (median {statistics.median(step_ev_ms):.1f}); "
          f"kernels a step (torch.profiler): with the edge terms "
          f"{step_launches['edge']['kernels']} ("
          f"{step_launches['edge']['launch_calls']} launch calls), without "
          f"{step_launches['interior']['kernels']} ("
          f"{step_launches['interior']['launch_calls']}); without the edge "
          f"terms {interior_ms:.1f} ms "
          f"(K1 {k1_ms:.2f}, K2 {k2_ms:.2f}), so the edge terms "
          f"{100 * (1 - interior_ms / step_med):.1f}% of the step; alone "
          f"(median of 3) the silhouettes {sil_ms:.1f} ms (one instrumented "
          f"call {sil_timed_ms:.1f} ms: its trace_rays call "
          f"{tr_ms['ms']:.1f} ms on {tr_ms['rays']} rays, its "
          f"{ka_ms['calls']} Alhazen solves {ka_ms['ms']:.2f} ms), the "
          f"penumbras {pen_ms:.1f} ms; the sites one by one {site_ms:.1f} ms"
          f" in {site_calls} trace_rays calls, the batch "
          f"{'bit-identical' if batch_bits else f'{batch_diff:.3g} off'}; "
          f"peak memory {peak_gb:.2f} GB "
          f"| kr 0.45 -> {float(fitted[paths.index('.materials[1].kr')]):.4f}"
          f", emission 3.0 -> "
          f"{float(fitted[paths.index('.lights[0].emission.x')]):.4f}, "
          f"center.x 0.58 -> {float(fitted[cx]):.4f} | the step's interior "
          f"gradient K2's at its cotangent bit for bit over {TIMED_RUNS} "
          f"calls | K2 vs plain: {k2_text}; per leaf with the pixel term: "
          f"worst {where['leaf_name']} = {where['excess']:.3g} of its bound; "
          f"plain {k2_plain_ms:.1f} ms | K1 vs plain on the tile: max_abs "
          f"{k1_err:.3g}, {'bit-identical' if k1_bit else 'not bit-identical'}"
          f", plain {k1_plain_ms:.1f} ms | {edge_text} | {bnd_text} | "
          f"center.x: central "
          f"difference (eps {FD_EPS:g}) {fd:.6g}, interior {g_int:.6g} + "
          f"boundary {g_bnd:.6g} = {g_int + g_bnd:.6g} | {card}", flush=True)

    shape = f"cornell_mirror {n}x{n} spp{spp} b{bounces} (config 5)"
    k1_b = bound(q, static, n, n, spp, bounces, samples=1, row_step=32)
    k2_b = bound(q, static, n, n, spp, bounces, grad=True, samples=1,
                 row_step=32)
    return [
        kernel_row("K1 render_block (config 5)",
                   "sail_tpu_torch/csrc/megakernel.cu + render_block.cuh + "
                   "path.cuh", "sail_tpu/ops/pallas/megakernel.py:159",
                   launches[0], k1_err, k1_ms, k1_plain_ms, k1_b, shape,
                   launches_counted_on=on, plain_shape=tile),
        kernel_row("K2 render_grad_block (config 5)",
                   "sail_tpu_torch/csrc/megakernel_grad.cu + render_grad.cuh "
                   "+ adjoint.cuh", "sail_tpu/ops/pallas/megakernel.py:262",
                   launches[1], grad_abs, k2_ms, k2_plain_ms, k2_b, shape,
                   launches_counted_on=on, rel_linf=grad_err,
                   plain_shape=tile, localised=where,
                   build=k2_build(q.numel(), static)),
        kernel_row("K2 reduce_grad_rows (config 5)",
                   "sail_tpu_torch/csrc/reduce_grad_rows.cu",
                   "sail_tpu/ops/pallas/megakernel.py:459", launches[2],
                   red["max_abs_vs_f64"], red["ms"], red["plain_ms"],
                   reduce_bound(red), f"{red['shape'][0]} rows x "
                   f"{red['shape'][1]} params (config 5's step)",
                   library_ms=red["sum_ms"], call_ms=red["call_ms"],
                   launches_counted_on=on + " (K2's rows and KP's)",
                   timing="ms, plain_ms, library_ms: per launch, queued "
                   "behind a sleeping kernel; call_ms: one call between "
                   "events")] + edge_rows


def multi_device_path(dev, card: str) -> list:
    """Phase 13: the multi-device parallel/ on the one card.  (a) config 2
    at 1024² x 64 x 5 over make_mesh(8, spp_axis=2) of ranks on the card,
    through exactly 8 K1 launches, within relative 1e-5 of the one-rank
    image, the 8 x 1 layout bit for bit, timed beside one rank; (b) the
    ElasticRenderer on those ranks, half of them lost at chunk 1, bit for
    bit the same render without the loss; (c) config 5's train step over 2
    ranks: without the edge terms (2, 2, 2) K1/K2/reduce launches, its
    gradient and loss against the one-rank step's, then MESH_STEPS steps
    with them, timed; (d) NCCL at world size 1: (a)'s render through the
    collectives bit for bit.  Returns the kernels' JSON entries."""
    import socket

    import torch.distributed as dist

    from sail_tpu_torch import scenes
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.diff.boundary import full_boundary_term, mse_adjoint
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.ops.cuda import penumbra as kp
    from sail_tpu_torch.parallel import render_sharded as rs
    from sail_tpu_torch.parallel.elastic import DeviceFailure, ElasticRenderer
    from sail_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from sail_tpu_torch.scene.scene import leaf_paths
    from sail_tpu_torch.tools import inverse_artifact as ia

    def counts():
        return (mk.render_block.launches, mk.render_grad_block.launches,
                mk.reduce_grad_rows.launches)

    def zero():
        mk.render_block.launches = mk.render_grad_block.launches = 0
        mk.reduce_grad_rows.launches = 0

    def median3(fn, *args, **kw):
        cuda_ms(fn, *args, **kw)
        return statistics.median(cuda_ms(fn, *args, **kw)[1]
                                 for _ in range(MESH_RUNS))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    n_ranks, spp_axis = MESH
    ranks = [dev] * n_ranks
    params, static = scenes.cornell_mirror().pack()
    params = params.to(dev)
    mesh = make_mesh(n_ranks, spp_axis, devices=ranks)
    rows_mesh = make_mesh(n_ranks, 1, devices=ranks)
    one = make_mesh(1, device=dev)
    full = (params, static, mesh, H, W, SPP)
    kw = dict(max_bounces=BOUNCES)

    # -- (a) config 2 over 8 ranks: the main path ----------------------------
    zero()
    img8 = rs.render_sharded(*full, **kw).stack()
    torch.cuda.synchronize()
    k1_launches = counts()
    if k1_launches != (n_ranks, 0, 0):
        raise AssertionError(f"the {n_ranks}-rank render made {k1_launches} "
                             f"K1/K2/reduce launches, not {n_ranks} K1")
    img1 = rs.render_sharded(params, static, one, H, W, SPP, **kw).stack()
    img_rows = rs.render_sharded(params, static, rows_mesh, H, W, SPP,
                                 **kw).stack()
    err8 = rel(img8, img1)
    if err8 > 1e-5 or not torch.equal(img_rows, img1) \
            or not bool(torch.isfinite(img8).all()):
        raise AssertionError(f"the {n_ranks}-rank image is {err8:.3g} off "
                             f"the one-rank image, or the rows-only layout "
                             f"is not it bit for bit")
    ms8 = median3(rs.render_sharded, *full, **kw)
    ms_rows = median3(rs.render_sharded, params, static, rows_mesh, H, W,
                      SPP, **kw)
    ms1 = median3(rs.render_sharded, params, static, one, H, W, SPP, **kw)
    rows, spp_local = H // mesh.n_tile, SPP // mesh.n_spp

    def k1_blocks():
        for di, _ in mesh.local_ranks:
            ti, si = divmod(di, mesh.n_spp)
            mk.render_block(params, static, rows, W, spp_local, 0,
                            si * spp_local, BOUNCES, row0=ti * rows,
                            image_height=H)

    k1_ms = median3(k1_blocks)
    k1_one_ms = median3(mk.render_block, params, static, H, W, SPP, 0, 0,
                        BOUNCES)
    k1_text, k1_err, _, k1_plain_ms, k1_shape = k1_tile(
        "cornell_mirror", params, static, spp_local)

    # -- (b) the elastic renderer, half the ranks lost at chunk 1 ------------
    size, e_spp, e_bounces, chunk = ELASTIC
    dead = {r.id for r in mesh.ranks[n_ranks // 2:]}
    tripped = []

    def fault_hook(k):
        if k == 1 and not tripped:
            tripped.append(True)
            raise DeviceFailure("injected: half the ranks lost")

    plain_er = ElasticRenderer(params, static, size, size, e_bounces,
                               devices=ranks)
    e_ref = plain_er.render(e_spp, 0, chunk).stack()
    er = ElasticRenderer(params, static, size, size, e_bounces, devices=ranks,
                         fault_hook=fault_hook, faulty=lambda r: r.id in dead)
    e_img, e_ms = host_ms(er.render, e_spp, 0, chunk)
    e_img = e_img.stack()
    e_one = rs.render_sharded(params, static, one, size, size, e_spp,
                              max_bounces=e_bounces).stack()
    if not (torch.equal(e_img, e_ref) and plain_er.events == []
            and any(e["event"] == "mesh_shrink" for e in er.events)
            and len(er.devices) == n_ranks // 2
            and rel(e_img, e_one) <= 1e-5):
        raise AssertionError(f"the elastic render after the loss is not the "
                             f"render without it bit for bit, or its events "
                             f"{er.events} name no shrink to "
                             f"{n_ranks // 2} ranks")

    # -- (c) config 5's train step over 2 ranks ------------------------------
    n, spp5, b5 = INV_SIZE, INV_SPP, INV_BOUNCES
    paths = leaf_paths(static)
    start = params.clone()
    for key, v in ia.PERTURBED.items():
        start[paths.index(key)] = v
    two = make_mesh(*MESH5, devices=[dev] * MESH5[0])
    with torch.no_grad():
        target = rs.render_sharded(params, static, one, n, n, spp5,
                                   max_bounces=b5)
    grads, losses, per_step, steps = {}, {}, {}, {}
    for name, m in (("one", one), ("two", two)):
        p = start.clone().requires_grad_()
        steps[name] = rs.make_train_step(static, m, n, n, spp5,
                                         torch.optim.Adam([p], lr=INV_LR),
                                         max_bounces=b5, boundary=False)
        zero()
        losses[name] = float(steps[name](target))
        torch.cuda.synchronize()
        per_step[name] = counts()
        grads[name] = p.grad.clone()
    g_err = rel(grads["two"], grads["one"])
    l_err = abs(losses["two"] - losses["one"]) / abs(losses["one"])
    if per_step["two"] != (2, 2, 2) or g_err > 1e-5 or l_err > 1e-6:
        raise AssertionError(f"config 5's 2-rank step made {per_step['two']} "
                             f"K1/K2/reduce launches, its gradient is "
                             f"{g_err:.3g} and its loss {l_err:.3g} off the "
                             f"one-rank step's")
    step2_ms = host_ms(steps["two"], target, runs=MESH_RUNS)[1]
    step1_ms = host_ms(steps["one"], target, runs=MESH_RUNS)[1]
    pb = start.clone().requires_grad_()
    step_b = rs.make_train_step(static, two, n, n, spp5,
                                torch.optim.Adam([pb], lr=INV_LR),
                                max_bounces=b5,
                                trainable=rs.trainable_mask(static,
                                                            ia.trainable))
    b_losses, b_ms = [], []
    edge0 = (mk.trace_rays.launches, kp.penumbra_partials.launches)
    fbt = full_boundary_term
    calls0 = (fbt.eager, fbt.captures, fbt.replays)
    for _ in range(MESH_STEPS):
        loss, ms = host_ms(step_b, target)
        b_losses.append(float(loss))
        b_ms.append(ms)
    edge_launches = (mk.trace_rays.launches - edge0[0],
                     kp.penumbra_partials.launches - edge0[1])
    edge_calls = tuple(a - b for a, b in zip(
        (fbt.eager, fbt.captures, fbt.replays), calls0))
    if not (all(np.isfinite(b_losses)) and torch.isfinite(pb).all()):
        raise AssertionError(f"config 5's 2-rank steps with the edge terms: "
                             f"losses {b_losses}")
    # each rank's seed is a key of its own: eager on the first step,
    # captured on the second, replayed after; KR and KP counted where they
    # launch, on the eager calls
    want_calls = (MESH5[0], MESH5[0], (MESH_STEPS - 1) * MESH5[0])
    if edge_calls != want_calls or edge_launches != (MESH5[0],) * 2:
        raise AssertionError(f"config 5's {MESH_STEPS} 2-rank steps made "
                             f"{edge_calls} eager/capture/replay calls of "
                             f"the edge terms, not {want_calls}, and "
                             f"{edge_launches} KR/KP launches, not one each "
                             f"a rank's eager call")
    # the step's kernels per rank: K2 on each rank's rows at the step's
    # cotangent, the reduce of a rank's rows, the plain K2 on a row tile
    with torch.no_grad():
        img5 = rs.render_sharded(start, static, one, n, n, spp5,
                                 max_bounces=b5)
    adj = torch.stack(mse_adjoint(img5, target)) * (1.0 / spp5)
    rows5 = n // two.n_tile

    def k2_ranks():
        for di, _ in two.local_ranks:
            g = Vec3(*adj[:, di * rows5:(di + 1) * rows5].contiguous())
            mk.render_grad_block(start, static, g, rows5, n, spp5, 0, 0, b5,
                                 row0=di * rows5, image_height=n)

    k2_ms = median3(k2_ranks)
    k2_one_ms = median3(mk.render_grad_block, start, static, Vec3(*adj), n,
                        n, spp5, 0, 0, b5)
    t_rows, t_row0 = MESH_K2_TILE
    gt = Vec3(*adj[:, t_row0:t_row0 + t_rows].contiguous())
    t_args = (start, static, gt, t_rows, n, spp5, 0, 0, b5)
    t_kw = dict(row0=t_row0, image_height=n)
    t_got = mk.render_grad_block(*t_args, **t_kw)
    t_want, k2_plain_ms = cuda_ms(mk.render_grad_block_plain, *t_args, **t_kw)
    k2_shape = (f"cornell_mirror rows {t_row0}-{t_row0 + t_rows - 1} of {n} "
                f"x {n} spp{spp5} b{b5}")
    k2_text, k2_err, k2_abs, _ = grad_check(k2_shape, t_got, t_want, static)
    bx, by = mk.GRAD_BLOCK
    red = reduce_check(dev, (-(-rows5 // by) * -(-n // bx), start.numel()))

    # -- (d) NCCL at world size 1: (a)'s render through the collectives ------
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                           timeout=120)
    try:
        init_s = time.perf_counter() - t0
        if not (mesh.gathers and dist.get_backend() == "nccl"):
            raise AssertionError("the mesh does not gather at world size 1")
        zero()
        img_nccl = rs.render_sharded(*full, **kw).stack()
        torch.cuda.synchronize()
        nccl_launches = counts()
        if nccl_launches != (n_ranks, 0, 0) or not torch.equal(img_nccl,
                                                               img8):
            raise AssertionError(f"the render through NCCL made "
                                 f"{nccl_launches} launches or is not the "
                                 f"in-process image bit for bit")
        nccl_ms = median3(rs.render_sharded, *full, **kw)
    finally:
        dist.destroy_process_group()

    print(f"phase 13 multi-device: (a) render_sharded cornell_mirror {W}x{H} "
          f"spp{SPP} b{BOUNCES} over {n_ranks} ranks on {dev} "
          f"({mesh.shape}): {k1_launches[0]} K1 launches, relative L-inf "
          f"{err8:.3g} against one rank, the {n_ranks} x 1 layout "
          f"bit-identical; {ms8:.2f} ms ({mesh.shape}), {ms_rows:.2f} ms "
          f"({rows_mesh.shape}), one rank {ms1:.2f} ms (median of "
          f"{MESH_RUNS}); K1 over the ranks {k1_ms:.2f} ms "
          f"({k1_ms / n_ranks:.3f} a rank), one launch {k1_one_ms:.2f} ms | "
          f"K1 vs plain on {k1_text} | (b) ElasticRenderer {size}x{size} "
          f"spp{e_spp} b{e_bounces} chunk {chunk}, ranks "
          f"{sorted(dead)} lost at chunk 1: events {er.events}, bit-identical"
          f" to the render without the loss, {rel(e_img, e_one):.3g} off one "
          f"rank, {e_ms:.1f} ms | (c) config 5 {n}x{n} spp{spp5} b{b5} over "
          f"{two.shape}: without the edge terms {per_step['two']} "
          f"K1/K2/reduce launches a step, gradient relative L-inf "
          f"{g_err:.3g} and loss {l_err:.3g} against one rank, step "
          f"{step2_ms:.1f} ms (one rank {step1_ms:.1f} ms); K2 over the "
          f"ranks {k2_ms:.2f} ms, one launch {k2_one_ms:.2f} ms; K2 vs plain:"
          f" {k2_text}, plain {k2_plain_ms:.1f} ms; with the edge terms "
          f"losses {' '.join(f'{x:.6g}' for x in b_losses)}, steps "
          f"{' '.join(f'{x:.1f}' for x in b_ms)} ms, the edge terms "
          f"{edge_calls} eager/capture/replay calls and {edge_launches} "
          f"KR/KP launches (on the eager calls) in {MESH_STEPS} steps | "
          f"(d) NCCL world size 1 "
          f"(init {init_s:.2f} s): {nccl_launches[0]} K1 launches, the image "
          f"bit-identical to (a)'s, {nccl_ms:.2f} ms | {card}", flush=True)

    on_a = f"render_sharded over {n_ranks} ranks (phase 13 a)"
    on_c = f"config 5's step over {MESH5[0]} ranks (phase 13 c)"
    return [
        kernel_row(f"K1 render_block (config 2 over {n_ranks} ranks on one "
                   f"card)", "sail_tpu_torch/csrc/megakernel.cu + "
                   "render_block.cuh + path.cuh",
                   "sail_tpu/ops/pallas/megakernel.py:159", k1_launches[0],
                   k1_err, k1_ms, k1_plain_ms,
                   bound(params, static, H, W, SPP, BOUNCES),
                   f"cornell_mirror {W}x{H} spp{SPP} b{BOUNCES} as "
                   f"{n_ranks} blocks of {rows} rows x {spp_local} spp",
                   launches_counted_on=on_a, plain_shape=k1_shape,
                   one_rank_ms=k1_one_ms, per_rank_ms=k1_ms / n_ranks,
                   render_ms=ms8, one_rank_render_ms=ms1),
        kernel_row(f"K2 render_grad_block (config 5 over {MESH5[0]} ranks)",
                   "sail_tpu_torch/csrc/megakernel_grad.cu + render_grad.cuh "
                   "+ adjoint.cuh", "sail_tpu/ops/pallas/megakernel.py:262",
                   per_step["two"][1], k2_abs, k2_ms, k2_plain_ms,
                   bound(start, static, n, n, spp5, b5, grad=True, samples=1,
                         row_step=32),
                   f"cornell_mirror {n}x{n} spp{spp5} b{b5} as {MESH5[0]} "
                   f"blocks of {rows5} rows", launches_counted_on=on_c,
                   rel_linf=k2_err, plain_shape=k2_shape,
                   one_rank_ms=k2_one_ms, per_rank_ms=k2_ms / MESH5[0],
                   build=k2_build(start.numel(), static)),
        kernel_row(f"K2 reduce_grad_rows (config 5 over {MESH5[0]} ranks)",
                   "sail_tpu_torch/csrc/reduce_grad_rows.cu",
                   "sail_tpu/ops/pallas/megakernel.py:459",
                   per_step["two"][2], red["max_abs_vs_f64"], red["ms"],
                   red["plain_ms"], reduce_bound(red),
                   f"{red['shape'][0]} rows x {red['shape'][1]} params (a "
                   f"rank's rows)", library_ms=red["sum_ms"],
                   call_ms=red["call_ms"], launches_counted_on=on_c,
                   timing="ms, plain_ms, library_ms: per launch, queued "
                   "behind a sleeping kernel; call_ms: one call between "
                   "events")]


def decode_png(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of an 8-bit RGB PNG with filter 0 on every
    row (what both encoders write)."""
    import struct
    import zlib
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    if raw[:, 0].any():
        raise AssertionError("a row with a PNG filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def tools_path(dev, card: str) -> list:
    """Phase 14: the last modules.  tools/gpu_checks.py's main on the card
    (its JSON on a line of its own); the native image codec built and its PNGs
    against the Python encoder's; a 256² viewer frame of
    examples/viewer.py timed by part and served to a localhost request;
    examples/render_scenes.py at EXAMPLE_SHAPE on every scene it knows and
    examples/inverse_render.py for INVERSE_EXAMPLE steps, their K1/K2/
    reduce/KR/KP launches counted.  Returns no kernel entry."""
    import contextlib
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from sail_tpu_torch import scenes
    from sail_tpu_torch.diff.boundary import full_boundary_term
    from sail_tpu_torch.examples import inverse_render, render_scenes, viewer
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.ops.cuda import penumbra as kp
    from sail_tpu_torch.tools import gpu_checks
    from sail_tpu_torch.utils import imageio, native

    def counts():
        return (mk.render_block.launches, mk.render_grad_block.launches,
                mk.reduce_grad_rows.launches, mk.trace_rays.launches,
                kp.penumbra_partials.launches)

    def zero():
        mk.render_block.launches = mk.render_grad_block.launches = 0
        mk.reduce_grad_rows.launches = mk.trace_rays.launches = 0
        kp.penumbra_partials.launches = 0

    # -- tools/gpu_checks.py, its JSON line printed through -------------------
    size, spp, bounces = GPU_CHECKS
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = gpu_checks.main(["--size", str(size), "--spp", str(spp),
                              "--bounces", str(bounces)])
    line = printed.getvalue().strip()
    print(line, flush=True)
    checks = json.loads(line.splitlines()[-1])
    if rc != 0 or not checks["ok"]:
        raise AssertionError(f"gpu_checks failed ({rc}): {checks}")
    os.makedirs(EXAMPLES_OUT, exist_ok=True)

    # -- the native codec: built, and its PNGs against the Python encoder's --
    if not native.available():
        raise AssertionError(f"the native image codec did not build: "
                             f"{native._error}")
    scene = scenes.cornell_mirror()
    scene.filter = "gamma"
    state = viewer.ViewerState(scene, VIEWER, dev)
    state.step()
    out = state.renderer.output(state.scene)
    u8 = imageio.to_uint8(out)
    nat_u8 = native.tonemap_u8(out)
    png_nat, png_py = native.encode_png(u8), imageio._png_bytes_py(u8)
    lut_diff = int(np.abs(nat_u8.astype(int) - u8.astype(int)).max())
    if not (np.array_equal(decode_png(png_nat), u8)
            and np.array_equal(decode_png(png_py), u8)
            and np.array_equal(decode_png(imageio.png_bytes(out)), nat_u8)
            and lut_diff <= 3):
        raise AssertionError(f"the native and Python PNGs decode to other "
                             f"pixels (the LUT {lut_diff}/255 off pow)")

    # -- a viewer frame by part: K1 (render), output, the PNG -----------------
    parts = {"render": [], "output": [], "png": [], "png_python": []}
    for _ in range(VIEWER_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state.renderer.render(state.scene)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame = state.renderer.output(state.scene)
        t2 = time.perf_counter()
        png = imageio.png_bytes(frame)
        t3 = time.perf_counter()
        imageio._png_bytes_py(imageio.to_uint8(frame))
        t4 = time.perf_counter()
        for k, a, b in (("render", t0, t1), ("output", t1, t2),
                        ("png", t2, t3), ("png_python", t3, t4)):
            parts[k].append((b - a) * 1e3)
    ms = {k: statistics.median(v) for k, v in parts.items()}
    frame_ms = ms["render"] + ms["output"] + ms["png"]
    state.png = png
    server = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_address[1]}/frame.png",
                timeout=60) as r:
            served = r.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    if served != png or decode_png(served).shape != (VIEWER, VIEWER, 3):
        raise AssertionError("the viewer served another frame")

    # -- examples/render_scenes.py on every scene it knows ------------------
    size, spp = EXAMPLE_SHAPE
    zero()
    scene_text = []
    for name in render_scenes.SCENES:
        path, meter, img = render_scenes.render(name, size, spp, BOUNCES,
                                                EXAMPLES_OUT)
        if not (np.isfinite(img).all() and img.mean() > 0
                and os.path.getsize(path) > 0):
            raise AssertionError(f"render_scenes {name}: bad image")
        scene_text.append(f"{name} {meter.seconds * 1e3:.2f} ms")
    rs_launches = counts()
    if rs_launches != (2 * len(render_scenes.SCENES), 0, 0, 0, 0):
        raise AssertionError(f"render_scenes made {rs_launches} "
                             f"K1/K2/reduce/KR/KP launches, not two K1 a "
                             f"scene")

    # -- examples/inverse_render.py ----------------------------------------
    isize, isteps = INVERSE_EXAMPLE
    zero()
    term = full_boundary_term
    graph0 = (term.eager, term.captures, term.replays)
    t0 = time.perf_counter()
    res = inverse_render.main(["--size", str(isize), "--steps", str(isteps),
                               "--out", EXAMPLES_OUT])
    inv_s = time.perf_counter() - t0
    inv_launches = counts()
    graph = tuple(b - a for a, b in zip(graph0, (term.eager, term.captures,
                                                 term.replays)))
    losses = res["losses"]
    # a step: K1 and K2 once each and the reduce for K2's rows; the edge
    # terms (KR, KP, KH's adjoint and the reduces for KP's and the
    # adjoint's rows) run eagerly at the first step, are captured at the
    # second and replayed from then on, which the wrappers do not count
    # (full_boundary_term); and three renders
    if inv_launches != (isteps + 3, isteps, isteps + 2, 1, 1) \
            or graph != (1, 1, isteps - 1) \
            or not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"inverse_render made {inv_launches} "
                             f"K1/K2/reduce/KR/KP launches and {graph} "
                             f"eager/captured/replayed edge terms, losses "
                             f"{losses}")

    print(f"phase 14 tools and examples: gpu_checks ok ({checks['config']}: "
          f"K1 bit-identical, K2 rel Linf {checks['grad_rel_linf']:.3g}, "
          f"sharded grad {checks['sharded_grad_rel_linf']:.3g}) | native "
          f"codec built; its encoder's PNG and the Python encoder's decode to"
          f" the same pixels, its LUT within {lut_diff}/255 of pow | viewer "
          f"{VIEWER}x{VIEWER} cornell_mirror frame {frame_ms:.2f} ms (median "
          f"of {VIEWER_FRAMES}: render {ms['render']:.2f}, output "
          f"{ms['output']:.2f}, native PNG {ms['png']:.2f}; the Python PNG "
          f"{ms['png_python']:.2f}), served to a localhost request | "
          f"render_scenes {size}x{size} spp{spp} b{BOUNCES}: "
          f"{', '.join(scene_text)}, {rs_launches[0]} K1 launches | "
          f"inverse_render {isize}x{isize} {isteps} steps: loss "
          f"{' '.join(f'{x:.6g}' for x in losses)}, {inv_launches} "
          f"K1/K2/reduce/KR/KP launches, {inv_s:.1f} s | {card}",
          flush=True)
    return []


def kernel_vs_plain(dev, card: str) -> list:
    """Phase 2: K1 against its plain version on the card, and the goldens.
    Returns no kernel entry (phase 3 gives K1's)."""
    from sail_tpu_torch import scenes
    from sail_tpu_torch.ops.cuda import megakernel as mk

    # -- phase 2: K1 against its plain version and the goldens --------------
    results = []
    # (scene, rows, cols, seed, sample0, row0, image_height)
    for name, rows, cols, seed, sample0, row0, image_h in (
            ("cornell_matte", 64, 64, 0, 0, 0, 64),
            ("cornell_mirror", 64, 64, 0, 0, 0, 64),
            ("cornell_mirror", 32, 64, 0, 0, 32, 64),      # a row tile
            ("cornell_mirror", 37, 50, -3, 5, 0, 37),      # ragged blocks
            ("open_lights", 64, 96, 0, 0, 0, 64)):
        params, static = getattr(scenes, name)().pack()
        args = (params.to(dev), static, rows, cols, 4, seed, sample0, BOUNCES)
        kw = dict(row0=row0, image_height=image_h)
        got = mk.render_block(*args, **kw)
        want = mk.render_block_plain(*args, **kw)
        torch.cuda.synchronize()
        err, bad = compare(got, want)
        results.append(f"{name} rows {row0}-{row0 + rows - 1} of {image_h} x "
                       f"{cols} seed {seed} sample0 {sample0} spp4 b{BOUNCES}: "
                       f"max_abs {err:.3g}, {bad} over {TOL:g}")
        if bad:
            raise AssertionError(f"K1 disagrees with its plain version: "
                                 f"{results[-1]}")
    for golden, name, bounces in (("config1_cornell_matte", "cornell_matte", 2),
                                  ("config2_cornell_mirror", "cornell_mirror", 3)):
        ref = np.load(os.path.join(GOLDENS, f"{golden}.npy"))
        params, static = getattr(scenes, name)().pack()
        img = mk.render_block(params.to(dev), static, 64, 64, 4, 0, 0, bounces)
        img = (img.stack() * 0.25).cpu().numpy()
        err = float(np.abs(img - ref).max())
        results.append(f"golden {golden} max_abs {err:.3g}")
        np.testing.assert_allclose(img, ref, atol=TOL, rtol=TOL)
    print("phase 2 kernel vs plain: " + "; ".join(results), flush=True)
    return []


def main_path(dev, card: str) -> list:
    """Phase 3: the forward path through exactly one K1 launch, K1 against
    its plain version at its shape, both timed.  Returns K1's JSON entry."""
    from sail_tpu_torch import Renderer, scenes
    from sail_tpu_torch.ops.cuda import megakernel as mk

    # -- phase 3: the main path, through exactly one K1 launch --------------
    scene = scenes.cornell_mirror()
    scene.filter = "gamma"
    mk.render_block.launches = 0
    r = Renderer(W, H, seed=0, max_bounces=BOUNCES, device="cuda")
    r.update(scene)
    r.render_spp(scene, SPP)
    out = r.output(scene)
    launches = mk.render_block.launches
    if launches != 1:
        raise AssertionError(f"main path made {launches} K1 launches, not 1")
    if out.shape != (H, W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad output: shape {out.shape}, "
                             f"finite {np.isfinite(out).all()}")

    # K1 against the plain version at the main path's shape, and both timed
    # (CUDA events around each call; K1 median of TIMED_RUNS after warm-up).
    params, static = scene.pack()
    args = (params.to(dev), static, H, W, SPP, 0, 0, BOUNCES)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end)

    got, _ = timed(mk.render_block)
    k1_ms = statistics.median(timed(mk.render_block)[1]
                              for _ in range(TIMED_RUNS))
    want, plain_ms = timed(mk.render_block_plain)
    err, bad = compare(got, want)
    step = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_spp(scene, SPP)
        torch.cuda.synchronize()
        step.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(step)
    frame = []                      # a progressive viewer's frame: 1 spp
    for _ in range(TIMED_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(scene)
        torch.cuda.synchronize()
        frame.append((time.perf_counter() - t0) * 1e3)
    frame_ms = statistics.median(frame[1:])
    print(f"phase 3 main path: cornell_mirror {W}x{H} spp{SPP} b{BOUNCES}, "
          f"{launches} K1 launch, output {out.shape} finite, mean "
          f"{out.mean():.4f} | render_spp {step_ms:.2f} ms = "
          f"{mrays(step_ms):.1f} Mrays/s (median of {TIMED_RUNS}) | render "
          f"(1 spp) {frame_ms:.3f} ms = {mrays(frame_ms, 1):.1f} Mrays/s | K1 "
          f"{k1_ms:.2f} ms = {mrays(k1_ms):.1f} Mrays/s | plain torch "
          f"{plain_ms:.1f} ms = {mrays(plain_ms):.1f} Mrays/s (one run, full "
          f"spp) | K1 vs plain max_abs {err:.3g}, {bad} of {3 * H * W} over "
          f"{TOL:g} | {card}", flush=True)
    if bad:
        raise AssertionError("K1 disagrees with its plain version at the "
                             "main path's shape")
    return [kernel_row("K1 render_block (forward megakernel)",
                    "sail_tpu_torch/csrc/megakernel.cu",
                    "sail_tpu/ops/pallas/megakernel.py:159", launches, err,
                    k1_ms, plain_ms, bound(params.to(dev), static, H, W, SPP,
                                           BOUNCES),
                    f"cornell_mirror {W}x{H} spp{SPP} b{BOUNCES}")]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.ops.cuda import profile as pf
    from sail_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    nvcc = next((ln for ln in nvcc if "release" in ln), nvcc[-1])
    t0 = time.perf_counter()
    libs = ("megakernel", *(("megakernel_grad", b.defines)
                            for b in mk.GRAD_BUILDS),
            "reduce_grad_rows", "profile", pf.GRAD_LIBRARY, "trace_rays",
            "penumbra", "alhazen", "receivers")
    build.build(*libs)   # one nvcc each, as many at once as there are cores
    build_s = time.perf_counter() - t0
    usage = {f"{k} ({build._spec(lib)[0]})": v
             for lib in libs for k, v in build.resource_usage(lib).items()}
    flags = ("false", "true")
    for kernel in (*(f"render_block_kernel<{a}, {c}, {m}, 0> (megakernel)"
                     for a in flags for c in flags for m in flags),
                   *(f"reduce_grad_rows_kernel<{ppt}> (reduce_grad_rows)"
                     for ppt in (1, 2, 4)),
                   *(f"{b.kernel} (megakernel_grad)" for b in mk.GRAD_BUILDS),
                   *(f"isect_only_kernel<{a}> (profile)" for a in flags),
                   "alu_peak_kernel<0> (profile)",
                   "alu_peak_kernel<1> (profile)",
                   "alu_peak_ilp8_kernel (profile)",
                   *(f"render_block_kernel<false, false, false, {b}> "
                     f"(profile)" for b in (1, 2, 4, 8)),
                   *(f"render_grad_kernel<{mk.SHARED_GRAD}, false, false, "
                     f"{st}, 2, false> (profile_grad)" for st in (1, 3)),
                   "trace_rays_kernel (trace_rays)",
                   "penumbra_kernel (penumbra)",
                   "alhazen_kernel (alhazen)"):
        if kernel not in usage:
            raise AssertionError(f"no -Xptxas -v report for {kernel}")
    print(card)
    print(f"phase 1 device+build: torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc {nvcc} | {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()} | K1, K2, KR, KP, KA and the "
          f"profiling kernels built in {build_s:.1f} s"
          + "".join(f" | {k}: {u['registers']} registers, {u['stack']} B "
                    f"stack, {u['spill_stores']}/{u['spill_loads']} B spill "
                    f"stores/loads, {u['smem']} B static smem"
                    for k, u in sorted(usage.items())),
          flush=True)

    kernels = []
    seconds = {1: time.perf_counter() - t0}
    for phase, fn in ((2, kernel_vs_plain), (3, main_path),
                      (4, gradient_path), (5, many_objects),
                      (6, many_gradients), (7, materials_path),
                      (8, profiling_path), (9, k2_phases),
                      (10, lights_path), (11, display_path),
                      (12, inverse_path), (13, multi_device_path),
                      (14, tools_path)):
        t1 = time.perf_counter()
        kernels += fn(dev, card)
        seconds[phase] = time.perf_counter() - t1
    print("seconds per phase: " + ", ".join(f"{k}: {v:.1f}"
                                            for k, v in seconds.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
