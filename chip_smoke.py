"""End-to-end smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device and build: torch, CUDA, nvcc, the card's name and power limit;
     builds K1 (csrc/megakernel.cu) and K2 (csrc/megakernel_grad.cu), one
     nvcc each, started together, and reports each kernel's registers,
     stack and spills (nvcc -Xptxas -v).
  2. kernel vs plain on the card: K1 against its plain torch version on the
     same CUDA tensors (cornell_matte, cornell_mirror, a row tile, a ragged
     block with another seed, and open_lights: misses, Oren-Nayar, an
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
     repeat; its reduce pass against a plain sum; then
     render_image_fast(params, seed, static, 1024, 1024, 64, 5) ->
     mean(x + y + z) -> backward(), through exactly one K1, one K2 and one
     reduce launch, timed; K2 at that shape against its plain version and,
     bit for bit, against the step's gradient; then 5 Adam steps on the
     materials and lights from a perturbed scene toward a target image,
     whose loss must fall.
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
     scenes at 64² and on 64 and 256 spheres (879 and 3,375 parameters) at
     32² x 1 spp, bit-identical on repeat; then render_image_fast on 64
     spheres at 1024² x 64 spp x 5 bounces and on 256 spheres at 1 spp ->
     mean(x+y+z) -> backward(), each through exactly one K1, one K2 and one
     reduce launch, timed, its gradient K2's at the same arguments bit for
     bit; K2 (and the 256-sphere step's K1) held against the plain version
     on a full-width row tile of each step at its spp and bounces, the
     worst leaf split into its per-pixel contributions on both sides
     (sail_tpu_torch/tools/grad_localise.py).
Every kernel's bound is computed from this run's inputs: the FP32
operations the plain version's masks say these paths need
(sail_tpu_torch/utils/opcount.py) over 67 TFLOP/s, or the bytes over
3.35 TB/s, whichever is larger.  The last two lines are a JSON object per
kernel and the JSON result.  Imports nothing of JAX.
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
# at 64 spheres): (rows, first row) of the 1024-row image
FEW, MANY, MOST = 16, 64, 256
SWEEP_COUNTS = (4, 16, 32, 64, 128, 256)
SWEEP_SIZE, SWEEP_SPP, SWEEP_BOUNCES = 512, 8, 3
K1_TILE = (32, 496)
K2_TILE = {MANY: (4, 510), MOST: (16, 504)}
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "goldens")


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


def kernel_row(name: str, source: str, replaces: str, launches: int,
               max_abs_err: float, ms: float, plain_ms: float, b: dict,
               shape: str, library_ms: float = None, **extra) -> dict:
    """One entry of the `kernels` line: `ms` and the bound at `shape`; where
    the plain version ran on a row tile of it (`plain_shape`), `tile_ms` is
    the kernel's time there."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": library_ms, "shape": shape, **extra}


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

    # the reduce pass against a plain sum, at the main path's row count
    bx, by = mk.grad_limits()["block"]
    rows_t = torch.randn((-(-W // bx) * -(-H // by), len(got)),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    red, red_ms = cuda_ms(mk.reduce_grad_rows, rows_t)
    red_plain, red_plain_ms = cuda_ms(lambda r: r.sum(0), rows_t)
    red_err = float((red.double() - rows_t.double().sum(0)).abs().max())
    if red_err > 1e-3:
        raise AssertionError(f"reduce pass off by {red_err}")

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
    # this call's bit for bit; and against the plain version at 64 spp
    g = Vec3(*(torch.full((H, W), 1.0 / (H * W * SPP), device=dev),) * 3)
    k2_args = (params, static, g, H, W, SPP, 0, 0, BOUNCES)
    k2_runs = [cuda_ms(mk.render_grad_block, *k2_args)
               for _ in range(TIMED_RUNS)]
    k2_ms = statistics.median(ms for _, ms in k2_runs)
    got = k2_runs[0][0]
    want, k2_plain_ms = cuda_ms(mk.render_grad_block_plain, *k2_args)
    summary, grad_err, grad_abs, _ = grad_check(
        f"cornell_mirror {W}x{H} spp{SPP} b{BOUNCES} (the step's shape)", got,
        want, static)
    if not all(torch.equal(got, r) for r, _ in k2_runs):
        raise AssertionError(f"K2 is not repeatable: {summary}")
    if not torch.equal(step_grad, got):
        raise AssertionError(
            f"the step's gradient is not K2's at the same arguments: max abs "
            f"diff {float((step_grad - got).abs().max()):.3g}")
    results.append(summary + f", bit-identical over {TIMED_RUNS} calls and "
                   f"to the step's gradient")

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
          f"plain K2 {k2_plain_ms:.1f} ms (one run) | reduce {red_ms:.3f} ms,"
          f" plain sum {red_plain_ms:.3f} ms | Adam lr 5e-2 x{ADAM_STEPS}: "
          f"loss {' '.join(f'{x:.6g}' for x in losses)}; sphere kd 0.6 -> "
          f"{float(fitted[off.materials[2]]):.4f} (true 1.0), light "
          f"emission 3.5 -> {float(fitted[off.lights[0]]):.4f} (true 5.0) | "
          f"{card}", flush=True)
    from sail_tpu_torch.utils import opcount
    k2_bound = bound(params, static, H, W, SPP, BOUNCES, grad=True)
    red_bound_ms, red_by = opcount.bound_ms(0.0, 4 * (rows_t.numel()
                                                      + rows_t.shape[1]))
    red_bound = {"bound_ms": red_bound_ms, "bound_by": red_by}
    shape = f"cornell_mirror {W}x{H} spp{SPP} b{BOUNCES}"
    return [
        kernel_row("K2 render_grad_block (backward megakernel)",
                   "sail_tpu_torch/csrc/megakernel_grad.cu",
                   "sail_tpu/ops/pallas/megakernel.py:262", launches[1],
                   grad_abs, k2_ms, k2_plain_ms, k2_bound, shape,
                   rel_linf=grad_err),
        kernel_row("K2 reduce_grad_rows (K2's cross-block sum)",
                   "sail_tpu_torch/csrc/megakernel_grad.cu",
                   "sail_tpu/ops/pallas/megakernel.py:459", launches[2],
                   red_err, red_ms, red_plain_ms, red_bound,
                   f"{rows_t.shape[0]} rows x {rows_t.shape[1]} params",
                   library_ms=red_plain_ms)]


def scene_of(name: str):
    """A scene of `sail_tpu_torch.scenes` by name; `spheres<n>` is the
    many-object scene with n spheres."""
    from sail_tpu_torch import scenes
    if name.startswith("spheres"):
        return scenes.many_spheres(int(name[len("spheres"):]))
    return getattr(scenes, name)()


def renderer_path(dev, n: int, label: str):
    """Renderer(W, H, seed=0, max_bounces=BOUNCES) -> update(n spheres) ->
    render_spp(SPP) -> output, through exactly one K1 launch (counted from
    0 just before), then timed.  Returns (launches, output, render_spp ms,
    params, static)."""
    from sail_tpu_torch import Renderer
    from sail_tpu_torch.ops.cuda import megakernel as mk
    scene = scene_of(f"spheres{n}")
    scene.filter = "gamma"
    r = Renderer(W, H, seed=0, max_bounces=BOUNCES)   # the card, by default
    r.update(scene)
    mk.render_block.launches = 0
    r.render_spp(scene, SPP)
    out = r.output(scene)
    launches = mk.render_block.launches
    if launches != 1 or out.shape != (H, W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"{label}: {launches} K1 launches, output "
                             f"{out.shape}, finite {np.isfinite(out).all()}")
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_spp(scene, SPP)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    params, static = scene.pack()
    return launches, out, statistics.median(times), params.to(dev), static


def k1_tile(name: str, params, static, spp: int):
    """K1 (the cull as render_block chooses it) against its plain version
    (no cull: an object the cull dropped would show) on a full-width row
    tile of the W x H image at `spp`: (text, max abs diff, K1 ms median,
    plain ms, shape).  Raises outside TOL."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    rows, row0 = K1_TILE
    args = (params, static, rows, W, spp, 0, 0, BOUNCES)
    kw = dict(row0=row0, image_height=H)
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
        launches, out, step_ms, params, static = renderer_path(dev, n, label)
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
    for name, size in (("quadrics", 64), ("spheres12", 64),
                       (f"spheres{MANY}", 32), (f"spheres{MOST}", 32)):
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
                             f"{mk.grad_cap(params.numel())})", got, want,
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
            f"{mk.grad_cap(params.numel())}) {W}x{H} spp{spp} b{BOUNCES}: "
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
            f"{mk.grad_cap(params.numel())}-parameter build)",
            "sail_tpu_torch/csrc/megakernel_grad.cu + adjoint.cuh",
            "sail_tpu/ops/pallas/megakernel.py:262", launches[1], abs_err,
            k2_ms, plain_ms, b, path, rel_linf=err,
            launches_counted_on=f"the fwd+bwd step on {n} spheres",
            plain_shape=shape, tile_ms=tile_ms, localised=where))
    print(f"phase 6 gradients, every shape and many objects: K2 vs plain: "
          + "; ".join(results) + " | steps render_image_fast -> mean(x+y+z)"
          " -> backward: " + " | ".join(steps) + f" | {card}", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from sail_tpu_torch import Renderer, scenes
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    nvcc = next((ln for ln in nvcc if "release" in ln), nvcc[-1])
    t0 = time.perf_counter()
    build.build("megakernel", "megakernel_grad")   # one nvcc each, together
    build_s = time.perf_counter() - t0
    usage = {**build.resource_usage("megakernel"),
             **build.resource_usage("megakernel_grad")}
    for kernel in (*(f"render_block_kernel<{a}, {c}>" for a in ("false", "true")
                     for c in ("false", "true")), "reduce_grad_rows_kernel",
                   *(f"render_grad_kernel<{cap}>" for cap in mk.GRAD_CAPS)):
        if kernel not in usage:
            raise AssertionError(f"no -Xptxas -v report for {kernel}")
    print(card)
    print(f"phase 1 device+build: torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc {nvcc} | {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()} | K1 and K2 built in {build_s:.1f} s"
          + "".join(f" | {k}: {u['registers']} registers, {u['stack']} B "
                    f"stack, {u['spill_stores']}/{u['spill_loads']} B spill "
                    f"stores/loads" for k, u in sorted(usage.items())),
          flush=True)

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

    k1 = kernel_row("K1 render_block (forward megakernel)",
                    "sail_tpu_torch/csrc/megakernel.cu",
                    "sail_tpu/ops/pallas/megakernel.py:159", launches, err,
                    k1_ms, plain_ms, bound(params.to(dev), static, H, W, SPP,
                                           BOUNCES),
                    f"cornell_mirror {W}x{H} spp{SPP} b{BOUNCES}")
    kernels = [k1] + gradient_path(dev, card)
    kernels += many_objects(dev, card) + many_gradients(dev, card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
