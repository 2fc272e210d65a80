"""End-to-end smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device and build: torch, CUDA, nvcc, the card's name and power limit;
     builds the K1 megakernel from sail_tpu_torch/csrc and reports its
     registers (nvcc -Xptxas -v).
  2. kernel vs plain on the card: K1 against its plain torch version on the
     same CUDA tensors (cornell_matte, cornell_mirror, a row tile, a ragged
     block with another seed, and open_lights: misses, Oren-Nayar, an
     emissive sphere, a reversed light, two lights, a 3:2 image), and the
     committed golden images tests/goldens/config{1,2}*.npy.
  3. the main path: Renderer(1024, 1024, seed=0, max_bounces=5,
     device="cuda") -> update(cornell_mirror) -> render_spp(64) ->
     output(gamma), which must go through exactly one K1 launch; then K1
     held against the plain version at that shape, both timed, and a
     progressive frame (render(), 1 spp) timed.
The last two lines are a JSON object per kernel and the JSON result.
Imports nothing of JAX.
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
    build.load("megakernel")
    build_s = time.perf_counter() - t0
    (k1_usage,) = build.resource_usage("megakernel").values()
    print(card)
    print(f"phase 1 device+build: torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc {nvcc} | {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()} | K1 built in {build_s:.1f} s: "
          f"{k1_usage['registers']} registers, {k1_usage['stack']} B stack, "
          f"{k1_usage['spill_stores']}/{k1_usage['spill_loads']} B spill "
          f"stores/loads", flush=True)

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

    print(json.dumps({"kernels": [{
        "name": "K1 render_block (forward megakernel)", "route": "cuda",
        "source": "sail_tpu_torch/csrc/megakernel.cu",
        "replaces": "sail_tpu/ops/pallas/megakernel.py:159",
        "launches": launches, "max_abs_err": err, "ms": k1_ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
