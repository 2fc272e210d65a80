"""Where K1's time goes, on the card: the port's counterpart of
`tools/profile_megakernel.py`.  `ncu` and `nsys` do not run on the card's
host, so K1 is split by subtraction and the card's issue rates are read with
kernels of known work.

    python3 -m sail_tpu_torch.tools.profile_megakernel [--sections op_count,phases,vpu_peak,open_scene]
        [--iters 5] [--budget-s 1800] [--out PROFILE_h100.json]
    python3 -m sail_tpu_torch.tools.profile_megakernel --device cpu --size 16 --spp 2 --bounces 2

Sections, each written to `--out` as soon as it ends (a run cut short still
leaves what it measured):
- `op_count`: the FP32 operations K1 and K2 do per lane-sample and per ray
  on config 2 (`cornell_mirror`), and K5a's per path-bounce, from the port's
  hand count over the plain version's masks (`utils/opcount.live_ops`,
  `isect_only_ops`), in place of the JAX tool's jaxpr walk; with the ray
  rate the FP32 bound allows.
- `phases`: K1 on config 2 at `--size`² x `--spp` x `--bounces` (1024² x 64
  x 5 by default) in full and with each of four phases stripped
  (`render_block_stripped`: constant RNG, constant texture, no shadow scan,
  no NEE), and K5a, the intersect-only path (`isect_only_block`), at that
  spp and at 1 spp; the four costs full minus stripped; and, so that no
  reading proves nothing, whether each stripped image differs from the
  full one and K5a's spp-to-1 time ratio.
- `vpu_peak`: K5b (`alu_peak`) for `fma` and `integrator_mix` at the JAX
  tool's two geometries and K5c (`alu_peak_ilp8`), under the JAX tool's
  keys.  Each gives ms, the operations in the TPU tool's unit (an
  elementwise op or a mul-add 1) and its rate, the FP32 rate under the FLOP
  convention (a fused mul-add 2, the unit of the card's 67 TFLOP/s) and the
  SFU rate, and the share of the kernel's bound (the slower of the FP32
  pipe and the SFU at the card's maximum SM clock).
- `open_scene`: K1 on `material_demo_open` at 512² x 32 x 5 with
  `early_exit` off and on.  On the card the two are one kernel (each thread
  starts its next sample when its path misses or dies), so the images are
  equal bit for bit and the times about the same.

Not ported, as they measure TPU knobs or XLA alone: `cost_recon` (XLA's cost
analysis), `tiles_fwd`, `tiles_bwd` and `tiles_bwd2` (Pallas tile shapes; K1
and K2 run a fixed 16 x 16 thread block), `unroll` (`spp_unroll`) and
`op_slope` (`INJECT_MIX_ITERS`).

On the card (the default) every time is per call, the median of 3 runs of
`--iters` calls back to back between CUDA events after a warm-up, beside
the card's name and power limit;
without a card it raises.  `--device cpu` runs the plain versions instead, a
smoke run whose times are the host's.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.ops.cuda import profile as pf
from sail_tpu_torch.tools.many_object_bench import _timed, card
from sail_tpu_torch.utils import opcount

SECTIONS = ("op_count", "phases", "vpu_peak", "open_scene")
SIZE, SPP, BOUNCES = 1024, 64, 5
OPEN = (512, 32, 5)
# vpu_peak's geometries (R, Cn, G, K): tools/profile_megakernel.py:600-601
# and, for the 8-chain kernel, :627
VPU_GEOMETRIES = {"": (256, 512, 32, 4096), "_tile8x512": (8, 512, 4096, 1024)}
ILP8_GEOMETRY = (8, 512, 2048, 256)
# (key, mix, geometry, independent chains) of vpu_peak's five kernels
ALU_CASES = [(mix + suffix, mix, geom, 1)
             for mix in ("fma", "integrator_mix")
             for suffix, geom in VPU_GEOMETRIES.items()] + [
    ("integrator_mix_tile8x512_ilp8", "integrator_mix", ILP8_GEOMETRY,
     opcount.ILP)]
# the phases' strips and their costs' keys (the JAX tool's, in ms)
COSTS = {"const_rng": "rng_cost_ms", "const_texture": "texture_cost_ms",
         "no_shadow_scan": "shadow_scan_cost_ms",
         "no_nee": "nee_total_cost_ms"}


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi gives it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def median_ms(fn, device: torch.device, iters: int, rounds: int = 3) -> float:
    """ms per call of fn(): after a warm-up, the median over `rounds` of
    the mean of `iters` calls made back to back between one pair of timers.
    On the card the calls queue on the stream, so the host's time to launch
    one hides behind the one before; a call timed alone would add it (tens
    of microseconds, a fifth of K5a's time at 1 spp)."""
    fn()

    def batch():
        for _ in range(iters):
            fn()
    return statistics.median(_timed(batch, device)[1] / iters
                             for _ in range(rounds))


def op_count_section(device, size: int = SIZE, spp: int = SPP,
                     bounces: int = BOUNCES) -> dict:
    """FP32 operations per lane-sample and per ray (bounces · 2 rays a
    lane-sample, the repo's convention) on config 2, from the masks of one
    sample on every 32nd row (of the block, for blocks of 64 rows or more)."""
    params, static = scenes.cornell_mirror().pack()
    params = params.to(device)
    row_step = 32 if size >= 64 else 1
    k1, k2 = opcount.live_ops(params, static, size, size, spp, 0, bounces,
                              samples=1, row_step=row_step)
    k5a = opcount.isect_only_ops(params, static, size, size, spp, bounces)
    lanes = size * size * spp
    rays = bounces * 2
    return {
        "scene": "cornell_mirror", "config": f"{size}^2 x {spp}spp x "
        f"{bounces}b", "source": "utils/opcount.py hand count over the plain"
        " version's masks (not a jaxpr walk)",
        "k1_ops_per_lane_sample": k1 / lanes,
        "k1_ops_per_ray_convention": k1 / lanes / rays,
        "k2_ops_per_lane_sample": k2 / lanes,
        "k5a_ops_per_path_bounce": k5a / (lanes * bounces),
        "fp32_peak_flops": opcount.H100_FP32_FLOPS,
        "k1_fp32_bound_mrays_per_s": rays * lanes
        / (k1 / opcount.H100_FP32_FLOPS) / 1e6,
        "weights_note": "each float add, multiply, divide, sqrt, min, max, "
                        "|x| and comparison 1; selects and integer work 0",
    }


def phases_section(device, size: int = SIZE, spp: int = SPP,
                   bounces: int = BOUNCES, iters: int = 5) -> dict:
    """K1 on config 2 in full, with each phase stripped, and K5a."""
    params, static = scenes.cornell_mirror().pack()
    params = params.to(device)
    args = (params, static, size, size, spp, 0, 0, bounces)
    out = {"config": f"cornell_mirror {size}^2 x {spp}spp x {bounces}b"}
    full = mk.render_block(*args).stack()
    out["full_ms"] = median_ms(lambda: mk.render_block(*args), device, iters)
    differs = {}
    for strip, cost in COSTS.items():
        img = pf.render_block_stripped(strip, *args).stack()
        differs[strip] = not torch.equal(img, full)
        out[f"{strip}_ms"] = median_ms(
            lambda: pf.render_block_stripped(strip, *args), device, iters)
        out[cost] = out["full_ms"] - out[f"{strip}_ms"]
    out["stripped_differs_from_full"] = differs
    for key, n in (("intersect_only_ms", spp), ("intersect_only_spp1_ms", 1)):
        out[key] = median_ms(lambda: pf.isect_only_block(
            params, static, size, size, n, bounces), device, iters)
    out["intersect_only_spp_ratio"] = (out["intersect_only_ms"]
                                       / out["intersect_only_spp1_ms"])
    return out


def vpu_peak_section(device, iters: int = 5) -> dict:
    """K5b and K5c at the JAX tool's geometries (ALU_CASES)."""
    clock = max_sm_clock_mhz() if device.type == "cuda" else None
    out = {"sm_clock_max_mhz": clock}
    for key, mix, (r, cn, g, k), chains in ALU_CASES:
        if chains == 1:
            def call(mix=mix, r=r, cn=cn, g=g, k=k):
                return pf.alu_peak(mix, r, cn, g, k, device=device)
        else:
            def call(r=r, cn=cn, g=g, k=k):
                return pf.alu_peak_ilp8(r, cn, g, k, device=device)
        ms = median_ms(call, device, iters)
        elem_iters = g * r * cn * k
        b = opcount.alu_bound_ms(mix, elem_iters, clock or 1.0, chains)
        s = ms * 1e-3
        out[key] = {
            "ms": ms, "geometry": dict(R=r, Cn=cn, G=g, K=k, chains=chains),
            "ops_counted": b["tpu_ops"],
            "achieved_tops_per_s": b["tpu_ops"] / s / 1e12,
            "unit": "Tops/s, the TPU tool's: an elementwise op or a mul-add "
                    "1",
            "fp32_flops": b["fp32_flops"],
            "achieved_fp32_tflops": b["fp32_flops"] / s / 1e12,
            "sfu_ops": b["sfu_ops"],
            "achieved_sfu_tops": b["sfu_ops"] / s / 1e12,
        }
        if clock:
            out[key].update(bound_ms=b["bound_ms"], bound_pipe=b["pipe"],
                            fp32_bound_ms=b["fp32_ms"],
                            sfu_bound_ms=b["sfu_ms"],
                            share_of_bound=b["bound_ms"] / ms)
    return out


def open_scene_section(device, size: int = OPEN[0], spp: int = OPEN[1],
                       bounces: int = OPEN[2], iters: int = 5) -> dict:
    """K1 on the open scene with early_exit off and on."""
    params, static = scenes.material_demo_open().pack()
    args = (params.to(device), static, size, size, spp, 0, 0, bounces)
    out = {"config": f"material_demo_open {size}^2 x {spp}spp x {bounces}b",
           "note": "on the card early_exit changes nothing in K1: each thread"
                   " starts its next sample when its path misses or dies"}
    imgs = {}
    for early in (False, True):
        key = "early" if early else "base"
        imgs[key] = mk.render_block(*args, early_exit=early).stack()
        out[f"{key}_ms"] = median_ms(
            lambda: mk.render_block(*args, early_exit=early), device, iters)
    out["bit_identical"] = torch.equal(imgs["base"], imgs["early"])
    out["speedup"] = out["base_ms"] / out["early_ms"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--budget-s", type=float, default=1800.0,
                    help="sections left when this is spent are skipped")
    ap.add_argument("--out", default="PROFILE_h100.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--spp", type=int, default=SPP)
    ap.add_argument("--bounces", type=int, default=BOUNCES)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the profile measures the card "
                           "(--device cpu runs the plain versions)")
    t0 = time.perf_counter()
    result = {"device": (torch.cuda.get_device_name(0) if device.type ==
                         "cuda" else "cpu"),
              "card": card() if device.type == "cuda" else None,
              "timer": ("CUDA events" if device.type == "cuda" else
                        "host clock, plain versions"),
              "sections": {}}
    small = dict(size=args.size, spp=args.spp, bounces=args.bounces)
    runners = {
        "op_count": lambda: op_count_section(device, **small),
        "phases": lambda: phases_section(device, iters=args.iters, **small),
        "vpu_peak": lambda: vpu_peak_section(device, args.iters),
        "open_scene": lambda: open_scene_section(device, iters=args.iters),
    }
    for name in args.sections.split(","):
        if name not in runners:
            raise ValueError(f"unknown section {name!r}: {SECTIONS}")
        if time.perf_counter() - t0 > args.budget_s:
            result["sections"][name] = "skipped: budget"
            continue
        s0 = time.perf_counter()
        result["sections"][name] = runners[name]()
        result["sections"][f"_{name}_s"] = time.perf_counter() - s0
        result["seconds_total"] = time.perf_counter() - t0
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"[{time.perf_counter() - t0:7.1f}s] section {name} done",
              flush=True)
    print(json.dumps(result["sections"]))
    return result


if __name__ == "__main__":
    main()
