"""Timing spread and device-busy share of K1 and the Renderer on one GPU.

    python3 -m sail_tpu_torch.tools.measure [--calls 20]

At 1024², 5 bounces, seed 0, beside the card's name and power limit, prints:
  - K1 (`render_block`) at 64 spp for configs 1 and 2: CUDA-event times
    over --calls calls after 3 warm-ups (median, quartiles, min, max);
  - torch.profiler over --calls `Renderer.render_spp(64)` calls and over
    --calls `Renderer.render` (1 spp, a progressive viewer's frame) calls of
    config 2: host wall time, device-busy time and share, and device time
    per kernel or copy.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from sail_tpu_torch import Renderer, scenes
from sail_tpu_torch.ops.cuda.megakernel import render_block

SIZE, SPP, BOUNCES, WARMUP = 1024, 64, 5, 3


def k1_spread(name: str, calls: int) -> str:
    params, static = getattr(scenes, name)().pack()
    args = (params.cuda(), static, SIZE, SIZE, SPP, 0, 0, BOUNCES)
    ms = []
    for k in range(WARMUP + calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render_block(*args)
        end.record()
        torch.cuda.synchronize()
        if k >= WARMUP:
            ms.append(start.elapsed_time(end))
    q1, q2, q3 = statistics.quantiles(ms, n=4)
    return (f"K1 {name} {SIZE}² spp{SPP} b{BOUNCES} over {calls} calls: "
            f"median {statistics.median(ms):.3f} ms, quartiles {q1:.3f} / "
            f"{q3:.3f}, min {min(ms):.3f}, max {max(ms):.3f}")


def profiled(label: str, step, calls: int) -> str:
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    parts = "; ".join(f"{key[:60]} x{n}: {ms:.3f} ms"
                      for key, ms, n in sorted(rows, key=lambda r: -r[1]))
    return (f"{label}, {calls} calls: wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}% | {parts}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    calls = ap.parse_args().calls
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for name in ("cornell_matte", "cornell_mirror"):
        print(k1_spread(name, calls), flush=True)
    scene = scenes.cornell_mirror()
    r = Renderer(SIZE, SIZE, seed=0, max_bounces=BOUNCES, device="cuda")
    r.update(scene)
    print(profiled(f"render_spp({SPP}) cornell_mirror {SIZE}²",
                   lambda: r.render_spp(scene, SPP), calls), flush=True)
    print(profiled(f"render() 1 spp cornell_mirror {SIZE}²",
                   lambda: r.render(scene), calls), flush=True)


if __name__ == "__main__":
    main()
