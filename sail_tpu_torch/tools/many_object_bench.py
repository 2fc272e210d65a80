"""K1's time as the object count grows, with and without the cluster cull:
the port's counterpart of `tools/many_object_bench.py`.

    python3 -m sail_tpu_torch.tools.many_object_bench [--counts 4,16,64,128,256]
    python3 -m sail_tpu_torch.tools.many_object_bench --plain --size 16 --counts 4,12

The scene is that tool's: a Cornell box, a grid of n small matte spheres
(`scenes.many_spheres`) and a ceiling light, rendered at its own 512² x 8 spp
x 3 bounces by default.  On the card each count runs in two modes, `kernel`
(`render_block`) and `kernel_cull` (`render_block(cull=True)`): a warm-up,
then the median of 5 calls timed with CUDA events; the two images must be
equal bit for bit.  Prints one JSON object with the card's name and power
limit.  Without a card it raises; `--plain` runs the plain torch version on
the CPU instead (a smoke run: its times are the CPU's, not the card's).
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.ops.cuda.megakernel import render_block

COUNTS = (4, 16, 64, 128, 256)
SIZE, SPP, BOUNCES, RUNS = 512, 8, 3, 5
MODES = {"kernel": False, "kernel_cull": True}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _timed(fn, device: torch.device):
    """(result, ms) of one call: CUDA events on the card, else the host
    clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        res = fn()
        return res, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def sweep(counts=COUNTS, size: int = SIZE, spp: int = SPP,
          bounces: int = BOUNCES, runs: int = RUNS, device="cuda") -> dict:
    """One row per count: each mode's median, min and max of `runs` timed
    calls after a warm-up, its kernel launches (`render_block.launches`),
    and whether the two modes' images are equal bit for bit.  Raises where
    they are not."""
    device = torch.device(device)
    rows = []
    for n in counts:
        params, static = scenes.many_spheres(n).pack()
        params = params.to(device)
        row = {"n_spheres": n, "n_params": params.numel()}
        images = {}
        for mode, cull in MODES.items():
            def call(cull=cull):
                return render_block(params, static, size, size, spp, 0, 0,
                                    bounces, cull=cull)
            before = render_block.launches
            images[mode] = _timed(call, device)[0].stack()
            ms = [_timed(call, device)[1] for _ in range(runs)]
            row[mode] = {"ms": statistics.median(ms), "min_ms": min(ms),
                         "max_ms": max(ms),
                         "launches": render_block.launches - before}
        row["cull_bit_identical"] = bool(torch.equal(images["kernel"],
                                                     images["kernel_cull"]))
        if not row["cull_bit_identical"]:
            raise AssertionError(f"cull=True changed the image at {n} spheres")
        rows.append(row)
    return {"metric": "K1 ms per call vs object count (median of "
                      f"{runs}, CUDA events)" if device.type == "cuda" else
                      f"plain torch ms per call on the CPU (median of {runs})",
            "config": f"many_spheres {size}x{size} x{spp}spp x{bounces}b",
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--counts", default=",".join(map(str, COUNTS)))
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--spp", type=int, default=SPP)
    ap.add_argument("--bounces", type=int, default=BOUNCES)
    ap.add_argument("--runs", type=int, default=RUNS)
    ap.add_argument("--plain", action="store_true",
                    help="the plain torch version on the CPU (no card)")
    args = ap.parse_args()
    if not args.plain and not torch.cuda.is_available():
        raise RuntimeError("many_object_bench times K1 on a CUDA device and "
                           "torch.cuda.is_available() is False; pass --plain "
                           "for the plain version on the CPU")
    result = sweep([int(c) for c in args.counts.split(",")], args.size,
                   args.spp, args.bounces, args.runs,
                   "cpu" if args.plain else "cuda")
    if not args.plain:
        result["card"] = card()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
