"""Determinism of K1 and K2 on the card: the port's counterpart of
`tools/determinism_check.py`.  A race in a kernel's sums would show as bits
that differ between repeated or re-tiled runs; the counter-based RNG and
the kernels' fixed summation orders make every check below exact.

    python3 -m sail_tpu_torch.tools.determinism_check [--size 512] [--spp 8] [--bounces 3] [--out DETERMINISM_h100.json]

On config 2 (`cornell_mirror`), seed 0:
  1. repeat      K1 twice: bit-identical.
  2. chunking    spp samples in one launch against spp/2 + spp/2 through
                 `sample0`: allclose (relative L-inf below 1e-5), not
                 bit-identical, as K1 adds a pixel's samples in order and
                 re-chunking re-associates that float32 sum; the chunked
                 sum itself must repeat bit for bit.
  3. tiling      K1's thread block is fixed, so the card's counterpart of
                 the TPU's tile shapes is the block's rows: the whole image
                 against the same image rendered as row tiles of each of
                 TILE_ROWS heights through `row0`, bit for bit.
  4. grad_repeat K2 (its block partials summed in a fixed order by a second
                 pass) twice, with bench.py's cotangent: bit-identical.
Runs on the card unless given `--device cpu` (the plain versions, a smoke
run).  Writes one JSON object to `--out` and prints it.  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.tools.many_object_bench import card
from sail_tpu_torch.utils.sanitize import assert_bit_equal

CHUNK_RTOL = 1e-5
# row-tile heights: a ragged last tile, a block's 16 rows, three blocks
TILE_ROWS = (7, 16, 48)


def run(size: int = 512, spp: int = 8, bounces: int = 3,
        device="cuda") -> dict:
    device = torch.device(device)
    t0 = time.perf_counter()
    params, static = scenes.cornell_mirror().pack()
    params = params.to(device)
    out = {"device": (torch.cuda.get_device_name(0) if device.type ==
                      "cuda" else "cpu"),
           "config": f"cornell_mirror {size}x{size} x{spp}spp x{bounces}b"}

    def render(n, sample0=0, rows=size, row0=0):
        return mk.render_block(params, static, rows, size, n, 0, sample0,
                               bounces, row0=row0,
                               image_height=size).stack()

    def same(key, a, b):
        try:
            assert_bit_equal(a, b, key)
            out[f"{key}_bit_identical"] = True
        except AssertionError as e:
            out[f"{key}_bit_identical"] = False
            out[f"{key}_mismatch"] = str(e)

    a = render(spp)
    same("repeat", a, render(spp))

    half = spp // 2
    c = render(half) + render(spp - half, half)
    rel = float((a - c).abs().max() / a.abs().max().clamp(min=1e-30))
    out["chunking_allclose_rel"] = rel
    out["chunking_allclose_pass"] = rel < CHUNK_RTOL
    same("chunking_repeat", c, render(half) + render(spp - half, half))

    for rows in TILE_ROWS:
        tiled = torch.cat([render(spp, rows=min(rows, size - r0), row0=r0)
                           for r0 in range(0, size, rows)])
        same(f"tiling_rows{rows}", a, tiled)

    g1 = torch.full((size, size), 1.0 / (size * size * spp), device=device)
    g = Vec3(g1, g1, g1)

    def grad():
        return mk.render_grad_block(params, static, g, size, size, spp, 0, 0,
                                    bounces)

    same("grad_repeat", grad(), grad())
    out["all_pass"] = (all(v for k, v in out.items()
                           if k.endswith("_bit_identical"))
                       and out["chunking_allclose_pass"])
    out["seconds_total"] = time.perf_counter() - t0
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="DETERMINISM_h100.json")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the check runs the kernels "
                           "(--device cpu runs the plain versions)")
    out = run(args.size, args.spp, args.bounces, args.device)
    if args.device == "cuda":
        out["card"] = card()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
