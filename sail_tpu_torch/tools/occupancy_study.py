"""How many paths each bounce still carries: the port's counterpart of
`tools/occupancy_study.py`, the measurement behind a compaction decision.

    python3 -m sail_tpu_torch.tools.occupancy_study [--size 128] [--spp 4] [--bounces 5] [--device cpu]

For BASELINE configs 2 and 3 and config 3's open twin, seed 0, the fraction
of paths alive after each bounce and the fraction alive with a throughput
below 1e-2 (what Russian roulette would also end), averaged over `--spp`
samples, from the plain version's masks (`render/integrator.
alive_fractions`); and the speedup perfect per-path compaction could give
at most, bounces / the bounces' share of paths still doing work (bounce 0
does work for every path, bounce b for those alive after b - 1), without and
with Russian roulette.  The JAX tool's tile-level bounds (its (8, tc) TPU
tiles) are not ported.  Occupancy depends on the paths, not the hardware;
the tool runs on the card unless given `--device cpu`.  Prints one JSON
object.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.core.camera import rays_for_pixels
from sail_tpu_torch.core.rng import TAG_PIXEL_JITTER, PixelNoise
from sail_tpu_torch.render import integrator
from sail_tpu_torch.scene.scene import unflatten

CONFIGS = (("config2_cornell_mirror", "cornell_mirror"),
           ("config3_material_demo", "material_demo"),
           ("open_material_demo", "material_demo_open"))
WEAK = 1e-2


def fractions(params, static, size: int, spp: int, bounces: int):
    """(alive, weak): per-bounce fractions over `spp` samples of the scene
    at size², as float64 tensors on params' device."""
    device = params.device
    scene = unflatten(params, static)
    ii, jj = integrator.pixel_grid(size, size, 0, device)
    alive = torch.zeros(bounces, dtype=torch.float64, device=device)
    weak = torch.zeros(bounces, dtype=torch.float64, device=device)
    with torch.no_grad():
        for s in range(spp):
            noise = PixelNoise(0, s, ii, jj)
            jx, jy, _ = noise.uniform3(0, TAG_PIXEL_JITTER)
            ro, rd = rays_for_pixels(scene.camera, ii.float(), jj.float(),
                                     size, size, jx, jy)
            a, w = integrator.alive_fractions(scene, static, ro, rd, noise,
                                              bounces, WEAK)
            alive += a.double()
            weak += w.double()
    return alive / spp, weak / spp


def compaction_bounds(alive: list, weak: list) -> tuple:
    """(bound, bound with Russian roulette): bounces over the paths doing
    work at each bounce."""
    useful = [1.0] + alive[:-1]
    useful_rr = [1.0] + [max(a - w, 0.0) for a, w in zip(alive[:-1],
                                                         weak[:-1])]
    return len(alive) / sum(useful), len(alive) / sum(useful_rr)


def run(size: int = 128, spp: int = 4, bounces: int = 5,
        device="cuda") -> dict:
    device = torch.device(device)
    out = {}
    for key, name in CONFIGS:
        params, static = getattr(scenes, name)().pack()
        alive, weak = (t.tolist() for t in fractions(
            params.to(device), static, size, spp, bounces))
        bound, bound_rr = compaction_bounds(alive, weak)
        out[key] = {"alive": alive, "weak": weak,
                    "perfect_compaction_bound": bound,
                    "with_rr_bound": bound_rr}
    return {"metric": "per-bounce path occupancy / compaction bound",
            "config": f"{size}x{size} x{spp}spp x{bounces}b",
            "device": (torch.cuda.get_device_name(0) if device.type ==
                       "cuda" else "cpu"),
            "scenes": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: give --device cpu to run on the "
                           "CPU")
    out = run(args.size, args.spp, args.bounces, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
