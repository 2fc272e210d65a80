"""BASELINE config 5 on the card: recover a BSDF, an emitter and one
geometry parameter from a target image with the boundary edge terms on
(the counterpart of the repo's `tools/inverse_artifact.py`).

Scene `cornell_mirror`; perturbations, as the JAX tool's:
  - the mirror's kr          1.0  -> 0.45  (BSDF)
  - the lamp's emission      5.0  -> 3.0   (emitter)
  - the matte sphere's cx    0.45 -> 0.58  (geometry: needs the boundary
    term, as autograd alone is biased across the silhouette's sweep)

The loss and its interior gradient run K1 and K2 through the one-rank
train step; the edge terms run in torch on the same device.  Writes a JSON
record (loss curve, true / perturbed / recovered, seconds per step, peak
memory, the card's name and power limit).

    python -m sail_tpu_torch.tools.inverse_artifact --size 512 --steps 500 \\
        --lr 0.025
    python -m sail_tpu_torch.tools.inverse_artifact --device cpu --size 16 \\
        --spp 2 --bounces 2 --steps 5 --out /tmp/inverse.json
"""
import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

# the JAX tool's perturbations, by `leaf_paths` key
PERTURBED = {".materials[1].kr": 0.45, ".lights[0].emission.x": 3.0,
             ".lights[0].emission.y": 3.0, ".lights[0].emission.z": 3.0,
             ".objects[2].center.x": 0.58}


def trainable(key: str) -> bool:
    """The lights, every kr and the matte sphere's (object 2's) center.
    The matte kd stays frozen: emission × kd is all a matte surface shows,
    so fitting both lands on an equivalent pair, not the true one."""
    if ".lights" in key:
        return True
    if ".materials" in key and ".kr" in key:
        return True
    return ".objects" in key and "[2]" in key and ".center" in key


def card_name(device: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or the device."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "constant"],
                    help="cosine: the learning rate decays to 0 over the "
                         "steps (optax.cosine_decay_schedule's formula); a "
                         "constant one oscillates in the valley left once "
                         "kr clips at 1, where the loss is flat in kr")
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu: the plain versions)")
    ap.add_argument("--out", default="chiprun_out/INVERSE_h100.json")
    args = ap.parse_args(argv)

    from sail_tpu_torch import scenes
    from sail_tpu_torch.diff.inverse import optimize
    from sail_tpu_torch.parallel.mesh import make_mesh
    from sail_tpu_torch.parallel.render_sharded import render_sharded
    from sail_tpu_torch.scene.scene import leaf_paths

    t_start = time.time()
    params, static = scenes.cornell_mirror().pack()
    mesh = make_mesh(1, device=args.device)
    dev = mesh.device
    H = W = args.size
    with torch.no_grad():
        target = render_sharded(params, static, mesh, H, W, args.spp, seed=0,
                                max_bounces=args.bounces)

    paths = leaf_paths(static)
    at = {k: paths.index(k) for k in PERTURBED}
    true = {k: float(params[i]) for k, i in at.items()}
    start = params.clone()
    for k, v in PERTURBED.items():
        start[at[k]] = v

    losses, times = [], []
    last = [time.time()]

    def callback(i, loss, p):
        now = time.time()
        times.append(now - last[0])
        last[0] = now
        losses.append(loss)
        if i % 10 == 0:
            print(f"step {i:3d} loss {loss:.6g} ({times[-1]:.2f}s)",
                  flush=True)

    scheduler = None
    if args.schedule == "cosine":
        def scheduler(opt):
            return torch.optim.lr_scheduler.CosineAnnealingLR(
                opt, T_max=args.steps, eta_min=0.0)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_opt0 = time.time()
    result = optimize(start, target, static, mesh, H, W, args.spp,
                      steps=args.steps, learning_rate=args.lr,
                      scheduler=scheduler, trainable=trainable,
                      max_bounces=args.bounces, boundary=True,
                      callback=callback)
    t_opt = time.time() - t_opt0
    rec = {k: float(result.params[i]) for k, i in at.items()}

    kr = rec[".materials[1].kr"]
    table = {
        "mirror_kr": {"true": true[".materials[1].kr"], "perturbed": 0.45,
                      "recovered": kr, "recovered_effective": min(kr, 1.0),
                      "note": "the specular weight is clipped at 1, so "
                              "every kr >= 1 gives the same image and a "
                              "zero gradient"},
        "lamp_emission": {"true": true[".lights[0].emission.x"],
                          "perturbed": 3.0,
                          "recovered": rec[".lights[0].emission.x"]},
        "matte_sphere_cx": {"true": true[".objects[2].center.x"],
                            "perturbed": 0.58,
                            "recovered": rec[".objects[2].center.x"]},
    }
    steady = times[2:] if len(times) > 2 else times
    out = {
        "metric": "config-5 inverse rendering (boundary ON)",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "card": card_name(dev),
        "torch": torch.__version__,
        "config": f"{H}x{W}, spp {args.spp}, bounces {args.bounces}, "
                  f"{args.steps} steps, adam lr {args.lr} "
                  f"({args.schedule} schedule)",
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_curve_every5": losses[::5],
        "recovered": table,
        "s_per_step_median": float(np.median(steady)),
        "s_per_step_first": times[0],
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 2**30
                           if dev.type == "cuda" else None),
        "wall_total_s": time.time() - t_start,
        "optimize_s": t_opt,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k != "loss_curve_every5"}, indent=1))


if __name__ == "__main__":
    main()
