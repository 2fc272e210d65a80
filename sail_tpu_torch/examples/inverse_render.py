"""Inverse rendering demo (the counterpart of the repo's
`examples/inverse_render.py`): recover material and emitter parameters
from a target image by gradient descent through the path tracer.

It renders a target with the true scene, dims the lamp and darkens the
mirror, then fits them back with `diff.inverse.optimize`: each step one
`render_sharded` (K1 forward, K2 backward on the card) plus the edge
terms.

    python -m sail_tpu_torch.examples.inverse_render --size 128 --spp 8 \\
        --steps 60
"""
import argparse
import os

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.diff.inverse import optimize
from sail_tpu_torch.parallel.mesh import make_mesh
from sail_tpu_torch.parallel.render_sharded import render_sharded
from sail_tpu_torch.scene.scene import leaf_paths
from sail_tpu_torch.utils.device import resolve
from sail_tpu_torch.utils.imageio import write_png


def perturb(params: torch.Tensor, static) -> torch.Tensor:
    """The lamps' emission × 0.5 and the kr of every material with a kr
    and no kt (mirror and metal, not glass) × 0.4."""
    paths = leaf_paths(static)
    out = params.clone()
    for i, key in enumerate(paths):
        head = key.rsplit(".", 1)[0]
        if key.startswith(".lights") and ".emission" in key:
            out[i] = params[i] * 0.5
        elif (key.startswith(".materials") and key.endswith(".kr")
              and f"{head}.kt" not in paths):
            out[i] = params[i] * 0.4
    return out


def trainable(key: str) -> bool:
    return ".materials" in key or ".lights" in key


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--out", default=".")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve(args.device, "inverse_render")
    params, static = scenes.cornell_mirror().pack()
    params = params.to(dev)
    mesh = make_mesh(1, device=dev)
    n = args.size
    with torch.no_grad():
        target = render_sharded(params, static, mesh, n, n, args.spp, seed=0,
                                max_bounces=args.bounces)
    perturbed = perturb(params, static)

    losses = []
    result = optimize(perturbed, target, static, mesh, n, n, args.spp,
                      steps=args.steps, learning_rate=args.lr,
                      trainable=trainable, max_bounces=args.bounces,
                      callback=lambda i, loss, p: losses.append(loss))

    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f} ({args.steps} steps)")
    paths = leaf_paths(static)
    for key in paths:
        if key.startswith(".lights") and key.endswith(".emission.x"):
            i = paths.index(key)
            print(f"light {key.split(']')[0].split('[')[1]} emission: true "
                  f"{float(params[i]):.3f} recovered "
                  f"{float(result.params[i]):.3f}")

    with torch.no_grad():
        img0 = render_sharded(perturbed, static, mesh, n, n, args.spp,
                              seed=0, max_bounces=args.bounces)
        img1 = render_sharded(result.params, static, mesh, n, n, args.spp,
                              seed=0, max_bounces=args.bounces)
    os.makedirs(args.out, exist_ok=True)
    for name, img in (("target", target), ("initial", img0),
                      ("recovered", img1)):
        write_png(os.path.join(args.out, f"inverse_{name}.png"),
                  img.stack().cpu().numpy())
    print(f"wrote {args.out}/inverse_{{target,initial,recovered}}.png")
    return {"losses": losses, "params": result.params, "true": params,
            "start": perturbed}


if __name__ == "__main__":
    main()
