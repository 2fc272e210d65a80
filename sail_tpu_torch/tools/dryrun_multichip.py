"""The full sharded inverse-rendering train step on an n-rank mesh at a
tiny size (the counterpart of `__graft_entry__.dryrun_multichip`): the
interior step at 2 bounces, then one step with the edge terms on (1
bounce, 16 edge samples, 8 noise passes split over the ranks, 8 curve
samples), each from a scene perturbed by 2% toward the true one's image.
The loss must be finite and positive and every parameter finite.

    python -m sail_tpu_torch.tools.dryrun_multichip --ranks 8 --device cpu
    python -m sail_tpu_torch.tools.dryrun_multichip --ranks 8   # the cards
"""
import argparse
import sys

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.parallel.mesh import make_mesh
from sail_tpu_torch.parallel.render_sharded import (make_train_step,
                                                    render_sharded)
from sail_tpu_torch.utils.device import resolve


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One interior and one edge-term train step of `cornell_mirror` on
    `n_devices` ranks: on `device` (the CPU if asked), else round robin
    over this process's cards.  Returns the mesh and both losses; raises
    if a loss is not finite and positive or a parameter not finite."""
    dev = resolve(device, "dryrun_multichip")
    if device is None:
        devices = [torch.device("cuda", i % torch.cuda.device_count())
                   for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    mesh = make_mesh(n_devices, devices=devices)
    params, static = scenes.cornell_mirror().pack()
    params = params.to(mesh.device)
    height = width = max(8 * mesh.n_tile, 16)
    spp = mesh.n_spp      # one sample per spp shard
    losses = []
    for bounces, edge in ((2, None), (1, dict(n_edge_samples=16, n_noise=8,
                                               n_curve_samples=8))):
        target = render_sharded(params, static, mesh, height, width, spp,
                                max_bounces=bounces)
        start = (params * 1.02).requires_grad_()
        step = make_train_step(static, mesh, height, width, spp,
                               torch.optim.Adam([start], lr=1e-2),
                               max_bounces=bounces, boundary=edge is not None,
                               **(edge or {}))
        loss = float(step(target))
        if not (loss > 0 and torch.isfinite(torch.tensor(loss))
                and torch.isfinite(start).all()):
            raise AssertionError(f"dryrun_multichip({n_devices}): loss "
                                 f"{loss}, finite parameters "
                                 f"{bool(torch.isfinite(start).all())}")
        losses.append(loss)
        print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} "
              f"img={height}x{width} spp={spp} bounces={bounces} "
              f"boundary={edge is not None} loss={loss:.6f} OK", flush=True)
    return dict(mesh=mesh.shape, size=height, spp=spp, loss=losses[0],
                loss_boundary=losses[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the cards)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
