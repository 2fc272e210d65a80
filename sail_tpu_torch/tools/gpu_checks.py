"""On-card correctness checks: the CUDA kernels against the plain torch
version on the GPU (the counterpart of the repo's `tools/tpu_checks.py`).

The CPU tests run the plain version only (a kernel has no interpreter);
this is the short, reproducible command that runs the kernels themselves.
It prints one JSON line with `tpu_checks.py`'s keys, `"device"` the card's
name, and exits non-zero unless every check passes.  It refuses to run
without CUDA.

    python -m sail_tpu_torch.tools.gpu_checks [--size 128 --spp 2 --bounces 5]

Checks, on `cornell_mirror`:
  1. forward bit-equality: K1 (`render_block`) against its plain version;
  2. gradient parity: K2 (`render_grad_block`) against autograd through the
     plain version, relative L-inf over the parameters < 1e-5;
  3. `render_sharded` on a one-rank mesh against K1's image (< 1e-6);
  4. the sharded gradient (autograd of `sharded_loss`: K1 forward, K2
     backward) against autograd of the same loss through the plain
     version, relative L-inf < 1e-4.
"""
import argparse
import json
import sys
import time

import torch


def run(size: int = 128, spp: int = 2, bounces: int = 5,
        device=None) -> dict:
    """The four checks on `device` (the first card by default; on a CPU
    tensor the wrappers run the plain version, which checks only this
    script); the JSON object `main` prints."""
    from sail_tpu_torch import scenes
    from sail_tpu_torch.core.vecmath import Vec3
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.parallel.mesh import make_mesh
    from sail_tpu_torch.parallel.render_sharded import (render_sharded,
                                                        sharded_loss)
    from sail_tpu_torch.render.integrator import render_image
    from sail_tpu_torch.scene.scene import unflatten

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    h = w = size
    params, static = scenes.cornell_mirror().pack()
    params = params.to(dev)
    t0 = time.time()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    # 1. forward bit-equality -----------------------------------------------
    a = mk.render_block(params, static, h, w, spp, 0, 0, bounces).stack()
    b = mk.render_block_plain(params, static, h, w, spp, 0, 0,
                              bounces).stack()
    fwd_bits_equal = bool(torch.equal(a, b))
    fwd_max_diff = float((a - b).abs().max())

    # 2. gradient parity at a smaller block, 1 spp: L = mean over pixels of
    # (x + y + z), so each channel's adjoint is 1/(gh·gw) ------------------
    gh = gw = min(size, 64)
    g = torch.full((gh, gw), 1.0 / (gh * gw), device=dev)
    gv = Vec3(g, g, g)
    g_k2 = mk.render_grad_block(params, static, gv, gh, gw, 1, 0, 0, bounces)
    g_plain = mk.render_grad_block_plain(params, static, gv, gh, gw, 1, 0, 0,
                                         bounces)
    grad_rel_err = rel(g_k2, g_plain)

    # 3. the sharded path on a one-rank mesh ------------------------------
    mesh = make_mesh(1, device=dev)
    s = render_sharded(params, static, mesh, h, w, spp, seed=0,
                       max_bounces=bounces).stack()
    k1_img = a * (1.0 / spp)
    sharded_bits_equal = bool(torch.equal(s, k1_img))
    sharded_max_diff = float((s - k1_img).abs().max())

    # 4. the sharded gradient against the plain one -----------------------
    zeros = torch.zeros((gh, gw), device=dev)
    target = Vec3(zeros, zeros, zeros)
    p = params.detach().clone().requires_grad_()
    (g_sh,) = torch.autograd.grad(
        sharded_loss(p, target, static, mesh, gh, gw, 1, 0, bounces), p)
    q = params.detach().clone().requires_grad_()
    img = render_image(unflatten(q, static), static, gh, gw, 1, seed=0,
                       max_bounces=bounces)
    loss = (torch.sum(img.x ** 2) + torch.sum(img.y ** 2)
            + torch.sum(img.z ** 2)) / (gh * gw * 3)
    (g_pl,) = torch.autograd.grad(loss, q)
    sharded_grad_rel = rel(g_sh, g_pl)

    ok = (fwd_bits_equal and grad_rel_err < 1e-5
          and sharded_max_diff < 1e-6 and sharded_grad_rel < 1e-4)
    return {
        "metric": "on-card cuda-vs-plain checks",
        "value": 1 if ok else 0,
        "unit": "pass",
        "ok": ok,
        "fwd_bits_equal": fwd_bits_equal,
        "fwd_max_abs_diff": fwd_max_diff,
        "grad_rel_linf": grad_rel_err,
        "sharded_bits_equal": sharded_bits_equal,
        "sharded_max_abs_diff": sharded_max_diff,
        "sharded_grad_rel_linf": sharded_grad_rel,
        "config": f"{h}x{w} x{spp}spp x{bounces}b (grads {gh}x{gw})",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "seconds_total": round(time.time() - t0, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpu_checks must run on a CUDA card: on the CPU only the plain "
              "version runs, which proves nothing about the kernels",
              file=sys.stderr)
        return 2
    result = run(args.size, args.spp, args.bounces)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
