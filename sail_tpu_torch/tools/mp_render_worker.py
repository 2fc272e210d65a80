"""One process of a multi-process sharded render (the counterpart of the
repo's `tools/mp_render_worker.py`).

Each process joins a torch.distributed process group at `--coordinator`
(NCCL for `--device cuda`, gloo for `--device cpu`), holds
`--local-devices` ranks on its device, and renders `cornell_matte` over a
mesh spanning every process's ranks (`parallel/mesh.py` +
`parallel/render_sharded.py`).  The gathered image is held against a
one-rank render in this process.  With `--grad` it also writes the flat
gradient of `sharded_value_and_grad` toward a target image, and with
`--bench-iters` times repeated renders.  Prints (and with `--out` writes)
one JSON object; exits non-zero unless `ok`.

    python -m sail_tpu_torch.tools.mp_render_worker --process-id 0 \\
        --num-processes 2 --coordinator 127.0.0.1:29500 --device cpu \\
        --local-devices 2 --size 16 --spp 2 --bounces 2   # and --process-id 1
"""
import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--local-devices", type=int, default=2,
                    help="ranks in this process")
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--spp-axis", type=int, default=None)
    ap.add_argument("--grad", action="store_true",
                    help="also write sharded_value_and_grad's gradient")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait")
    ap.add_argument("--out", default=None,
                    help="write the JSON result here (every process)")
    ap.add_argument("--bench-iters", type=int, default=0,
                    help="also time repeated renders")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)

    import torch.distributed as dist

    from sail_tpu_torch import scenes
    from sail_tpu_torch.parallel.mesh import (global_ranks,
                                              initialize_distributed,
                                              make_mesh)
    from sail_tpu_torch.parallel.render_sharded import (
        render_sharded, sharded_value_and_grad)

    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id,
                           backend="gloo" if args.device == "cpu" else "nccl",
                           timeout=args.timeout)
    try:
        local = ([args.device] if args.device == "cpu"
                 else [f"cuda:{j}" for j in range(torch.cuda.device_count())])
        local = (local * args.local_devices)[:args.local_devices]
        mesh = make_mesh(devices=global_ranks(local), spp_axis=args.spp_axis)
        one = make_mesh(device=mesh.device)
        params, static = scenes.cornell_matte().pack()
        params = params.to(mesh.device)
        h = w = args.size
        kw = dict(seed=0, max_bounces=args.bounces)
        full = render_sharded(params, static, mesh, h, w, args.spp, **kw)
        single = render_sharded(params, static, one, h, w, args.spp, **kw)
        diff = float((full.stack() - single.stack()).abs().max())
        result = {
            "process_id": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "global_devices": mesh.size,
            "mesh": mesh.shape,
            "backend": dist.get_backend(),
            "max_abs_diff_vs_single": diff,
            "bit_identical_vs_single": bool(torch.equal(full.stack(),
                                                        single.stack())),
            "ok": diff < 1e-5,
        }
        if args.grad:
            # from a perturbed scene toward the true one's image
            loss, grad = sharded_value_and_grad(params * 1.02, full, static,
                                                mesh, h, w, args.spp, **kw)
            result["loss"] = float(loss)
            result["grad"] = grad.cpu().tolist()
            result["ok"] = result["ok"] and bool(torch.isfinite(grad).all())
        if args.bench_iters:
            def run(seed):
                img = render_sharded(params, static, mesh, h, w, args.spp,
                                     seed=seed, max_bounces=args.bounces)
                return float(img.x.sum())   # readback: a barrier

            run(1)
            dist.barrier()
            t0 = time.perf_counter()
            for i in range(args.bench_iters):
                run(2 + i)
            dist.barrier()
            dt = time.perf_counter() - t0
            rays = h * w * args.spp * args.bounces * 2 * args.bench_iters
            result["seconds"] = dt
            result["mrays_per_s"] = rays / dt / 1e6
    finally:
        dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps({k: v for k, v in result.items() if k != "grad"}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
