"""Scaling-efficiency harness (the counterpart of the repo's
`tools/scaling_efficiency.py`): the rays/s of a sharded render at 1
process and at N, each process the port's worker
(`sail_tpu_torch/tools/mp_render_worker.py --bench-iters`) holding
`--local-devices` ranks, and

    efficiency = mrays/s(N processes) / (N * mrays/s(1 process)).

`--device cuda` (the default) runs one process per card, joined by NCCL,
each seeing only its own card; it needs N cards.  `--device cpu` runs gloo
processes, each pinned to one core (as the JAX tool's emulated hosts), so
that the one-process baseline does not get the whole machine.  On a host
with one card, runs of more than one process are the CPU's.

    python -m sail_tpu_torch.tools.scaling_efficiency --device cpu \\
        --procs 2 --size 16 --spp 2
"""
import argparse
import json
import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = "sail_tpu_torch.tools.mp_render_worker"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(n_procs: int, device: str, local_devices: int, size: int,
              spp: int, bounces: int, iters: int, timeout: float = 900.0):
    """Start `n_procs` workers on a fresh localhost port and return process
    0's JSON result; raises if any worker fails."""
    port = _free_port()
    ncpu = os.cpu_count() or 1
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        prefix = []
        if device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(pid)
        elif n_procs <= ncpu:
            # one core each: else the 1-process baseline's threads span
            # the machine while each of N processes gets 1/N of it
            prefix = ["taskset", "-c", str(pid % ncpu)]
        procs.append(subprocess.Popen(
            prefix + [sys.executable, "-m", WORKER,
                      "--process-id", str(pid),
                      "--num-processes", str(n_procs),
                      "--coordinator", f"127.0.0.1:{port}",
                      "--device", device,
                      "--local-devices", str(local_devices),
                      "--size", str(size), "--spp", str(spp),
                      "--bounces", str(bounces),
                      "--bench-iters", str(iters)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO))
    results, failed = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                failed.append(f"worker exited {p.returncode}:\n"
                              f"{out[-2000:]}\n{err[-4000:]}")
            else:
                results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return results[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < args.procs:
            print(f"--device cuda runs one process per card: {args.procs} "
                  f"processes need {args.procs} cards, this host has {cards}"
                  f" (--device cpu runs them as gloo processes)",
                  file=sys.stderr)
            return 2

    shape = (args.size, args.spp, args.bounces, args.iters)
    one = run_group(1, args.device, args.local_devices, *shape)
    many = run_group(args.procs, args.device, args.local_devices, *shape)
    eff = many["mrays_per_s"] / (args.procs * one["mrays_per_s"])
    if args.device == "cuda":
        note = (f"{args.procs} processes, one card each (NCCL), "
                f"{args.local_devices} ranks on each card")
    else:
        note = ("gloo processes on the CPU, each pinned to one core (emulated "
                "hosts); on a host with one card, runs of more than one "
                "process are the CPU's")
    print(json.dumps({
        "metric": f"rays/s scaling efficiency 1->{args.procs} processes",
        "value": round(eff, 4),
        "unit": "fraction",
        "target": 0.85,
        "pass": eff >= 0.85,
        "detail": {
            "mrays_1proc": round(one["mrays_per_s"], 3),
            f"mrays_{args.procs}proc": round(many["mrays_per_s"], 3),
            "device": args.device,
            "local_devices": args.local_devices,
            "config": f"{args.size}^2 x {args.spp}spp x {args.bounces}b "
                      f"x {args.iters}it",
            "note": note,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
