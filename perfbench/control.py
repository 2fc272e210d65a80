"""The control of a cell's check: the reference computed in bfloat16, put
in the program's place, held against the float32 reference at the cell's
own size; each seed's numbers on one line.  The smallest of them over the
seeds is the upper reading a limit has to stay below.

    python3 -m perfbench.control --workload cornell_mirror.fwdbwd \\
        --seeds 11,12,13
"""
import argparse
import json
import sys
import time

from perfbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    loop_class = harness.loop_class(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        readings = loop_class(cell, seed, torch.device("cuda", 0)).control()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": dict(readings),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
