"""The benchmark of `sail_tpu_torch`, the PyTorch and CUDA path tracer, on
NVIDIA GPUs.

One run is one cell (`workloads/<cell>.json`: a configuration under a
traffic mix) measured once:

    python3 perfbench/run.py --workload cornell_mirror.fwdbwd --seed 7 \\
        --seconds 10 --trace 0

Everything is found by name: `configs/<config>.json` (the scene as data),
`traffic/<mix>.json` (the loop and its sizes), `loops/<loop>.py` (the
general code that drives a kind of traffic and checks it),
`end_to_end/<metric>.py` and `layer_metrics/<metric>.py` (one reader a
metric), and `BENCHMARK.json` at the root (which metrics a cell reports).
`reference/` is the plain reference the outputs are held against; it
imports nothing of the program.
"""
