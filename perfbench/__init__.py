"""The benchmark of `sail_tpu_torch`, the PyTorch and CUDA path tracer, on
NVIDIA GPUs.

One run is one cell (`workloads/<cell>.json`: a configuration under a
traffic mix) measured once:

    python3 perfbench/run.py --workload cornell_mirror.fwdbwd --seed 7 \\
        --seconds 10 --trace 0

Everything is found by name: `configs/<config>.json` (the scene as data),
`traffic/<mix>.json` (the loop and its sizes, and under `tiny` the sizes
the CPU tests run), `loops/<loop>.py` (the general code that drives a kind
of traffic and checks it, and any faults of its own beside `faults.py`'s),
`end_to_end/<metric>.py` and `layer_metrics/<metric>.py` (one reader a
metric), and `BENCHMARK.json` at the root (which metrics a cell reports).
`reference/` is the plain reference the outputs are held against; it
imports nothing of the program.  A cell on more than one card runs as one
process a card, rank 0 printing the result (`harness.launch`).
"""
