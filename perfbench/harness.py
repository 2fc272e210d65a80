"""The general part of a run: find the cell's files by name, set the loop
up, measure the window, trace a sub-window, read the metrics, check the
outputs against the reference, and print the result line.

A cell is `workloads/<cell>.json`; it names its configuration
(`configs/<config>.json`) and its traffic (`traffic/<traffic>.json`),
whose `loop` names the code that drives it (`loops/<loop>.py`, a class
`Loop`).  The metrics a cell reports are the entries of `BENCHMARK.json`
that list it (or list no cells); each is read by `end_to_end/<name>.py` or
`layer_metrics/<name>.py`, a function `read(window)` that returns a number
or None (then the metric is left out)."""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names a run may never load
FORBIDDEN = ("jax", "jaxlib", "flax", "sail_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file `path` as a fresh module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` with its configuration, traffic and the metrics
    `BENCHMARK.json` has it report: {"name", "workload", "config",
    "traffic", "end_to_end", "per_layer", "root"}."""
    bench = os.path.join(root, "perfbench")
    workload = load_json(os.path.join(bench, "workloads", f"{name}.json"))
    config = load_json(os.path.join(bench, "configs",
                                    f"{workload['config']}.json"))
    traffic = load_json(os.path.join(bench, "traffic",
                                     f"{workload['traffic']}.json"))
    spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(name=name, workload=workload, config=config, traffic=traffic,
                end_to_end=mine(spec["end_to_end"]),
                per_layer=mine(spec["per_layer"]), root=root)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one a run may not load,
    compared whole (`sail_tpu_torch` is not `sail_tpu`)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Window:
    """What readers read: the set-up time, the measured units (each a dict
    with its start `t0` and end `t1` in seconds from the window's start,
    and what the loop recorded), the spans by name (seconds), the cell,
    and the traced sub-window (`profile`, or None)."""

    def __init__(self, cell, setup_s, units, spans, profile):
        self.cell = cell
        self.setup_s = setup_s
        self.units = units
        self.spans = spans
        self.profile = profile

    @property
    def seconds(self) -> float:
        """The window: from its start to the end of its last unit."""
        return self.units[-1]["t1"]

    @property
    def work(self) -> dict:
        """The frozen work counts of the cell's data."""
        return self.cell["workload"].get("work", {})


class Spans:
    """Host-clock spans the loops record around calls into the program,
    each also a profiler range `perfbench.<name>` (which names the host's
    work in a traced run's idle gaps)."""

    def __init__(self):
        self.times = {}

    def __call__(self, name: str):
        return _Span(name, self.times.setdefault(name, []))


class _Span:
    def __init__(self, name: str, out: list):
        import torch
        self.range = torch.profiler.record_function(f"perfbench.{name}")
        self.out = out

    def __enter__(self):
        self.range.__enter__()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        self.out.append(time.perf_counter() - self.t)
        self.range.__exit__(*exc)


def _synchronize(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _units(loop, n, seconds, spans, t_start, device, out):
    """Run units until `n` have run or `seconds` have passed since
    `t_start`, each timed on the host clock to its synchronize."""
    while True:
        rec = {}
        u0 = time.perf_counter()
        loop.unit(rec, spans)
        _synchronize(device)
        u1 = time.perf_counter()
        rec.update(t0=u0 - t_start, t1=u1 - t_start)
        out.append(rec)
        if (n is not None and len(out) >= n) or (
                seconds is not None and u1 - t_start >= seconds):
            return out


def traced(loop, n_units, spans, device, out_path):
    """`n_units` units under torch.profiler; the profile's device and host
    events and its window (the span `perfbench.traced`, which ends after a
    synchronize)."""
    import torch
    from . import devtrace
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("perfbench.traced"):
            units = _units(loop, n_units, None, spans, time.perf_counter(),
                           device, [])
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        prof.export_chrome_trace(out_path)
    return devtrace.Profile(prof.events(), len(units))


def loop_class(cell: dict):
    """The class `Loop` of the cell's traffic's loop."""
    loop = cell["traffic"]["loop"]
    return load_module(os.path.join(cell["root"], "perfbench", "loops",
                                    f"{loop}.py"), f"perfbench_loop_{loop}").Loop


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             log=sys.stderr) -> dict:
    """One run of `cell`: the result line's object."""
    import torch
    traffic = cell["traffic"]
    loop = loop_class(cell)(cell, seed, torch.device(device))
    loop.setup()
    _synchronize(device)
    # what set-up made stays for the run: the collector's full passes in
    # the window then walk only what the window makes
    gc.collect()
    gc.freeze()
    spans = Spans()
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    units = _units(loop, None, seconds, spans, t_start, device, [])
    profile = None
    if trace:
        out = os.path.join(cell["root"], "perfbench", "out",
                           f"{cell['name']}.trace.json")
        profile = traced(loop, traffic["trace_units"], Spans(), device,
                         out if device != "cpu" else None)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    window = Window(cell, setup_s, units, spans.times, profile)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        kind = "layer_metrics" if trace else "end_to_end"
        reader = load_module(
            os.path.join(cell["root"], "perfbench", kind, f"{m['name']}.py"),
            f"perfbench_{kind}_{m['name'].replace('.', '_')}")
        value = reader.read(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    loop.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = loop.check()
    check_s = time.perf_counter() - t_check
    limits = cell["workload"].get("limits", {})
    checks = {}
    for name, value in readings:
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] == c["value"]
        and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(units), "failed": 0,
              "metrics": metrics, "device": _device(device, peak, profile)}
    if profile is not None:
        result["breakdown"] = profile.breakdown()
    print(f"setup {setup_s:.3f} s, window {window.seconds:.3f} s, "
          f"{len(units)} units, check {check_s:.3f} s", file=log)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=log)
    result["checks"] = checks
    return result


def _device(device, peak, profile) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if profile is not None:
        out["busy_s"] = profile.busy_s
        out["window_s"] = profile.window_s
    return out


def main(argv, t_process: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_process)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded modules it may not: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    return 0

