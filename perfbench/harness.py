"""The general part of a run: find the cell's files by name, set the loop
up, measure the window, trace a sub-window, read the metrics, check the
outputs against the reference, and print the result line.

A cell is `workloads/<cell>.json`; it names its configuration
(`configs/<config>.json`) and its traffic (`traffic/<traffic>.json`),
whose `loop` names the code that drives it (`loops/<loop>.py`, a class
`Loop`).  The metrics a cell reports are the entries of `BENCHMARK.json`
that list it (or list no cells); each is read by `end_to_end/<name>.py` or
`layer_metrics/<name>.py`, a function `read(window)` that returns a number
or None (then the metric is left out).

A cell on k > 1 cards runs as k processes, one a card, laid out as torchrun
lays out a one-host job (`launch`): the process the command started
supervises them, and rank 0 alone prints the result line."""
from __future__ import annotations

import argparse
import collections
import datetime
import gc
import importlib.util
import json
import os
import selectors
import signal
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names a run may never load
FORBIDDEN = ("jax", "jaxlib", "flax", "sail_tpu")
# a multi-card run's allowances, in seconds: set-up (the first run of a cell
# in a checkout compiles), then, after the window, the traced units, the
# readers and rank 0's check.  No wait of the run outlasts their sum.
SETUP_ALLOWANCE_S = 1080
AFTER_WINDOW_S = 300
# the lines of a failing rank's standard error repeated at the end
TAIL_LINES = 20


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


def _units(loop, n, seconds, spans, t_start, device, out, lockstep=None):
    """Run units until `n` have run or `seconds` have passed since
    `t_start`, each timed on the host clock to its synchronize; in a
    multi-card run until rank 0's `lockstep` says stop."""
    while True:
        rec = {}
        u0 = time.perf_counter()
        loop.unit(rec, spans)
        _synchronize(device)
        u1 = time.perf_counter()
        rec.update(t0=u0 - t_start, t1=u1 - t_start)
        out.append(rec)
        stop = (n is not None and len(out) >= n) or (
            seconds is not None and u1 - t_start >= seconds)
        if lockstep is not None:
            stop = lockstep.after(len(out), stop)
        if stop:
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


def loop_module(cell: dict):
    """The module of the cell's traffic's loop, `loops/<loop>.py`."""
    loop = cell["traffic"]["loop"]
    return load_module(os.path.join(cell["root"], "perfbench", "loops",
                                    f"{loop}.py"), f"perfbench_loop_{loop}")


def loop_class(cell: dict):
    """The class `Loop` of the cell's traffic's loop."""
    return loop_module(cell).Loop


class Lockstep:
    """A multi-card run's host-side store (a TCPStore on a port of its own,
    which rank 0 serves; not the program's process group): after each
    window unit rank 0 posts whether another follows, and each peer waits
    for that word, so every process runs as many units as rank 0.  After
    the traced units each peer posts its unit count and memory peak, and
    leaves once rank 0 has read them all."""

    def __init__(self, rank: int, world: int, port: int, timeout: float):
        from torch.distributed import TCPStore
        self.rank, self.world = rank, world
        self.store = TCPStore("127.0.0.1", port, world, is_master=rank == 0,
                              timeout=datetime.timedelta(seconds=timeout),
                              wait_for_workers=False)
        self.post_s = 0.0

    def after(self, i: int, stop: bool) -> bool:
        """Whether the window stops after unit `i`: rank 0's `stop`,
        posted; on a peer, what rank 0 posted."""
        if self.rank:
            return self.store.get(f"unit.{i}") == b"stop"
        t = time.perf_counter()
        self.store.set(f"unit.{i}", "stop" if stop else "go")
        self.post_s += time.perf_counter() - t
        return stop

    def report(self, units: int, peak: int):
        """A peer's count and peak; returns once rank 0 has read them."""
        self.store.set(f"peer.{self.rank}",
                       json.dumps({"units": units, "peak": peak}))
        self.store.get("done")

    def gather(self, units: int, peak: int, log) -> int:
        """Rank 0: the largest memory peak of the processes; raises where a
        peer ran another number of units than rank 0."""
        print(f"rank 0: {units} units, peak {peak} B", file=log)
        peaks = [peak]
        for r in range(1, self.world):
            peer = json.loads(self.store.get(f"peer.{r}"))
            print(f"rank {r}: {peer['units']} units, peak "
                  f"{peer['peak']} B", file=log)
            if peer["units"] != units:
                raise RuntimeError(f"rank {r} ran {peer['units']} units, "
                                   f"rank 0 {units}")
            peaks.append(peer["peak"])
        self.store.set("done", "1")
        print(f"lock step: {self.post_s / units * 1e3:.4f} ms a window unit "
              f"on rank 0's host", file=log)
        return max(peaks)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             log=sys.stderr, rank: int = 0, world: int = 1,
             lockstep: Lockstep | None = None) -> dict | None:
    """One run of `cell`: the result line's object.  In a multi-card run
    this is the process of rank `rank` of `world`, kept in step with the
    others by `lockstep`; a peer (rank > 0) gives None."""
    import torch
    traffic = cell["traffic"]
    loop = loop_class(cell)(cell, seed, torch.device(device), rank=rank,
                            world=world)
    loop.setup()
    _synchronize(device)
    # what set-up made stays for the run: the collector's full passes in
    # the window then walk only what the window makes
    gc.collect()
    gc.freeze()
    spans = Spans()
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    units = _units(loop, None, seconds, spans, t_start, device, [], lockstep)
    profile = None
    if trace:
        out = os.path.join(cell["root"], "perfbench", "out",
                           f"{cell['name']}.trace.json")
        profile = traced(loop, traffic["trace_units"], Spans(), device,
                         out if torch.device(device).type != "cpu"
                         and rank == 0 else None)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    if rank:
        print(f"setup {setup_s:.3f} s, window {units[-1]['t1']:.3f} s, "
              f"{len(units)} units", file=log)
        lockstep.report(len(units), int(peak))
        loop.release()
        return None
    if lockstep is not None:
        peak = lockstep.gather(len(units), int(peak), log)
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
              "metrics": metrics,
              "device": _device(device, peak, profile, world)}
    if profile is not None:
        result["breakdown"] = profile.breakdown()
    print(f"setup {setup_s:.3f} s, window {window.seconds:.3f} s, "
          f"{len(units)} units, check {check_s:.3f} s", file=log)
    print_checks(checks, log)
    result["checks"] = checks
    return result


def print_checks(checks: dict, log):
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=log)


def _device(device, peak, profile, count=1) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": count, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": count,
               "memory_peak_bytes": 0}
    if profile is not None:
        out["busy_s"] = profile.busy_s
        out["window_s"] = profile.window_s
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent():
    """In a rank's process, before it starts: the kernel kills it when the
    supervisor dies, however that ends (PR_SET_PDEATHSIG)."""
    import ctypes
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)


def launch(cell: dict, seed: int, seconds: float, trace: bool,
           t_process: float, device: str = "cuda", fault: str | None = None,
           out=sys.stdout, err=sys.stderr) -> int:
    """Run a cell of k = `chips` processes, one a card (or, with `device`
    "cpu", k processes on the CPU), and supervise them: rank r gets
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK as torchrun
    sets them, its own card, and the job on its standard input (the cell,
    `fault` to plant, the lock step's port).  Each rank's standard error is
    passed on, line by line, after `[rank r] `; rank 0's standard output
    ends in the result line, which is printed, after the checks, once every
    process has exited 0.  The run ends, killing every process, where one
    exits otherwise or the allowances pass; its exit code is then that
    process's, or 4."""
    world = cell["workload"]["chips"]
    store_port = _free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
    job = json.dumps({"cell": cell, "seed": seed, "seconds": seconds,
                      "trace": trace, "t_process": t_process,
                      "device": device, "fault": fault,
                      "store_port": store_port}).encode()
    deadline = t_process + SETUP_ALLOWANCE_S + seconds + AFTER_WINDOW_S
    procs = []
    try:
        for r in range(world):
            p = subprocess.Popen(
                [sys.executable, os.path.join(cell["root"], "perfbench",
                                              "run.py"), "--rank", str(r)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, cwd=cell["root"],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                preexec_fn=_die_with_parent)
            procs.append(p)
            p.stdin.write(job)
            p.stdin.close()
        failed, stdout0, tails = _supervise(procs, deadline, err)
    finally:
        _stop(procs)
    if failed is None and forbidden_modules():
        failed = "the supervisor loaded " + ", ".join(forbidden_modules())
    lines = stdout0.splitlines()
    if failed is None:
        try:
            result = json.loads(lines[-1])
        except (IndexError, ValueError):
            failed = "rank 0 printed no result line"
    if failed is not None:
        # the last lines of the ranks that failed; past the deadline, of all
        at_fault = [r for r, p in enumerate(procs) if p.returncode > 0] \
            or range(world)
        print(f"the run failed: {failed}", file=err)
        for r in at_fault:
            for line in tails[r]:
                print(f"[rank {r}] {line}", file=err)
        return next((procs[r].returncode for r in at_fault
                     if procs[r].returncode > 0), 4)
    for line in lines[:-1]:
        print(line, file=out)
    print_checks(result["checks"], err)
    err.flush()
    print(lines[-1], file=out)
    out.flush()
    return 0


def _supervise(procs, deadline, err):
    """Pass the ranks' output on until every rank has closed it and exited:
    (None, rank 0's standard output, each rank's last lines of standard
    error), or a reason in place of None where a rank exits otherwise than
    with 0 or the deadline passes."""
    sel = selectors.DefaultSelector()
    for r, p in enumerate(procs):
        sel.register(p.stdout, selectors.EVENT_READ, (r, True))
        sel.register(p.stderr, selectors.EVENT_READ, (r, False))
    partial = {}
    stdout0 = []
    tails = [collections.deque(maxlen=TAIL_LINES) for _ in procs]

    def emit(r, to_stdout, text):
        if r == 0 and to_stdout:
            stdout0.append(text)
            return
        for line in text.splitlines():
            tails[r].append(line)
            print(f"[rank {r}] {line}", file=err, flush=True)

    while True:
        for key, _ in sel.select(timeout=0.2):
            r, to_stdout = key.data
            chunk = os.read(key.fd, 1 << 16)
            if not chunk:
                sel.unregister(key.fileobj)
                rest = partial.pop(key.fd, b"")
                if rest:
                    emit(r, to_stdout, rest.decode(errors="replace"))
                continue
            data = partial.pop(key.fd, b"") + chunk
            head, nl, rest = data.rpartition(b"\n")
            if nl:
                emit(r, to_stdout, head.decode(errors="replace") + "\n")
            partial[key.fd] = rest
        for r, p in enumerate(procs):
            if p.poll() not in (None, 0):
                return f"rank {r} exited with {p.returncode}", "", tails
        if not sel.get_map() and all(p.poll() == 0 for p in procs):
            return None, "".join(stdout0), tails
        if time.perf_counter() > deadline:
            return ("a wait passed the run's deadline "
                    f"({SETUP_ALLOWANCE_S} s of set-up, the window and "
                    f"{AFTER_WINDOW_S} s after it)"), "", tails


def _stop(procs):
    """End every rank still running (SIGTERM, then SIGKILL after 5 s) and
    wait for each."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    t_end = time.perf_counter() + 5.0
    for p in procs:
        try:
            p.wait(max(0.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        for f in (p.stdout, p.stderr):
            f.close()


def _no_cards(cell: dict) -> bool:
    """Whether this host lacks the CUDA devices the cell asks for (said on
    standard error)."""
    import torch
    chips = cell["workload"]["chips"]
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        return False
    print(f"{cell['name']} needs {chips} CUDA device(s); "
          f"torch.cuda.is_available() is {torch.cuda.is_available()}",
          file=sys.stderr)
    return True


def _finish(result: dict | None) -> int:
    """The exit code, after printing `result` (if any) as the last line of
    standard output, unless the run loaded a module it may not."""
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded modules it may not: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result))
    return 0


def rank_main(rank: int) -> int:
    """One rank of a multi-card run: the job from standard input, its card
    (`cuda:<rank>`, made current) or the CPU, the fault planted, then the
    run in step with the others; rank 0 prints the result line."""
    job = json.load(sys.stdin)
    cell = job["cell"]
    world = cell["workload"]["chips"]
    import torch
    if job["device"] == "cuda":
        if _no_cards(cell):
            return 2
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if job["fault"] is not None:
        from _pytest.monkeypatch import MonkeyPatch
        from perfbench import faults
        faults.of(cell)[job["fault"]](MonkeyPatch())
    lockstep = Lockstep(rank, world, job["store_port"],
                        SETUP_ALLOWANCE_S + job["seconds"] + AFTER_WINDOW_S)
    return _finish(run_cell(cell, job["seed"], job["seconds"], job["trace"],
                            job["t_process"], device, rank=rank, world=world,
                            lockstep=lockstep))


def main(argv, t_process: float) -> int:
    if argv[:1] == ["--rank"]:
        return rank_main(int(argv[1]))
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if cell["workload"]["chips"] > 1:
        return launch(cell, args.seed, args.seconds, bool(args.trace),
                      t_process)
    if _no_cards(cell):
        return 2
    return _finish(run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            t_process))
