"""A multi-card cell added as files alone is taken up: the launcher runs it
as one process a card (here processes on the CPU, joined over gloo), in
lock step, with one result line from rank 0; a process that fails ends the
run and every other process with it; and the benchmark's own checks cover
the cell's own tiny sizes and faults."""
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from perfbench.conftest import ROOT
from perfbench import harness

CELL = "cornell_mirror.sharded"
# config 2 rendered by `render_sharded` over a mesh of one rank a process;
# the image is checked against the reference's one-process render
LOOP = '''"""The configuration's scene through `render_sharded` on a mesh of
one rank a process, the processes joined over torch.distributed."""
import torch

from perfbench import scene_data
from perfbench.loop_base import LoopBase
from perfbench.reference import compare as ref


class Loop(LoopBase):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        t = self.t
        # the rows checked: `check_rows` drawn from the seed, or all
        self.rows = sorted(self.rng.choice(
            t["size"], t.get("check_rows", t["size"]), replace=False))

    def setup(self):
        import sail_tpu_torch
        from sail_tpu_torch.parallel.mesh import (
            global_ranks, initialize_distributed, make_mesh)
        from sail_tpu_torch.parallel.render_sharded import render_sharded
        if self.world > 1:
            initialize_distributed(
                backend="gloo" if self.device.type == "cpu" else None)
        params, self.static = scene_data.make_scene(
            self.config["scene"], sail_tpu_torch).pack()
        self.params = params.to(self.device)
        self.mesh = make_mesh(devices=global_ranks([self.device]))
        self.render = render_sharded
        self.n = 0
        self.warm()

    def unit(self, rec, spans):
        t = self.t
        self.n += 1
        if [self.rank, self.n - t["warmup_units"]] == t.get("fail_at"):
            raise RuntimeError("a failure planted in this unit")
        with torch.no_grad():
            self.image = torch.stack(tuple(self.render(
                self.params, self.static, self.mesh, t["size"], t["size"],
                t["spp"], seed=self.rseed, max_bounces=t["bounces"])))
        rec["rays"] = t["size"] ** 2 * t["spp"] * t["bounces"] * 2

    def release(self):
        import torch.distributed as dist
        self.out = {"image": self.image[:, self.rows].cpu()}
        del self.image
        if dist.is_initialized():
            dist.destroy_process_group()

    def outputs(self):
        return self.out

    def reference(self, dtype):
        t = self.t
        params, static = ref.packed(self.config, self.device, dtype)
        with torch.no_grad():
            image = torch.cat([ref.mean_image(
                params, static, t["size"], t["size"], t["spp"], self.rseed,
                t["bounces"], row0=int(i), rows=1) for i in self.rows], 1)
        return {"image": image.float().cpu()}

    def compare(self, program, reference):
        return [("image_rel", ref.rel_linf(program["image"],
                                           reference["image"]))]


def _altered(monkeypatch):
    """One pixel's red altered where the image is assembled."""
    from sail_tpu_torch.parallel import render_sharded as rs
    real = rs._assemble

    def assemble(mesh, blocks):
        out = real(mesh, blocks).clone()
        out[0, 0, 0] += 0.05 * out.abs().max()
        return out
    monkeypatch.setattr(rs, "_assemble", assemble)


def _no_exchange(monkeypatch):
    """The exchange between processes left out: the blocks of the other
    processes' ranks come back as zeros."""
    from sail_tpu_torch.parallel import render_sharded as rs
    from sail_tpu_torch.parallel.mesh import process_index
    real = rs._gather

    def gather(mesh, local):
        me = process_index()
        return [t if r.process == me else torch.zeros_like(t)
                for t, r in zip(real(mesh, local), mesh.ranks)]
    monkeypatch.setattr(rs, "_gather", gather)


FAULTS = {"altered": _altered, "no_exchange": _no_exchange}
'''


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    """A copy of the benchmark with a two-process cell added as new files:
    its traffic (with its own `tiny`), its loop (with its own `FAULTS`),
    its cell, a per-layer reader and its entries in BENCHMARK.json."""
    root = str(tmp_path_factory.mktemp("bench"))
    bench = os.path.join(root, "perfbench")
    shutil.copytree(os.path.join(ROOT, "perfbench"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "out"))

    def add(path, text):
        with open(os.path.join(bench, path), "w") as f:
            f.write(text if isinstance(text, str) else json.dumps(text))
    add("loops/sharded.py", LOOP)
    add("traffic/sharded.json", {
        "loop": "sharded", "size": 1024, "spp": 64, "bounces": 5,
        "warmup_units": 1, "trace_units": 2,
        "tiny": {"size": 16, "spp": 2, "bounces": 2}})
    add(f"workloads/{CELL}.json", {
        "config": "cornell_mirror", "traffic": "sharded", "chips": 2,
        "why": "a test cell", "limits": {"image_rel": 1e-4}})
    add("layer_metrics/units_traced.sharded.py",
        "def read(window):\n    return window.profile.n_units\n")
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec["workloads"].append({"name": CELL, "config": "cornell_mirror",
                              "traffic": "sharded", "chips": 2,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "render_mrays_per_s":
            m["workloads"].append(CELL)
    spec["per_layer"].append({"name": "units_traced.sharded", "unit": "n",
                              "better": "higher", "source": "device_trace",
                              "layer": "renderer", "moves": "setup_s",
                              "workloads": [CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def _tiny(root):
    cell = harness.load_cell(CELL, root)
    cell["traffic"].update(cell["traffic"]["tiny"])
    return cell


def _leftovers(root) -> list:
    """Processes still running a run.py of the copy."""
    mine = os.path.join(root, "perfbench", "run.py").encode()
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if mine in f.read():
                    left.append(int(pid))
        except OSError:
            pass
    return left


def test_two_processes_run_in_step_with_one_result_line(copy_root,
                                                       monkeypatch):
    monkeypatch.setenv("PYTHONPATH", ROOT)   # the program, beside the copy
    out, err = io.StringIO(), io.StringIO()
    rc = harness.launch(_tiny(copy_root), 2**31 + 101, 0.5, True,
                        time.perf_counter(), device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["correct"] and result["checks"]["image_rel"]["value"] < 1e-4
    assert result["device"]["count"] == 2
    assert result["metrics"]["units_traced.sharded"]["value"] == 2
    ran = {int(r): int(n) for r, n in re.findall(
        r"^\[rank (\d+)\] setup .* (\d+) units", err.getvalue(), re.M)}
    assert ran == {0: result["attempted"], 1: result["attempted"]}
    # the checks are the last lines of standard error
    assert err.getvalue().splitlines()[-1].startswith("image_rel ")
    assert not _leftovers(copy_root)


def test_a_peer_that_fails_ends_the_run(copy_root, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", ROOT)
    cell = _tiny(copy_root)
    cell["traffic"]["fail_at"] = [1, 3]
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    rc = harness.launch(cell, 2**31 + 102, 30.0, False, t0, device="cpu",
                        out=out, err=err)
    assert rc != 0 and time.perf_counter() - t0 < 60
    assert out.getvalue() == ""
    assert "a failure planted in this unit" in err.getvalue()
    assert "the run failed: rank 1 exited" in err.getvalue()
    assert not _leftovers(copy_root)


def test_the_checks_cover_a_cell_added_as_files(copy_root):
    """The copy's own checks, unedited, take up the new cell: its control,
    a sound run, each of its loop's faults, and the same seed twice."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-k", "sharded", "perfbench/test_bench_checks.py",
         "perfbench/test_bench_traffic.py"],
        capture_output=True, text=True, cwd=copy_root, env=env, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:]
    assert re.search(r"\b4 passed, 1 skipped\b", out.stdout), out.stdout
    assert not _leftovers(copy_root)
