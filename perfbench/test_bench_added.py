"""A later change adds a configuration, a traffic mix, a cell and metrics
as files and entries alone: the harness takes them up by name, with no
edit to a file that is there."""
import json
import os
import shutil
import time

from perfbench.conftest import ROOT
from perfbench import harness


def test_a_cell_added_as_files_is_taken_up(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    bench = os.path.join(root, "perfbench")

    def add(path, data):
        with open(os.path.join(bench, path), "w") as f:
            json.dump(data, f)
    config = harness.load_json(os.path.join(bench, "configs",
                                            "cornell_mirror.json"))
    config["scene"]["items"][1]["args"][1] = 0.3   # a smaller mirror
    add("configs/small_mirror.json", config)
    tiny = harness.load_json(os.path.join(bench, "traffic",
                                          "render.json"))["tiny"]
    add("traffic/stills.json", dict(tiny, loop="frames", warmup_units=1,
                                    trace_units=2, filter_margin=2))
    add("workloads/small_mirror.stills.json", {
        "config": "small_mirror", "traffic": "stills", "chips": 1,
        "why": "a test cell", "limits": {"radiance_rel": 0.0,
                                         "frame_rel": 0.0}})
    with open(os.path.join(bench, "layer_metrics",
                           "units_traced.stills.py"), "w") as f:
        f.write("def read(window):\n    return window.profile.n_units\n")
    spec["configs"].append({"name": "small_mirror", "source": "a test",
                            "file": "perfbench/configs/small_mirror.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "small_mirror.stills",
                              "config": "small_mirror", "traffic": "stills",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "render_mrays_per_s":
            m["workloads"].append("small_mirror.stills")
    spec["per_layer"].append({"name": "units_traced.stills", "unit": "n",
                              "better": "higher", "source": "device_trace",
                              "layer": "renderer", "moves": "setup_s",
                              "workloads": ["small_mirror.stills"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    cell = harness.load_cell("small_mirror.stills", root)
    log = open(os.devnull, "w")
    plain_run = harness.run_cell(cell, 11, 0.05, False, time.perf_counter(),
                                 device="cpu", log=log)
    assert set(plain_run["metrics"]) == {"render_mrays_per_s", "setup_s"}
    assert plain_run["correct"]
    traced_run = harness.run_cell(cell, 11, 0.05, True, time.perf_counter(),
                                  device="cpu", log=log)
    assert traced_run["metrics"]["units_traced.stills"]["value"] == 2
    assert list(traced_run)[-1] == "checks"
