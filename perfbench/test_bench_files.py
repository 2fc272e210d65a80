"""Every cell's files are found by name, and BENCHMARK.json keeps to the
form its readers expect: keys, names, units and limits of size."""
import json
import os
import re

import pytest
import torch

from perfbench.conftest import ROOT
from perfbench import harness, scene_data

SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL_NAMES = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"][1] == "perfbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell_found_by_name(name):
    cell = harness.load_cell(name)
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert cell["workload"]["config"] == entry["config"]
    assert cell["workload"]["traffic"] == entry["traffic"]
    assert cell["workload"]["chips"] == entry["chips"] in (1, 4)
    loop = os.path.join(ROOT, "perfbench", "loops",
                        f"{cell['traffic']['loop']}.py")
    assert os.path.exists(loop)
    e2e = [m["name"] for m in cell["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for kind, metrics in (("end_to_end", cell["end_to_end"]),
                          ("layer_metrics", cell["per_layer"])):
        for m in metrics:
            assert os.path.exists(os.path.join(
                ROOT, "perfbench", kind, f"{m['name']}.py")), m["name"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e


def test_four_card_cells_are_few():
    """Of n cells at most max(1, n // 4) take four cards."""
    four = [w["name"] for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4), four


def test_configs_are_used_and_their_files_exist():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        data = harness.load_json(os.path.join(ROOT, c["file"]))
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


@pytest.mark.parametrize("config", ["cornell_mirror", "lights_and_quadrics"])
def test_config_scene_is_the_ports_scene(config):
    """The data builds the scene `sail_tpu_torch.scenes` names, parameter
    for parameter, with the program's classes and with the reference's."""
    import sail_tpu_torch
    from sail_tpu_torch import scenes
    from perfbench.reference import plain
    data = harness.load_json(os.path.join(
        ROOT, "perfbench", "configs", f"{config}.json"))["scene"]
    want, static = getattr(scenes, config)().pack()
    for lib in (sail_tpu_torch, plain):
        got, got_static = scene_data.make_scene(data, lib).pack()
        assert torch.equal(got, want)
        assert tuple(got_static.object_categories) == tuple(
            static.object_categories)
