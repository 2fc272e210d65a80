"""The comparison that decides `correct` can fail: the control (the
reference in bfloat16 in the program's place) and the faults the timed
path can have each fail a cell's limits, while a sound run at the same
tiny size passes them; and on a card each cell runs correct."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench.conftest import CELLS, ROOT, tiny_cell
from perfbench import faults, harness


def _failed(cell, readings) -> list:
    limits = cell["workload"]["limits"]
    return [n for n, v in readings if not v <= limits[n]]


def _run(cell, fault=None):
    """A short run on the CPU, a multi-card cell's as its processes."""
    return faults.run(cell, 2**31 + 77, 0.05, fault, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_a_sound_run_passes(name):
    cell = tiny_cell(name)
    loop = harness.loop_class(cell)(cell, 2**31 + 5, torch.device("cpu"))
    assert _failed(cell, loop.control())
    assert _run(cell)["correct"]


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS for f in faults.of(harness.load_cell(n, ROOT))])
def test_a_broken_timed_path_is_not_correct(name, fault):
    assert not _run(tiny_cell(name), fault)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, card):
    """The command a check runs, for a short window, on the card."""
    chips = harness.load_cell(name)["workload"]["chips"]
    if chips > torch.cuda.device_count():
        pytest.skip(f"{name} needs {chips} CUDA devices")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         "2147483901", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
