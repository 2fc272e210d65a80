"""The benchmark's own tests (`python -m pytest perfbench -q`): on the CPU
they drive every cell at a tiny size through the program's plain torch
path (a multi-card cell's runs as processes on the CPU, over gloo); those
marked `card` need a CUDA device, and as many as the cell's chips, and skip
without them."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cell of BENCHMARK.json, each found by its name
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = tuple(w["name"] for w in json.load(_f)["workloads"])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def tiny_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` with its traffic cut to a CPU test's size: the
    traffic file's own `tiny` sizes."""
    from perfbench import harness
    cell = harness.load_cell(name, root)
    cell["traffic"].update(cell["traffic"]["tiny"])
    return cell
