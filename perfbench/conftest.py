"""The benchmark's own tests (`python -m pytest perfbench -q`): on the CPU
they drive every cell at a tiny size through the program's plain torch
path; those marked `card` need a CUDA device and skip without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each traffic at a size a CPU test holds
TINY = {"fwdbwd": dict(size=16, spp=2, bounces=2),
        "render": dict(size=16, spp=4, bounces=2, check_rows=2),
        "inverse": dict(size=16, spp=2, bounces=2, edge_samples=16,
                        followed_steps=2),
        "viewer": dict(size=16, spp=1, bounces=2, session=6, moving=2,
                       control_frames=9, trace_units=6)}
CELLS = ("cornell_mirror.fwdbwd", "lights_and_quadrics.render",
         "cornell_mirror.inverse", "cornell_mirror.viewer")


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
    """The cell `name` with its traffic cut to a CPU test's size."""
    from perfbench import harness
    cell = harness.load_cell(name, root)
    cell["traffic"].update(TINY[cell["workload"]["traffic"]])
    return cell
