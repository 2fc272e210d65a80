"""The metrics that read the program's own ranges (`program_spans`): their
arithmetic on a hand-made profile, nothing (and no error) from a profile
without the ranges, every one reported by a traced run of the tiny
inverse and viewer cells on the CPU, and on a card a launch count within
the step's kernels and no range with a device-side twin."""
import os
import time
from types import SimpleNamespace

import pytest

from perfbench.conftest import ROOT, tiny_cell
from perfbench import devtrace, harness, program_spans

NEW = {"cornell_mirror.inverse": ("edge_terms_ms.inverse",
                                  "edge_launches.inverse",
                                  "edge_idle_ms.inverse"),
       "cornell_mirror.viewer": ("pack_ms.viewer", "deflate_ms.viewer")}


def _event(name, start, end, device=False):
    import torch
    kind = torch.autograd.DeviceType
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end), device_type=kind.CUDA if device else kind.CPU)


def _read(name, profile):
    reader = harness.load_module(
        os.path.join(ROOT, "perfbench", "layer_metrics", f"{name}.py"),
        f"perfbench_test_{name.replace('.', '_')}")
    return reader.read(harness.Window(None, 0.0, [], {}, profile))


def test_ranges_read_on_a_hand_made_profile():
    """Two units in a 1,000-µs window; `sail.edge_terms` over 100–300 and
    500–600 (with `sail.bisect` inside), a kernel over 120–200, launch
    calls at 150, 550 and 700."""
    events = [_event(devtrace.WINDOW_SPAN, 0, 1000),
              _event("sail.edge_terms", 100, 300),
              _event("sail.edge_terms", 500, 600),
              _event("sail.bisect", 110, 130),
              _event("cudaLaunchKernel", 150, 155),
              _event("cuLaunchKernelEx", 550, 551),
              _event("cudaLaunchKernel", 700, 705),
              _event("aten::mul", 140, 160),
              _event("void k(int)", 120, 200, device=True)]
    p = devtrace.Profile(events, 2)
    assert _read("edge_terms_ms.inverse", p) == pytest.approx(0.15)
    assert _read("edge_launches.inverse", p) == 1.0
    # idle inside the range: 100–120, 200–300 and 500–600
    assert _read("edge_idle_ms.inverse", p) == pytest.approx(0.11)
    assert program_spans.mean_ms(p, "sail.edge_terms") == pytest.approx(0.15)


def test_a_program_without_the_ranges_reports_nothing():
    p = devtrace.Profile([_event(devtrace.WINDOW_SPAN, 0, 1000),
                          _event("aten::mul", 10, 20),
                          _event("cudaLaunchKernel", 30, 31)], 1)
    for names in NEW.values():
        for name in names:
            assert _read(name, p) is None, name


@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_run_reports_the_ranges(name):
    cell = tiny_cell(name)
    out = harness.run_cell(cell, 2**31 + 311, 0.05, True,
                           time.perf_counter(), device="cpu",
                           log=open(os.devnull, "w"))
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW[name]) <= set(got)
    assert out["correct"]
    for metric in NEW[name]:
        if "_ms." in metric:
            assert got[metric] > 0, metric
    if name == "cornell_mirror.inverse":
        assert got["edge_idle_ms.inverse"] <= got["edge_terms_ms.inverse"]
        # nothing is launched on the CPU
        assert got["edge_launches.inverse"] == 0


@pytest.mark.card
def test_edge_launches_within_the_steps_kernels_on_the_card(card):
    """The inverse cell at its full size: the edge terms' launch calls are
    among the step's kernels, and no range of the program has a
    device-side event."""
    cell = harness.load_cell("cornell_mirror.inverse")
    loop = harness.loop_class(cell)(cell, 2**31 + 409, card)
    loop.setup()
    profile = harness.traced(loop, cell["traffic"]["trace_units"],
                             harness.Spans(), card, None)
    launches = _read("edge_launches.inverse", profile)
    kernels = _read("kernels_per_step.inverse", profile)
    assert 0 < launches <= kernels
    assert not [n for n, _, _ in profile.device if n.startswith("sail.")]
    assert program_spans.ms_per_unit(profile, "sail.edge_terms") > 0
