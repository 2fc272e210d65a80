"""The port's `utils/metrics.py` against the JAX package's: ray counts and
`RenderMeter`'s numbers on the same samples and seconds, its wait on the
render it is given, and `profile_trace`'s Chrome trace, on the CPU."""
import json
import os

import pytest
import torch

from sail_tpu.utils import metrics as jmetrics
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.utils import metrics


@pytest.mark.parametrize("h,w,bounces,nee", [(64, 64, 5, True),
                                             (17, 9, 3, False),
                                             (1024, 1024, 4, True)])
def test_rays_per_sample_matches_jax(h, w, bounces, nee):
    assert metrics.rays_per_sample(h, w, bounces, nee) == \
        jmetrics.rays_per_sample(h, w, bounces, nee)


def test_render_meter_matches_jax():
    m = metrics.RenderMeter(64, 48, 5)
    j = jmetrics.RenderMeter(64, 48, 5)
    for meter, sync in ((m, Vec3(*(torch.ones(2, 2),) * 3)), (j, None)):
        meter.start()
        meter.stop(samples=2, sync=sync)
        meter.start()
        meter.stop(samples=3)
        meter.seconds = 0.125          # the same clock on both
    assert m.total_rays == j.total_rays == 64 * 48 * 5 * 2 * 5
    assert m.mrays_per_s == j.mrays_per_s
    assert m.report() == j.report()
    assert str(m) == str(j)


def test_render_meter_waits_on_a_tensor_or_vec3():
    m = metrics.RenderMeter(8, 8, 2, nee=False)
    m.start()
    m.stop(samples=4, sync=torch.zeros(3))
    assert m.samples == 4 and m.seconds > 0
    assert m.total_rays == 8 * 8 * 2 * 4


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with metrics.profile_trace(logdir) as prof:
        x = torch.ones(64) * 3.0
        float(x.sum())
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mul" in names and "aten::sum" in names
    # no card here: no kernel and no launch call
    assert metrics.kernel_launches(prof) == {"launch_calls": 0,
                                             "kernels": 0}
