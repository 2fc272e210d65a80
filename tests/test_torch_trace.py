"""The program's own profiler ranges (`utils/metrics.span`), on the CPU.

A tiny config 5 train step (16², 2 spp, 2 bounces, 16 edge samples) run
under `torch.profiler` shows the train step's and the edge terms' ranges,
nested as the code calls them, none of them a user annotation (which would
give each a device-side twin on a card), and changes no bit of the loss or
the parameters; with no profiler `span` hands out one shared context.  The
viewer's frame (an orbit drag, `render`, `output`, `png_bytes`) shows the
repack, the filter, the tone map and the encode on both codec paths."""
import numpy as np
import pytest
import torch

import sail_tpu_torch as sail
from sail_tpu_torch import scenes
from sail_tpu_torch.parallel.mesh import make_mesh
from sail_tpu_torch.parallel.render_sharded import (make_train_step,
                                                    render_sharded,
                                                    trainable_mask)
from sail_tpu_torch.render.control import Control
from sail_tpu_torch.tools import inverse_artifact as ia
from sail_tpu_torch.utils import imageio, metrics, native

H = W = 16
SPP, BOUNCES = 2, 2
EDGE = dict(n_edge_samples=16, n_noise=2, n_curve_samples=8)
CPU = [torch.profiler.ProfilerActivity.CPU]

# each train-step range and the range it lies directly inside
PARENTS = {"sail.train_step": None,
           "sail.interior": "sail.train_step",
           "sail.edge_terms": "sail.train_step",
           "sail.adam": "sail.train_step",
           "sail.silhouette": "sail.edge_terms",
           "sail.penumbra": "sail.edge_terms",
           "sail.bisect": "sail.silhouette",
           "sail.edge_backward": ("sail.silhouette", "sail.penumbra")}


def _step(profiled: bool):
    """One train step from config 5's perturbed start: (loss, parameters
    after it, the profile's `sail.*` events or None)."""
    scene = scenes.cornell_mirror()
    params, static = scene.pack()
    mesh = make_mesh(1, device="cpu")
    with torch.no_grad():
        target = render_sharded(params, static, mesh, H, W, SPP,
                                max_bounces=BOUNCES)
    start = scenes.cornell_mirror(light_emission=(3.0, 3.0, 3.0)).pack()[0]
    p = start.clone()
    opt = torch.optim.Adam([p], lr=0.02)
    step = make_train_step(static, mesh, H, W, SPP, opt,
                           max_bounces=BOUNCES,
                           trainable=trainable_mask(static, ia.trainable),
                           **EDGE)
    if not profiled:
        return step(target), p.detach().clone(), None
    with torch.profiler.profile(activities=CPU) as prof:
        loss = step(target)
    events = [e for e in prof.events() if e.name.startswith("sail.")]
    return loss, p.detach().clone(), events


@pytest.fixture(scope="module")
def steps():
    return _step(False), _step(True)


def _parent(e, events):
    """The innermost `sail.*` range on `e`'s thread that holds `e`."""
    around = [o for o in events if o is not e and o.thread == e.thread
              and o.time_range.start <= e.time_range.start
              and e.time_range.end <= o.time_range.end]
    if not around:
        return None
    return min(around, key=lambda o: o.time_range.end
               - o.time_range.start).name


def test_train_step_ranges_nest_as_called(steps):
    events = steps[1][2]
    assert {e.name for e in events} == set(PARENTS)
    assert sum(e.name == "sail.train_step" for e in events) == 1
    parents = {}
    for e in events:
        parent = _parent(e, events)
        want = PARENTS[e.name]
        assert parent in (want if isinstance(want, tuple) else (want,)), \
            (e.name, parent)
        parents.setdefault(e.name, set()).add(parent)
    # each term takes its own backward pass
    assert parents["sail.edge_backward"] == {"sail.silhouette",
                                             "sail.penumbra"}


def test_no_range_is_a_user_annotation(steps):
    events = steps[1][2]
    assert events and not any(e.is_user_annotation for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in events)


def test_ranges_change_no_bit_of_the_step(steps):
    (loss, params, _), (loss_p, params_p, _) = steps
    assert torch.equal(loss, loss_p)
    assert torch.equal(params, params_p)


def test_span_without_a_profiler_is_one_shared_context():
    assert metrics.span("sail.a") is metrics.span("sail.b")
    with metrics.span("sail.a") as entered:
        assert entered is None
    with torch.profiler.profile(activities=CPU) as prof:
        assert metrics.span("sail.a") is not metrics.span("sail.b")
        with metrics.span("sail.a"):
            torch.ones(4).sum()
    assert [e.name for e in prof.events()
            if e.name.startswith("sail.")] == ["sail.a"]


@pytest.mark.parametrize("codec", ["native", "python"])
def test_viewer_frame_ranges(codec, monkeypatch):
    """An orbit drag repacks the scene at the next `render`; `output`
    filters; `png_bytes` tone-maps and encodes, on either codec path."""
    if codec == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    scene = scenes.cornell_mirror()
    scene.filter = "gamma"
    r = sail.Renderer(W, H, seed=7, max_bounces=BOUNCES, device="cpu")
    r.update(scene)
    control = Control(scene, W, H, device="cpu")
    with torch.profiler.profile(activities=CPU) as prof:
        control.orbit(4, 0)
        r.render(scene)
        scene.moving = False
        png = imageio.png_bytes(r.output(scene))
    names = [e.name for e in prof.events() if e.name.startswith("sail.")]
    assert sorted(names) == ["sail.deflate", "sail.filter", "sail.pack",
                             "sail.tonemap"]
    assert png.startswith(b"\x89PNG")
    assert np.isfinite(r.output(scene)).all()
