"""The port's runtime on the CPU, against the JAX package: checkpoints
(`.npz` files either package writes continue in the other, atol = rtol =
1e-5), a fresh Renderer resuming a loaded checkpoint, picking on every
pixel of a 32² grid, a scripted `Control` session (orbit, zoom, a drag) to
1e-6, the entry points' default device, and the port's twins of
tests/test_renderer_api.py."""
import math

import jax
import numpy as np
import pytest
import torch

import sail_tpu as jsail
from sail_tpu import scenes as jscenes
from sail_tpu.render import picking as jpicking
from sail_tpu.render.control import Control as JControl
import sail_tpu_torch as sail
from sail_tpu_torch import scenes
from sail_tpu_torch.render import picking
from sail_tpu_torch.render.control import Control

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_renderer(scene):
    r = jsail.Renderer(16, 16, seed=7, max_bounces=2)
    r.update(scene)
    return r


def _port_renderer(scene=None):
    r = sail.Renderer(16, 16, seed=7, max_bounces=2, device="cpu")
    if scene is not None:
        r.update(scene)
    return r


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    jscene = jscenes.cornell_mirror()
    jr = _jax_renderer(jscene)
    jr.render_spp(jscene, 2)
    jr.save(path)
    jr.render_spp(jscene, 2)
    want = jr.output(jscene)
    tscene = scenes.cornell_mirror()
    tr = _port_renderer()
    tr.load(path)
    assert tr.sample_count == 2
    tr.render_spp(tscene, 2)
    assert tr.sample_count == tscene.sample_count == 4
    np.testing.assert_allclose(tr.output(tscene), want, **TOL)


def test_port_checkpoint_continues_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    tscene = scenes.cornell_mirror()
    tr = _port_renderer(tscene)
    tr.render_spp(tscene, 2)
    tr.save(path)
    tr.render_spp(tscene, 2)
    want = tr.output(tscene)
    jscene = jscenes.cornell_mirror()
    jr = _jax_renderer(jscene)     # load after update: JAX's render keeps it
    jr.load(path)
    jr.render_spp(jscene, 2)
    np.testing.assert_allclose(jr.output(jscene), want, **TOL)
    with np.load(path) as data:    # the JAX package's keys and dtypes
        assert data["accum"].dtype == np.float32
        assert data["accum"].shape == (16, 16, 3)
        assert int(data["sample_count"]) == 2


def test_empty_checkpoint_matches_jax():
    jr = _jax_renderer(jscenes.cornell_mirror())
    tr = _port_renderer(scenes.cornell_mirror())
    for a, b in ((tr.checkpoint(), jr.checkpoint()),):
        assert a["sample_count"] == b["sample_count"] == 0
        assert a["accum"].dtype == b["accum"].dtype == np.float64
        np.testing.assert_array_equal(a["accum"], b["accum"])


def test_fresh_renderer_resumes_a_loaded_checkpoint(tmp_path):
    """JAX's fresh Renderer drops a loaded checkpoint at its first render
    (render -> update -> reset); the port's keeps it, so load + 2 samples
    equals 4 uninterrupted samples."""
    path = str(tmp_path / "state.npz")
    scene = scenes.cornell_mirror()
    r = _port_renderer(scene)
    r.render_spp(scene, 2)
    r.save(path)
    r.render_spp(scene, 2)
    want = r.output(scene)
    fresh = _port_renderer()
    fresh.load(path)
    fresh.render_spp(scene, 2)
    assert fresh.sample_count == 4
    np.testing.assert_allclose(fresh.output(scene), want, rtol=1e-6)
    # the reference's fault, for the record: its fresh Renderer restarts
    jscene = jscenes.cornell_mirror()
    jr = jsail.Renderer(16, 16, seed=7, max_bounces=2)
    jr.load(path)
    jr.render_spp(jscene, 2)
    assert jr.sample_count == 2


def test_restore_refuses_another_size():
    r = _port_renderer(scenes.cornell_mirror())
    with pytest.raises(ValueError, match="16x16"):
        r.restore({"accum": np.zeros((8, 8, 3)), "sample_count": 1})


@pytest.mark.parametrize("name", ["cornell_matte", "lights_and_quadrics"])
def test_pick_matches_jax_on_every_pixel(name):
    jscene, tscene = getattr(jscenes, name)(), getattr(scenes, name)()
    n = 32
    got = [[picking.pick(tscene, x, y, n, n, device="cpu")
            for x in range(n)] for y in range(n)]
    want = [[jpicking.pick(jscene, x, y, n, n) for x in range(n)]
            for y in range(n)]
    assert got == want
    assert {i for row in got for i in row} - {None}   # something is picked


def _session(ctl, scene, x, y):
    """Orbit by a drag on empty space, zoom, then drag the object under
    (x, y) across: the script of a viewer session."""
    ctl.mouse_down(0, 0)              # a Cornell box wall: not pickable
    ctl.mouse_move(6, 2)
    ctl.mouse_move(9, -3)
    ctl.mouse_up()
    ctl.zoom(+1)
    ctl.zoom(-1)
    ctl.zoom(+1)
    assert ctl.mouse_down(x, y)
    for k in range(1, 4):
        ctl.mouse_move(x + 2 * k, y - k)
    moving = scene.moving
    ctl.mouse_up()
    return moving


def test_control_session_matches_jax():
    jscene, tscene = jscenes.cornell_matte(), scenes.cornell_matte()
    jctl = JControl(jscene, 32, 32)
    tctl = Control(tscene, 32, 32, device="cpu")
    x, y = 16, 24                     # on the sphere, object 1
    assert jpicking.pick(jscene, x, y, 32, 32) == 1
    assert _session(tctl, tscene, x, y) == _session(jctl, jscene, x, y)
    assert tscene.select == jscene.select == 1
    assert not tscene.moving and not jscene.moving
    np.testing.assert_allclose(tscene.camera.eye, jscene.camera.eye,
                               atol=1e-6, rtol=1e-6)
    for a, b in ((tctl.radius, jctl.radius), (tctl.angle_x, jctl.angle_x),
                 (tctl.angle_y, jctl.angle_y)):
        assert a == pytest.approx(b, abs=1e-6)
    for to, jo in zip(tscene.objects, jscene.objects):
        np.testing.assert_allclose(to.pack(), np.asarray(
            jax.tree.leaves(jo.pack()), np.float64), atol=1e-6, rtol=1e-6)
    assert tscene.objects[1].center != scenes.cornell_matte().objects[1].center


@pytest.mark.parametrize("make", [
    lambda s: picking.pick(s, 1, 1, 8, 8),
    lambda s: picking.Dragger(s, 1, 4, 6, 8, 8),
    lambda s: Control(s, 8, 8),
    lambda s: sail.Renderer(8, 8),
    lambda s: sail.vec3(1.0, 2.0, 3.0),
    lambda s: sail.make_camera(s.camera.eye, s.camera.center),
    lambda s: sail.generate_rays(sail.make_camera(
        s.camera.eye, s.camera.center, device="cpu"), 8, 8)])
def test_entry_points_default_to_the_card(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(scenes.cornell_matte())


# -- twins of tests/test_renderer_api.py ---------------------------------------

H = W = 24


@pytest.fixture(scope="module")
def renderer_and_scene():
    scene = scenes.cornell_matte()
    r = sail.Renderer(W, H, max_bounces=2, device="cpu")
    r.update(scene)
    return r, scene


def test_progressive_accumulation(renderer_and_scene):
    r, scene = renderer_and_scene
    r.reset()
    r.render(scene)
    assert r.sample_count == 1
    img1 = r.output(scene)
    r.render(scene)
    img2 = r.output(scene)
    assert r.sample_count == 2
    assert img1.shape == (H, W, 3)
    assert not np.allclose(img1, img2)
    assert np.isfinite(img2).all()


def test_motion_resets_accumulation(renderer_and_scene):
    r, scene = renderer_and_scene
    r.reset()
    r.render(scene)
    r.render(scene)
    assert r.sample_count == 2
    scene.moving = True
    r.render(scene)
    assert r.sample_count == 1
    scene.moving = False


def test_checkpoint_resume(renderer_and_scene):
    r, scene = renderer_and_scene
    r.reset()
    r.render(scene)
    r.render(scene)
    state = r.checkpoint()
    img_before = r.output(scene)
    r.reset()
    r.restore(state)
    assert r.sample_count == 2
    np.testing.assert_allclose(r.output(scene), img_before, rtol=1e-5)


def test_checkpoint_to_disk_resume_continues_identically(
        renderer_and_scene, tmp_path):
    r, scene = renderer_and_scene
    r.reset()
    r.render(scene)
    r.render(scene)
    path = str(tmp_path / "state.npz")
    r.save(path)
    r.render(scene)
    img_uninterrupted = r.output(scene)
    r.reset()
    r.load(path)
    assert r.sample_count == 2
    r.render(scene)
    np.testing.assert_allclose(r.output(scene), img_uninterrupted, rtol=1e-6)


def test_filter_switch(renderer_and_scene):
    r, scene = renderer_and_scene
    r.reset()
    r.render(scene)
    scene.filter = "gamma"
    img_g = r.output(scene)
    scene.filter = "color"
    img_c = r.output(scene)
    assert not np.allclose(img_g, img_c)
    scene.filter = "not-a-filter"
    assert scene.filter == "color"
    scene.trace = "not-a-tracer"
    assert scene.trace == "path"


def test_pick_finds_sphere():
    scene = scenes.cornell_matte()
    found = None
    for y in range(H // 2, H):
        idx = picking.pick(scene, W / 2, y, W, H, device="cpu")
        if idx is not None:
            found = idx
            break
    assert found == 1      # the sphere (the Cornell box, 0, is not pickable)


def test_drag_translates_object():
    scene = scenes.cornell_matte()
    sphere = scene.objects[1]
    c0 = sphere.center
    ctl = Control(scene, W, H, device="cpu")
    y_hit = next(y for y in range(H // 2, H)
                 if picking.pick(scene, W / 2, y, W, H, device="cpu")
                 is not None)
    assert ctl.mouse_down(W / 2, y_hit)
    ctl.mouse_move(W / 2 + 2, y_hit)
    assert scene.moving
    ctl.mouse_up()
    assert sphere.center != c0
    assert not scene.moving


def test_orbit_moves_eye():
    scene = scenes.cornell_matte()
    eye0 = scene.camera.eye
    ctl = Control(scene, W, H, device="cpu")
    ctl.orbit(10, 0)
    assert scene.camera.eye != eye0 and scene.eye == scene.camera.eye
    d0 = math.dist(eye0, scene.camera.center)
    d1 = math.dist(scene.camera.eye, scene.camera.center)
    assert d1 == pytest.approx(d0, rel=1e-6)
    ctl.zoom(+1)
    d2 = math.dist(scene.camera.eye, scene.camera.center)
    assert d2 == pytest.approx(d0 * 0.9, rel=1e-6)


def test_texture_classes_roundtrip():
    from sail_tpu_torch import (UV, Bilerp, Checkerboard, Checkerboard2, Mix,
                                Scale, ScaleT)
    assert Scale is ScaleT
    for tex in [Checkerboard(), Checkerboard2(), Bilerp((1, 0, 0), (0, 1, 0),
                (0, 0, 1), (1, 1, 1)), Mix((1, 0, 0), (0, 0, 1), 0.3),
                ScaleT((1, 1, 0), (0.5, 0.5, 0.5)), UV()]:
        assert tex.pack() is not None


def test_scene_add_dispatch_and_area_light_injection():
    scene = sail.Scene()
    scene.add(sail.Camera((0, 0, 3), (0, 0, 0)))
    rect = sail.Rectangle((-1, 1, -1), (1, 1, 1), sail.Matte())
    scene.add(sail.AreaLight(rect, (3, 3, 3)))
    assert len(scene.objects) == 1
    assert scene.objects[0] is rect
    assert rect.emission == (3.0, 3.0, 3.0)
    _, static = scene.pack()
    assert static.area_light_objects == (0,)
    assert static.object_emissive == (True,)
