"""The port's display path on the CPU, against the JAX package:

- the G-buffer (`integrator.gbuffer`) against JAX's `render_sample(...,
  sample_idx).normal/.position` on configs 2, 3 and 4 (atol = rtol = 1e-5,
  with the exception below);
- `Renderer.output` for every display filter against JAX's Renderer after
  `render()` (the G-buffer of the sample just traced) and after
  `render_spp` (sample 0's, which JAX's TPU path fills lazily; its CPU
  path keeps the last sample's, so the test clears `_gbuffer_ok` to take
  JAX's lazy fill), at 1e-5.
  The exception: a ray close to a quadric's silhouette, where float32 does
  not resolve the G-buffer to 5e-6 on one side (off the port's float64
  G-buffer), is held at 5e-5, the batched fold's detail limit; each such
  pixel is named below, by (row, col);
- the selection overlay: `draw_selection`'s frame equal to JAX's for every
  shape, and the port's twins of tests/test_overlay.py.
"""
import jax
import numpy as np
import pytest
import torch

import sail_tpu as jsail
from sail_tpu import scenes as jscenes
from sail_tpu.render import overlay as joverlay
from sail_tpu.render.integrator import render_sample as jrender_sample
import sail_tpu_torch as sail
from sail_tpu_torch import scenes
from sail_tpu_torch.core.camera import rays_for_pixels
from sail_tpu_torch.render import integrator, overlay
from sail_tpu_torch.scene.scene import VALID_FILTERS, unflatten

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _off(a, b, tol):
    """Pixels (H, W) where any channel of `a` is off `b` by more than tol
    (atol = rtol)."""
    return (np.abs(a - b) > tol + tol * np.abs(b)).any(-1)


def _unresolved(*triples):
    """Pixels where float32 does not resolve a G-buffer value to 5e-6 on one
    of the two sides, (port, JAX, float64 witness) each: there agreement to
    1e-5 is not implied.  Such a ray runs close to the silhouette of a
    quadric, whose discriminant cancels."""
    mask = False
    for got, want, witness in triples:
        mask = mask | _off(want, witness, 5e-6) | _off(got, witness, 5e-6)
    return mask


def _hold(got, want, named, unresolved):
    """`got` (the port) against `want` (JAX) per pixel at 1e-5, but at the
    `named` pixels, each unresolved in float32, at 5e-5."""
    off = {tuple(map(int, p)) for p in np.argwhere(_off(got, want, 1e-5))}
    assert off <= named, sorted(off - named)
    assert all(unresolved[p] for p in off), sorted(off)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)


def _np(v):
    return np.asarray(v.stack()) if hasattr(v, "stack") else v


def _witness(name, h, w, seed, idx):
    """The port's G-buffer in float64: (normal, position) numpy arrays."""
    params, static = getattr(scenes, name)().pack()
    return tuple(v.stack().numpy() for v in integrator.gbuffer(
        unflatten(params.double(), static), static, h, w, seed, idx))


# At 20x24, seed 5, sample 3: the pixels outside 1e-5 (port against JAX at
# most 1.2e-5 on config 2, 4.4e-5 on config 3, 3.0e-5 on config 4).
GBUFFER_NAMED = {
    "cornell_mirror": {(16, 14)},
    "material_demo": {(12, 9), (12, 10), (12, 19), (13, 2), (13, 21),
                      (14, 7), (15, 2), (16, 8), (16, 15), (16, 16)},
    "lights_and_quadrics": {(11, 14), (12, 4), (14, 7), (15, 7), (16, 8)},
}


@pytest.mark.parametrize("name", ["cornell_mirror", "material_demo",
                                  "lights_and_quadrics"])
def test_gbuffer_matches_jax_render_sample(name):
    h, w, seed, idx = 20, 24, 5, 3
    jpacked, jstatic = getattr(jscenes, name)().pack()
    # the G-buffer is bounce 0's, so one bounce gives it
    res = jax.jit(lambda p: jrender_sample(p, jstatic, h, w, seed, idx,
                                           max_bounces=1))(jpacked)
    params, static = getattr(scenes, name)().pack()
    got = [v.stack().numpy() for v in integrator.gbuffer(
        unflatten(params, static), static, h, w, seed, idx)]
    want = [_np(res.normal), _np(res.position)]
    for g in got:
        assert g.shape == (h, w, 3) and np.isfinite(g).all()
    unresolved = _unresolved(*zip(got, want, _witness(name, h, w, seed,
                                                      idx)))
    for g, wv in zip(got, want):
        _hold(g, wv, GBUFFER_NAMED[name], unresolved)
    # rays hit (unit normals)
    assert np.abs(got[0]).sum(-1).max() > 0.99


def test_gbuffer_row_blocks_equal_one_pass(monkeypatch):
    params, static = scenes.cornell_mirror().pack()
    packed = unflatten(params, static)
    whole = integrator.gbuffer(packed, static, 12, 10, 1, 2)
    monkeypatch.setattr(integrator, "RAYS_PER_PASS", 25)   # 2-row blocks
    blocks = integrator.gbuffer(packed, static, 12, 10, 1, 2)
    for a, b in zip(whole, blocks):
        torch.testing.assert_close(a.stack(), b.stack(), rtol=0, atol=0)


@pytest.fixture(scope="module")
def twin_renderers():
    """JAX's Renderer and the port's on config 2 at 16², seed 7, 2 bounces
    (the shape of tests/test_torch_slice.py, so JAX's compile is shared)."""
    jscene, tscene = jscenes.cornell_mirror(), scenes.cornell_mirror()
    jr = jsail.Renderer(16, 16, seed=7, max_bounces=2)
    tr = sail.Renderer(16, 16, seed=7, max_bounces=2, device="cpu")
    jr.update(jscene)
    tr.update(tscene)
    return jr, jscene, tr, tscene


def _hold_outputs(jr, jscene, tr, tscene, refill, named):
    """Every filter's output, the port's against JAX's: at 1e-5, but at
    5e-5 on the `named` pixels, whose G-buffer float32 does not resolve,
    for the filters that read it."""
    for name in VALID_FILTERS:
        jscene.filter = tscene.filter = name
        if refill:
            jr._gbuffer_ok = False
        want, got = jr.output(jscene), tr.output(tscene)
        assert got.shape == (16, 16, 3) and got.dtype == np.float32, name
        reads_gbuffer = name in ("normal", "position", "wavelet")
        if reads_gbuffer:
            witness = _witness("cornell_mirror", 16, 16, 7,
                               tr._gbuffer_sample)
            unresolved = _unresolved(*zip(
                (_np(tr._normal), _np(tr._position)),
                (_np(jr._normal), _np(jr._position)), witness))
        else:
            unresolved = np.zeros((16, 16), bool)
        _hold(got, want, named if reads_gbuffer else set(), unresolved)
    jscene.filter = tscene.filter = "color"


def test_output_after_render_matches_jax(twin_renderers):
    jr, jscene, tr, tscene = twin_renderers
    jr.reset()
    tr.reset()
    for _ in range(3):
        jr.render(jscene)
        tr.render(tscene)
    _hold_outputs(jr, jscene, tr, tscene, refill=False, named=set())


def test_output_after_render_spp_matches_jax(twin_renderers):
    jr, jscene, tr, tscene = twin_renderers
    jr.reset()
    tr.reset()
    jr.render_spp(jscene, 4)
    tr.render_spp(tscene, 4)
    # (14, 3): the normal filter 1.4e-5 off JAX's, unresolved in float32
    _hold_outputs(jr, jscene, tr, tscene, refill=True, named={(14, 3)})


def test_gbuffer_is_filled_once_per_render(twin_renderers, monkeypatch):
    _, _, tr, tscene = twin_renderers
    calls = []
    real = integrator.gbuffer

    def counted(*args):
        calls.append(args[-1])
        return real(*args)

    from sail_tpu_torch.render import renderer
    monkeypatch.setattr(renderer, "gbuffer", counted)
    tr.reset()
    tr.render_spp(tscene, 2)
    tr.render(tscene)
    tscene.filter = "color"
    tr.output(tscene)
    assert calls == []                  # only the G-buffer filters fill it
    for name in ("normal", "position", "wavelet"):
        tscene.filter = name
        tr.output(tscene)
    assert calls == [2]                 # once, from the sample just traced
    tr.render_spp(tscene, 2)
    tr.output(tscene)
    assert calls == [2, 0]              # after render_spp: sample 0
    tscene.filter = "color"


# -- the selection overlay ----------------------------------------------------

def _shapes(lib):
    """Every shape category in a Cornell box; the same scene in either
    package."""
    s = lib.Scene()
    s.add(lib.Camera((0.2, 0.5, -3.0), (0.0, 0.0, 0.0)))
    s.add(lib.Cornellbox((-1.5, -1.0, -1.5), (1.5, 1.8, 1.5)))
    s.add(lib.Cube((-1.2, -1.0, -0.4), (-0.8, -0.5, 0.1)))
    s.add(lib.Sphere((0.1, -0.6, 0.3), 0.35))
    s.add(lib.Rectangle((-0.4, 1.7, -0.4), (0.4, 1.7, 0.4)))
    s.add(lib.Cone((-0.6, -1.0, 0.8), 0.9, 0.3))
    s.add(lib.Cylinder((0.9, -1.0, -0.6), 0.6, 0.2))
    s.add(lib.Disk((0.8, -0.99, 0.6), 0.4, 0.1))
    s.add(lib.Hyperboloid((0.0, 0.5, 1.0), (0.2, 0.0, -0.2),
                          (0.25, 0.0, 0.2)))
    s.add(lib.Paraboloid((-0.9, 0.4, -0.2), 0.0, 0.5, 0.25))
    return s


@pytest.mark.parametrize("index", range(9))
def test_draw_selection_equals_jax(index):
    js, ts = _shapes(jsail), _shapes(sail)
    if index == 2:                     # the sphere mid-drag
        js.objects[2].temporary_translate((0.3, 0.1, -0.2))
        ts.objects[2].temporary_translate((0.3, 0.1, -0.2))
    img = np.random.RandomState(index).rand(40, 48, 3).astype(np.float32)
    want = joverlay.draw_selection(img.copy(), js, index)
    got = overlay.draw_selection(img.copy(), ts, index)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for a, b in zip(overlay.selection_segments(ts, index, 48, 40),
                    joverlay.selection_segments(js, index, 48, 40)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- twins of tests/test_overlay.py ---------------------------------------------

def test_object_bounds_all_shapes():
    cases = [
        (sail.Cube((-1, -2, -3), (1, 2, 3)), (-1, -2, -3), (1, 2, 3)),
        (sail.Sphere((1, 2, 3), 0.5), (0.5, 1.5, 2.5), (1.5, 2.5, 3.5)),
        (sail.Rectangle((0, 1, 0), (2, 1, 2)), (0, 1, 0), (2, 1, 2)),
        (sail.Cone((0, 0, 0), 2.0, 0.5), (-0.5, 0, -0.5), (0.5, 2, 0.5)),
        (sail.Cylinder((1, 0, 1), 1.0, 0.25), (0.75, 0, 0.75),
         (1.25, 1, 1.25)),
        (sail.Paraboloid((0, 0, 0), 0.0, 0.6, 0.3), (-0.3, 0, -0.3),
         (0.3, 0.6, 0.3)),
    ]
    for obj, lo, hi in cases:
        blo, bhi = overlay.object_bounds(obj)
        np.testing.assert_allclose(blo, lo, atol=1e-6)
        np.testing.assert_allclose(bhi, hi, atol=1e-6)
    blo, bhi = overlay.object_bounds(sail.Disk((0, 1, 0), 0.5))
    np.testing.assert_allclose(blo[[0, 2]], [-0.5, -0.5])
    np.testing.assert_allclose(bhi[[0, 2]], [0.5, 0.5])
    assert bhi[1] - blo[1] < 0.01


def test_bounds_follow_temporary_translate():
    s = sail.Sphere((0, 0, 0), 1.0)
    s.temporary_translate((2.0, 0.0, 0.0))
    lo, hi = overlay.object_bounds(s)
    np.testing.assert_allclose((lo + hi) / 2, [2, 0, 0], atol=1e-6)


def test_project_inverts_primary_rays():
    """A point along pixel (i, j)'s center ray projects back to (j, i)."""
    scene = scenes.cornell_mirror()
    params, static = scene.pack()
    cam = unflatten(params, static).camera
    h = w = 64
    for (i, j) in [(32, 32), (5, 50), (60, 8)]:
        ro, rd = rays_for_pixels(cam, torch.tensor(float(i)),
                                 torch.tensor(float(j)), h, w)
        p = np.array([float(ro.x + rd.x * 3.0), float(ro.y + rd.y * 3.0),
                      float(ro.z + rd.z * 3.0)])[None]
        xy, front = overlay.project_points(scene.camera, p, w, h)
        assert front[0]
        np.testing.assert_allclose(xy[0], [j, i], atol=1e-3)


def test_point_behind_camera_flagged():
    scene = scenes.cornell_mirror()
    eye = np.asarray(scene.camera.eye)
    center = np.asarray(scene.camera.center)
    _, front = overlay.project_points(scene.camera,
                                      (eye + (eye - center))[None], 64, 64)
    assert not front[0]


def test_selection_segments_and_draw():
    scene = scenes.cornell_mirror()
    idx = next(i for i, o in enumerate(scene.objects)
               if isinstance(o, sail.Sphere))
    assert len(overlay.selection_segments(scene, idx, 64, 64)) == 12
    img = np.zeros((64, 64, 3), np.float32)
    overlay.draw_selection(img, scene, idx)
    assert (img > 0).any()
    img2 = np.zeros((64, 64, 3), np.float32)
    overlay.draw_selection(img2, scene, None)
    assert (img2 == 0).all()


def test_near_plane_corner_clipped_not_allocated():
    """A corner at camera depth ~1e-8 projects to ~1e8 px: the raster walk
    must clip to the viewport before sizing its line."""
    scene = sail.Scene()
    eye = [0.0, 0.0, 2.0]
    scene.add(sail.Camera(eye, [0.0, 0.0, 0.0]))
    scene.add(sail.Cornellbox([-1, -1, -1], [1, 1, 1]))
    scene.add(sail.Cube([-0.2, -0.2, -0.2], [0.4, 0.4, eye[2] - 1e-8]))
    img = np.zeros((64, 64, 3), np.float32)
    out = overlay.draw_selection(img, scene, len(scene.objects) - 1)
    assert out.shape == img.shape


def test_clip_segment_cases():
    p = overlay._clip_segment((1.0, 1.0), (5.0, 5.0), 64, 64)
    np.testing.assert_allclose(p, [(1, 1), (5, 5)])
    assert overlay._clip_segment((-10, -10), (-5, -20), 64, 64) is None
    (a, b) = overlay._clip_segment((-10.0, 32.0), (100.0, 32.0), 64, 64)
    assert a[0] == 0.0 and b[0] == 63.0


def test_renderer_output_draws_selection():
    scene = scenes.cornell_mirror()
    idx = next(i for i, o in enumerate(scene.objects)
               if isinstance(o, sail.Sphere))
    r = sail.Renderer(32, 32, device="cpu")
    r.update(scene)          # no samples: the accumulation is zeros
    plain = r.output(scene)
    scene.select = idx
    marked = r.output(scene)
    assert (marked != plain).any()
    # the box is the overlay's, drawn over the filtered frame
    np.testing.assert_array_equal(
        marked, overlay.draw_selection(plain.copy(), scene, idx))
