"""The port's primary-visibility edge terms (`sail_tpu_torch/diff/
boundary.py`) on the CPU, each against the JAX package's on the same scene,
seed and sizes, and the five values the JAX package's smoke tests bake
(`tests/test_boundary_grad.py`, held there at rel 0.15).

Scenes: the emissive sphere in a dark box, the sphere seen only in a planar
mirror and only in a sphere mirror (the scenes of
`tests/test_boundary_grad.py`), and one of each surface of revolution.  The
JAX side runs eagerly, as the JAX package's own tests run it; the smallest
sizes that exercise each term keep its op-by-op dispatch short.

Tolerance: per leaf |port − JAX| ≤ 1e-4 · max|JAX| (relative L∞ of the
largest leaf), with JAX's rsqrt taken as `1/sqrt`, the port's
(`test_torch_grad.py` says why); measured 2.7e-5 on the sphere mirror
(its Alhazen bisection, a fixed-iteration loop that XLA compiles and
fuses) and ≤ 2.4e-7 on the other scenes.  No straddle sample flips
between the two at these sizes: a flipped one would move a leaf by its
whole Δf, ~1e-2 of the largest, and fail the bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sail_tpu as jsail
import sail_tpu_torch as tsail
from sail_tpu.core.camera import make_camera as jax_make_camera
from sail_tpu.core.camera import rays_for_pixels as jax_rays
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.diff import boundary as jb
from sail_tpu_torch.core.camera import make_camera, rays_for_pixels
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import leaf_paths

torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture
def jax_rsqrt_as_port(monkeypatch):
    """JAX's rsqrt as `1/sqrt`, the port's two correctly rounded steps
    (XLA's differs by an ulp on about a third of inputs)."""
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))


# -- scenes (each built by either package) ------------------------------------

def emissive_sphere(lib):
    """An emissive sphere in a dark box: the camera silhouette is the
    only discontinuity (`test_boundary_grad._scene`)."""
    s = lib.Scene()
    s.add(lib.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(lib.Cornellbox([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]))
    s.add(lib.Sphere([0.15, -0.2, 0.2], 0.38, emission=[1.0, 1.0, 1.0]))
    return s


def planar_mirror(lib):
    """An emissive sphere behind the camera, seen only in a planar mirror
    (`test_boundary_grad._mirror_scene`)."""
    s = lib.Scene()
    s.add(lib.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(lib.Rectangle([-0.9, -0.9, -0.99], [0.9, 0.9, -0.99],
                        lib.Mirror(kr=1.0)))
    s.add(lib.Sphere([0.5, 0.0, 3.4], 0.8, emission=[1.0, 1.0, 1.0]))
    return s


def curved_mirror(lib):
    """An emissive sphere behind the camera, seen only in a sphere mirror
    (`test_boundary_grad._curved_mirror_scene`)."""
    s = lib.Scene()
    s.add(lib.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(lib.Sphere([0.0, 0.0, -0.3], 0.7, lib.Mirror(kr=1.0)))
    s.add(lib.Sphere([0.6, 0.2, 3.6], 0.8, emission=[1.0, 1.0, 1.0]))
    return s


def revolution(lib):
    """One emissive surface of each kind of revolution, no box: rims and
    smooth silhouettes of every branch of `_revolution_curves`.  The
    paraboloid is cut above its apex (at z0 = 0 the rim radius' square root
    has an infinite derivative, NaN in both packages)."""
    s = lib.Scene()
    s.add(lib.Camera([0.0, 0.2, 2.5], [0.0, 0.0, 0.0]))
    s.add(lib.Cone([-0.55, -0.6, 0.0], 0.8, 0.3, emission=[1.0, 1.0, 1.0]))
    s.add(lib.Cylinder([0.0, -0.6, 0.0], 0.7, 0.25,
                       emission=[0.8, 0.9, 1.0]))
    s.add(lib.Disk([0.55, 0.3, -0.2], 0.3, 0.1, emission=[1.0, 0.7, 0.5]))
    s.add(lib.Paraboloid([0.5, -0.6, 0.2], 0.1, 0.5, 0.3,
                         emission=[0.6, 1.0, 0.6]))
    s.add(lib.Hyperboloid([-0.4, 0.2, 0.0], [0.3, 0.0, -0.25],
                          [0.35, 0.0, 0.3], emission=[1.0, 1.0, 1.0]))
    return s


def bridged(scene_fn):
    """(JAX packed, JAX static, port params, port static) of one scene,
    the port's parameters carried over from JAX's leaves."""
    packed, static = scene_fn(jsail).pack()
    params = params_from_jax_leaves([np.asarray(l)
                                     for l in jax.tree.leaves(packed)])
    return packed, static, params, static_from_jax(static)


def ramp_adjoint(h: int, w: int, lo=0.25, hi=2.0):
    """The tests' loss adjoint: an x ramp / (3·H·W), as numpy (both sides
    take the same numbers)."""
    ramp = (np.linspace(lo, hi, w, dtype=np.float32)[None, :]
            * np.ones((h, 1), np.float32))
    return ramp / np.float32(3.0 * h * w)


def adjoints(wn):
    j = jnp.asarray(wn)
    t = torch.from_numpy(wn)
    return JVec3(j, j, j), Vec3(t, t, t)


def assert_leaves_close(label, jax_grad, port_grad, static):
    """Per leaf |port − JAX| ≤ TOL · max|JAX|; the term must be nonzero
    and finite."""
    want = np.array([np.asarray(l) for l in jax.tree.leaves(jax_grad)],
                    np.float64)
    got = port_grad.detach().double().numpy()
    scale = np.abs(want).max()
    assert scale > 0, f"{label}: the JAX term is zero"
    assert np.isfinite(got).all() and np.isfinite(want).all(), label
    d = np.abs(got - want)
    k = int(d.argmax())
    assert d[k] <= TOL * scale, (
        f"{label}: leaf {leaf_paths(static)[k]} port {got[k]:.8g} JAX "
        f"{want[k]:.8g}, |diff| {d[k]:.3g} > {TOL:g} x {scale:.3g}")


# -- screen projection and the silhouette circle ------------------------------

def test_screen_project_and_sphere_silhouette_match_jax():
    eye, at = [0.2, -0.1, 2.5], [0.0, 0.1, 0.0]
    jcam = jax_make_camera(eye, at)
    tcam = make_camera(eye, at, device="cpu")
    ii = np.array([3.25, 17.5, 38.9], np.float32)
    jj = np.array([1.75, 22.0, 39.1], np.float32)
    jro, jrd = jax_rays(jcam, jnp.asarray(ii), jnp.asarray(jj), 40, 40,
                        jitter_x=0.0, jitter_y=0.0)
    tro, trd = rays_for_pixels(tcam, torch.from_numpy(ii),
                               torch.from_numpy(jj), 40, 40, jitter_x=0.0,
                               jitter_y=0.0)
    want = jb.screen_project(jcam, jro + jrd * 2.1, 40, 40)
    got = tb.screen_project(tcam, tro + trd * 2.1, 40, 40)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), jj, atol=1e-4)   # the inverse
    np.testing.assert_allclose(got[1].numpy(), ii, atol=1e-4)

    ts = (np.arange(32, dtype=np.float32) + 0.5) / 32
    c, r = [0.3, -0.2, 0.1], 0.4
    want = jb.sphere_silhouette(jcam, JVec3(*map(jnp.float32, c)),
                                jnp.float32(r), jnp.asarray(ts))
    got = tb.sphere_silhouette(
        tcam, Vec3(*(torch.tensor(v) for v in c)), torch.tensor(r),
        torch.from_numpy(ts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    centre = Vec3(*(torch.tensor(v) for v in c))
    # on the sphere, and tangent to the view
    np.testing.assert_allclose((got - centre).length().numpy(), r,
                               atol=1e-5)
    np.testing.assert_allclose((got - centre).dot(got - tcam.eye).numpy(),
                               0.0, atol=1e-5)


# -- boundary_term against JAX's ----------------------------------------------

# scene, size, boundary_term's keywords
CASES = {
    "emissive_sphere": (emissive_sphere, 24,
                        dict(n_edge_samples=64, n_noise=1, seed=5,
                             max_bounces=1)),
    "planar_mirror": (planar_mirror, 24,
                      dict(n_edge_samples=64, n_noise=1, seed=11,
                           max_bounces=2)),
    "curved_mirror": (curved_mirror, 24,
                      dict(n_edge_samples=64, n_noise=1, seed=11,
                           max_bounces=2)),
    "revolution": (revolution, 24,
                   dict(n_edge_samples=64, n_noise=1, seed=5,
                        max_bounces=1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_boundary_term_matches_jax(name, jax_rsqrt_as_port):
    scene_fn, size, kw = CASES[name]
    packed, static, params, tstatic = bridged(scene_fn)
    jdl, tdl = adjoints(ramp_adjoint(size, size))
    want = jb.boundary_term(packed, static, jdl, size, size, **kw)
    got = tb.boundary_term(params, tstatic, tdl, size, size, **kw)
    assert_leaves_close(name, want, got, tstatic)


def test_boundary_term_zero_without_silhouettes():
    """No sphere, box or surface of revolution: zeros, as JAX's; and a
    zero adjoint gives zeros where there are edges."""
    s = tsail.Scene()
    s.add(tsail.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    params, static = s.pack()
    zero = torch.zeros((8, 8))
    g = tb.boundary_term(params, static, Vec3(zero, zero, zero), 8, 8,
                         n_edge_samples=8, n_noise=1)
    assert torch.equal(g, torch.zeros_like(params))
    params, static = emissive_sphere(tsail).pack()
    g = tb.boundary_term(params, static, Vec3(zero, zero, zero), 8, 8,
                         n_edge_samples=8, n_noise=1, max_bounces=1)
    assert g.shape == params.shape and not g.any()


# -- the JAX package's baked smoke values -------------------------------------

def _leaf(static, grad, key):
    return float(grad[leaf_paths(static).index(key)])


def test_mirror_silhouette_smoke_baked():
    """`test_boundary_grad.test_mirror_silhouette_smoke_baked` on the port:
    24², 128 edge samples."""
    params, static = planar_mirror(tsail).pack()
    _, tdl = adjoints(ramp_adjoint(24, 24))
    g = tb.boundary_term(params, static, tdl, 24, 24, n_edge_samples=128,
                         n_noise=2, seed=11, max_bounces=2)
    gx = _leaf(static, g, ".objects[1].center.x")
    gr = _leaf(static, g, ".objects[1].radius")
    assert gx < 0 and gr > 0, (gx, gr)
    assert gx == pytest.approx(-0.0061958, rel=0.15), gx
    assert gr == pytest.approx(0.0770737, rel=0.15), gr


def test_curved_mirror_silhouette_smoke_baked():
    """`test_curved_mirror_silhouette_smoke_baked` on the port."""
    params, static = curved_mirror(tsail).pack()
    _, tdl = adjoints(ramp_adjoint(24, 24))
    g = tb.boundary_term(params, static, tdl, 24, 24, n_edge_samples=128,
                         n_noise=2, seed=11, max_bounces=2)
    assert _leaf(static, g, ".objects[1].center.x") == pytest.approx(
        -0.00057653, rel=0.15)
    assert _leaf(static, g, ".objects[1].radius") == pytest.approx(
        0.00831524, rel=0.15)


def mirror_penumbra(lib):
    """An occluder behind the camera whose shadow shows only in a mirror
    (`test_boundary_grad.test_mirror_penumbra_smoke_baked`)."""
    s = lib.Scene()
    s.add(lib.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(lib.Rectangle([-0.9, -1.2, -0.99], [0.9, 0.9, -0.99],
                        lib.Mirror(kr=1.0)))
    s.add(lib.Rectangle([-1.4, -0.95, -0.95], [1.4, -0.95, 3.7],
                        lib.Matte(kd=0.95)))
    s.add(lib.Sphere([0.1, 0.0, 3.1], 0.45, lib.Matte(kd=0.3)))
    s.add(lib.AreaLight(lib.Rectangle([-0.3, 1.6, 2.85], [0.5, 1.6, 3.35],
                                      lib.Matte()), [12.0, 12.0, 12.0]))
    return s


def indirect_shadow(lib):
    """A floor's penumbra seen only through the back wall's diffuse bounce
    (`test_boundary_grad.test_indirect_shadow_smoke_baked`)."""
    s = lib.Scene()
    s.add(lib.Camera([0.0, 0.3, 2.5], [0.0, 0.3, 0.0]))
    s.add(lib.Rectangle([-1.4, -0.98, -1.0], [1.4, 1.8, -1.0],
                        lib.Matte(kd=0.9)))
    s.add(lib.Rectangle([-1.4, -1.0, -1.0], [1.4, -1.0, 2.6],
                        lib.Matte(kd=0.9)))
    s.add(lib.Sphere([0.2, 0.1, 0.8], 0.4, lib.Matte(kd=0.3)))
    s.add(lib.AreaLight(lib.Rectangle([-0.2, 1.5, 0.5], [0.4, 1.5, 1.1],
                                      lib.Matte()), [14.0, 14.0, 14.0]))
    return s


def secondary_silhouette(lib):
    """A side-lit sphere behind the camera, seen only through the back
    wall's diffuse bounce (`test_boundary_grad._secondary_sil_scene`)."""
    s = lib.Scene()
    s.add(lib.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(lib.Rectangle([-1.4, -1.4, -1.0], [1.4, 1.4, -1.0],
                        lib.Matte(kd=0.9)))
    s.add(lib.Sphere([0.3, 0.0, 3.2], 0.5, lib.Matte(kd=0.8)))
    s.add(lib.AreaLight(lib.Rectangle([-3.4, 2.2, 2.2], [-1.2, 2.2, 4.2],
                                      lib.Matte()), [10.0, 10.0, 10.0]))
    return s


def test_mirror_penumbra_smoke_baked():
    """`test_mirror_penumbra_smoke_baked` on the port: 48², 32 curve
    samples; the mirror receivers' penumbra."""
    params, static = mirror_penumbra(tsail).pack()
    _, tdl = adjoints(ramp_adjoint(48, 48, 0.1, 3.0))
    g = tb.shadow_boundary_term(params, static, tdl, 48, 48,
                                n_curve_samples=32)
    gx = _leaf(static, g, ".objects[2].center.x")
    assert gx > 0, gx
    assert gx == pytest.approx(0.00026220, rel=0.15), gx


def test_indirect_shadow_smoke_baked():
    """`test_indirect_shadow_smoke_baked` on the port: the indirect
    receivers' share (4 directions minus none) at 48²."""
    params, static = indirect_shadow(tsail).pack()
    _, tdl = adjoints(ramp_adjoint(48, 48, 0.1, 3.0))
    shd0 = tb.shadow_boundary_term(params, static, tdl, 48, 48,
                                   n_curve_samples=32)
    shd1 = tb.shadow_boundary_term(params, static, tdl, 48, 48,
                                   n_curve_samples=32, n_indirect_dirs=4)
    key = ".objects[2].center.x"
    g_ind = _leaf(static, shd1, key) - _leaf(static, shd0, key)
    assert g_ind == pytest.approx(0.00377, rel=0.15), g_ind


def test_secondary_vertex_silhouette_smoke_baked():
    """`test_secondary_vertex_silhouette_smoke_baked` on the port: 32²."""
    params, static = secondary_silhouette(tsail).pack()
    _, tdl = adjoints(ramp_adjoint(32, 32))
    g = tb.indirect_silhouette_term(params, static, tdl, 32, 32,
                                    n_dir_samples=8, n_noise=1, seed=11,
                                    max_bounces=2)
    gx = _leaf(static, g, ".objects[1].center.x")
    assert gx < 0, gx
    assert gx == pytest.approx(-0.0043837, rel=0.15), gx


def test_pixel_noise_matches_jax():
    """`rng.pixel_noise` (the edge terms' streams) draws JAX's uniforms bit
    for bit, for an image block, a flat batch and given coordinates."""
    from sail_tpu.core import rng as jrng
    from sail_tpu_torch.core import rng
    ii = np.array([[0, 3], [17, 40]], np.int32)
    jj = np.array([[5, 0], [2, 39]], np.int32)
    for kw, tkw in ((dict(shape=(4, 6)), dict(shape=(4, 6), device="cpu")),
                    (dict(shape=(7,)), dict(shape=(7,), device="cpu")),
                    (dict(ii=jnp.asarray(ii), jj=jnp.asarray(jj)),
                     dict(ii=torch.from_numpy(ii), jj=torch.from_numpy(jj)))):
        want = jrng.pixel_noise(11, 7919, **kw).uniform3(0, jrng.TAG_BSDF)
        got = rng.pixel_noise(11, 7919, **tkw).uniform3(0, rng.TAG_BSDF)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
