"""The port's lights on the CPU, each piece against the JAX package.

- The two samplers the lights use, `uniform_sphere` and `concentric_disk`,
  and `_sample_geometry` for each of the eight sampleable shapes, on
  seeded uniforms (the disk's center u = (0.5, 0.5) among them).
- `sample_direct` per light category (AREA over each shape of the check
  scene, POINT, SPOT) on seeded hit points, visibility included.
- The pack layout of `PointLight` and `SpotLight` against the leaves of
  `jax.tree.flatten`, and config 4 and the check scene `area_lights` packed
  as the JAX package packs them.
- Twins of `tests/test_oracle_parity.py::test_cube_area_light`,
  `::test_area_light_geometry_acceptance` and
  `::test_lights_and_quadrics_small`, the plain render against golden
  config 4 (64², 4 spp, 3 bounces), and the check scene's render against
  JAX's.

Tolerances: atol = rtol = 1e-5 for single ops (the two sides round the
same float32 operations, but XLA:CPU fuses multiply-adds), 1e-4 for whole
renders (the goldens' bound, `tools/goldens.py`), and the oracle twins'
own.  The kernels' light code is held against the plain version on the
card (`chip_smoke.py` phase 10) and on the CPU through the host builds
(`tests/test_torch_k1_host.py`, `tests/test_torch_k2_host.py`).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sail_tpu as jsail
import sail_tpu_torch as tsail
from sail_tpu import constants as JC
from sail_tpu import scenes as jscenes
from sail_tpu.core import samplers as jsamplers
from sail_tpu.ops import lights as jlights
from sail_tpu_torch import constants as C
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.core import samplers
from sail_tpu_torch.core.rng import PixelNoise
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import lights as tlights
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.oracle import cpu_tracer as oracle
from sail_tpu_torch.render import integrator
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import unflatten
from sail_tpu_torch.tools.goldens import golden_check

from test_oracle_parity import make_rand
from test_torch_ops import N, _close, _vec

torch.set_num_threads(1)

TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "config4_lights_quadrics.npy")


def _jax_scene(name):
    """The JAX package's build of a port scene: config 4 from its own
    scenes, the check scene from the port's scene function over its
    classes."""
    if name == "area_lights":
        return tscenes.area_lights(jsail)
    return getattr(jscenes, name)()


def _bridge(jscene):
    packed, static = jscene.pack()
    tstatic = static_from_jax(static)
    tparams = params_from_jax_leaves([np.asarray(l)
                                      for l in jax.tree.leaves(packed)])
    return packed, static, tparams, tstatic


def _uniforms(seed, n=N):
    """Seeded uniforms with the samplers' special points among them: 0,
    0.5 (the disk's center) and the pairs on its diagonals."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(0, 1, (2, n)).astype(np.float32)
    u[:, :6] = [[0.5, 0.0, 0.5, 0.25, 0.75, 0.0],
                [0.5, 0.0, 0.0, 0.25, 0.25, 0.5]]
    return u


@pytest.mark.parametrize("which", ["uniform_sphere", "concentric_disk"])
def test_samplers_match_jax(which):
    u = _uniforms(3)
    want = getattr(jsamplers, which)(jnp.asarray(u[0]), jnp.asarray(u[1]))
    got = getattr(samplers, which)(torch.from_numpy(u[0]),
                                   torch.from_numpy(u[1]))
    _close(tuple(got), tuple(want))
    if which == "concentric_disk":
        assert float(got[0][0]) == 0.0 and float(got[1][0]) == 0.0
        r2 = got[0] ** 2 + got[1] ** 2
        assert float(r2.max()) <= 1.0 + 1e-6


# (scene, light index) whose area light is over each sampleable shape
AREA_SHAPES = {C.SPHERE: ("area_lights", 0), C.DISK: ("area_lights", 1),
               C.CUBE: ("area_lights", 2), C.CONE: ("area_lights", 3),
               C.CYLINDER: ("area_lights", 4),
               C.PARABOLOID: ("area_lights", 5),
               C.HYPERBOLOID: ("area_lights", 6),
               C.RECTANGLE: ("lights_and_quadrics", 0)}


@pytest.mark.parametrize("cat", sorted(AREA_SHAPES),
                         ids=[C.SHAPE_NAMES[c] for c in sorted(AREA_SHAPES)])
def test_sample_geometry_matches_jax(cat):
    name, li = AREA_SHAPES[cat]
    packed, static, tparams, tstatic = _bridge(_jax_scene(name))
    obj = static.area_light_objects[li]
    assert static.object_categories[obj] == cat
    u = _uniforms(4)
    want = jlights._sample_geometry(cat, packed.objects[obj],
                                    jnp.asarray(u[0]), jnp.asarray(u[1]),
                                    (N,))
    got = tlights._sample_geometry(cat, unflatten(tparams, tstatic)
                                   .objects[obj], torch.from_numpy(u[0]),
                                   torch.from_numpy(u[1]), (N,))
    assert all(c.shape == (N,) for v in got[:2] for c in v)
    assert got[2].shape == (N,) and bool((got[2] > 0).all())
    _close((tuple(got[0]), tuple(got[1]), got[2]),
           (tuple(want[0]), tuple(want[1]), want[2]))


def _hits(seed, lo, hi, up=True):
    """N hit points in the box (lo, hi) with normals +y (the floor's) or,
    for the other half, -z (the back wall's, facing the camera)."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(lo, hi, (N, 3)).T
    n = np.zeros((3, N))
    n[1, : N // 2] = 1.0 if up else -1.0
    n[2, N // 2:] = -1.0
    return _vec(p), _vec(n)


@pytest.mark.parametrize("name,cats", [
    ("area_lights", (C.AREA,)),
    ("lights_and_quadrics", (C.POINT,)),
    ("lights_and_quadrics", (C.SPOT,)),
    ("lights_and_quadrics", (C.AREA, C.POINT, C.SPOT)),
], ids=["area_every_shape", "point", "spot", "config4_mixed"])
def test_sample_direct_matches_jax(name, cats):
    packed, static, tparams, tstatic = _bridge(_jax_scene(name))
    view = unflatten(tparams, tstatic)
    (jp, tp), (jn, tn) = _hits(11, (-1.4, -0.95, -1.4), (1.4, 1.0, 1.4))
    u = _uniforms(12)
    rng = np.random.RandomState(13)
    pick = [i for i, c in enumerate(static.light_categories) if c in cats]
    lidx = np.asarray(pick, np.int32)[rng.randint(0, len(pick), N)]
    want = jlights.sample_direct(packed.objects, packed.lights, static, jp,
                                 jn, jnp.asarray(u[0]), jnp.asarray(u[1]),
                                 jnp.asarray(lidx))
    got = tlights.sample_direct(view.objects, view.lights, tstatic, tp, tn,
                                torch.from_numpy(u[0]),
                                torch.from_numpy(u[1]),
                                torch.from_numpy(lidx))
    lit = int((np.asarray(want[0].x) > 0).sum())
    assert 0 < lit < N, lit   # some samples lit, some shadowed or dark
    _close(tuple(tuple(v) for v in got), tuple(tuple(v) for v in want))


def test_point_and_spot_layouts_match_jax_flatten():
    """PointLight (origin, emission, radius) and SpotLight (origin, the two
    cosines rounded from double, emission) pack in the order of the JAX
    rows' leaves, with their widths."""
    from sail_tpu_torch import PointLight, SpotLight
    from sail_tpu_torch.scene.light import LAYOUTS
    cases = ((PointLight((-1.0, 1.2, 1.0), (0.6, 0.5, 0.4), radius=0.15),
              jsail.PointLight((-1.0, 1.2, 1.0), (0.6, 0.5, 0.4),
                               radius=0.15)),
             (SpotLight((1.0, 1.5, 0.0), 35.0, 10.0, (2.0, 1.0, 3.0)),
              jsail.SpotLight((1.0, 1.5, 0.0), 35.0, 10.0,
                              (2.0, 1.0, 3.0))))
    for light, jlight in cases:
        assert light.category == jlight.category
        leaves = jax.tree.leaves(jlight.pack())
        want = np.array([np.float32(l) for l in leaves])
        got = torch.tensor(light.pack(), dtype=torch.float32).numpy()
        np.testing.assert_array_equal(got, want)
        row, widths = LAYOUTS[light.category]
        assert row._fields == type(jlight.pack())._fields
        assert widths == tuple(np.size(np.asarray(f)) if not hasattr(f, "x")
                               else 3 for f in jlight.pack())


@pytest.mark.parametrize("name", ["lights_and_quadrics", "area_lights"])
def test_port_scenes_pack_as_jax_scenes(name):
    """Config 4 and the check scene pack to the JAX package's structure and,
    but for the camera's basis in the last bit, its numbers; a point or
    spot light has no object (-1)."""
    _, _, params, static = _bridge(_jax_scene(name))
    tparams, tstatic = getattr(tscenes, name)().pack()
    assert tstatic == static
    np.testing.assert_allclose(tparams.numpy(), params.numpy(), rtol=2e-7,
                               atol=2e-7)
    for cat, obj in zip(tstatic.light_categories,
                        tstatic.area_light_objects):
        assert (obj == -1) == (cat != C.AREA)


def _oracle_twin(scene, h, w, bounces, atol=2e-3, rtol=2e-3):
    """tests/test_oracle_parity.py's `run_parity` through the port: the
    same uniforms (`rand_override`) against the port's numpy oracle, on a
    scene of the port's classes."""
    params, static = scene.pack()
    rand = make_rand((h, w), len(scene.lights), bounces, 0)
    ro_np, rd_np = oracle.camera_rays(scene.camera, h, w)
    want = oracle.trace(scene, ro_np, rd_np, rand, max_bounces=bounces)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ro = Vec3(*(t(ro_np[..., k]) for k in range(3)))
    rd = Vec3(*(t(rd_np[..., k]) for k in range(3)))
    ii, jj = integrator.pixel_grid(h, w, 0, "cpu")
    got = integrator.trace_rays(
        unflatten(params, static), static, ro, rd, PixelNoise(0, 0, ii, jj),
        max_bounces=bounces,
        rand_override=[{k: t(v) for k, v in rb.items()} for rb in rand])
    got = got.stack().numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    return got


def test_oracle_parity_cube_area_light():
    """The per-face cube sampler against the oracle's twin."""
    s = tsail
    scene = s.Scene()
    scene.add(s.Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(s.Cornellbox((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
    scene.add(s.Sphere((0.0, -0.6, 0.0), 0.4, s.Matte(kd=1.0)))
    scene.add(s.AreaLight(s.Cube((-0.3, 0.8, -0.2), (0.3, 0.95, 0.2),
                                 s.Matte()), (5.0, 5.0, 5.0)))
    img = _oracle_twin(scene, 12, 12, 2)
    assert img.mean() > 0.01


def test_area_light_geometry_acceptance():
    """Scene.add takes an area light over every sampleable shape, and
    refuses the one without a surface to sample, the Cornell box, with the
    JAX package's error."""
    from sail_tpu_torch import (AreaLight, Cone, Cornellbox, Cube, Cylinder,
                                Disk, Hyperboloid, Matte, Paraboloid,
                                Rectangle, Scene, Sphere)
    scene = Scene()
    for geom in (Sphere((0, 0, 0), 0.5), Rectangle((0, 0, 0), (1, 0, 1)),
                 Disk((0, 0, 0), 0.5), Cube((0, 0, 0), (1, 1, 1)),
                 Cone((0, 0, 0), 1.0, 0.5, Matte()),
                 Cylinder((0, 0, 0), 1.0, 0.5), Paraboloid((0, 0, 0), 0.0,
                                                           0.5, 0.3),
                 Hyperboloid((0, 0, 0), (0.3, 0, -0.3), (0.4, 0, 0.3))):
        scene.add(AreaLight(geom, (1, 1, 1)))
    assert len(scene.lights) == 8
    with pytest.raises(ValueError, match="no area sampler"):
        scene.add(AreaLight(Cornellbox((-1, -1, -1), (1, 1, 1)), (1, 1, 1)))
    with pytest.raises(ValueError, match="no area sampler"):
        jsail.Scene().add(jsail.AreaLight(
            jsail.Cornellbox((-1, -1, -1), (1, 1, 1)), (1, 1, 1)))


def test_oracle_parity_lights_and_quadrics_small():
    """Config 4 at 16² x 3 bounces against the oracle at its default
    (tight) tolerances: the quadrics and the point and spot paths."""
    img = _oracle_twin(tscenes.lights_and_quadrics(), 16, 16, 3)
    assert img.mean() > 0.01


def test_golden_config4():
    """The plain render (the wrapper on CPU tensors) against golden config
    4: 64², 4 spp, 3 bounces."""
    params, static = tscenes.lights_and_quadrics().pack()
    img = (mk.render_block(params, static, 64, 64, 4, 0, 0, 3).stack()
           * 0.25).numpy()
    res = golden_check(img, np.load(GOLDEN), params, static, 4)
    assert res["unexplained"] == [], res
    assert res["max_abs_elsewhere"] < TOL, res


def test_check_scene_render_matches_jax():
    """The check scene through the whole plain integrator against the JAX
    package's, 16², 3 bounces, two samples."""
    from sail_tpu.render import integrator as jintegrator
    packed, jstatic, params, static = _bridge(_jax_scene("area_lights"))
    view = unflatten(params, static)
    for sample in (0, 1):
        want = jintegrator.render_sample(packed, jstatic, 16, 16, 0, sample,
                                         max_bounces=3).color
        got = integrator.render_sample(view, static, 16, 16, 0, sample, 3)
        np.testing.assert_allclose(got.stack().numpy(),
                                   np.asarray(want.stack()), rtol=TOL,
                                   atol=TOL)
    assert float(got.stack().max()) > 0
    assert JC.AREA == C.AREA and JC.POINT == C.POINT and JC.SPOT == C.SPOT
