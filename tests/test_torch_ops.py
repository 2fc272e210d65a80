"""The port's ops against the JAX package's on random rays and hit points
from numpy (atol = rtol = 1e-5): the three intersects, the scene fold, the
shadow scan, the two BSDFs, the material dispatch and light sampling.
Both sides read the same scene numbers (carried across by the bridge)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops import bsdf as jbsdf
from sail_tpu.ops import intersect as jisect
from sail_tpu.ops import lights as jlights
from sail_tpu.ops import materials as jmat
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import bsdf as tbsdf
from sail_tpu_torch.ops import intersect as tisect
from sail_tpu_torch.ops import lights as tlights
from sail_tpu_torch.ops import materials as tmat
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import unflatten

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
N = 512


def _scenes(name):
    packed, static = getattr(jscenes, name)().pack()
    tstatic = static_from_jax(static)
    tparams = params_from_jax_leaves([np.asarray(l)
                                      for l in jax.tree.leaves(packed)])
    return packed, static, unflatten(tparams, tstatic), tstatic


def _vec(a):
    """(3, N) numpy -> (JAX Vec3, port Vec3)."""
    a = np.ascontiguousarray(a, np.float32)
    return (JVec3(*(jnp.asarray(c) for c in a)),
            Vec3(*(torch.from_numpy(c.copy()) for c in a)))


def _unit(rng, n):
    d = rng.normal(size=(3, n))
    return d / np.linalg.norm(d, axis=0)


def _rays(seed, toward=None):
    """Origins inside the Cornell box; directions random, or aimed at
    random points of the box `toward` = (lo, hi)."""
    rng = np.random.RandomState(seed)
    ro = rng.uniform(-0.9, 0.9, (3, N))
    if toward is None:
        rd = _unit(rng, N)
    else:
        tgt = rng.uniform(toward[0], toward[1], (N, 3)).T
        rd = (tgt - ro) / np.linalg.norm(tgt - ro, axis=0)
    return _vec(ro), _vec(rd)


def _close(got, want, mask=None):
    """Compare matching (nested) tuples of tensors / arrays."""
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, mask)
        return
    g = got.numpy()
    w = np.asarray(want)
    if mask is not None:
        g, w = g[mask], w[mask]
    if g.dtype == np.bool_ or np.issubdtype(g.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("name,obj,fn,toward", [
    ("cornell_mirror", 1, "sphere_intersect", ((-0.85, -1, -0.6), (-0.05, -0.2, 0.2))),
    ("cornell_mirror", 2, "sphere_intersect", ((0.05, -1, -0.2), (0.85, -0.2, 0.6))),
    ("cornell_mirror", 3, "rectangle_intersect", ((-0.4, 0.98, -0.4), (0.4, 0.98, 0.4))),
    ("cornell_matte", 0, "cornellbox_intersect", None),
])
@pytest.mark.parametrize("detail", [True, False])
def test_shape_intersect(name, obj, fn, toward, detail):
    packed, _, view, _ = _scenes(name)
    (jro, tro), (jrd, trd) = _rays(obj, toward)
    want = getattr(jisect, fn)(jro, jrd, packed.objects[obj], detail=detail)
    got = getattr(tisect, fn)(tro, trd, view.objects[obj], detail=detail)
    hit = np.asarray(want.t) < 1e5
    assert hit.sum() > N // 8          # the rays do hit the object
    _close(got.t, want.t)
    _close(got[1:], tuple(want[1:]), mask=hit)


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror"])
def test_intersect_scene_and_occluded(name):
    packed, static, view, tstatic = _scenes(name)
    (jro, tro), (jrd, trd) = _rays(11)
    want = jisect.intersect_scene(packed.objects, static, jro, jrd)
    got = tisect.intersect_scene(view.objects, tstatic, tro, trd)
    assert bool(np.asarray(want.valid).all())
    _close(got, tuple(want))
    # shadow rays from the hit points toward random points of the light
    tgt = np.random.RandomState(12).uniform((-0.3, 0.98, -0.3),
                                            (0.3, 0.98, 0.3), (N, 3)).T
    p = np.stack([np.asarray(c) for c in want.p])
    n = np.stack([np.asarray(c) for c in want.n])
    org = p + n * 1e-4
    dist = np.linalg.norm(tgt - org, axis=0)
    (jo, to_), (jd, td) = _vec(org), _vec((tgt - org) / dist)
    max_t = (dist * 0.999).astype(np.float32)
    occ_j = np.asarray(jisect.occluded(packed.objects, static, jo, jd, max_t))
    occ_t = tisect.occluded(view.objects, tstatic, to_, td,
                            torch.from_numpy(max_t)).numpy()
    assert 0 < occ_j.sum() < N
    np.testing.assert_array_equal(occ_t, occ_j)


def _shading_inputs(seed):
    rng = np.random.RandomState(seed)
    wo = _unit(rng, N)
    # some below the horizon
    wo[2] = np.where(np.arange(N) < N // 8, -np.abs(wo[2]), np.abs(wo[2]))
    sc = rng.uniform(0.05, 1.0, (3, N))
    u = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    return _vec(wo), _vec(sc), u


@pytest.mark.parametrize("sigma", [0.0, 0.35])
def test_matte_and_mirror_sample(sigma):
    (jwo, two), (jsc, tsc), u = _shading_inputs(3)
    u1, u2 = u[0], u[1]
    kd = np.float32(0.8)
    want = jbsdf.matte_sample(kd, np.float32(sigma), jsc, jnp.asarray(u1),
                              jnp.asarray(u2), jwo)
    got = tbsdf.matte_sample(torch.tensor(kd), torch.tensor(sigma,
                             dtype=torch.float32), tsc, torch.from_numpy(u1),
                             torch.from_numpy(u2), two)
    _close(got, tuple(want))
    want = jbsdf.mirror_sample(np.float32(0.9), jsc, jwo)
    got = tbsdf.mirror_sample(torch.tensor(0.9), tsc, two)
    _close(got, tuple(want))


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror"])
def test_sample_material_and_eval_matte_f(name):
    packed, static, view, tstatic = _scenes(name)
    (jwo, two), (jsc, tsc), u = _shading_inputs(5)
    rows = np.random.RandomState(6).randint(0, len(static.material_categories),
                                            N).astype(np.int32)
    into = np.random.RandomState(7).rand(N) < 0.5
    args_j = (jnp.asarray(rows), jsc, *(jnp.asarray(x) for x in u), jwo,
              jnp.asarray(into))
    args_t = (torch.from_numpy(rows), tsc, *(torch.from_numpy(x) for x in u),
              two, torch.from_numpy(into))
    want = jmat.sample_material(packed.materials, static, *args_j)
    got = tmat.sample_material(view.materials, tstatic, *args_t)
    _close(got, tuple(want))
    (jwi, twi), _, _ = _shading_inputs(8)
    want = jmat.eval_matte_f(packed.materials, static, jnp.asarray(rows), jsc,
                             jwo, jwi)
    got = tmat.eval_matte_f(view.materials, tstatic, torch.from_numpy(rows),
                            tsc, two, twi)
    _close(got, tuple(want))


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror"])
def test_sample_direct(name):
    packed, static, view, tstatic = _scenes(name)
    rng = np.random.RandomState(9)
    # points on the floor and the left wall, normals facing into the box
    p = rng.uniform(-0.95, 0.95, (3, N))
    n = np.zeros((3, N))
    p[1, : N // 2] = -1.0
    n[1, : N // 2] = 1.0
    p[0, N // 2:] = -1.0
    n[0, N // 2:] = 1.0
    (jp, tp), (jn, tn) = _vec(p), _vec(n)
    u = rng.uniform(0, 1, (2, N)).astype(np.float32)
    lidx = np.zeros(N, np.int32)
    want = jlights.sample_direct(packed.objects, packed.lights, static, jp, jn,
                                 jnp.asarray(u[0]), jnp.asarray(u[1]),
                                 jnp.asarray(lidx))
    got = tlights.sample_direct(view.objects, view.lights, tstatic, tp, tn,
                                torch.from_numpy(u[0]), torch.from_numpy(u[1]),
                                torch.from_numpy(lidx))
    assert 0 < int((np.asarray(want[0].x) > 0).sum()) < N   # lit and shadowed
    _close(got, tuple(want))
