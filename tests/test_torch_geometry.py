"""The port's shapes against the JAX package's, on the CPU: every new
intersect with and without its detail pass, every category's bound box, and
the host classes' packing.

Rays come from numpy seeds and aim at the object, so most hit; some start
inside it, some graze its clip planes (the clipped quadratic's far root) and
some run down its axis (the azimuth's pole).  Tolerance atol = rtol = 1e-6:
both sides do the same float32 operations in the same order; XLA:CPU may
contract a multiply-add and its sin/cos may differ from torch's in the last
ulp (the hyperboloid's tangent)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sail_tpu as jsail
from sail_tpu import constants as JC
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops import intersect as jisect
import sail_tpu_torch as tsail
from sail_tpu_torch import constants as C
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import intersect as isect
from sail_tpu_torch.scene import geometry
from sail_tpu_torch.scene.scene import _view

torch.set_num_threads(1)

TOL = 1e-6

# (constructor args, the JAX intersect's name): the same arguments build the
# JAX and the port object
SHAPES = {
    "cube": (((-0.3, -0.2, -0.4), (0.5, 0.3, 0.2)), "cube_intersect"),
    "cone": (((0.1, -0.5, 0.2), 0.9, 0.35), "cone_intersect"),
    "cylinder": (((0.0, -0.4, -0.1), 0.7, 0.25), "cylinder_intersect"),
    "disk": (((0.2, -0.2, 0.1), 0.45, 0.1), "disk_intersect"),
    "hyperboloid": (((0.0, -0.3, 0.0), (0.45, 0.0, -0.35), (0.6, 0.0, 0.55)),
                    "hyperboloid_intersect"),
    "paraboloid": (((0.1, -0.5, 0.2), 0.0, 0.6, 0.3),
                   "paraboloid_intersect"),
}
CLASSES = {"cube": "Cube", "cone": "Cone", "cylinder": "Cylinder",
           "disk": "Disk", "hyperboloid": "Hyperboloid",
           "paraboloid": "Paraboloid"}


def _objects(name, **kw):
    args, _ = SHAPES[name]
    return (getattr(jsail, CLASSES[name])(*args, **kw),
            getattr(tsail, CLASSES[name])(*args, **kw))


def _port_view(obj):
    cls, widths = geometry.LAYOUTS[obj.category]
    return _view(cls, widths, torch.tensor(obj.pack(), dtype=torch.float32),
                 0)


def _rays(obj, n=768, seed=0):
    """Rays from around the object toward points near it, a quarter from
    its base point (inside or on it), and a few straight down its axis."""
    rng = np.random.default_rng(seed)
    base = np.asarray(obj.pack()[:3], np.float32)
    ro = base + rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    ro[: n // 4] = base + rng.uniform(-0.05, 0.3, (n // 4, 3))
    target = base + rng.uniform(-0.5, 0.8, (n, 3)).astype(np.float32)
    rd = target - ro
    # down the axis (world y is the shapes' local z): the pole of phi
    ro[-8:] = base + np.array([0.0, 2.0, 0.0], np.float32)
    rd[-8:] = np.array([0.0, -1.0, 0.0], np.float32)
    rd[-4:] = np.array([1e-7, -1.0, 0.0], np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def _split(a):
    return [a[:, k] for k in range(3)]


@pytest.mark.parametrize("detail", [False, True])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_intersect_matches_jax(name, detail):
    jobj, tobj = _objects(name)
    ro, rd = _rays(tobj)
    jfn = getattr(jisect, SHAPES[name][1])
    want = jfn(JVec3(*map(jnp.asarray, _split(ro))),
               JVec3(*map(jnp.asarray, _split(rd))), jobj.pack(),
               detail=detail)
    got = isect.SHAPE_FNS[tobj.category](
        Vec3(*map(torch.from_numpy, _split(ro))),
        Vec3(*map(torch.from_numpy, _split(rd))), _port_view(tobj),
        detail=detail)
    t = np.asarray(want.t)
    valid = t < JC.MAX_DISTANCE
    assert valid.sum() > len(t) // 5, "too few hits to test"
    np.testing.assert_allclose(got.t.numpy(), t, atol=TOL, rtol=TOL)
    if not detail:
        return
    for field in ("p", "ng", "dpdu", "u", "v"):
        w = np.broadcast_to(np.stack(jax.tree.leaves(getattr(want, field))),
                            (3 if field in ("p", "ng", "dpdu") else 1,
                             len(t)))
        g = getattr(got, field)
        g = torch.stack(torch.broadcast_tensors(*g)) if isinstance(g, tuple) \
            else g[None]
        np.testing.assert_allclose(g.numpy()[:, valid], w[:, valid],
                                   atol=TOL, rtol=TOL, err_msg=field)


AABB_CASES = [("Sphere", ((0.1, -0.2, 0.3), 0.4)),
              ("Rectangle", ((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3))),
              ("Rectangle", ((-2e4, 3e4, -1.0), (2e4, 3e4, 1.0))),
              ("Cornellbox", ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))),
              ("Disk", ((0.2, 5e3, 0.1), 0.45, 0.1))] + \
    [(CLASSES[name], SHAPES[name][0]) for name in sorted(SHAPES)]


def test_object_aabb_matches_jax():
    """All nine categories, the flat rectangle (a degenerate y axis, also
    far from the origin, where the pad must scale) and the disk's pad."""
    cats = set()
    for cls, args in AABB_CASES:
        jobj, tobj = getattr(jsail, cls)(*args), getattr(tsail, cls)(*args)
        cats.add(tobj.category)
        lo_w, hi_w = jisect.object_aabb(jobj.category, jobj.pack())
        lo_g, hi_g = isect.object_aabb(tobj.category, _port_view(tobj))
        for g, w in zip((*lo_g, *hi_g), (*lo_w, *hi_w)):
            np.testing.assert_allclose(float(g), float(w), atol=TOL,
                                       rtol=TOL, err_msg=cls)
        assert all(float(a) < float(b) for a, b in zip(lo_g, hi_g)), cls
    assert cats == set(geometry.LAYOUTS)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pack_matches_jax_leaves(name):
    """The host classes pack the JAX pytree's leaves, in its order, with an
    emission, a reversed normal and a drag preview."""
    kw = dict(emission=(1.0, 2.0, 3.0), reverse_normal=True)
    jobj, tobj = _objects(name, **kw)
    for o in (jobj, tobj):
        o.temporary_translate((0.1, -0.2, 0.3))
    want = np.array([float(x) for x in jax.tree.leaves(jobj.pack())],
                    np.float32)
    got = torch.tensor(tobj.pack(), dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    # every row ends (emission[3], reverse), where the kernels look for them
    assert len(got) == sum(geometry.LAYOUTS[tobj.category][1])
    assert geometry.LAYOUTS[tobj.category][1][-2:] == (3, 1)
    jobj.translate()
    tobj.translate()
    np.testing.assert_array_equal(
        torch.tensor(tobj.pack(), dtype=torch.float32).numpy(),
        np.array([float(x) for x in jax.tree.leaves(jobj.pack())],
                 np.float32))
