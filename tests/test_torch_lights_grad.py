"""The gradient path through the lights on the CPU, against the JAX package.

- Torch autograd through the plain integrator against `jax.grad` of
  `sail_tpu.render.integrator.render_sample` per leaf, on config 4
  (`lights_and_quadrics`: area, point and spot lights) and on the check
  scene `area_lights` (an area light over each of seven shapes): 8², 2
  bounces, rtol = atol = 2e-4 with JAX's rsqrt taken as `1/sqrt` (the
  fixture and the tolerance of tests/test_torch_grad.py).
- Autograd through `sample_direct` against `jax.grad` per light: the
  adjoint of each area sampler, of a point light's jitter radius and of a
  spot's falloff band, on seeded hit points (rtol = atol = 1e-5 of the
  largest leaf: one op chain, no path).
- The plain gradient is finite where a lane's division is masked: a disk
  light sampled at its center, u = (0.5, 0.5), and hit points outside a
  spot's cone (which give its cosines no gradient).
- The paraboloid's band clamp `maximum(min(z0, z1), 0)` sits on its bound
  when z0 = 0: the port gives z0 JAX's half of the gradient there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops import lights as jlights
from sail_tpu_torch import constants as C
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import lights as tlights
from sail_tpu_torch.scene.scene import param_offsets, unflatten

from test_torch_grad import TOL, _bridge, _jax_grad, _torch_grad
from test_torch_grad import jax_rsqrt_as_port  # noqa: F401  (fixture)
from test_torch_lights import _jax_scene

torch.set_num_threads(1)

N = 256


@pytest.mark.parametrize("name", ["lights_and_quadrics", "area_lights"])
def test_autograd_matches_jax_grad(name, jax_rsqrt_as_port):
    packed, static = _jax_scene(name).pack()
    want = _jax_grad(packed, static, 8, 8, 2)
    got = _torch_grad(*_bridge(packed, static), 8, 8, 2)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert np.isfinite(want).all()
    assert got.shape == (len(want),)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i], w, rtol=TOL, atol=TOL,
                                   err_msg=f"leaf {i}")
    # every light's row takes gradient
    off = param_offsets(_bridge(packed, static)[1])
    for start in off.lights:
        assert np.abs(got[start:start + 3]).max() > 0


def _hit_points(seed, n=N):
    """Hit points on the floor (normal +y) and the back wall (normal -z)
    of config 4's room, as (numpy p, numpy n)."""
    rng = np.random.RandomState(seed)
    p = rng.uniform((-1.4, -1.0, -1.4), (1.4, 1.0, 1.4), (n, 3)).T
    nrm = np.zeros((3, n))
    p[1, : n // 2] = -0.999
    nrm[1, : n // 2] = 1.0
    p[2, n // 2:] = 1.499
    nrm[2, n // 2:] = -1.0
    return p.astype(np.float32), nrm.astype(np.float32)


def _direct_grads(name, li, p, nrm, u, weights=(0.3, 0.5, 0.2)):
    """d(Σ w · direct radiance)/d(params) of light `li` picked at every hit
    point, from jax.grad and from torch autograd, as flat numpy arrays."""
    packed, static = _jax_scene(name).pack()
    params, tstatic = _bridge(packed, static)
    lidx = np.full(p.shape[1], li, np.int32)
    jv = lambda a: JVec3(*(jnp.asarray(c) for c in a))  # noqa: E731

    def jloss(pk):
        rad, _ = jlights.sample_direct(pk.objects, pk.lights, static, jv(p),
                                       jv(nrm), jnp.asarray(u[0]),
                                       jnp.asarray(u[1]), jnp.asarray(lidx))
        return jnp.sum(rad.x * weights[0] + rad.y * weights[1]
                       + rad.z * weights[2])

    want = np.stack([np.asarray(l) for l in
                     jax.tree.leaves(jax.grad(jloss)(packed))])
    x = params.clone().requires_grad_()
    view = unflatten(x, tstatic)
    tv = lambda a: tuple(torch.from_numpy(c.copy()) for c in a)  # noqa: E731
    rad, _ = tlights.sample_direct(view.objects, view.lights, tstatic,
                                   Vec3(*tv(p)), Vec3(*tv(nrm)),
                                   torch.from_numpy(u[0].copy()),
                                   torch.from_numpy(u[1].copy()),
                                   torch.from_numpy(lidx))
    loss = (rad.x * weights[0] + rad.y * weights[1]
            + rad.z * weights[2]).sum()
    (got,) = torch.autograd.grad(loss, x)
    return got.numpy(), want, tstatic


# (scene, light index): an area light over each sampleable shape, the
# point light and the spot light
LIGHTS = {"rectangle": ("lights_and_quadrics", 0),
          "point": ("lights_and_quadrics", 1),
          "spot": ("lights_and_quadrics", 2),
          "sphere": ("area_lights", 0), "disk": ("area_lights", 1),
          "cube": ("area_lights", 2), "cone": ("area_lights", 3),
          "cylinder": ("area_lights", 4), "paraboloid": ("area_lights", 5),
          "hyperboloid": ("area_lights", 6)}


@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_sample_direct_grad_matches_jax(light, jax_rsqrt_as_port):
    name, li = LIGHTS[light]
    p, nrm = _hit_points(21)
    u = np.random.RandomState(22).uniform(0, 1, (2, N)).astype(np.float32)
    got, want, static = _direct_grads(name, li, p, nrm, u)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    # the light's own parameters take gradient: its emission, and for an
    # area light its shape's
    off = param_offsets(static)
    assert np.abs(got[off.lights[li]:off.lights[li] + 3]).max() > 0
    if static.light_categories[li] == C.AREA:
        obj = static.area_light_objects[li]
        assert np.abs(got[off.objects[obj]:off.objects[obj] + 3]).max() > 0


def test_plain_gradient_is_finite_at_the_disk_center():
    """u = (0.5, 0.5) maps to the disk's center, where concentric_disk's
    divisions read their 1e-20 guard: the gradient stays finite."""
    p, nrm = _hit_points(23)
    u = np.full((2, N), 0.5, np.float32)
    got, want, static = _direct_grads("area_lights", LIGHTS["disk"][1], p,
                                      nrm, u)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_plain_gradient_is_finite_outside_the_spot_cone():
    """Hit points all outside the spot's cone (at least 38.6 degrees off
    its axis, the cone 35): its falloff is 0, no parameter takes gradient,
    and nothing is NaN."""
    rng = np.random.RandomState(24)
    p = np.stack([rng.uniform(-1.4, -1.0, N), np.full(N, -0.999),
                  rng.uniform(-1.4, 1.4, N)]).astype(np.float32)
    nrm = np.zeros((3, N), np.float32)
    nrm[1] = 1.0
    u = rng.uniform(0, 1, (2, N)).astype(np.float32)
    li = LIGHTS["spot"][1]
    got, want, static = _direct_grads("lights_and_quadrics", li, p, nrm, u)
    assert np.isfinite(got).all()
    assert (got == 0).all() and (want == 0).all()   # dark: no gradient


def test_paraboloid_tie_gives_jax_gradient(jax_rsqrt_as_port):
    """The check scene's paraboloid light has z0 = 0 < z1, so the band's
    lower end, maximum(min(z0, z1), 0), sits on its bound: JAX gives z0
    half the gradient there (torch.clamp would give it all), and so does
    the port."""
    name, li = LIGHTS["paraboloid"]
    p, nrm = _hit_points(25)
    u = np.random.RandomState(26).uniform(0, 1, (2, N)).astype(np.float32)
    got, want, static = _direct_grads(name, li, p, nrm, u)
    obj = static.area_light_objects[li]
    z0 = param_offsets(static).objects[obj] + 3
    params = _bridge(*_jax_scene(name).pack())[0]
    assert float(params[z0]) == 0.0 < float(params[z0 + 1])
    assert want[z0] != 0
    np.testing.assert_allclose(got[z0], want[z0], rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_k2_takes_lights_up_to_its_largest_lights_build():
    """K2's builds with the lights beyond a rectangle area light go up to
    LIGHTS_MAX_CAP (352) parameters: a larger scene with a point light is
    refused before any launch, naming the limit, while its plain gradient
    (a CPU tensor) and the scenes of this file stay inside it."""
    import sail_tpu_torch as sail
    from sail_tpu_torch import scenes as tscenes
    from sail_tpu_torch.ops.cuda import megakernel as mk
    assert mk.LIGHTS_MAX_CAP == mk.GRAD_CAPS[0]
    for name in ("lights_and_quadrics", "area_lights"):
        params, static = getattr(tscenes, name)().pack()
        assert mk.scene_table(static).lights
        assert mk.grad_build(params.numel()) <= mk.LIGHTS_MAX_CAP
    scene = tscenes.many_spheres(24)
    scene.add(sail.PointLight((0.0, 0.9, 0.0), (1.0, 1.0, 1.0)))
    params, static = scene.pack()
    assert params.numel() > mk.LIGHTS_MAX_CAP
    g = Vec3(*(torch.ones(4, 4) for _ in range(3)))
    with pytest.raises(NotImplementedError, match="352"):
        mk.render_grad_rows(params, static, g, 4, 4, 1, 0, 0, 2)
    grad = mk.render_grad_block(params, static, g, 4, 4, 1, 0, 0, 2)
    assert torch.isfinite(grad).all()
