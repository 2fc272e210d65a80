"""The gradient path through metal, glass and the uv textures on the CPU,
against the JAX package.

- Torch autograd through the plain integrator against `jax.grad` of
  `sail_tpu.render.integrator.render_sample` per leaf, on `material_demo`
  (BASELINE config 3) and on the check scene `material_check` (Beckmann
  and anisotropic GGX metal, rough glass of both distributions, every uv
  texture, Bilerp and UV on six shapes, so a hit's u and v carry
  gradient): 8², 2 bounces, rtol = atol = 2e-4 with JAX's rsqrt taken as
  `1/sqrt` (the fixture and the tolerance of tests/test_torch_grad.py).
- K2's wrapper `render_grad_block` on CPU tensors (its plain version)
  against `jax.grad` of the same loss, Σ g · image, on `material_demo`,
  and finite where the microfacet D is masked.
The CUDA kernels are held against the plain version on the card
(`chip_smoke.py` phase 7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sail_tpu as jsail
from sail_tpu import scenes as jscenes
from sail_tpu.render.integrator import render_sample as jax_render_sample
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk

from test_torch_grad import TOL, _bridge, _g, _jax_grad, _torch_grad
from test_torch_grad import jax_rsqrt_as_port  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _jax_material_check():
    """`sail_tpu_torch.scenes.material_check` built from the JAX package's
    classes."""
    s = jsail
    scene = s.Scene()
    scene.add(s.Camera((0.0, 0.3, -2.8), (0.0, 0.0, 0.0)))
    scene.add(s.Cornellbox((-1.5, -1.0, -1.5), (1.5, 1.5, 1.5)))
    scene.add(s.Rectangle((-1.5, -0.99, -1.5), (1.5, -0.99, 1.5),
                          s.Matte(kd=0.9),
                          s.Checkerboard2((0.9, 0.9, 0.8), (0.3, 0.2, 0.2),
                                          0.3)))
    scene.add(s.Rectangle((-1.4, -0.9, 1.45), (1.4, 1.2, 1.45), s.Matte(),
                          s.UV()))
    scene.add(s.Sphere((-0.95, -0.6, -0.1), 0.35,
                       s.Metal(roughness=0.25, distribution="beckmann"),
                       s.Bilerp((1.0, 0.3, 0.2), (0.2, 1.0, 0.3),
                                (0.3, 0.2, 1.0), (0.9, 0.9, 0.2))))
    scene.add(s.Sphere((-0.2, -0.6, 0.1), 0.35,
                       s.Metal(uroughness=0.05, vroughness=0.35), s.UV()))
    scene.add(s.Sphere((0.55, -0.6, -0.2), 0.35,
                       s.Glass(eta=1.5, uroughness=0.15, vroughness=0.15)))
    scene.add(s.Cylinder((1.05, -1.0, 0.6), 0.8, 0.25,
                         s.Glass(eta=1.33, uroughness=0.1, vroughness=0.3,
                                 distribution="beckmann"),
                         s.Mix((0.9, 0.9, 1.0), (0.6, 1.0, 0.8), 0.3)))
    scene.add(s.Cube((-1.3, -1.0, 0.7), (-0.8, -0.5, 1.2),
                     s.Matte(kd=0.8, sigma=15.0), s.Checkerboard(0.1, 0.02)))
    scene.add(s.Cone((-0.3, -1.0, 0.9), 0.8, 0.3, s.Matte(kd=0.9),
                     s.Bilerp((0.2, 0.4, 1.0), (1.0, 0.4, 0.2),
                              (0.4, 1.0, 0.2), (0.9, 0.9, 0.9))))
    scene.add(s.Disk((0.4, 0.6, 1.3), 0.4, 0.1, s.Matte(), s.UV()))
    scene.add(s.Paraboloid((0.3, -1.0, 0.9), 0.0, 0.5, 0.25,
                           s.Matte(kd=0.8),
                           s.ScaleT((0.9, 0.6, 0.5), (0.8, 1.0, 0.9))))
    scene.add(s.Hyperboloid((-0.9, 0.5, 0.8), (0.3, 0.0, -0.3),
                            (0.4, 0.0, 0.3), s.Matte(kd=0.9), s.UV()))
    scene.add(s.AreaLight(s.Rectangle((-0.5, 1.48, -0.5), (0.5, 1.48, 0.5),
                                      s.Matte()), (6.0, 6.0, 6.0)))
    return scene


SCENES = {"material_demo": jscenes.material_demo,
          "material_check": _jax_material_check}


def test_check_scene_is_the_ports():
    """The JAX twin above packs to the port's check scene, but for the
    camera basis's last bit."""
    params, static = _bridge(*_jax_material_check().pack())
    tparams, tstatic = tscenes.material_check().pack()
    assert tstatic == static
    np.testing.assert_allclose(tparams.numpy(), params.numpy(), rtol=2e-7,
                               atol=2e-7)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_autograd_matches_jax_grad(name, jax_rsqrt_as_port):
    packed, static = SCENES[name]().pack()
    want = _jax_grad(packed, static, 8, 8, 2)
    got = _torch_grad(*_bridge(packed, static), 8, 8, 2)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert np.isfinite(want).all()
    assert got.shape == (len(want),)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i], w, rtol=TOL, atol=TOL,
                                   err_msg=f"leaf {i}")


def test_grad_block_matches_jax_grad(jax_rsqrt_as_port):
    """K2's wrapper on CPU tensors against `jax.grad` of Σ g · image_sum
    on config 3: 8², 2 bounces, 1 spp."""
    packed, static = jscenes.material_demo().pack()
    g = _g(8, 8)
    gj = [jnp.asarray(c.numpy()) for c in g]

    def loss(p):
        c = jax_render_sample(p, static, 8, 8, 0, 0, max_bounces=2).color
        return jnp.sum(c.x * gj[0] + c.y * gj[1] + c.z * gj[2])

    want = np.stack([np.asarray(l) for l in
                     jax.tree.leaves(jax.grad(loss)(packed))])
    params, tstatic = _bridge(packed, static)
    got = mk.render_grad_block(params, tstatic, g, 8, 8, 1, 0, 0, 2).numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the parameters the materials and textures own take gradient
    off = mk.scene_table(tstatic).offsets
    assert np.abs(got[off.materials[1]:off.lights[0]]).max() > 0


def test_plain_gradient_is_finite_where_d_is_masked():
    """Masked lanes of the microfacet D and tan²θ (cos⁴θ on its 1e-20
    floor) must not turn their zero cotangent into NaN: the plain K2 on the
    check scene at 16², 2 spp, 5 bounces, where such lanes occur."""
    params, static = tscenes.material_check().pack()
    g = Vec3(*(torch.ones(16, 16) for _ in range(3)))
    grad = mk.render_grad_block(params, static, g, 16, 16, 2, 0, 0, 5)
    assert torch.isfinite(grad).all()
    assert grad.abs().max() > 0
