"""The port's plain torch integrator against the JAX package's
`render_image` (atol = rtol = 1e-5, the megakernel test's own contract) and
against the committed golden renders (1e-4, tests/test_goldens.py)."""
import os

import jax
import numpy as np
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.render.integrator import render_image as jax_render_image
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.render.integrator import render_image
from sail_tpu_torch.scene.scene import unflatten

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _render(name, size, spp, bounces, seed=0, width=None):
    params, static = getattr(tscenes, name)().pack()
    img = render_image(unflatten(params, static), static, size,
                       width or size, spp, seed=seed, max_bounces=bounces)
    return img.stack().numpy()


def _jax_open_lights():
    """`sail_tpu_torch.scenes.open_lights` built from the JAX classes."""
    import sail_tpu as s
    scene = s.Scene()
    scene.add(s.Camera((0.0, 0.4, -3.0), (0.0, -0.2, 0.0), aspect=1.5))
    scene.add(s.Rectangle((-1.5, -1.0, -1.5), (1.5, -1.0, 1.5),
                          s.Matte(kd=0.8, sigma=25.0),
                          s.UniformColor((0.9, 0.85, 0.7))))
    scene.add(s.Sphere((-0.55, -0.5, 0.1), 0.5, s.Matte(kd=0.9, sigma=20.0),
                       s.UniformColor((0.8, 0.3, 0.25))))
    scene.add(s.Sphere((0.45, -0.65, -0.45), 0.35, s.Mirror(kr=0.9)))
    scene.add(s.Sphere((1.0, -0.7, 0.3), 0.3, s.Matte(),
                       emission=(3.0, 1.5, 0.5)))
    scene.add(s.AreaLight(s.Rectangle((-0.5, 1.4, -0.5), (0.5, 1.4, 0.5)),
                          (5.0, 5.0, 5.0)))
    scene.add(s.AreaLight(s.Rectangle((-0.8, -0.6, 1.6), (0.8, 0.8, 1.6),
                                      reverse_normal=True), (0.5, 1.0, 2.0)))
    return scene


def test_open_lights_packs_as_jax():
    packed, jstatic = _jax_open_lights().pack()
    params, static = tscenes.open_lights().pack()
    np.testing.assert_array_equal(
        params.numpy(), np.stack([np.asarray(l)
                                  for l in jax.tree.leaves(packed)]))
    assert static == tuple(tuple(f) for f in jstatic)


@pytest.mark.parametrize("height,width", [(8, 12), (16, 24)])
def test_open_lights_matches_jax(height, width):
    """Misses, Oren-Nayar, an emissive sphere that is not a light, a
    reversed light normal, two lights and a 3:2 image."""
    packed, static = _jax_open_lights().pack()
    want = np.asarray(jax_render_image(packed, static, height, width, 1,
                                       seed=0, max_bounces=2).stack())
    got = _render("open_lights", height, 1, 2, width=width)
    assert np.isfinite(got).all() and got.max() > 0
    assert (got == 0).all(axis=0).any()   # some primary rays miss
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror"])
@pytest.mark.parametrize("size", [8, 16])
def test_render_image_matches_jax(name, size):
    packed, static = getattr(jscenes, name)().pack()
    want = np.asarray(jax_render_image(packed, static, size, size, 1, seed=0,
                                       max_bounces=2).stack())
    got = _render(name, size, 1, 2)
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("golden,name,bounces", [
    ("config1_cornell_matte", "cornell_matte", 2),
    ("config2_cornell_mirror", "cornell_mirror", 3),
])
def test_golden(golden, name, bounces):
    ref = np.load(os.path.join(GOLDEN_DIR, f"{golden}.npy"))
    got = _render(name, 64, 4, bounces)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_jax_is_cpu():
    # the reference side of these comparisons runs on the CPU backend
    assert jax.default_backend() == "cpu"
