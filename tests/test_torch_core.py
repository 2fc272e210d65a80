"""The port's core math against the JAX package: the polynomial atan2/acos,
the camera basis, primary rays and the cosine hemisphere sampler, on the
same numpy inputs (atol 1e-6: float32 rounding of XLA's fused ops)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.core import camera as jcam
from sail_tpu.core import fastmath as jfm
from sail_tpu.core import samplers as jsamp
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu_torch.core import camera as tcam
from sail_tpu_torch.core import fastmath as tfm
from sail_tpu_torch.core import samplers as tsamp
from sail_tpu_torch.core.vecmath import Vec3

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)
RNG = np.random.RandomState(1234)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_atan2_and_acos_match():
    y = RNG.uniform(-3, 3, 4096).astype(np.float32)
    x = RNG.uniform(-3, 3, 4096).astype(np.float32)
    x[:64] = 0.0                       # the den == 0 substitution
    y[64:128] = 0.0
    y[128:192] = x[128:192]            # |y| == |x|
    np.testing.assert_allclose(tfm.atan2(_t(y), _t(x)).numpy(),
                               np.asarray(jfm.atan2(y, x)), **TOL)
    c = RNG.uniform(-1.2, 1.2, 4096).astype(np.float32)
    np.testing.assert_allclose(tfm.acos(_t(c)).numpy(),
                               np.asarray(jfm.acos(c)), **TOL)


CAMERAS = [((0.0, 0.0, -2.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 55.0, 1.0),
           ((1.3, 0.7, -2.0), (0.1, -0.2, 0.4), (0.0, 1.0, 0.0), 40.0, 1.5),
           ((-2.0, 3.0, 1.0), (0.0, 0.5, 0.0), (0.2, 1.0, 0.1), 70.0, 0.75)]


@pytest.mark.parametrize("cam", CAMERAS)
def test_make_camera_matches(cam):
    want = [np.asarray(v) for v in _leaves(jcam.make_camera(*cam))]
    got = [v.numpy() for v in _leaves(tcam.make_camera(*cam,
                                                        device="cpu"))]
    np.testing.assert_allclose(np.stack(got), np.stack(want), **TOL)


def _leaves(c):
    return [*c.eye, *c.right, *c.up, *c.back, c.tan_half_fovy, c.aspect]


@pytest.mark.parametrize("cam", CAMERAS)
def test_rays_for_pixels_match(cam):
    jc = jcam.make_camera(*cam)
    # the same basis floats on both sides, so only the ray math is compared
    vals = [float(np.asarray(v)) for v in _leaves(jc)]
    tc = tcam.CameraParams(
        *(Vec3(*(torch.tensor(v) for v in vals[k:k + 3])) for k in (0, 3, 6, 9)),
        torch.tensor(vals[12]), torch.tensor(vals[13]))
    h, w = 24, 40
    ii, jj = np.meshgrid(np.arange(h, dtype=np.float32) + 8.0,
                         np.arange(w, dtype=np.float32), indexing="ij")
    jx = RNG.uniform(0, 1, (h, w)).astype(np.float32)
    jy = RNG.uniform(0, 1, (h, w)).astype(np.float32)
    jo, jd = jcam.rays_for_pixels(jc, jnp.asarray(ii), jnp.asarray(jj), 64, w,
                                  jnp.asarray(jx), jnp.asarray(jy))
    to, td = tcam.rays_for_pixels(tc, _t(ii), _t(jj), 64, w, _t(jx), _t(jy))
    for a, b in zip((*td, *to), (*jd, *jo)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_cosine_hemisphere_matches():
    u1 = RNG.uniform(0, 1, 4096).astype(np.float32)
    u2 = RNG.uniform(0, 1, 4096).astype(np.float32)
    u1[:4] = [0.0, 1.0 - 2**-24, 0.5, 1e-7]
    want = jsamp.cosine_hemisphere(jnp.asarray(u1), jnp.asarray(u2))
    got = tsamp.cosine_hemisphere(_t(u1), _t(u2))
    assert isinstance(want, JVec3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
