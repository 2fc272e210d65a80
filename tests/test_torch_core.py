"""The port's core math against the JAX package: the polynomial
atan2/acos/asin, the camera basis, primary rays, the samplers and the
vector helpers (splat, from_stacked, onb), on the same numpy inputs (atol
1e-6: float32 rounding of XLA's fused ops)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.core import camera as jcam
from sail_tpu.core import fastmath as jfm
from sail_tpu.core import samplers as jsamp
from sail_tpu.core import vecmath as jvm
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu_torch.core import camera as tcam
from sail_tpu_torch.core import fastmath as tfm
from sail_tpu_torch.core import samplers as tsamp
from sail_tpu_torch.core import vecmath as tvm
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


def test_asin_matches():
    x = RNG.uniform(-1.2, 1.2, 4096).astype(np.float32)
    x[:3] = [-1.0, 0.0, 1.0]
    np.testing.assert_allclose(tfm.asin(_t(x)).numpy(),
                               np.asarray(jfm.asin(x)), **TOL)


def test_uniform_disk_and_triangle_match():
    u1 = RNG.uniform(0, 1, 4096).astype(np.float32)
    u2 = RNG.uniform(0, 1, 4096).astype(np.float32)
    u1[:3] = [0.0, 1.0 - 2**-24, 0.25]
    for name in ("uniform_disk", "uniform_triangle"):
        want = getattr(jsamp, name)(jnp.asarray(u1), jnp.asarray(u2))
        got = getattr(tsamp, name)(_t(u1), _t(u2))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("cos_max", [0.8, -0.3, 1.0])
def test_uniform_cone_matches(cos_max):
    u1 = RNG.uniform(0, 1, 4096).astype(np.float32)
    u2 = RNG.uniform(0, 1, 4096).astype(np.float32)
    want = jsamp.uniform_cone(jnp.asarray(u1), jnp.asarray(u2), cos_max)
    got = tsamp.uniform_cone(_t(u1), _t(u2), cos_max)
    assert isinstance(got, Vec3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("v", [(0.5, -1.0, 2.0), 3.0, [1, 2, 3]])
def test_splat_matches(v):
    want = jvm.splat(v)
    got = tvm.splat(v, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == ()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tvm.splat(got) is got


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_from_stacked_matches(axis):
    shape = [4, 5, 6]
    shape[axis] = 3
    a = RNG.uniform(-1, 1, shape).astype(np.float32)
    want = jvm.from_stacked(jnp.asarray(a), axis)
    got = tvm.from_stacked(_t(a), axis)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(got.stack(axis).numpy(), a)


def test_onb_matches():
    n = RNG.normal(size=(3, 512)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    n[:, :2] = [[0.0, 0.0], [0.0, 0.0], [1.0, -1.0]]   # ortho's other branch
    want = jvm.onb(JVec3(*map(jnp.asarray, n)))
    got = tvm.onb(Vec3(*map(_t, n)))
    for gv, wv in zip(got, want):
        for a, b in zip(gv, wv):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
