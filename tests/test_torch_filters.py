"""The port's display filters against the JAX package's `apply_filter` on
the same seeded images, normals and positions (some of them zero, as a
missed ray leaves them): the windowed filters at atol = rtol = 1e-6, the
others at 1e-5; and the port's twins of tests/test_filters.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops import filters as jfilters
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import filters
from sail_tpu_torch.scene.scene import VALID_FILTERS

torch.set_num_threads(1)

H, W = 20, 24
WINDOWED = ("box", "triangle", "gaussian", "mitchell", "sinc")


def _planes(seed, scale=1.0, zero_every=0):
    """Three seeded (H, W) float32 planes; every `zero_every`-th pixel of all
    three set to 0 (a miss)."""
    r = np.random.RandomState(seed)
    planes = [(r.rand(H, W).astype(np.float32) - 0.25) * scale
              for _ in range(3)]
    if zero_every:
        for p in planes:
            p.reshape(-1)[::zero_every] = 0.0
    return planes


def _both(planes):
    return (JVec3(*(jnp.asarray(p) for p in planes)),
            Vec3(*(torch.from_numpy(p.copy()) for p in planes)))


def _normals(seed):
    n = np.stack(_planes(seed, 2.0, zero_every=5))
    n /= np.maximum(np.linalg.norm(n, axis=0), 1e-6)
    n[:, np.all(n == 0, axis=0)] = -0.0
    return list(n.astype(np.float32))


CASES = [(name, {}) for name in VALID_FILTERS] + [
    ("gamma", {"c": 2.0}),
    ("gaussian", {"r": (3.0, 3.0), "alpha": 1.0}),
    ("mitchell", {"r": (2.5, 1.5), "b": 0.5, "c": 0.25}),
    ("sinc", {"r": (3.0, 3.0), "tau": 2.0}),
    ("wavelet", {"levels": 2, "c_phi": 2.0, "n_phi": 64.0, "p_phi": 0.5}),
]


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_filter_matches_jax(name, params):
    jimg, timg = _both(_planes(0, 1.5))
    jn, tn = _both(_normals(1))
    jp, tp = _both(_planes(2, 3.0, zero_every=7))
    want = np.asarray(jfilters.apply_filter(name, jimg, jn, jp, **params)
                      .stack())
    got = filters.apply_filter(name, timg, tn, tp, **params).stack().numpy()
    tol = 1e-6 if name in WINDOWED else 1e-5
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", WINDOWED)
def test_window_table_matches_jax(name):
    assert (filters.window_table(name, (2.5, 1.5))
            == jfilters.window_table(name, (2.5, 1.5)))


@pytest.mark.parametrize("dy,dx", [(0, 0), (2, -1), (-3, 4), (H, 0),
                                   (0, -W - 1), (H + 5, 3), (-H - 2, -W)])
def test_shifted_matches_jax(dy, dx):
    a = _planes(3)[0]
    want, wvalid = jfilters._shifted(jnp.asarray(a), dy, dx)
    got = filters._shifted(torch.from_numpy(a), dy, dx)
    valid = filters._inside(torch.from_numpy(a), dy, dx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(wvalid, np.float32))


# -- twins of tests/test_filters.py -----------------------------------------

def img_of(a):
    a = torch.as_tensor(np.asarray(a, np.float32))
    return Vec3(a, a * 0.5, a * 0.25)


def rand_img(h, w, seed=0):
    r = np.random.RandomState(seed)
    return Vec3(*(torch.from_numpy(r.rand(h, w).astype(np.float32))
                  for _ in range(3)))


def test_color_passthrough():
    img = rand_img(8, 8)
    out = filters.apply_filter("color", img)
    np.testing.assert_array_equal(out.x.numpy(), img.x.numpy())


def test_gamma():
    img = img_of(np.full((4, 4), 0.25))
    out = filters.apply_filter("gamma", img, c=2.0)
    np.testing.assert_allclose(out.x.numpy(), 0.5, rtol=1e-5)


def test_tonemap_range():
    img = rand_img(8, 8, 1) * 10.0
    a = filters.apply_filter("tonemapping", img).stack().numpy()
    assert a.min() >= 0.0 and a.max() <= 1.0 + 1e-5


@pytest.mark.parametrize("name", WINDOWED)
def test_window_filters_preserve_constant(name):
    img = img_of(np.full((16, 16), 0.7))
    out = filters.apply_filter(name, img, r=(2.0, 2.0))
    np.testing.assert_allclose(out.x.numpy(), 0.7, rtol=1e-4)


def test_window_filter_smooths_noise():
    img = rand_img(32, 32, 2)
    out = filters.apply_filter("gaussian", img, r=(2.0, 2.0))
    assert float(out.x.std()) < float(img.x.std())
    assert float(out.x.mean()) == pytest.approx(float(img.x.mean()),
                                                abs=0.02)


def test_wavelet_smooths_but_keeps_edges():
    h = w = 32
    base = np.zeros((h, w), np.float32)
    base[:, w // 2:] = 1.0
    noisy = base + np.random.RandomState(3).randn(h, w).astype(
        np.float32) * 0.05
    t = torch.from_numpy(noisy)
    img = Vec3(t, t, t)
    z, one = torch.zeros((h, w)), torch.ones((h, w))
    out = filters.apply_filter("wavelet", img, Vec3(z, z, one),
                               Vec3(torch.from_numpy(base), z, z))
    a = out.x.numpy()
    assert a[:, :w // 2 - 2].std() < noisy[:, :w // 2 - 2].std()
    assert (a[:, w // 2 + 2] - a[:, w // 2 - 3]).mean() > 0.8


def test_normal_position_views():
    img = rand_img(4, 4)
    z = torch.zeros((4, 4))
    n = Vec3(z, z, torch.ones((4, 4)))
    out = filters.apply_filter("normal", img, n, n)
    np.testing.assert_allclose(out.z.numpy(), 1.0, rtol=1e-5)
    out = filters.apply_filter("position", img, n, n)
    assert np.isfinite(out.stack().numpy()).all()
    # a zero position (a miss) maps to 0.5, not NaN
    out = filters.apply_filter("position", img, n, Vec3(z, z, z))
    np.testing.assert_array_equal(out.stack().numpy(), 0.5)
