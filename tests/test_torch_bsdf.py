"""The port's BSDFs (`sail_tpu_torch/ops/bsdf.py`) on the CPU.

Each function against the JAX package's (`sail_tpu/ops/bsdf.py`) on the
same seeded random directions and parameters: the Fresnel terms, both
microfacet distributions isotropic and anisotropic, rays entering and
leaving, total internal reflection; then twins of `tests/test_bsdf.py`'s
property tests (furnace, reciprocity, normalisation, Snell).

Tolerance against JAX: rtol = atol = 1e-5 on values (XLA:CPU fuses
multiply-adds, the port does not), 1e-4 where a value passes through exp,
log, sin, cos or the distribution's division by cos⁴θ, which amplify the
last bit.  A sampled direction picks a branch by comparing floats, so
sample tests compare where both sides took the same branch and require it
on all but 1% of the rays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu import constants as JC
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops import bsdf as jbsdf
from sail_tpu.scene.material import Glass as JGlass
from sail_tpu.scene.material import Metal as JMetal
from sail_tpu_torch import constants as C
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import bsdf
from sail_tpu_torch.scene import material

torch.set_num_threads(1)

N = 4096
TOL = 1e-5
TOL_TRANSCENDENTAL = 1e-4
KINDS = [C.BECKMANN, C.TROWBRIDGE_REITZ]


def _dirs(rng, n=N, lower=False):
    """Random unit directions, upper hemisphere (both with `lower`)."""
    v = rng.normal(size=(3, n))
    v /= np.linalg.norm(v, axis=0)
    if not lower:
        v[2] = np.abs(v[2])
    return v.astype(np.float32)


def _both(arr):
    """The same (3, n) float32 array as a JAX Vec3 and a port Vec3."""
    return (JVec3(*(jnp.asarray(c) for c in arr)),
            Vec3(*(torch.from_numpy(c.copy()) for c in arr)))


def _uni(rng, n=N):
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return jnp.asarray(u), torch.from_numpy(u)


def _np(x):
    """A Vec3 of either package as a (3, n) array, a value as an array."""
    if isinstance(x, tuple):
        return np.stack([np.broadcast_to(np.asarray(c, np.float64), (N,))
                         for c in x])
    return np.asarray(x, np.float64)


def _close(got, want, tol=TOL, mask=None):
    got, want = _np(got), _np(want)
    if mask is not None:
        got, want = got[..., mask], want[..., mask]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _params(p):
    """A JAX material's packed fields as 0-d tensors, in its NamedTuple."""
    fields = []
    for f in p:
        if isinstance(f, JVec3):
            fields.append(Vec3(*(torch.tensor(float(c)) for c in f)))
        else:
            fields.append(torch.tensor(float(f)))
    return fields


# -- Fresnel ------------------------------------------------------------------

@pytest.mark.parametrize("eta", [1.5, 1.33, 2.4])
def test_fr_dielectric_matches_jax(eta):
    """Entering and leaving (cos < 0, the indices swap), past the critical
    angle (total internal reflection) and at normal incidence."""
    cos = np.linspace(-1.0, 1.0, N).astype(np.float32)
    want = jbsdf.fr_dielectric(jnp.asarray(cos), 1.0, jnp.float32(eta))
    got = bsdf.fr_dielectric(torch.from_numpy(cos), 1.0, torch.tensor(eta))
    _close(got, want)
    assert (got[(cos > -0.6) & (cos < 0.0)] == 1.0).all()  # TIR on the way out


def test_fr_conductor_matches_jax():
    rng = np.random.default_rng(0)
    cos = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    m = JMetal()
    one = jnp.float32(1.0)
    want = jbsdf.fr_conductor(jnp.asarray(cos), JVec3(one, one, one),
                              JVec3(*(jnp.float32(v) for v in m.eta)),
                              JVec3(*(jnp.float32(v) for v in m.k)))
    t1 = torch.tensor(1.0)
    got = bsdf.fr_conductor(torch.from_numpy(cos), Vec3(t1, t1, t1),
                            Vec3(*(torch.tensor(v) for v in m.eta)),
                            Vec3(*(torch.tensor(v) for v in m.k)))
    _close(got, want)


# -- microfacet distributions -------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ax,ay", [(0.3, 0.3), (0.05, 0.4), (1e-4, 1e-4)])
def test_distribution_matches_jax(kind, ax, ay):
    rng = np.random.default_rng(1)
    jwh, twh = _both(_dirs(rng))
    want = jbsdf._distribution_d(jwh, jnp.float32(ax), jnp.float32(ay), kind)
    got = bsdf._distribution_d(twh, torch.tensor(ax), torch.tensor(ay), kind)
    _close(got, want, TOL_TRANSCENDENTAL)
    jwo, two = _both(_dirs(rng))
    _close(bsdf._distribution_pdf(two, twh, torch.tensor(ax),
                                  torch.tensor(ay), kind),
           jbsdf._distribution_pdf(jwo, jwh, jnp.float32(ax),
                                   jnp.float32(ay), kind),
           TOL_TRANSCENDENTAL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ax,ay", [(0.3, 0.3), (0.05, 0.4), (0.4, 0.1)])
def test_sample_wh_matches_jax(kind, ax, ay):
    """The half-vector of both distributions, isotropic and anisotropic
    (Beckmann's isotropy threshold is 1e-3, GGX's 1e-7), for wo above and
    below the surface (the half-vector follows wo's hemisphere)."""
    rng = np.random.default_rng(2)
    (ju1, tu1), (ju2, tu2) = _uni(rng), _uni(rng)
    jwo, two = _both(_dirs(rng, lower=True))
    want = jbsdf._sample_wh(ju1, ju2, jnp.float32(ax), jnp.float32(ay), jwo,
                            kind)
    got = bsdf._sample_wh(tu1, tu2, torch.tensor(ax), torch.tensor(ay), two,
                          kind)
    _close(got, want, TOL_TRANSCENDENTAL)
    assert (np.sign(got.z.numpy()) == np.sign(two.z.numpy())).all()


# -- material samples ---------------------------------------------------------

def _sample_pair(name, kind, p_jax, into_frac=1.0, seed=3):
    rng = np.random.default_rng(seed)
    (ju1, tu1), (ju2, tu2), (jul, tul) = _uni(rng), _uni(rng), _uni(rng)
    sc = rng.uniform(0.2, 1.0, (3, N)).astype(np.float32)
    jsc, tsc = _both(sc)
    jwo, two = _both(_dirs(rng, lower=True))
    into = rng.uniform(size=N) < into_frac
    p = type(p_jax)(*_params(p_jax))
    if name == "metal":
        want = jbsdf.metal_sample(p_jax, jsc, ju1, ju2, jwo, kind=kind)
        got = bsdf.metal_sample(p, tsc, tu1, tu2, two, kind=kind)
    else:
        want = jbsdf.glass_sample(p_jax, jsc, ju1, ju2, jul, jwo,
                                  jnp.asarray(into), kind=kind)
        got = bsdf.glass_sample(p, tsc, tu1, tu2, tul, two,
                                torch.from_numpy(into), kind=kind)
    return got, want


def _same_branch(got, want):
    """Rays on which both sides sampled the same direction (a branch chosen
    by a float comparison can differ in the last bit's neighbourhood)."""
    gw, jw = _np(got.wi), _np(want.wi)
    same = np.abs(gw - jw).max(0) < 1e-3
    assert same.mean() > 0.99
    return same


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rough", [(0.1, 0.1), (0.05, 0.35)])
def test_metal_sample_matches_jax(kind, rough):
    p = JMetal(uroughness=rough[0], vroughness=rough[1]).pack()
    got, want = _sample_pair("metal", kind, p)
    same = _same_branch(got, want)
    _close(got.wi, want.wi, TOL_TRANSCENDENTAL, same)
    _close(got.weight, want.weight, TOL_TRANSCENDENTAL, same)
    _close(got.f_nee, want.f_nee, TOL_TRANSCENDENTAL, same)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rough,eta,into_frac", [
    ((0.0, 0.0), 1.5, 1.0),     # specular, entering
    ((0.0, 0.0), 1.5, 0.0),     # specular, leaving: TIR past the angle
    ((0.2, 0.2), 1.5, 0.5),     # rough, both ways
    ((0.1, 0.3), 1.33, 0.5),    # rough and anisotropic
])
def test_glass_sample_matches_jax(kind, rough, eta, into_frac):
    p = JGlass(eta=eta, uroughness=rough[0], vroughness=rough[1]).pack()
    got, want = _sample_pair("glass", kind, p, into_frac)
    same = _same_branch(got, want)
    _close(got.wi, want.wi, TOL_TRANSCENDENTAL, same)
    _close(got.weight, want.weight, TOL_TRANSCENDENTAL, same)
    np.testing.assert_array_equal(got.is_specular.numpy(),
                                  np.asarray(want.is_specular))


@pytest.mark.parametrize("kind", KINDS)
def test_microfacet_transmission_matches_jax(kind):
    """The rough dielectric's BTDF value and pdf, entering and leaving, at
    random direction pairs in opposite hemispheres."""
    rng = np.random.default_rng(4)
    wo = _dirs(rng, lower=True)
    wi = _dirs(rng, lower=True)
    wi[2] = -np.sign(wo[2]) * np.abs(wi[2])
    (jwo, two), (jwi, twi) = _both(wo), _both(wi)
    jt, tt = _both(np.ones((3, N), np.float32))
    into = rng.uniform(size=N) < 0.5
    ji, ti = jnp.asarray(into), torch.from_numpy(into)
    a = (jnp.float32(0.2), jnp.float32(0.3))
    b = (torch.tensor(0.2), torch.tensor(0.3))
    _close(bsdf.microfacet_t_f(tt, two, twi, torch.tensor(1.5), ti, *b, kind),
           jbsdf.microfacet_t_f(jt, jwo, jwi, jnp.float32(1.5), ji, *a, kind),
           TOL_TRANSCENDENTAL)
    _close(bsdf.microfacet_t_pdf(two, twi, torch.tensor(1.5), ti, *b, kind),
           jbsdf.microfacet_t_pdf(jwo, jwi, jnp.float32(1.5), ji, *a, kind),
           TOL_TRANSCENDENTAL)


def test_lambertian_t_matches_jax():
    rng = np.random.default_rng(5)
    (ju1, tu1), (ju2, tu2) = _uni(rng), _uni(rng)
    jwo, two = _both(_dirs(rng, lower=True))
    jt, tt = _both(rng.uniform(0.2, 1.0, (3, N)).astype(np.float32))
    want = jbsdf.lambertian_t_sample(jt, ju1, ju2, jwo)
    got = bsdf.lambertian_t_sample(tt, tu1, tu2, two)
    _close(got.wi, want.wi)
    _close(got.weight, want.weight)
    _close(bsdf.lambertian_t_pdf(two, got.wi),
           jbsdf.lambertian_t_pdf(jwo, want.wi))


# -- twins of tests/test_bsdf.py's properties ---------------------------------

def _vfill(n, x, y, z):
    return Vec3(*(torch.full((n,), v) for v in (x, y, z))).normalize()


def _unis(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((3, n), generator=g).unbind(0)


WHITE = lambda n: _vfill(n, 1.0, 1.0, 1.0) * (3 ** 0.5)  # noqa: E731


def test_fr_dielectric_normal_incidence_and_exit():
    assert float(bsdf.fr_dielectric(torch.tensor(1.0), 1.0,
                                    torch.tensor(1.5))) == \
        pytest.approx(0.04, rel=1e-4)
    cos_c = float(np.sqrt(1 - (1 / 1.5) ** 2))
    assert float(bsdf.fr_dielectric(torch.tensor(-(cos_c - 0.05)), 1.0,
                                    torch.tensor(1.5))) == 1.0
    assert float(bsdf.fr_dielectric(torch.tensor(-(cos_c + 0.05)), 1.0,
                                    torch.tensor(1.5))) < 1.0


def test_lambert_white_furnace_and_reciprocity():
    n = 50000
    u1, u2, _ = _unis(n, 0)
    s = bsdf.matte_sample(torch.tensor(1.0), torch.tensor(0.0), WHITE(n), u1,
                          u2, _vfill(n, 0.3, 0.1, 0.94))
    assert float(s.weight.x.mean()) == pytest.approx(1.0, abs=0.01)
    wo, wi = _vfill(16, 0.4, 0.1, 0.91), _vfill(16, -0.2, 0.6, 0.77)
    sig = torch.tensor(np.deg2rad(25.0), dtype=torch.float32)
    f1 = bsdf.matte_f(torch.tensor(0.8), sig, WHITE(16), wo, wi)
    f2 = bsdf.matte_f(torch.tensor(0.8), sig, WHITE(16), wi, wo)
    torch.testing.assert_close(f1.x, f2.x, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_distribution_normalization(kind):
    """∫ D(wh) cosθ dω = 1 over the hemisphere, isotropic and not."""
    n = 200000
    u1, u2, _ = _unis(n, 3)
    z = u1
    r = torch.sqrt(torch.clamp(1 - z * z, min=0.0))
    phi = 2 * np.pi * u2
    wh = Vec3(r * torch.cos(phi), r * torch.sin(phi), z)
    for ax, ay in ((0.3, 0.3), (0.2, 0.45)):
        d = bsdf._distribution_d(wh, torch.tensor(ax), torch.tensor(ay), kind)
        assert float((d * wh.z.abs()).mean() * 2 * np.pi) == \
            pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("kind", KINDS)
def test_metal_samples_upper_hemisphere_and_energy(kind):
    n = 50000
    u1, u2, _ = _unis(n, 6)
    p = material.MetalP(*_params(JMetal(roughness=0.15).pack()))
    s = bsdf.metal_sample(p, WHITE(n), u1, u2, _vfill(n, 0.0, 0.0, 1.0),
                          kind=kind)
    w = s.weight.x
    assert torch.isfinite(w).all() and (w >= 0).all()
    assert (s.wi.z[w > 0] > 0).all()
    assert float(torch.clamp(w, 0, 10).mean()) < 1.05


def test_smooth_glass_energy_and_snell():
    n = 100000
    _, _, ul = _unis(n, 7)
    p = material.GlassP(*_params(JGlass(eta=1.5).pack()))
    wo = _vfill(n, 0.3, 0.0, 0.954)
    s = bsdf.glass_sample(p, WHITE(n), ul, ul, ul, wo,
                          torch.ones(n, dtype=torch.bool))
    f = float(bsdf.fr_dielectric(wo.z[0], 1.0, torch.tensor(1.5)))
    expect = f + (1 - f) * (1 / 1.5) ** 2
    assert float(s.weight.x.mean()) == pytest.approx(expect, abs=0.02)
    ang = np.pi / 6
    wo = _vfill(4, np.sin(ang), 0.0, np.cos(ang))
    ul = torch.full((4,), 0.999)
    s = bsdf.glass_sample(p, WHITE(4), ul * 0, ul * 0, ul, wo,
                          torch.ones(4, dtype=torch.bool))
    torch.testing.assert_close(s.wi.x, torch.full((4,), -np.sin(ang) / 1.5,
                                                  dtype=torch.float32),
                               rtol=1e-4, atol=0.0)
    assert (s.wi.z < 0).all()


def test_material_layouts_and_variants():
    """The packed rows in `jax.tree.flatten` order, and the distribution a
    name selects."""
    m = material.Metal(uroughness=0.1, vroughness=0.2,
                       distribution="beckmann")
    assert m.variant == C.BECKMANN and m.category == C.METAL
    assert m.pack() == (0.1, 0.2, *material._DEFAULT_ETA,
                        *material._DEFAULT_K)
    assert material.Metal(roughness=0.3).pack()[:2] == (0.3, 0.3)
    g = material.Glass(kr=0.9, kt=0.8, eta=1.4, uroughness=0.1)
    assert g.pack() == (0.9, 0.8, 1.4, 0.1, 0.0)
    assert g.variant == C.TROWBRIDGE_REITZ
    assert material.roughness_to_alpha(0.5) == pytest.approx(
        __import__("sail_tpu").scene.material.roughness_to_alpha(0.5))
    assert JC.BECKMANN == C.BECKMANN
