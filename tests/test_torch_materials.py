"""BASELINE config 3 and its open twin on the CPU: the port's plain
integrator with metal, glass and the checkerboard against the JAX package,
the golden image, the numpy oracle, and `early_exit`.

- `render_sample` on `material_demo` and `material_demo_open` against the
  JAX XLA integrator (16², 3 bounces, two samples): atol = rtol = 1e-4.
- The plain K1 (`render_block` on CPU tensors) against golden
  `config3_material_demo` (64², 4 spp, 3 bounces): atol = rtol = 1e-4 on
  every pixel but those whose primary ray grazes a sphere within float32
  rounding (`sail_tpu_torch/tools/goldens.py`; XLA:CPU fuses the camera's
  multiply-adds, the port does not, and at (52, 42) that last bit decides
  whether sample 1's ray hits the glass sphere).
- A twin of `tests/test_oracle_parity.py::test_material_demo_small`: the
  same uniforms through `rand_override`, unclipped weights as the oracle
  has them, atol = rtol = 5e-3 (that test's).
- `early_exit=True` against `False`, bit for bit, in the plain version and
  through the Renderer, and against JAX's `early_exit=True` render
  (allclose 1e-4); the alive fractions against JAX's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.core.camera import rays_for_pixels as jrays
from sail_tpu.core.rng import pixel_noise
from sail_tpu.oracle import cpu_tracer as oracle
from sail_tpu.render import integrator as jintegrator
import sail_tpu_torch
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.core.rng import PixelNoise
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.render import integrator
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import unflatten
from sail_tpu_torch.tools.goldens import golden_check

from test_oracle_parity import make_rand

torch.set_num_threads(1)

TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "config3_material_demo.npy")
SCENES = ["material_demo", "material_demo_open"]


def _bridge(scene):
    packed, static = scene.pack()
    return packed, static, params_from_jax_leaves(
        [np.asarray(l) for l in jax.tree.leaves(packed)]), \
        static_from_jax(static)


@pytest.mark.parametrize("name", SCENES)
def test_render_matches_jax(name):
    packed, jstatic, params, static = _bridge(getattr(jscenes, name)())
    scene = unflatten(params, static)
    for sample in (0, 1):
        want = jintegrator.render_sample(packed, jstatic, 16, 16, 0, sample,
                                         max_bounces=3).color
        got = integrator.render_sample(scene, static, 16, 16, 0, sample, 3)
        np.testing.assert_allclose(got.stack().numpy(),
                                   np.asarray(want.stack()), rtol=TOL,
                                   atol=TOL)
    assert float(got.stack().max()) > 0


def test_port_scenes_pack_as_jax_scenes():
    """The port's config-3 scenes pack to the JAX package's structure and,
    but for the camera's basis in the last bit, its numbers."""
    for name in SCENES:
        _, _, params, static = _bridge(getattr(jscenes, name)())
        tparams, tstatic = getattr(tscenes, name)().pack()
        assert tstatic == static
        np.testing.assert_allclose(tparams.numpy(), params.numpy(),
                                   rtol=2e-7, atol=2e-7)


def test_golden_config3():
    params, static = tscenes.material_demo().pack()
    img = (mk.render_block(params, static, 64, 64, 4, 0, 0, 3).stack()
           * 0.25).numpy()
    ref = np.load(GOLDEN)
    res = golden_check(img, ref, params, static, 4)
    assert res["unexplained"] == [], res
    assert res["excused"] == [(52, 42)], res
    assert res["max_abs_elsewhere"] < 1e-4


def test_oracle_parity_material_demo_small():
    """Config 3 shrunk, against the numpy oracle on identical uniforms."""
    jscene = jscenes.material_demo()
    _, _, params, static = _bridge(jscene)
    h = w = 10
    rand = make_rand((h, w), len(jscene.lights), 3, 0)
    ro_np, rd_np = oracle.camera_rays(jscene.camera, h, w)
    want = oracle.trace(jscene, ro_np, rd_np, rand, max_bounces=3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ro = Vec3(*(t(ro_np[..., k]) for k in range(3)))
    rd = Vec3(*(t(rd_np[..., k]) for k in range(3)))
    rand_t = [{k: t(v) for k, v in rb.items()} for rb in rand]
    ii, jj = integrator.pixel_grid(h, w, 0, "cpu")
    got = integrator.trace_rays(unflatten(params, static), static, ro, rd,
                                PixelNoise(0, 0, ii, jj), max_bounces=3,
                                rand_override=rand_t)
    got = got.stack().numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


def _away():
    """Everything behind the camera: every ray misses at bounce 0, so the
    early exit skips that bounce's shading and every later bounce."""
    scene = sail_tpu_torch.Scene()
    scene.add(sail_tpu_torch.Camera((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)))
    scene.add(sail_tpu_torch.Sphere((0.0, 0.0, -3.0), 0.5,
                                    sail_tpu_torch.Metal()))
    return scene


@pytest.mark.parametrize("name", SCENES + ["cornell_mirror", "away"])
def test_early_exit_is_bit_identical(name):
    scene = _away() if name == "away" else getattr(tscenes, name)()
    params, static = scene.pack()
    args = (params, static, 16, 16, 2, 0, 0, 5)
    off = mk.render_block(*args)
    on = mk.render_block(*args, early_exit=True)
    assert torch.equal(off.stack(), on.stack())
    tally_off, tally_on = {}, {}
    sc = unflatten(params, static)
    integrator.render_sample(sc, static, 16, 16, 0, 0, 5, tally=tally_off)
    integrator.render_sample(sc, static, 16, 16, 0, 0, 5, tally=tally_on,
                             early_exit=True)
    # a skipped bounce does no work: fewer bounce records, never more
    assert len(tally_on["bounces"]) <= len(tally_off["bounces"])
    if name == "away":
        assert float(on.stack().abs().max()) == 0.0
        assert len(tally_on["bounces"]) == 1


def test_renderer_early_exit():
    scene = tscenes.material_demo_open()
    images = []
    for ee in (False, True):
        r = sail_tpu_torch.Renderer(12, 12, seed=3, max_bounces=4,
                                    device="cpu", early_exit=ee)
        assert r.early_exit is ee
        r.update(scene)
        r.render_spp(scene, 2)
        images.append(r.output(scene))
    np.testing.assert_array_equal(images[0], images[1])
    r.early_exit = 0
    assert r.early_exit is False


def test_early_exit_matches_jax():
    packed, jstatic, params, static = _bridge(jscenes.material_demo_open())
    want = jintegrator.render_sample(packed, jstatic, 16, 16, 0, 0,
                                     max_bounces=4, early_exit=True).color
    got = integrator.render_sample(unflatten(params, static), static, 16, 16,
                                   0, 0, 4, early_exit=True)
    np.testing.assert_allclose(got.stack().numpy(), np.asarray(want.stack()),
                               rtol=TOL, atol=TOL)


def test_alive_fractions_match_jax():
    """The per-bounce occupancy of the open scene (the early exit's case):
    the same lanes die in both packages."""
    packed, jstatic, params, static = _bridge(jscenes.material_demo_open())
    h = w = 16
    ii = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], (h, w))
    jj = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :], (h, w))
    noise = pixel_noise(0, 0, ii=ii, jj=jj)
    jx, jy, _ = noise.uniform3(0, 0)
    ro, rd = jrays(packed.camera, ii.astype(jnp.float32),
                   jj.astype(jnp.float32), h, w, jx, jy)
    want = jintegrator.alive_fractions(packed, jstatic, ro, rd, noise, 4)
    scene = unflatten(params, static)
    tii, tjj = integrator.pixel_grid(h, w, 0, "cpu")
    tnoise = PixelNoise(0, 0, tii, tjj)
    tx, ty, _ = tnoise.uniform3(0, 0)
    from sail_tpu_torch.core.camera import rays_for_pixels
    tro, trd = rays_for_pixels(scene.camera, tii.float(), tjj.float(), h, w,
                               tx, ty)
    got = integrator.alive_fractions(scene, static, tro, trd, tnoise, 4)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1.0 / 256)
    assert 0.0 < float(got[0][0]) < 1.0 and float(got[0][-1]) < float(got[0][0])
