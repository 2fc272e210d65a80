"""The profiling kernels' plain versions (`sail_tpu_torch.ops.cuda.profile`)
against the JAX package's, on the CPU: K5a (intersect-only) and K5b/K5c
(the ALU peak loops) against their Pallas kernels in interpret mode, and K1
with a phase stripped against the JAX integrator under the patches of
`tools/profile_megakernel.py:325-350`.  The Pallas bodies are closures
inside that tool, so this file carries copies of them, citing their lines.
The CUDA kernels run only on the card (`python3 chip_smoke.py`, phase 8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import sail_tpu.core.rng as jrng
import sail_tpu.ops.intersect as jisect
import sail_tpu.ops.lights as jlights
import sail_tpu.ops.textures as jtextures
from sail_tpu import scenes as jscenes
from sail_tpu.core.camera import rays_for_pixels as jax_rays
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops.pallas.megakernel import _flatten_scene
from sail_tpu.render.integrator import render_sample as jax_render_sample
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.core.camera import rays_for_pixels
from sail_tpu_torch.core.rng import TAG_PIXEL_JITTER, PixelNoise
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import intersect as isect
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.ops.cuda import profile as pf
from sail_tpu_torch.render.integrator import pixel_grid
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import unflatten
from sail_tpu_torch.tools.goldens import grazing_pixels

from test_intersect import _many_sphere_scene

torch.set_num_threads(1)


def _bridge(scene):
    packed, static = scene.pack()
    return (packed, static,
            params_from_jax_leaves([np.asarray(l)
                                    for l in jax.tree.leaves(packed)]),
            static_from_jax(static))


# ------------------------------------------------------------------ K5a ----

def _jax_isect_only(packed, static, H, W, spp, bounces):
    """The Pallas K5a of tools/profile_megakernel.py:380-419 (its kernel
    body :385-411, copied), in interpret mode, returning the image rather
    than its sum."""
    params, treedef, n_leaves = _flatten_scene(packed)
    tr = 8

    def kernel(params_ref, out_ref):
        vals = [params_ref[i] for i in range(n_leaves)]
        pk = jax.tree.unflatten(treedef, vals)
        ti = pl.program_id(0)
        ii = (ti * tr + jax.lax.broadcasted_iota(jnp.int32, (tr, W), 0))
        jj = jax.lax.broadcasted_iota(jnp.int32, (tr, W), 1)
        noise = jrng.PixelNoise(jnp.int32(0), jnp.int32(0), ii, jj)
        jx, jy, _ = noise.uniform3(0, jrng.TAG_PIXEL_JITTER)
        ro0, rd0 = jax_rays(pk.camera, ii.astype(jnp.float32),
                            jj.astype(jnp.float32), H, W, jx, jy)

        def body(s, acc):
            ro, rd = ro0, rd0
            a = jnp.zeros((tr, W), jnp.float32)
            for b in range(bounces):
                hit = jisect.intersect_scene(pk.objects, static, ro, rd)
                a = a + jnp.where(hit.valid, hit.t, 0.0)
                rd = (rd - hit.n * (2.0 * hit.n.dot(rd))).normalize()
                ro = hit.p + hit.n * 1e-4
            return acc + a

        out_ref[:] = jax.lax.fori_loop(
            0, spp, body, jnp.zeros((tr, W), jnp.float32))

    return np.asarray(pl.pallas_call(
        kernel, grid=(H // tr,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((tr, W), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((H, W), jnp.float32),
        interpret=True)(params))


# K5a against the Pallas kernel.  One bounce (the primary hits): atol = rtol
# = 1e-5 on every pixel, but those whose primary ray grazes a sphere,
# excused by name (tools/goldens.grazing_pixels: XLA:CPU's fused camera
# multiply-adds move a ray by an ulp, which decides hit or miss there).
# Several bounces: a reflection off a sphere of radius r scales a ray's
# rounding error by about 2t/r, so two float32 runs part by more than that
# (on spheres8's 0.12-radius spheres the sum of t moves 9.6e-5 between JAX
# and the plain version at the second bounce).  There each of them is held
# to the plain version run in float64, at rtol = 1e-4: both drift up to
# 6.4e-5 from it on these scenes.
ISECT_TOL = 1e-5
WITNESS_RTOL = 1e-4
ISECT_CASES = {
    # name: (JAX scene, size, spp, bounces)
    "cornell_mirror": (jscenes.cornell_mirror, 16, 2, 3),
    "material_demo_open": (jscenes.material_demo_open, 8, 2, 3),  # misses
    "spheres8": (lambda: _many_sphere_scene(8), 8, 2, 3),  # batched fold
}


@pytest.mark.parametrize("name", sorted(ISECT_CASES))
def test_isect_only_plain_matches_pallas_interpret(name):
    make, size, spp, bounces = ISECT_CASES[name]
    packed, static, params, tstatic = _bridge(make())
    want = _jax_isect_only(packed, static, size, size, spp, 1)
    got = pf.isect_only_block(params, tstatic, size, size, spp, 1).numpy()
    assert np.isfinite(got).all() and got.max() > 0
    bad = np.abs(got - want) > ISECT_TOL + ISECT_TOL * np.abs(want)
    excused = grazing_pixels(params, tstatic, size, size, spp) \
        if bad.any() else set()
    unexplained = {tuple(map(int, p)) for p in np.argwhere(bad)} - excused
    assert not unexplained, (unexplained, float(np.abs(got - want).max()))

    want = _jax_isect_only(packed, static, size, size, spp, bounces)
    got = pf.isect_only_block(params, tstatic, size, size, spp,
                              bounces).numpy()
    witness = pf.isect_only_plain(params.double(), tstatic, size, size, spp,
                                  bounces).numpy()
    for x in (got, want):
        np.testing.assert_allclose(x, witness, rtol=WITNESS_RTOL,
                                   atol=ISECT_TOL)


def test_isect_only_miss_restarts_at_the_origin():
    """A ray that misses keeps its direction and restarts at the world
    origin, as the TPU kernel's does (the miss record: t = 1e5, p = 0,
    n = 0): on the open scene, the second bounce of each primary ray that
    missed is the closest hit from the origin along its direction."""
    params, static = tscenes.material_demo_open().pack()
    tally = []
    pf.isect_only_plain(params, static, 8, 8, 1, 2, tally=tally)
    (_, hit0), (obj1, hit1) = tally
    assert (~hit0).any()
    scene = unflatten(params, static)
    ii, jj = pixel_grid(8, 8, 0, "cpu")
    jx, jy, _ = PixelNoise(0, 0, ii, jj).uniform3(0, TAG_PIXEL_JITTER)
    _, rd = rays_for_pixels(scene.camera, ii.float(), jj.float(), 8, 8, jx,
                            jy)
    origin = Vec3(*(torch.zeros(8, 8),) * 3)
    hit = isect.intersect_scene(scene.objects, static, origin, rd.normalize())
    assert torch.equal(hit.valid[~hit0], hit1[~hit0])
    assert torch.equal(hit.obj_id[~hit0], obj1[~hit0])


def test_isect_only_sums_spp_equal_samples():
    params, static = tscenes.cornell_mirror().pack()
    one = pf.isect_only_block(params, static, 8, 8, 1, 3)
    three = pf.isect_only_block(params, static, 8, 8, 3, 3)
    assert torch.equal(three, one + one + one)
    tile = pf.isect_only_block(params, static, 4, 8, 3, 3, row0=4,
                               image_height=8)
    assert torch.equal(tile, three[4:])


# ------------------------------------------------------------- K5b, K5c ----

def _jax_fma_mix(a, b):   # tools/profile_megakernel.py:539-544
    for _ in range(4):
        a = a * b + 1.000001
        b = b * a + 0.999999
    return a, b


def _jax_integrator_mix(a, b):   # :546-553
    for _ in range(2):
        a = a * b + 1.000001
        m = jnp.maximum(a, b)
        s = jnp.where(a > b, a, b * 1.000001)
        b = jax.lax.rsqrt(jnp.abs(m * s) + 1.0)
    return a, b


def _jax_run_kernel(body_ops, R, Cn, G, K):
    """`run_kernel` (:519-537) in interpret mode, returning the block."""
    def kernel(out_ref):
        a = (jax.lax.broadcasted_iota(jnp.int32, (R, Cn), 1)
             .astype(jnp.float32) * 1e-3 + 1.0)
        b = a * 0.5 + 0.25

        def body(i, ab):
            a, b = ab
            return body_ops(a, b)

        a, b = jax.lax.fori_loop(0, K, body, (a, b))
        out_ref[:] = a + b

    return np.asarray(pl.pallas_call(
        kernel, grid=(G,),
        out_specs=pl.BlockSpec((R, Cn), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, Cn), jnp.float32),
        interpret=True)())


def _jax_run_kernel_ilp8(R, Cn, G, K):
    """`run_kernel_ilp8` (:572-593, chains :555-570) in interpret mode."""
    def kernel(out_ref):
        base = (jax.lax.broadcasted_iota(jnp.int32, (R, Cn), 1)
                .astype(jnp.float32) * 1e-3 + 1.0)
        chains = tuple((base * (1.0 + 0.01 * c), base * 0.5 + 0.25)
                       for c in range(8))

        def body(i, ch):
            return tuple(_jax_integrator_mix(a, b) for a, b in ch)

        chains = jax.lax.fori_loop(0, K, body, chains)
        acc = chains[0][0]
        for a, b in chains[1:]:
            acc = acc + a + b
        out_ref[:] = acc + chains[0][1]

    return np.asarray(pl.pallas_call(
        kernel, grid=(G,),
        out_specs=pl.BlockSpec((R, Cn), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, Cn), jnp.float32),
        interpret=True)())


# Relative tolerances against JAX on the CPU.  fma: XLA:CPU rounds each
# product and sum of the chain, the plain version fuses them as FFMA does,
# and 8 chained mul-adds on values that grow to 6e10 move by 2.5e-6; from
# K = 2 both overflow to +inf everywhere and must agree exactly.
# integrator_mix: torch's rsqrt against XLA's, 1 ulp (1.0e-7).
MIX_RTOL = {"fma": 1e-5, "integrator_mix": 1e-6}
R, CN, G = 8, 128, 2


def _close(got, want, rtol):
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


@pytest.mark.parametrize("iters", [1, 2, 3, 16])
@pytest.mark.parametrize("mix", ["fma", "integrator_mix"])
def test_alu_peak_plain_matches_pallas_interpret(mix, iters):
    body = {"fma": _jax_fma_mix, "integrator_mix": _jax_integrator_mix}[mix]
    want = _jax_run_kernel(body, R, CN, G, iters)
    got = pf.alu_peak(mix, R, CN, G, iters, device="cpu").numpy()
    assert got.shape == (R, CN)
    if mix == "fma" and iters > 1:
        assert np.isposinf(got).all()
    else:
        assert np.isfinite(got).all()
        if iters <= 3:   # before the fixed point they differ per element
            assert len(np.unique(got[0])) > 1
    _close(got, want, MIX_RTOL[mix])


@pytest.mark.parametrize("iters", [1, 2, 3, 16])
def test_alu_peak_ilp8_plain_matches_pallas_interpret(iters):
    want = _jax_run_kernel_ilp8(R, CN, G, iters)
    got = pf.alu_peak_ilp8(R, CN, G, iters, device="cpu").numpy()
    assert np.isfinite(got).all()
    _close(got, want, MIX_RTOL["integrator_mix"])


def test_fma_plain_rounds_once_per_mul_add():
    """The plain fma_mix is FFMA's fused mul-add (to a double rounding):
    its first step is float32(a·b + c) from the exact product."""
    a = torch.tensor([1.5, 3.0000002], dtype=torch.float32)
    b = torch.tensor([1.0000001, 7.0], dtype=torch.float32)
    c = torch.tensor(1.000001, dtype=torch.float32)
    exact = np.float32(np.float64(a.numpy()) * np.float64(b.numpy())
                       + np.float64(c.numpy()))
    assert np.array_equal(pf._fma(a, b, c).numpy(), exact)


def test_ulp_diff():
    x = torch.tensor([1.0, -2.0, float("inf"), 0.0])
    y = torch.nextafter(x, torch.tensor(float("inf")))
    assert pf.ulp_diff(x, x) == 0
    assert pf.ulp_diff(x[:2], y[:2]) == 1
    assert pf.ulp_diff(torch.tensor([0.0]), torch.tensor([-0.0])) == 0


# -------------------------------------------------- K1, phase stripped ----

def _const_u3(self, bounce, tag):   # :326-328
    h = jnp.full(jnp.shape(self.ii), 0.5, jnp.float32)
    return h, h, h


def _const_sc(textures, static_, tex_row, p, u, v, ov, use_ov):   # :334-336
    one = jnp.ones(jnp.shape(u), jnp.float32)
    return JVec3(one, one, one)


# :340-341 and :347-349 with the `cull=` keyword that sail_tpu/ops/lights.py
# and sail_tpu/render/integrator.py now pass (the tool's own patches lack it)
def _no_occ(objects, static_, ro, rd, max_t, cull=False):
    return jnp.zeros(jnp.shape(max_t), bool)


def _no_nee(objects, lights, static_, hit_p, hit_n, u1, u2, lidx, cull=False):
    zero = jnp.zeros(hit_p.shape, jnp.float32)
    return JVec3(zero, zero, zero), JVec3(zero, zero, zero + 1.0)


JAX_PATCHES = {
    "const_rng": (jrng.PixelNoise, "uniform3", _const_u3),
    "const_texture": (jtextures, "surface_color", _const_sc),
    "no_shadow_scan": (jisect, "occluded", _no_occ),
    "no_nee": (jlights, "sample_direct", _no_nee),
}
STRIP_SCENES = {"cornell_mirror": jscenes.cornell_mirror,
                "material_demo": jscenes.material_demo}
STRIP_SHAPE = (8, 2, 2)   # size, spp, bounces


@pytest.mark.parametrize("scene", sorted(STRIP_SCENES))
@pytest.mark.parametrize("strip", sorted(pf.STRIPS))
def test_stripped_plain_matches_patched_jax(strip, scene, monkeypatch):
    """The stripped plain version against the JAX integrator under the
    same patch, atol = rtol = 1e-5 (the integrator test's contract); each
    stripped image differs from the full one, so the strip took.  JAX's
    `render_image` is the mean of its `render_sample` passes; they run
    here eagerly, one per sample (an XLA compile of `render_image` under
    each patch took 13-17 s on material_demo)."""
    size, spp, bounces = STRIP_SHAPE
    packed, static, params, tstatic = _bridge(STRIP_SCENES[scene]())
    got = pf.render_block_stripped(strip, params, tstatic, size, size, spp,
                                   0, 0, bounces).stack() * (1.0 / spp)
    full = mk.render_block(params, tstatic, size, size, spp, 0, 0,
                           bounces).stack() * (1.0 / spp)
    monkeypatch.setattr(*JAX_PATCHES[strip])
    want = sum(np.asarray(jax_render_sample(packed, static, size, size, 0, s,
                                            bounces).color.stack())
               for s in range(spp)) * np.float32(1.0 / spp)
    got = got.numpy()
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not np.array_equal(got, full.numpy())


def test_stripped_patches_are_undone():
    params, static = tscenes.cornell_mirror().pack()
    before = mk.render_block(params, static, 4, 4, 1, 0, 0, 2).stack()
    saved = [getattr(o, a) for o, a, _ in pf._PATCHES.values()]
    for strip in pf.STRIPS:
        with pytest.raises(ZeroDivisionError):
            with pf.stripped(strip):
                1 / 0
    assert [getattr(o, a) for o, a, _ in pf._PATCHES.values()] == saved
    assert torch.equal(before, mk.render_block(params, static, 4, 4, 1, 0,
                                               0, 2).stack())


# ------------------------------------------------------------ wrappers ----

def test_cpu_calls_count_no_launch():
    params, static = tscenes.cornell_mirror().pack()
    pf.isect_only_block(params, static, 4, 4, 1, 1)
    pf.alu_peak("fma", 2, 4, 1, 1, device="cpu")
    pf.alu_peak_ilp8(2, 4, 1, 1, device="cpu")
    pf.render_block_stripped("no_nee", params, static, 4, 4, 1, 0, 0, 1)
    assert (pf.isect_only_block.launches, pf.alu_peak.launches,
            pf.alu_peak_ilp8.launches,
            pf.render_block_stripped.launches) == (0, 0, 0, 0)


def test_bad_arguments_raise():
    params, static = tscenes.cornell_mirror().pack()
    with pytest.raises(ValueError, match="strip"):
        pf.render_block_stripped("no_rng", params, static, 4, 4, 1, 0, 0, 1)
    with pytest.raises(ValueError, match="mix"):
        pf.alu_peak("fmac", 2, 4, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        pf.alu_peak_ilp8(0, 4, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="bad block"):
        pf.isect_only_block(params, static, 4, 4, 0, 1)
    with pytest.raises(TypeError):
        pf.isect_only_block(params.double(), static, 4, 4, 1, 1)
