"""The gradient path on the new shapes and on many objects, on the CPU,
against the JAX package: torch autograd through the plain integrator
against `jax.grad` per leaf (8², 2 bounces), K2's plain version against the
Pallas K2 in interpret mode on the smallest scene that takes the batched
fold, and K2's choice of gradient-array size.

Tolerance rtol = atol = 2e-4 per leaf, with JAX's rsqrt taken as `1/sqrt`
(the fixture and the tolerance of tests/test_torch_grad.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops.pallas.megakernel import render_grad_block_pallas
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.scene.scene import BATCH_THRESHOLD

from test_intersect import _many_sphere_scene
from test_torch_grad import TOL, _bridge, _g, _jax_grad, _torch_grad
from test_torch_grad import jax_rsqrt_as_port  # noqa: F401  (fixture)
from test_torch_many import _quadrics

torch.set_num_threads(1)

SCENES = {"spheres12": lambda: _many_sphere_scene(12), "quadrics": _quadrics}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_autograd_matches_jax_grad(name, jax_rsqrt_as_port):
    packed, static = SCENES[name]().pack()
    want = _jax_grad(packed, static, 8, 8, 2)
    got = _torch_grad(*_bridge(packed, static), 8, 8, 2)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert got.shape == (len(want),)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i], w, rtol=TOL, atol=TOL,
                                   err_msg=f"leaf {i}")


def _eight_spheres():
    """The smallest scene that takes the batched fold: BATCH_THRESHOLD = 8
    matte spheres, three of them emissive, and nothing else.  Without a
    light or a box the Pallas K2 in interpret mode compiles in about a
    minute on the CPU; the 12-sphere scene in a box under a light took
    995 s there, cold.  The batched fold with light sampling is held by
    `test_autograd_matches_jax_grad[spheres12]` against `jax.grad`."""
    from sail_tpu import Camera, Matte, Scene, Sphere
    scene = Scene()
    scene.add(Camera((0, 0, -2.5), (0, 0, 0)))
    for k in range(8):
        scene.add(Sphere((-0.8 + 1.6 * (k % 4) / 3.0, -0.4 + 0.8 * (k // 4),
                          0.2 * (k % 2)), 0.35, Matte(kd=0.8),
                         emission=(2.0, 1.5, 1.0) if k % 3 == 0 else
                         (0.0, 0.0, 0.0)))
    return scene


def test_grad_block_matches_pallas_interpret():
    """K2's wrapper on CPU tensors against the JAX package's K2 in interpret
    mode on a scene that takes the batched fold (`_eight_spheres`): 8², 1
    bounce, 1 spp, so the gradient is each pixel's winning sphere's
    emission: the fold must pick JAX's winner."""
    packed, static = _eight_spheres().pack()
    assert len(static.object_categories) == BATCH_THRESHOLD
    g = _g(8, 8)
    want = render_grad_block_pallas(
        packed, static, JVec3(*(jnp.asarray(c.numpy()) for c in g)), 8, 8, 1,
        0, 0, max_bounces=1, tile_rows=8, tile_cols=8, interpret=True)
    want = np.stack([np.asarray(l) for l in jax.tree.leaves(want)])
    params, tstatic = _bridge(packed, static)
    assert mk.scene_table(tstatic).n_groups == 1
    got = mk.render_grad_block(params, tstatic, g, 8, 8, 1, 0, 0, 1).numpy()
    assert np.isfinite(got).all() and (np.abs(got) > 0).sum() >= 9
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_grad_cap_choice():
    """Above the shared build, the smallest local K2 build that holds the
    parameters; a raise above the largest.  The many-sphere scene packs
    13 N + 47 parameters."""
    def cap(n):
        return mk.grad_build(n, True, False, False).cap

    assert cap(1) == cap(mk.SHARED_GRAD_MAX_PARAMS) == mk.SHARED_GRAD
    assert cap(mk.SHARED_GRAD_MAX_PARAMS + 1) == cap(352) == 352
    assert cap(353) == cap(1024) == 1024
    sizes = {n: tscenes.many_spheres(n).pack()[0].numel()
             for n in (12, 64, 256)}
    assert sizes == {12: 203, 64: 879, 256: 3375}
    assert [cap(s) for s in sizes.values()] == [mk.SHARED_GRAD, 1024, 4096]
    with pytest.raises(ValueError, match="at most 4096"):
        cap(4097)
    with pytest.raises(ValueError, match="at most 4096"):
        params, static = tscenes.many_spheres(320).pack()
        cap(params.numel())
