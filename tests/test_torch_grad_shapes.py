"""The gradient path on the new shapes and on many objects, on the CPU,
against the JAX package: torch autograd through the plain integrator
against `jax.grad` per leaf (8², 2 bounces), K2's plain version against the
Pallas K2 in interpret mode, and K2's choice of gradient-array size.

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


def test_grad_block_matches_pallas_interpret():
    """K2's wrapper on CPU tensors against the JAX package's K2 in interpret
    mode on the 12-sphere scene: 8², 1 bounce, 1 spp."""
    packed, static = _many_sphere_scene(12).pack()
    g = _g(8, 8)
    want = render_grad_block_pallas(
        packed, static, JVec3(*(jnp.asarray(c.numpy()) for c in g)), 8, 8, 1,
        0, 0, max_bounces=1, tile_rows=8, tile_cols=8, interpret=True)
    want = np.stack([np.asarray(l) for l in jax.tree.leaves(want)])
    params, tstatic = _bridge(packed, static)
    got = mk.render_grad_block(params, tstatic, g, 8, 8, 1, 0, 0, 1).numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_grad_cap_choice():
    """The smallest K2 build that holds the parameters; a raise above the
    largest.  The many-sphere scene packs 13 N + 47 parameters."""
    assert mk.grad_cap(1) == mk.grad_cap(352) == 352
    assert mk.grad_cap(353) == mk.grad_cap(1024) == 1024
    sizes = {n: tscenes.many_spheres(n).pack()[0].numel()
             for n in (12, 64, 256)}
    assert sizes == {12: 203, 64: 879, 256: 3375}
    assert [mk.grad_cap(s) for s in sizes.values()] == [352, 1024, 4096]
    with pytest.raises(ValueError, match="at most 4096"):
        mk.grad_cap(4097)
    with pytest.raises(ValueError, match="at most 4096"):
        params, static = tscenes.many_spheres(320).pack()
        mk.grad_cap(params.numel())
