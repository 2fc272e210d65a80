"""The port's penumbra and secondary-vertex edge terms
(`sail_tpu_torch/diff/boundary.py`: `shadow_boundary_term`,
`indirect_silhouette_term`) on the CPU, against the JAX package's on the
same scene, seed and sizes, and `grad_with_boundary` as their sum with the
interior gradient.  (`full_boundary_term` on config 5's scene is held in
`test_torch_inverse.py`, beside the train step that calls it.)

`shadow_boundary_term` runs for receivers seen directly (a matte sphere
under a rectangle lamp in a box), through a mirror (an occluder behind the
camera whose shadow shows only in the mirror) and through one diffuse
bounce (`n_indirect_dirs=4`).

Tolerance as `test_torch_boundary.py`: per leaf ≤ 1e-4 · max|JAX|, JAX's
rsqrt taken as the port's `1/sqrt`; measured ≤ 1.3e-6 (no ray is traced
for the penumbras).
"""
import numpy as np
import pytest
import torch

import sail_tpu_torch as tsail
from sail_tpu.diff import boundary as jb
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.ops.cuda.megakernel import render_image_fast
from sail_tpu_torch.scene.scene import leaf_paths

from test_torch_boundary import (adjoints, assert_leaves_close, bridged,
                                 indirect_shadow, jax_rsqrt_as_port,  # noqa
                                 mirror_penumbra, ramp_adjoint,
                                 secondary_silhouette)

torch.set_num_threads(1)


def matte_shadow(lib):
    """A matte sphere under a rectangle lamp in a box: penumbras on the
    box's walls seen directly (`test_boundary_grad.
    test_shadow_boundary_closes_nee_gap`)."""
    s = lib.Scene()
    s.add(lib.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(lib.Cornellbox([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]))
    s.add(lib.Sphere([0.15, -0.2, 0.2], 0.38, lib.Matte(0.9)))
    s.add(lib.AreaLight(lib.Rectangle([-0.4, 0.97, -0.4], [0.4, 0.97, 0.4]),
                        [6.0, 6.0, 6.0]))
    return s


# receivers, scene, size, shadow_boundary_term's keywords
SHADOW_CASES = {
    "direct": (matte_shadow, 24, dict(n_curve_samples=16)),
    "mirror": (mirror_penumbra, 48, dict(n_curve_samples=32)),
    "indirect": (indirect_shadow, 24, dict(n_curve_samples=16,
                                           n_indirect_dirs=4, seed=3)),
}


@pytest.mark.parametrize("name", list(SHADOW_CASES))
def test_shadow_boundary_term_matches_jax(name, jax_rsqrt_as_port):
    scene_fn, size, kw = SHADOW_CASES[name]
    packed, static, params, tstatic = bridged(scene_fn)
    jdl, tdl = adjoints(ramp_adjoint(size, size, 0.1, 3.0))
    want = jb.shadow_boundary_term(packed, static, jdl, size, size, **kw)
    got = tb.shadow_boundary_term(params, tstatic, tdl, size, size, **kw)
    assert_leaves_close(name, want, got, tstatic)


def test_indirect_silhouette_term_matches_jax(jax_rsqrt_as_port):
    packed, static, params, tstatic = bridged(secondary_silhouette)
    jdl, tdl = adjoints(ramp_adjoint(16, 16))
    kw = dict(n_dir_samples=8, n_noise=1, seed=11, max_bounces=2)
    want = jb.indirect_silhouette_term(packed, static, jdl, 16, 16, **kw)
    got = tb.indirect_silhouette_term(params, tstatic, tdl, 16, 16, **kw)
    assert_leaves_close("secondary vertex", want, got, tstatic)


def test_full_boundary_term_matches_jax(jax_rsqrt_as_port):
    """Config 5's scene at 16², as the train step calls it (its seed
    offset), with few samples."""
    from sail_tpu import scenes as jscenes
    packed, static, params, tstatic = bridged(
        lambda lib: jscenes.cornell_mirror())
    rng = np.random.default_rng(5)
    dl = (rng.standard_normal((16, 16, 3)) * 1e-3).astype(np.float32)
    kw = dict(n_edge_samples=16, n_noise=1, seed=7717, max_bounces=2,
              n_curve_samples=8)
    want = jb.full_boundary_term(packed, static, dl, 16, 16, **kw)
    got = tb.full_boundary_term(params, tstatic, torch.from_numpy(dl), 16,
                                16, **kw)
    assert_leaves_close("cornell_mirror", want, got, tstatic)


def test_edge_terms_zero_where_none_applies():
    """No rectangle light, or no sphere: the penumbra and secondary-vertex
    terms are zeros of the parameters' shape, as JAX's."""
    zero = torch.zeros((8, 8))
    adj = Vec3(zero + 1e-3, zero + 1e-3, zero + 1e-3)
    s = tsail.Scene()
    s.add(tsail.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(tsail.Cornellbox([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]))
    s.add(tsail.Sphere([0.0, 0.0, 0.0], 0.3, tsail.Matte()))
    s.add(tsail.PointLight([0.0, 0.9, 0.0], [4.0, 4.0, 4.0]))
    params, static = s.pack()
    g = tb.shadow_boundary_term(params, static, adj, 8, 8, n_curve_samples=4)
    assert torch.equal(g, torch.zeros_like(params))
    s = tsail.Scene()
    s.add(tsail.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(tsail.Cornellbox([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]))
    s.add(tsail.AreaLight(tsail.Rectangle([-0.3, 0.98, -0.3],
                                          [0.3, 0.98, 0.3]), [5.0] * 3))
    params, static = s.pack()
    for fn in (tb.shadow_boundary_term, tb.indirect_silhouette_term):
        g = fn(params, static, adj, 8, 8)
        assert torch.equal(g, torch.zeros_like(params)), fn.__name__


def test_grad_with_boundary_is_interior_plus_edge_terms():
    """The interior gradient by autograd plus `full_boundary_term` of the
    mean squared error's adjoint, and the image."""
    params, static = tscenes.cornell_mirror().pack()
    target = render_image_fast(params, 9, static, 8, 8, 2, 2)

    def loss_fn(p):
        img = render_image_fast(p, 0, static, 8, 8, 2, 2)
        return sum(((a - b) ** 2).mean() for a, b in zip(img, target)) / 3, \
            img

    kw = dict(n_edge_samples=16, n_noise=1, seed=3)
    total, img = tb.grad_with_boundary(
        loss_fn, params, static, dict(height=8, width=8, max_bounces=2),
        target, **kw)
    p = params.clone().requires_grad_()
    loss, img2 = loss_fn(p)
    (interior,) = torch.autograd.grad(loss, p)
    bnd = tb.full_boundary_term(params, static, tb.mse_adjoint(img2, target),
                                8, 8, max_bounces=2, **kw)
    assert bnd.abs().max() > 0
    torch.testing.assert_close(total, interior + bnd, rtol=0, atol=0)
    assert torch.equal(img.stack(), img2.stack().detach())
    assert len(leaf_paths(static)) == params.numel()
