"""The port's multi-rank `parallel/` on the CPU, against the JAX package:
the twin of tests/test_sharding.py, on `cornell_matte` at 16², 4 spp, 2
bounces, its inputs from JAX's scene through the bridge.

- The port's 8-rank layout (4 × 2, all ranks on "cpu" in this process)
  against JAX's `render_sharded` on `make_mesh(8, spp_axis=2)` (its XLA
  path on the conftest's 8 virtual CPU devices) and against the port's
  one-rank image, each within 1e-5 (atol = rtol; XLA:CPU contracts
  multiply-adds, the plain version does not, and the spp sum is ordered
  differently; measured 3.0e-7 and 4.8e-7).  Layouts: spp axis 4 against 1 within 1e-5; 8 × 1, which
  splits rows only, against one rank bit for bit.
- The 8-rank gradient against the one-rank gradient at JAX's 1e-4 / 1e-3
  (atol / rtol; measured 1.5e-8, 8.3e-8 of the largest leaf), and against
  JAX's eager gradient (`render_sample` per sample, summed in order, as
  tests/test_torch_inverse.py forms it) within 2e-4 of the largest leaf
  (measured 1.6e-6),
  JAX's rsqrt taken as the port's `1/sqrt` (tests/test_torch_grad.py).
- The masked Adam loop lowers the loss and moves kd from 0.4 above 0.45.
- The train step's edge term on 2 ranks (1 bounce, 16 edge samples, 4
  noise passes) against JAX's `full_boundary_term` run once per device
  with seed 7717·(di + 1) and 2 passes, summed and halved, eagerly,
  within 1e-4 of its largest leaf; then one 8-rank step with finite
  parameters, and `dryrun_multichip(8, device="cpu")`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.diff import boundary as jb
from sail_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sail_tpu.parallel.render_sharded import render_sharded as jax_render
from sail_tpu.render.integrator import render_sample as jax_render_sample
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff.boundary import mse_adjoint
from sail_tpu_torch.parallel import mesh as pm
from sail_tpu_torch.parallel import render_sharded as rs
from sail_tpu_torch.parallel.mesh import Rank, make_mesh
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import leaf_paths
from sail_tpu_torch.tools.dryrun_multichip import dryrun_multichip

torch.set_num_threads(1)

H = W = 16
SPP = 4
BOUNCES = 2
IMG_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
JAX_GRAD_TOL = 2e-4
EDGE_TOL = 1e-4
# the edge-term step, cut to the size of tests/test_sharding.py's
EDGE = dict(n_edge_samples=16, n_noise=4, n_curve_samples=8)


def _cpu(n: int, spp_axis=None):
    return make_mesh(n, spp_axis, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    packed, jstatic = jscenes.cornell_matte().pack()
    params = params_from_jax_leaves([np.asarray(l)
                                     for l in jax.tree.leaves(packed)])
    return packed, jstatic, params, static_from_jax(jstatic)


def _img(v) -> np.ndarray:
    return np.asarray(v.stack()) if isinstance(v, JVec3) \
        else v.stack().detach().numpy()


def test_make_mesh_layouts():
    """JAX's near-square split (8 ranks 4 × 2, 6 ranks 3 × 2), ranks in
    row-major order with ids of their own, the one-rank `device=` call, and
    ValueError for too few ranks or an spp axis that does not divide."""
    m = _cpu(8)
    assert m.shape == {"tile": 4, "spp": 2} and m.size == 8
    assert [r.id for r in m.ranks] == list(range(8))
    assert m.local_ranks == tuple(enumerate(m.ranks))
    assert m.device == torch.device("cpu") and not m.gathers
    assert _cpu(6).shape == {"tile": 3, "spp": 2}
    assert _cpu(8, 1).shape == {"tile": 8, "spp": 1}
    assert make_mesh(device="cpu") == make_mesh(1, device="cpu")
    assert make_mesh(device="cpu").ranks == (Rank(0, torch.device("cpu"),
                                                  0),)
    sub = make_mesh(devices=m.ranks[4:])
    assert [r.id for r in sub.ranks] == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="requested a 9-rank mesh"):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(6, spp_axis=4, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="not both"):
        make_mesh(devices=["cpu"], device="cpu")


def test_mesh_defaults_to_the_cards(monkeypatch):
    """Without devices the mesh takes every CUDA device of every process;
    with no card that raises, and NCCL refuses to start, rather than fall
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="gloo"):
        pm.initialize_distributed("127.0.0.1:1", 1, 0)
    assert pm.process_count() == 1 and pm.process_index() == 0
    assert pm.global_ranks(["cpu", "cpu"]) == [
        Rank(0, torch.device("cpu"), 0), Rank(1, torch.device("cpu"), 0)]


def test_sharded_matches_single_device(setup):
    packed, jstatic, params, static = setup
    img8 = _img(rs.render_sharded(params, static, _cpu(8, 2), H, W, SPP,
                                  max_bounces=BOUNCES))
    img1 = _img(rs.render_sharded(params, static, make_mesh(device="cpu"), H,
                                  W, SPP, max_bounces=BOUNCES))
    want = _img(jax_render(packed, jstatic, jax_make_mesh(8, spp_axis=2), H,
                           W, SPP, max_bounces=BOUNCES))
    assert np.isfinite(img8).all() and img8.max() > 0
    np.testing.assert_allclose(img8, want, atol=IMG_TOL, rtol=IMG_TOL)
    np.testing.assert_allclose(img8, img1, atol=IMG_TOL, rtol=IMG_TOL)


def test_mesh_layout_invariance(setup):
    _, _, params, static = setup
    kw = dict(max_bounces=BOUNCES)
    a = _img(rs.render_sharded(params, static, _cpu(8, 4), H, W, SPP, **kw))
    b = _img(rs.render_sharded(params, static, _cpu(8, 1), H, W, SPP, **kw))
    one = _img(rs.render_sharded(params, static, make_mesh(device="cpu"), H,
                                 W, SPP, **kw))
    np.testing.assert_allclose(a, b, atol=IMG_TOL, rtol=IMG_TOL)
    np.testing.assert_array_equal(b, one)     # rows split only
    with pytest.raises(ValueError, match="does not divide"):
        rs.render_sharded(params, static, _cpu(8, 1), 12, W, SPP, **kw)


def _jax_loss(static, packed, target):
    """JAX's sharded loss on one device without the shard_map: the samples
    of `_render_block`'s loop summed in order, the mean, the mean squared
    error."""
    acc = None
    for i in range(SPP):
        c = jax_render_sample(packed, static, H, W, 0, i,
                              max_bounces=BOUNCES, row0=0,
                              image_height=H).color
        acc = c if acc is None else jax.tree.map(jnp.add, acc, c)
    img = acc * (1.0 / SPP)
    se = ((img.x - target.x) ** 2 + (img.y - target.y) ** 2
          + (img.z - target.z) ** 2)
    return jnp.sum(se) / (H * W * 3)


def test_sharded_grad_matches_single(setup, monkeypatch):
    packed, jstatic, params, static = setup
    zero = torch.zeros(H, W)
    target = Vec3(zero, zero, zero)

    def grad(mesh):
        p = params.clone().requires_grad_()
        loss = rs.sharded_loss(p, target, static, mesh, H, W, SPP, 0,
                               BOUNCES)
        return float(loss.detach()), torch.autograd.grad(loss, p)[0]

    l8, g8 = grad(_cpu(8, 2))
    l1, g1 = grad(make_mesh(device="cpu"))
    assert torch.isfinite(g8).all() and g8.abs().max() > 0
    assert l8 == pytest.approx(l1, rel=1e-6)
    torch.testing.assert_close(g8, g1, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # the explicit gradient the multi-process path takes
    lv, gv = rs.sharded_value_and_grad(params, target, static, _cpu(8, 2),
                                       H, W, SPP, 0, BOUNCES)
    assert float(lv) == pytest.approx(l8, rel=1e-6)
    assert float((gv - g8).abs().max()) <= 1e-5 * float(g8.abs().max())

    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    jzero = jnp.zeros((H, W), jnp.float32)
    jg = jax.grad(lambda pk: _jax_loss(jstatic, pk, JVec3(jzero, jzero,
                                                          jzero)))(packed)
    want = np.array([np.asarray(l) for l in jax.tree.leaves(jg)], np.float64)
    d = np.abs(g8.double().numpy() - want)
    assert d.max() <= JAX_GRAD_TOL * np.abs(want).max(), \
        leaf_paths(static)[int(d.argmax())]


def test_sharded_train_step_decreases_loss(setup):
    _, _, params, static = setup
    mesh = _cpu(8, 2)
    target = rs.render_sharded(params, static, mesh, H, W, SPP,
                               max_bounces=BOUNCES)
    kd = leaf_paths(static).index(".materials[0].kd")
    start = params.clone()
    start[kd] = 0.4
    start.requires_grad_()
    step = rs.make_train_step(
        static, mesh, H, W, SPP, torch.optim.Adam([start], lr=0.1),
        max_bounces=BOUNCES, boundary=False,
        trainable=rs.trainable_mask(static, lambda k: ".materials" in k))
    losses = [float(step(target)) for _ in range(4)]
    assert losses[-1] < losses[0]
    assert float(start.detach()[kd]) > 0.45
    frozen = rs.trainable_mask(static, lambda k: ".materials" not in k) > 0
    assert torch.equal(start.detach()[frozen], params[frozen])


def test_sharded_train_step_with_boundary(setup):
    """The step's edge term on 2 ranks: the difference of the gradients a
    step leaves with and without the edge terms, against JAX's
    `full_boundary_term` per device (its `make_train_step`'s shard_map
    body) summed and halved; then one 8-rank step."""
    packed, jstatic, params, static = setup
    bounces = 1
    mesh = _cpu(2)
    target = rs.render_sharded(params, static, mesh, H, W, 2,
                               max_bounces=bounces)
    start = params * 1.02
    grads = {}
    for boundary in (False, True):
        p = start.clone().requires_grad_()
        step = rs.make_train_step(static, mesh, H, W, 2,
                                  torch.optim.SGD([p], lr=0.0),
                                  max_bounces=bounces, boundary=boundary,
                                  **EDGE)
        float(step(target))
        grads[boundary] = p.grad.double().numpy()
    got = grads[True] - grads[False]

    img = rs.render_sharded(start, static, mesh, H, W, 2,
                            max_bounces=bounces)
    adj = JVec3(*(jnp.asarray(c.numpy()) for c in mse_adjoint(img, target)))
    jstart = jax.tree.unflatten(jax.tree.structure(packed),
                                [jnp.float32(v) for v in start.tolist()])
    terms = [jb.full_boundary_term(
        jstart, jstatic, adj, H, W, n_edge_samples=EDGE["n_edge_samples"],
        n_noise=EDGE["n_noise"] // 2, seed=7717 * (di + 1),
        max_bounces=bounces, n_curve_samples=EDGE["n_curve_samples"])
        for di in range(2)]
    want = np.array([np.float64(a) + np.float64(b) for a, b in zip(
        *(jax.tree.leaves(t) for t in terms))]) * 0.5
    d = np.abs(got - want)
    assert np.abs(want).max() > 0 and np.isfinite(got).all()
    assert d.max() <= EDGE_TOL * np.abs(want).max(), \
        leaf_paths(static)[int(d.argmax())]

    mesh8 = _cpu(8, 2)
    p = start.clone().requires_grad_()
    step = rs.make_train_step(static, mesh8, H, W, 2,
                              torch.optim.Adam([p], lr=1e-2),
                              max_bounces=bounces, n_edge_samples=16,
                              n_noise=8, n_curve_samples=8)
    assert np.isfinite(float(step(rs.render_sharded(
        params, static, mesh8, H, W, 2, max_bounces=bounces))))
    assert torch.isfinite(p).all() and not torch.equal(p.detach(), start)


def test_dryrun_multichip_on_cpu():
    out = dryrun_multichip(8, device="cpu")
    assert out["mesh"] == {"tile": 4, "spp": 2}
    assert out["loss"] > 0 and out["loss_boundary"] > 0
