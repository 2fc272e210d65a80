"""The port's inverse-rendering path on the CPU (`scene.leaf_paths`,
`parallel/mesh.py`, `parallel/render_sharded.py`, `diff/inverse.py`,
`tools/inverse_artifact.py`), each against the JAX package's.

BASELINE config 5's scene (`cornell_mirror`) at 16², 2 spp, 2 bounces on a
one-device mesh.  The loss and image are held against JAX's
`sharded_loss_and_image` on a one-CPU-device mesh; the gradients against
`jax.value_and_grad` of the loss that mesh's block computes on the CPU
(`_render_block`: `render_sample` per sample, summed in order), run
eagerly, because the jitted gradient of the shard_map compiles for over
three minutes on the CPU.  JAX's train step is held as its parts
(`make_train_step`'s body: that gradient, `full_boundary_term` with the
step's seed and noise passes, the trainable mask, `optax.adam`): the
jitted step traces the eager edge terms into one XLA program whose CPU
compile takes longer still.

Tolerances: the image within 1e-5 (XLA:CPU contracts multiply-adds; the
port's plain version does not), the loss within 1e-5 relative, each
gradient leaf within 2e-4 of the largest (the JAX package's own K2
contract, `test_torch_grad.py`), the edge terms 1e-4 of their largest
leaf (`test_torch_boundary.py`); Adam's steps on the trainable leaves
whose JAX gradient is clearly nonzero (Adam's first update is lr·sign(g),
so a leaf whose gradient is ~0 on both sides may move either way).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.diff import boundary as jb
from sail_tpu.diff.inverse import finite_difference_grad as jax_fd
from sail_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sail_tpu.parallel.render_sharded import (
    sharded_loss_and_image as jax_loss_and_image)
from sail_tpu.parallel.render_sharded import trainable_mask as jax_mask
from sail_tpu.render.integrator import render_sample as jax_render_sample
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.diff.inverse import finite_difference_grad, optimize
from sail_tpu_torch.parallel.mesh import make_mesh
from sail_tpu_torch.parallel import render_sharded as rs
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import leaf_paths
from sail_tpu_torch.tools import inverse_artifact as ia

torch.set_num_threads(1)

H = W = 16
SPP = 2
BOUNCES = 2
LR = 0.025
# the train step's edge terms, cut to the size of the test
EDGE = dict(n_edge_samples=16, n_noise=1, n_curve_samples=8)
GRAD_TOL = 2e-4
EDGE_TOL = 1e-4


def _leaves(tree) -> np.ndarray:
    return np.array([np.asarray(l) for l in jax.tree.leaves(tree)],
                    np.float64)


def _jax_loss(static, packed, target):
    """(loss, image) of JAX's `sharded_loss_and_image` on one CPU device,
    without the shard_map: the samples of `_render_block`'s loop (XLA's
    integrator) summed in order, the mean, the mean squared error."""
    acc = None
    for i in range(SPP):
        c = jax_render_sample(packed, static, H, W, 0, i,
                              max_bounces=BOUNCES, row0=0,
                              image_height=H).color
        acc = c if acc is None else jax.tree.map(jnp.add, acc, c)
    img = acc * (1.0 / SPP)
    se = ((img.x - target.x) ** 2 + (img.y - target.y) ** 2
          + (img.z - target.z) ** 2)
    return jnp.sum(se) / (H * W * 3), img


@pytest.fixture(scope="module")
def config5():
    """JAX's config 5 at 16²: the perturbed scene (inverse_artifact's
    perturbations), the target (the true scene's image), the eager
    loss-and-gradient, and the port's counterparts.  JAX's rsqrt is the
    port's `1/sqrt` while the module runs (`test_torch_grad.py`)."""
    real_rsqrt = jax.lax.rsqrt
    jax.lax.rsqrt = lambda x: 1.0 / jnp.sqrt(x)
    try:
        packed, static = jscenes.cornell_mirror().pack()
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(packed)[0]]
        flat, treedef = jax.tree.flatten(packed)
        for k, v in ia.PERTURBED.items():
            flat[paths.index(k)] = jnp.float32(v)
        jstart = jax.tree.unflatten(treedef, flat)
        vg = jax.value_and_grad(functools.partial(_jax_loss, static),
                                has_aux=True)
        jtarget = _jax_loss(static, packed,
                            JVec3(*(jnp.zeros((H, W)),) * 3))[1]
        yield dict(
            jstart=jstart, jstatic=static, jtarget=jtarget, vg=vg,
            start=params_from_jax_leaves([np.asarray(l) for l in flat]),
            static=static_from_jax(static),
            target=Vec3(*(torch.tensor(np.asarray(c)) for c in jtarget)),
            mesh=make_mesh(1, device="cpu"))
    finally:
        jax.lax.rsqrt = real_rsqrt


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror",
                                  "material_demo", "material_demo_open",
                                  "lights_and_quadrics"])
def test_leaf_paths_match_jax_keystr(name):
    packed, static = getattr(jscenes, name)().pack()
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(packed)[0]]
    assert list(leaf_paths(static_from_jax(static))) == want


@pytest.mark.parametrize("predicate", [
    ia.trainable, lambda k: ".materials" in k or ".lights" in k])
def test_trainable_mask_matches_jax(predicate):
    packed, static = jscenes.cornell_mirror().pack()
    want = _leaves(jax_mask(packed, predicate))
    got = rs.trainable_mask(static_from_jax(static), predicate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_make_mesh_is_one_rank(monkeypatch):
    """`device=` is the one-rank mesh: more ranks, or an spp axis of more
    than one, need `devices=` (tests/test_torch_sharding.py)."""
    mesh = make_mesh(1, device="cpu")
    assert mesh.shape == {"tile": 1, "spp": 1} and mesh.size == 1
    assert make_mesh(device="cpu") == mesh
    assert mesh.device == torch.device("cpu")
    for n, spp_axis in ((2, None), (4, 2), (1, 2)):
        with pytest.raises(ValueError):
            make_mesh(n, spp_axis, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1)     # the card unless the caller asks for the CPU


def test_sharded_loss_and_image_match_jax(config5):
    c = config5
    jloss, jimg = jax_loss_and_image(c["jstart"], c["jtarget"], c["jstatic"],
                                     jax_make_mesh(1), H, W, SPP, 0, BOUNCES)
    (eloss, eimg), jgrad = c["vg"](c["jstart"], c["jtarget"])
    assert float(eloss) == pytest.approx(float(jloss), rel=1e-6)
    p = c["start"].clone().requires_grad_()
    loss, img = rs.sharded_loss_and_image(p, c["target"], c["static"],
                                          c["mesh"], H, W, SPP, 0, BOUNCES)
    (grad,) = torch.autograd.grad(loss, p)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(img.stack().detach().numpy(),
                               np.asarray(jimg.stack()), rtol=1e-5, atol=1e-5)
    want = _leaves(jgrad)
    d = np.abs(grad.double().numpy() - want)
    assert d.max() <= GRAD_TOL * np.abs(want).max(), \
        leaf_paths(c["static"])[int(d.argmax())]
    assert float(rs.sharded_loss(c["start"], c["target"], c["static"],
                                 c["mesh"], H, W, SPP, 0, BOUNCES)) \
        == float(loss.detach())
    mean = rs.render_sharded(c["start"], c["static"], c["mesh"], H, W, SPP,
                             max_bounces=BOUNCES)
    total = rs.render_sharded(c["start"], c["static"], c["mesh"], H, W, SPP,
                              max_bounces=BOUNCES, return_sum=True)
    assert torch.equal(mean.stack(), img.stack().detach())
    assert torch.equal((total * (1.0 / SPP)).stack(), mean.stack())


def test_full_boundary_term_matches_jax(config5):
    """Config 5's scene, as the train step calls it (its seed offset): the
    silhouettes of both spheres, the box's and lamp's edges, the matte
    sphere in the sphere mirror, the penumbras at primary and mirror
    receivers."""
    c = config5
    dl = (np.random.default_rng(5).standard_normal((H, W, 3))
          * 1e-3).astype(np.float32)
    kw = dict(EDGE, seed=7717, max_bounces=BOUNCES)
    want = _leaves(jb.full_boundary_term(c["jstart"], c["jstatic"], dl, H, W,
                                         **kw))
    got = tb.full_boundary_term(c["start"], c["static"], torch.from_numpy(dl),
                                H, W, **kw).double().numpy()
    d = np.abs(got - want)
    assert np.abs(want).max() > 0 and np.isfinite(got).all()
    assert d.max() <= EDGE_TOL * np.abs(want).max(), \
        leaf_paths(c["static"])[int(d.argmax())]


def _jax_step(c, packed, state, opt, mask):
    """JAX's `make_train_step` body on one device, by its parts."""
    (loss, img), grads = c["vg"](packed, c["jtarget"])
    n = H * W * 3
    dL = JVec3(*((a - b) * (2.0 / n) for a, b in zip(img, c["jtarget"])))
    bnd = jb.full_boundary_term(packed, c["jstatic"], dL, H, W,
                                n_edge_samples=EDGE["n_edge_samples"],
                                n_noise=EDGE["n_noise"], seed=0 + 7717,
                                max_bounces=BOUNCES,
                                n_curve_samples=EDGE["n_curve_samples"])
    grads = jax.tree.map(lambda a, b: a + b * 1.0, grads, bnd)
    grads = jax.tree.map(lambda g, m: g * m, grads, mask)
    updates, state = opt.update(grads, state, packed)
    return optax.apply_updates(packed, updates), state, float(loss), \
        _leaves(grads)


def test_train_steps_match_jax(config5):
    """Two steps with the edge terms on: the loss, the masked gradient per
    leaf, and the parameters after each step on the trainable leaves whose
    gradient is clearly nonzero."""
    c = config5
    opt = optax.adam(LR)
    jmask = jax_mask(c["jstart"], ia.trainable)
    packed, state = c["jstart"], opt.init(c["jstart"])

    p = c["start"].clone().requires_grad_()
    topt = torch.optim.Adam([p], lr=LR)
    step = rs.make_train_step(c["static"], c["mesh"], H, W, SPP, topt,
                              max_bounces=BOUNCES,
                              trainable=rs.trainable_mask(c["static"],
                                                          ia.trainable),
                              **EDGE)
    names = leaf_paths(c["static"])
    mask = _leaves(jmask) > 0
    for k in range(2):
        packed, state, jloss, jgrad = _jax_step(c, packed, state, opt, jmask)
        loss = float(step(c["target"]))
        assert loss == pytest.approx(jloss, rel=1e-5), k
        grad = p.grad.double().numpy()
        d = np.abs(grad - jgrad)
        assert d.max() <= GRAD_TOL * np.abs(jgrad).max(), (k, names[int(
            d.argmax())])
        assert not grad[~mask].any()
        clear = mask & (np.abs(jgrad) > 1e-2 * np.abs(jgrad).max())
        assert clear.sum() >= 3
        np.testing.assert_allclose(p.detach().double().numpy()[clear],
                                   _leaves(packed)[clear], rtol=1e-5,
                                   atol=1e-6)


def test_finite_difference_grad_matches_jax(config5):
    c = config5
    key = ".objects[2].center.x"
    idx = leaf_paths(c["static"]).index(key)
    jleaf = c["jstart"].objects[2].center.x
    want = jax_fd(lambda pk: _jax_loss(c["jstatic"], pk, c["jtarget"])[0],
                  c["jstart"], jleaf, eps=1e-2)

    def loss(v):
        return rs.sharded_loss(v, c["target"], c["static"], c["mesh"], H, W,
                               SPP, 0, BOUNCES)

    got = finite_difference_grad(loss, c["start"], key, eps=1e-2,
                                 static=c["static"])
    assert got == finite_difference_grad(loss, c["start"], idx, eps=1e-2)
    assert abs(want) > 0
    assert got == pytest.approx(want, rel=1e-3, abs=1e-7)
    with pytest.raises(ValueError):
        finite_difference_grad(loss, c["start"], key)   # a key needs static
    with pytest.raises(ValueError):
        finite_difference_grad(loss, c["start"], ".objects[9].radius",
                               static=c["static"])


def test_optimize_lowers_the_loss(config5):
    """`optimize` on the 16² config-5 twin, the artifact's trainable
    leaves, edge terms on at their defaults, a cosine schedule."""
    c = config5
    seen = []
    steps = 4
    result = optimize(
        c["start"], c["target"], c["static"], c["mesh"], H, W, SPP,
        steps=steps, learning_rate=LR, trainable=ia.trainable,
        max_bounces=BOUNCES,
        scheduler=lambda o: torch.optim.lr_scheduler.CosineAnnealingLR(
            o, T_max=steps, eta_min=0.0),
        callback=lambda i, loss, p: seen.append((i, loss)))
    assert result.steps == steps and len(result.losses) == steps
    assert [i for i, _ in seen] == list(range(steps))
    assert all(np.isfinite(result.losses))
    assert result.losses[-1] < result.losses[0]
    frozen = rs.trainable_mask(c["static"], ia.trainable) == 0
    assert torch.equal(result.params[frozen], c["start"][frozen])
    assert not torch.equal(result.params, c["start"])


def test_inverse_artifact_runs_on_the_cpu(tmp_path):
    out = tmp_path / "inverse.json"
    ia.main(["--device", "cpu", "--size", "8", "--spp", "1", "--bounces",
             "2", "--steps", "3", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["card"] == "cpu"
    assert len(rec["loss_curve_every5"]) == 1
    assert set(rec["recovered"]) == {"mirror_kr", "lamp_emission",
                                     "matte_sphere_cx"}
    assert rec["recovered"]["lamp_emission"]["perturbed"] == 3.0
    assert np.isfinite(rec["loss_last"])
