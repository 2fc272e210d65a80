"""Many-object scenes on the CPU, each against the JAX package: the batched
winner-fold and the shadow scan with and without the cluster cull, the fold
order at a deliberate tie, the kernels' scene table, renders of the
12-sphere and quadrics scenes, and the plain K1 with the cull against the
Pallas K1 in interpret mode.

Tolerances: the fold's choices (object, rows, validity, facing) and
occlusion exactly; the winner's t at 1e-6, its other float fields at
FOLD_TOL; renders at 1e-4, as the JAX package holds its own batched fold
against its unrolled one (`tests/test_intersect.py`
test_batched_render_matches_unrolled)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sail_tpu as jsail
from sail_tpu.core.camera import rays_for_pixels as jax_rays
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops import intersect as jisect
from sail_tpu.ops.pallas.megakernel import render_block_pallas
from sail_tpu.render.integrator import render_sample as jax_render_sample
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.core.camera import rays_for_pixels
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import intersect as isect
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.render.integrator import render_sample
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import unflatten

from test_intersect import _many_sphere_scene

torch.set_num_threads(1)

# The fold's float fields: a small sphere seen from afar loses about 9 bits
# of its discriminant to cancellation (b² ≈ 25 against b² - 4ac ≈ 0.05), so
# XLA:CPU's contracted multiply-adds move t by ~10 ulp: 2.6e-6 on the
# 12-sphere scene at 16², where the JAX package's own batched and unrolled
# folds differ by 5.5e-6, and the normal of a 0.12-radius sphere (h / r) by
# 2.2e-5.  The shapes alone agree to 1e-6 (tests/test_torch_geometry.py).
FOLD_TOL = 5e-5


def _flat_rectangles():
    scene = jsail.Scene()
    scene.add(jsail.Camera((0, 0, -2.5), (0, 0, 0)))
    scene.add(jsail.Cornellbox((-1, -1, -1), (1, 1, 1)))
    for k in range(8):
        y = -0.8 + 1.5 * k / 7.0
        scene.add(jsail.Rectangle((-0.6, y, -0.6), (0.6, y, 0.6),
                                  jsail.Matte(kd=0.7)))
    scene.add(jsail.AreaLight(
        jsail.Rectangle((0.65, 0.98, -0.3), (0.95, 0.98, 0.3), jsail.Matte()),
        (5.0, 5.0, 5.0)))
    return scene


def _quadrics():
    """`sail_tpu_torch.scenes.quadrics` built with the JAX package."""
    scene = jsail.Scene()
    scene.add(jsail.Camera((0.0, 0.6, -3.0), (0.0, 0.0, 0.0)))
    scene.add(jsail.Cornellbox((-1.5, -1.0, -1.5), (1.5, 1.8, 1.5)))
    scene.add(jsail.Cone((-0.8, -1.0, -0.3), 0.9, 0.35, jsail.Matte(kd=0.9)))
    scene.add(jsail.Cylinder((0.0, -1.0, -0.5), 0.7, 0.25,
                             jsail.Mirror(kr=0.9)))
    scene.add(jsail.Disk((0.8, -0.99, 0.2), 0.45, 0.1, jsail.Matte(kd=1.0)))
    scene.add(jsail.Paraboloid((0.6, -1.0, 0.6), 0.0, 0.6, 0.3,
                               jsail.Matte(kd=0.8)))
    scene.add(jsail.Cube((-1.2, -1.0, 0.5), (-0.7, -0.5, 1.0),
                         jsail.Matte(kd=0.7, sigma=20.0),
                         jsail.UniformColor((0.8, 0.5, 0.3))))
    scene.add(jsail.Hyperboloid((0.0, 0.3, 0.7), (0.45, 0.0, -0.35),
                                (0.6, 0.0, 0.55), jsail.Matte(kd=0.9)))
    scene.add(jsail.AreaLight(
        jsail.Rectangle((-0.4, 1.78, -0.4), (0.4, 1.78, 0.4), jsail.Matte()),
        (4.0, 4.0, 4.0)))
    return scene


def _tie():
    """A deliberate tie: seen from inside, a Cube and a Cornellbox with the
    same bounds give bit-equal t (the same slab test, the far wall).  With 8
    cubes the cubes fold after the Cornellbox, so the Cornellbox (scene
    index 8) wins, where a fold in scene order would pick cube 0."""
    scene = jsail.Scene()
    scene.add(jsail.Camera((0.0, 0.0, -0.5), (0.0, 0.0, 1.0)))
    scene.add(jsail.Cube((-1, -1, -1), (1, 1, 1), jsail.Mirror(kr=0.5)))
    for k in range(7):
        x = -0.6 + 0.2 * k
        scene.add(jsail.Cube((x, 0.5, 0.3), (x + 0.15, 0.6, 0.45)))
    scene.add(jsail.Cornellbox((-1, -1, -1), (1, 1, 1)))
    scene.add(jsail.AreaLight(
        jsail.Rectangle((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3), jsail.Matte()),
        (5.0, 5.0, 5.0)))
    return scene


def _bridge(scene):
    packed, static = scene.pack()
    return (packed, static,
            params_from_jax_leaves([np.asarray(l)
                                    for l in jax.tree.leaves(packed)]),
            static_from_jax(static))


def _primary_rays(packed, params, static, h, w):
    ii = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    jj = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    jro, jrd = jax_rays(packed.camera, ii, jj, h, w)
    tro, trd = rays_for_pixels(unflatten(params, static).camera,
                               torch.from_numpy(np.array(ii)),
                               torch.from_numpy(np.array(jj)), h, w)
    return (jro, jrd), (tro, trd)


def _leaves(x):
    return [np.asarray(a) for a in jax.tree.leaves(x)]


SCENES = {"spheres12": lambda: _many_sphere_scene(12),
          "flat_rectangles": _flat_rectangles, "tie": _tie}


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_fold_and_shadow_scan_match_jax(name, cull):
    """Primary rays at 16² through the closest-hit fold, then shadow rays
    from their hits toward the ceiling through the any-hit scan."""
    packed, static, params, tstatic = _bridge(SCENES[name]())
    h = w = 16
    (jro, jrd), (tro, trd) = _primary_rays(packed, params, tstatic, h, w)
    want = jisect.intersect_scene(packed.objects, static, jro, jrd, cull=cull)
    objects = unflatten(params, tstatic).objects
    got = isect.intersect_scene(objects, tstatic, tro, trd, cull=cull)
    assert int(np.sum(np.asarray(want.obj_id) > 0)) > 0
    for field, (g, w_) in enumerate(zip(jax.tree.leaves(tuple(got)),
                                        _leaves(want))):
        if g.dtype == torch.float32:
            tol = 1e-6 if field == 0 else FOLD_TOL    # leaf 0 is t
            np.testing.assert_allclose(g.numpy(), w_, atol=tol, rtol=tol,
                                       err_msg=f"leaf {field}")
        else:
            np.testing.assert_array_equal(g.numpy(), w_,
                                          err_msg=f"leaf {field}")

    origin = [np.array(p + n * 1e-4) for p, n in zip(want.p, want.n)]
    to_l = [np.float32(c) - o for c, o in zip((0.1, 0.97, -0.05), origin)]
    dist = np.sqrt(sum(c * c for c in to_l))
    wi = [c / dist for c in to_l]
    max_t = dist * np.float32(1.0 - 1e-3)
    occ_w = np.asarray(jisect.occluded(
        packed.objects, static, JVec3(*map(jnp.asarray, origin)),
        JVec3(*map(jnp.asarray, wi)), jnp.asarray(max_t), cull=cull))
    occ_g = isect.occluded(
        objects, tstatic, Vec3(*map(torch.from_numpy, origin)),
        Vec3(*map(torch.from_numpy, wi)), torch.from_numpy(max_t),
        cull=cull).numpy()
    np.testing.assert_array_equal(occ_g, occ_w)
    assert 0 < int(occ_g.sum()) < h * w


def test_tie_picks_jax_object():
    packed, static, params, tstatic = _bridge(_tie())
    (jro, jrd), (tro, trd) = _primary_rays(packed, params, tstatic, 8, 8)
    want = np.asarray(jisect.intersect_scene(packed.objects, static, jro,
                                             jrd).obj_id)
    got = isect.intersect_scene(unflatten(params, tstatic).objects, tstatic,
                                tro, trd).obj_id.numpy()
    assert (want == 8).sum() > 32          # the tie is real and common
    np.testing.assert_array_equal(got, want)
    # ... and the kernels' table walks the same order: row 0 is object 8
    table = mk.scene_table(tstatic)
    assert table.order == (8, 9, 0, 1, 2, 3, 4, 5, 6, 7)
    img = mk.render_block(params, tstatic, 8, 8, 1, 0, 0, 2)
    want_img = render_block_pallas(packed, static, 8, 8, 1, 0, 0,
                                   max_bounces=2, tile_rows=8,
                                   interpret=True)
    np.testing.assert_allclose(img.stack().numpy(),
                               np.asarray(want_img.stack()), atol=1e-4,
                               rtol=1e-4)


def test_scene_table_order_and_ids():
    """Rows of small categories in scene order, then each batched group in
    the order its category first appears; each row keeps its scene index;
    each group's (first row, count); lights point at their object's row."""
    _, _, _, static = _bridge(_many_sphere_scene(12))
    t = mk.scene_table(static)
    # scene: box 0, spheres 1..12, light rectangle 13
    assert t.order == (0, 13) + tuple(range(1, 13))
    assert (t.n_plain, t.n_groups, t.n_clusters) == (2, 1, 2)
    ints = np.array(t.ints)
    rows = ints[:6 * 14].reshape(14, 6)
    assert list(rows[:, 5]) == list(t.order)
    assert list(rows[:, 0]) == [static.object_categories[i] for i in t.order]
    assert list(rows[:, 1]) == [t.offsets.objects[i] for i in t.order]
    assert list(ints[6 * 14:6 * 14 + 2]) == [2, 12]
    light = ints[-3:]
    assert light[1] == 1 and light[2] == t.offsets.lights[0]


@pytest.mark.parametrize("name", ["spheres12", "quadrics"])
def test_render_sample_matches_jax(name):
    scene = _many_sphere_scene(12) if name == "spheres12" else _quadrics()
    packed, static, params, tstatic = _bridge(scene)
    want = np.asarray(jax_render_sample(packed, static, 8, 8, 0, 0,
                                        max_bounces=2).color.stack())
    got = render_sample(unflatten(params, tstatic), tstatic, 8, 8, 0, 0,
                        2).stack().numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_port_scenes_are_the_jax_scenes():
    for port, jax_scene in ((tscenes.quadrics, _quadrics),
                            (tscenes.flat_rectangles, _flat_rectangles)):
        params, static = port().pack()
        _, _, want, want_static = _bridge(jax_scene())
        assert torch.equal(params, want) and static == want_static


def test_plain_k1_cull_matches_pallas_cull():
    """The 9-sphere scene of tests/test_pallas_megakernel.py at 16²: the
    port's plain K1 with the cull against the Pallas K1 with its per-tile
    cull in interpret mode, and the same image without the cull."""
    scene = jsail.Scene()
    scene.add(jsail.Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(jsail.Cornellbox((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
    for k in range(9):
        x = -0.7 + 0.7 * (k % 3)
        y = -0.7 + 0.7 * (k // 3)
        scene.add(jsail.Sphere((x, y, 0.3), 0.22, jsail.Matte(kd=0.8)))
    scene.add(jsail.AreaLight(
        jsail.Rectangle((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3), jsail.Matte()),
        (5.0, 5.0, 5.0)))
    packed, static, params, tstatic = _bridge(scene)
    want = np.asarray(render_block_pallas(
        packed, static, 16, 16, 1, 0, 0, max_bounces=2, tile_rows=8,
        tile_cols=8, cull=True, interpret=True).stack())
    culled = mk.render_block(params, tstatic, 16, 16, 1, 0, 0, 2, cull=True)
    plain = mk.render_block(params, tstatic, 16, 16, 1, 0, 0, 2)
    np.testing.assert_allclose(culled.stack().numpy(), want, atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(culled.stack(), plain.stack())
