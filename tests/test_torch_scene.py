"""The port's scene packing is the JAX package's: the flat parameter vector
equals the JAX PackedScene's leaves exactly, SceneStatic agrees field by
field, and the bridge carries the JAX parameters across unchanged."""
import jax
import numpy as np
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax
from sail_tpu_torch.scene.scene import unflatten

torch.set_num_threads(1)

SCENES = [("cornell_matte", 60), ("cornell_mirror", 72)]


def _jax_pack(name):
    packed, static = getattr(jscenes, name)().pack()
    return [np.asarray(l) for l in jax.tree.leaves(packed)], static


@pytest.mark.parametrize("name,n_leaves", SCENES)
def test_pack_matches_jax_leaves(name, n_leaves):
    leaves, jstatic = _jax_pack(name)
    params, static = getattr(tscenes, name)().pack()
    assert params.dtype == torch.float32 and params.shape == (n_leaves,)
    np.testing.assert_array_equal(params.numpy(), np.stack(leaves))
    assert len(static) == len(jstatic)
    for field in jstatic._fields:
        assert getattr(static, field) == tuple(getattr(jstatic, field)), field


@pytest.mark.parametrize("name,n_leaves", SCENES)
def test_bridge_round_trip(name, n_leaves):
    leaves, jstatic = _jax_pack(name)
    params = params_from_jax_leaves(leaves)
    np.testing.assert_array_equal(params.numpy(), np.stack(leaves))
    static = static_from_jax(jstatic)
    assert static == getattr(tscenes, name)().pack()[1]
    # the structured view reads the same numbers the JAX pytree holds
    packed, _ = getattr(jscenes, name)().pack()
    view = unflatten(params, static)
    got = [float(x) for x in jax.tree.leaves(
        [tuple(o) for o in view.objects] + [tuple(m) for m in view.materials]
        + [tuple(t) for t in view.textures] + [tuple(l) for l in view.lights]
        + [tuple(view.camera)])]
    np.testing.assert_array_equal(np.float32(got), np.stack(leaves))
    assert float(view.objects[1].radius) == float(packed.objects[1].radius)


@pytest.mark.parametrize("name,n_leaves", [("material_demo", 126),
                                           ("material_demo_open", 111)])
def test_material_scene_pack_matches_jax_leaves(name, n_leaves):
    """Config 3 and its open twin: the metal row (uroughness, vroughness,
    eta, k), the glass row (kr, kt, eta, uroughness, vroughness) and the
    Checkerboard2 row (color1, color2, size) in `jax.tree.flatten` order,
    every leaf equal but the camera basis's, which the port normalizes with
    `1/sqrt` where JAX's XLA takes its rsqrt: there 2e-7.  The bridge
    carries JAX's leaves across exactly, and the view reads them."""
    leaves, jstatic = _jax_pack(name)
    params, static = getattr(tscenes, name)().pack()
    assert params.shape == (n_leaves,)
    assert static == static_from_jax(jstatic)
    bridged = params_from_jax_leaves(leaves)
    np.testing.assert_array_equal(bridged.numpy(), np.stack(leaves))
    off = unflatten(bridged, static)
    cam = n_leaves - 14
    np.testing.assert_array_equal(params[:cam].numpy(), np.stack(leaves[:cam]))
    np.testing.assert_allclose(params[cam:].numpy(), np.stack(leaves[cam:]),
                               rtol=2e-7, atol=2e-7)
    metal = static.material_categories.index(3)
    assert float(off.materials[metal].uroughness) == pytest.approx(0.1)
    assert tuple(float(v) for v in off.materials[metal].k) == \
        pytest.approx((13.028170336874789, 8.112634272577575,
                       5.502811570992323))
    glass = static.material_categories.index(4)
    assert float(off.materials[glass].eta) == pytest.approx(1.5)
    floor = off.textures[static.object_tex_rows[1 if name == "material_demo"
                                                else 0]]
    assert float(floor.size) == pytest.approx(0.25)
    assert tuple(float(v) for v in floor.color2) == pytest.approx((0.2,) * 3)


def test_shared_material_is_deduplicated():
    from sail_tpu_torch import AreaLight, Camera, Cornellbox, Matte, Rectangle
    from sail_tpu_torch import Scene, Sphere
    shared = Matte(kd=0.5)
    scene = Scene()
    scene.add(Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1, -1, -1), (1, 1, 1)))
    scene.add(Sphere((0.3, -0.6, 0.0), 0.3, shared))
    scene.add(Sphere((-0.3, -0.6, 0.0), 0.3, shared))
    scene.add(AreaLight(Rectangle((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3)),
                        (4.0, 4.0, 4.0)))
    params, static = scene.pack()
    assert static.object_mat_rows == (0, 1, 1, 2)
    assert static.object_emissive == (False, False, False, True)
    assert static.area_light_objects == (3,)
    assert params.shape == (10 + 8 + 8 + 10 + 3 * 2 + 4 * 3 + 3 + 14,)
