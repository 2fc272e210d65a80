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
