"""K1 (`sail_tpu_torch.ops.cuda.megakernel`) on the CPU, where its wrapper
runs the plain torch version: held against the JAX package's Pallas
megakernel in interpret mode, tiled renders agree with whole ones, nothing
counts as a kernel launch, and structure outside the slice is refused.
The CUDA kernel itself runs only on the card (`python3 chip_smoke.py`)."""
import jax
import numpy as np
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.ops.pallas.megakernel import render_block_pallas
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror"])
def test_plain_matches_pallas_interpret(name):
    packed, static = getattr(jscenes, name)().pack()
    want = np.asarray(render_block_pallas(packed, static, 8, 8, 1, 0, 0,
                                          max_bounces=2, tile_rows=8,
                                          interpret=True).stack())
    params, tstatic = getattr(tscenes, name)().pack()
    got = mk.render_block(params, tstatic, 8, 8, 1, 0, 0, 2).stack().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_row_tile_matches_whole_block():
    params, static = tscenes.cornell_mirror().pack()
    whole = mk.render_block(params, static, 16, 8, 2, 3, 5, 2).stack()
    for row0 in (0, 8):
        tile = mk.render_block(params, static, 8, 8, 2, 3, 5, 2, row0=row0,
                               image_height=16).stack()
        assert torch.equal(tile, whole[row0:row0 + 8])


def test_sum_over_samples_in_order():
    params, static = tscenes.cornell_matte().pack()
    two = mk.render_block(params, static, 8, 8, 2, 0, 4, 2)
    one_a = mk.render_block(params, static, 8, 8, 1, 0, 4, 2)
    one_b = mk.render_block(params, static, 8, 8, 1, 0, 5, 2)
    assert torch.equal(two.stack(), (one_a + one_b).stack())


def test_cpu_calls_count_no_launch():
    before = mk.render_block.launches
    params, static = tscenes.cornell_matte().pack()
    mk.render_block(params, static, 4, 4, 1, 0, 0, 1)
    assert mk.render_block.launches == before == 0


def test_default_renderer_asks_for_the_card(monkeypatch):
    """Renderer() with no device runs on the card: without one it raises
    and names device="cpu", never carrying on on the CPU by itself."""
    from sail_tpu_torch import Renderer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(8, 8)


def test_cuda_renderer_without_card_raises(monkeypatch):
    from sail_tpu_torch import Renderer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(8, 8, device="cuda")


def _from_jax(scene):
    packed, static = scene.pack()
    return (params_from_jax_leaves([np.asarray(l)
                                    for l in jax.tree.leaves(packed)]),
            static_from_jax(static))


def _disk_light():
    import sail_tpu as sail
    scene = sail.Scene()
    scene.add(sail.Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(sail.Sphere((0.0, -0.3, 0.3), 0.3, sail.Matte()))
    scene.add(sail.AreaLight(sail.Disk((0.0, 0.9, 0.0), 0.3), (5.0, 5.0, 5.0)))
    return scene


def _point_light():
    import sail_tpu as sail
    scene = sail.Scene()
    scene.add(sail.Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(sail.Sphere((0.0, -0.3, 0.3), 0.3, sail.Metal()))
    scene.add(sail.PointLight((0.0, 0.9, 0.0), (5.0, 5.0, 5.0)))
    return scene


def _cornell_light():
    """A Cornell box as an area light, which `Scene.add` refuses: its
    static structure made by hand."""
    params, static = _from_jax(_disk_light())
    cats = list(static.object_categories)
    cats[static.area_light_objects[0]] = 9   # CORNELLBOX
    return params, static._replace(object_categories=tuple(cats))


def _unknown_light():
    params, static = _from_jax(_point_light())
    return params, static._replace(light_categories=(7,))


def _unknown_shape():
    params, static = _from_jax(_point_light())
    return params, static._replace(object_categories=(12,))


@pytest.mark.parametrize("scene_fn,match", [
    (_unknown_light, "unknown light category 7"),
    (_unknown_shape, "unknown shape category 12"),
    (_cornell_light, "no area sampler"),
])
def test_unsupported_structure_raises(scene_fn, match):
    """Every light and shape renders now (tests/test_torch_lights.py); what
    the kernels cannot take is a category they do not know and an area
    light over a Cornell box."""
    params, static = scene_fn()
    with pytest.raises(ValueError, match=match):
        mk.render_block(params, static, 4, 4, 1, 0, 0, 1)


@pytest.mark.parametrize("scene_fn", [_point_light, _disk_light,
                                      jscenes.lights_and_quadrics])
def test_every_light_renders_through_the_wrapper(scene_fn):
    """The scenes the port once refused (a point light, a disk light,
    config 4) render through the wrapper on CPU tensors, as the JAX
    package renders them."""
    from sail_tpu.render import integrator as jintegrator
    packed, jstatic = scene_fn().pack()
    params, static = _from_jax(scene_fn())
    got = mk.render_block(params, static, 6, 6, 1, 0, 0, 2)
    want = jintegrator.render_sample(packed, jstatic, 6, 6, 0, 0,
                                     max_bounces=2).color
    assert torch.isfinite(got.stack()).all()
    np.testing.assert_allclose(got.stack().numpy(), np.asarray(want.stack()),
                               rtol=1e-4, atol=1e-4)


def test_bad_arguments_raise():
    params, static = tscenes.cornell_matte().pack()
    with pytest.raises(TypeError):
        mk.render_block(params.double(), static, 4, 4, 1, 0, 0, 1)
    with pytest.raises(ValueError):
        mk.render_block(params[:-1], static, 4, 4, 1, 0, 0, 1)
    with pytest.raises(ValueError):
        mk.render_block(params, static, 8, 4, 1, 0, 0, 1, row0=4,
                        image_height=8)


def test_scene_table_names_the_material_build_and_distribution():
    """A scene of matte, mirror and uniform colors keeps the kernels'
    smaller build; a metal, a glass or a uv texture asks for the MATS one;
    each material row carries its microfacet distribution (GGX where the
    variant is 0), after its category and offset."""
    from sail_tpu_torch import UV
    from sail_tpu_torch import constants as C
    assert not mk.scene_table(tscenes.cornell_mirror().pack()[1]).materials
    params, static = tscenes.material_demo().pack()
    table = mk.scene_table(static)
    assert table.materials and not table.all_shapes
    scene = tscenes.cornell_matte()
    scene.objects[1].texture = UV()
    assert mk.scene_table(scene.pack()[1]).materials
    n_obj, _, n_groups, n_mat, _, _ = mk._counts(static)
    rows = table.ints[6 * n_obj + 2 * n_groups:][:3 * n_mat]
    assert rows[0::3] == static.material_categories
    assert rows[1::3] == table.offsets.materials
    assert rows[2::3] == tuple(v or C.TROWBRIDGE_REITZ
                               for v in static.material_variants)
    beck = tscenes.material_check().pack()[1]
    assert C.BECKMANN in mk.scene_table(beck).ints
