"""How the port's plain version and kernel wrappers choose their work, on
the CPU: samples traced together in one pass give the image of one sample
at a time (and the same gradient), the plain version follows float64
parameters, K2's block partials are the card's alone, `render_block` culls
by itself from AUTO_CULL_CLUSTERS clusters, and the scene table marks the
scenes K1's smaller build cannot take."""
import pytest
import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.render import integrator
from sail_tpu_torch.scene.scene import unflatten

torch.set_num_threads(1)

H, W, SPP, BOUNCES = 6, 10, 3, 3


def _scene(name):
    if name.startswith("spheres"):
        return scenes.many_spheres(int(name[len("spheres"):]))
    return getattr(scenes, name)()


def _g(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return Vec3(*(torch.rand(H, W, generator=gen) for _ in range(3)))


@pytest.mark.parametrize("name", ["quadrics", "spheres12", "open_lights"])
def test_samples_traced_together_equal_one_at_a_time(name, monkeypatch):
    params, static = _scene(name).pack()
    scene = unflatten(params, static)
    want = None
    for s in range(SPP):
        one = integrator.render_sample(scene, static, H, W, 7, 2 + s,
                                       BOUNCES, row0=3, image_height=12)
        want = one if want is None else want + one
    together = mk.render_block_plain(params, static, H, W, SPP, 7, 2,
                                     BOUNCES, row0=3, image_height=12)
    monkeypatch.setattr(integrator, "RAYS_PER_PASS", 1)
    apart = mk.render_block_plain(params, static, H, W, SPP, 7, 2, BOUNCES,
                                  row0=3, image_height=12)
    assert float(want.stack().max()) > 0
    assert torch.equal(together.stack(), want.stack())
    assert torch.equal(apart.stack(), want.stack())


def test_gradient_of_samples_together_is_one_at_a_time(monkeypatch):
    params, static = scenes.many_spheres(12).pack()
    args = (params, static, _g(), H, W, SPP, 0, 0, BOUNCES)
    together = mk.render_grad_block_plain(*args)
    monkeypatch.setattr(integrator, "RAYS_PER_PASS", 1)
    apart = mk.render_grad_block_plain(*args)
    # the same terms, summed over the pixels of one pass or of each sample
    scale = float(apart.abs().max())
    assert scale > 0
    torch.testing.assert_close(together, apart, atol=1e-6 * scale, rtol=0)


def test_plain_version_follows_float64_parameters():
    params, static = scenes.quadrics().pack()
    img32 = mk.render_block_plain(params, static, H, W, 2, 0, 0, BOUNCES)
    img64 = mk.render_block_plain(params.double(), static, H, W, 2, 0, 0,
                                  BOUNCES)
    assert all(c.dtype == torch.float64 for c in img64)
    torch.testing.assert_close(img64.stack(), img32.stack().double(),
                               atol=1e-4, rtol=1e-4)
    g = _g()
    grad = mk.render_grad_block_plain(
        params.double(), static, Vec3(*(c.double() for c in g)), H, W, 1, 0,
        0, BOUNCES)
    assert grad.dtype == torch.float64 and torch.isfinite(grad).all()


def test_k2_block_partials_need_the_card():
    params, static = scenes.cornell_mirror().pack()
    with pytest.raises(TypeError, match="CUDA"):
        mk.render_grad_rows(params, static, _g(), H, W, 1, 0, 0, BOUNCES)


@pytest.mark.parametrize("n, cull, max_clusters, want", [
    (16, None, None, 0),        # 2 clusters: below the crossover
    (32, None, None, 4),        # 4 clusters: the cull pays
    (64, None, None, 8),
    (12, True, None, 2),        # asked for
    (64, False, None, 0),       # refused
    (64, None, 4, 0),           # more than the kernel takes: no cull
])
def test_render_block_culls_by_itself_from_four_clusters(n, cull,
                                                        max_clusters, want):
    _, static = scenes.many_spheres(n).pack()
    assert mk.AUTO_CULL_CLUSTERS == 4
    assert mk.cull_clusters(static, cull, max_clusters) == want


def test_asking_for_more_clusters_than_the_kernel_takes_raises():
    _, static = scenes.many_spheres(64).pack()
    with pytest.raises(ValueError, match="at most 4 clusters"):
        mk.cull_clusters(static, True, 4)


def test_table_marks_scenes_beyond_the_benchmark_shapes():
    marks = {name: mk.scene_table(_scene(name).pack()[1]).all_shapes
             for name in ("cornell_mirror", "spheres12", "quadrics",
                          "cubes_and_disks")}
    assert marks == {"cornell_mirror": False, "spheres12": False,
                     "quadrics": True, "cubes_and_disks": True}
