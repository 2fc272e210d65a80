"""The port's FP32 operation count behind the kernels' bound
(`sail_tpu_torch/utils/opcount.py`), on the CPU: it reads the plain
version's masks and never changes a value, it stays below the JAX package's
masked per-lane count (which runs every bounce on every lane and counts
every primitive), a path that misses costs its camera ray and one scan,
the cull's skipped clusters cost one slab test each, and what depends on an
object alone is counted once per launch."""
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.utils import opcount as jopcount
import sail_tpu_torch as sail
from sail_tpu_torch import constants as C
from sail_tpu_torch import scenes
from sail_tpu_torch.render.integrator import render_sample
from sail_tpu_torch.scene.scene import unflatten
from sail_tpu_torch.utils import opcount

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror"])
def test_live_ops_below_jax_masked_count(name):
    packed, static = getattr(jscenes, name)().pack()
    _, raw = jopcount.integrator_ops_per_lane(packed, static, 2)
    params, tstatic = getattr(scenes, name)().pack()
    k1, k2 = opcount.live_ops(params, tstatic, 8, 8, 1, 0, 2)
    per_pixel = k1 / 64
    assert 0.2 * raw < per_pixel < raw
    assert k2 > 2 * k1      # one forward and its adjoint, which costs more


@pytest.mark.parametrize("cat", [C.SPHERE, C.RECTANGLE])
def test_a_miss_costs_its_camera_ray_and_one_scan(cat):
    scene = sail.Scene()
    scene.add(sail.Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    if cat == C.SPHERE:                                      # behind
        scene.add(sail.Sphere((0.0, 0.0, -5.0), 0.5, sail.Matte()))
    else:
        scene.add(sail.Rectangle((-1.0, 0.0, -5.0), (1.0, 1.0, -5.5),
                                 sail.Matte()))
    params, static = scene.pack()
    k1, k2 = opcount.live_ops(params, static, 4, 4, 2, 0, 3)
    per_sample = opcount.CAMERA_OPS + opcount.T_OPS[cat]
    # what depends on the object alone (the sphere's r², the rectangle's
    # frame) once per launch, not per test
    assert k1 == 16 * 2 * per_sample + opcount.OBJECT_OPS[cat]
    assert k2 == k1 + 16 * 2 * opcount.ADJ_CAMERA_OPS \
        + opcount.OBJECT_ADJ_OPS.get(cat, 0)


def test_tally_changes_no_value_and_the_cull_saves_work():
    params, static = scenes.many_spheres(16).pack()
    scene = unflatten(params, static)
    plain = render_sample(scene, static, 8, 8, 0, 0, 2).stack()
    tallied = render_sample(scene, static, 8, 8, 0, 0, 2, cull=True,
                            tally={}).stack()
    assert torch.equal(plain, tallied)
    off, on = (opcount.live_ops(params, static, 8, 8, 1, 0, 2, cull=c)[0]
               for c in (False, True))
    assert on < off


def test_bound_is_the_larger_time():
    assert opcount.bound_ms(67e9) == (pytest.approx(1.0), "operations")
    assert opcount.bound_ms(67e9, 6.7e9) == (pytest.approx(2.0), "bytes")


def test_live_ops_counts_the_render_and_scales_a_row_stride():
    """live_ops traces the rays render_sample traces (the same image), and
    every other row scaled by two stays near the full count."""
    params, static = scenes.many_spheres(12).pack()
    full = opcount.live_ops(params, static, 8, 8, 1, 0, 2, row0=4,
                            image_height=16)
    tally = {}
    scene = unflatten(params, static)
    render_sample(scene, static, 8, 8, 0, 0, 2, 4, 16, tally=tally)
    k1 = sum(opcount.bounce_ops(static, r)[0] for r in tally["bounces"])
    once = sum(opcount.OBJECT_OPS.get(c, 0) for c in static.object_categories)
    once += opcount.LIGHT_OPS * len(static.light_categories)
    assert full[0] == pytest.approx(k1 + 64 * opcount.CAMERA_OPS + once)
    half = opcount.live_ops(params, static, 8, 8, 1, 0, 2, row0=4,
                            image_height=16, row_step=2)
    assert half[0] == pytest.approx(full[0], rel=0.25)
