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


K2_OVER_K1 = {"cornell_matte": 2.0, "cornell_mirror": 2.0,
              "material_demo": 1.5}


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror",
                                  "material_demo"])
def test_live_ops_below_jax_masked_count(name):
    packed, static = getattr(jscenes, name)().pack()
    _, raw = jopcount.integrator_ops_per_lane(packed, static, 2)
    params, tstatic = getattr(scenes, name)().pack()
    k1, k2 = opcount.live_ops(params, tstatic, 8, 8, 1, 0, 2)
    per_pixel = k1 / 64
    assert 0.2 * raw < per_pixel < raw
    # one forward and its adjoint, which costs more; on material_demo more
    # of the forward is the scans over its eight objects, which the adjoint
    # does not repeat
    assert k2 > K2_OVER_K1[name] * k1


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


@pytest.mark.parametrize("name", ["cornell_mirror", "material_demo_open"])
def test_isect_only_ops_per_path_bounce(name):
    """K5a's count: every path runs every bounce and tests every object;
    a path-bounce costs its tests and the reflection, and a hit its
    winner's record on top; the samples repeat one sample's work."""
    params, static = getattr(scenes, name)().pack()
    fixed = opcount.CAMERA_OPS * 64 + sum(
        opcount.OBJECT_OPS.get(c, 0) for c in static.object_categories)
    one, three = (opcount.isect_only_ops(params, static, 8, 8, spp, 2)
                  - fixed for spp in (1, 3))
    assert three == pytest.approx(3 * one)
    floor = sum(opcount.T_OPS[c] for c in static.object_categories) \
        + opcount.ISECT_BOUNCE_OPS
    per = one / (64 * 2)
    assert floor <= per <= floor + max(opcount.HIT_OPS.values())


def test_alu_bound_is_the_slower_pipe():
    n = 1e9
    fma = opcount.alu_bound_ms("fma", n, 1980.0)
    assert fma["pipe"] == "fp32" and fma["sfu_ms"] == 0
    assert fma["bound_ms"] == pytest.approx(16 * n / 67e12 * 1e3)
    mix = opcount.alu_bound_ms("integrator_mix", n, 1980.0)
    assert mix["pipe"] == "sfu"
    assert mix["bound_ms"] == pytest.approx(2 * n / (132 * 16 * 1980e6) * 1e3)
    assert opcount.alu_bound_ms("integrator_mix", n, 1980.0, chains=8)[
        "bound_ms"] == pytest.approx(8 * mix["bound_ms"])


def test_no_shadow_scan_bound_keeps_the_light_sample(monkeypatch):
    """With the shadow scan stripped the build still samples the light: the
    count lies between the full one and the one with no NEE, and loses
    exactly the light sample's NEE_OPS when those are set to 0."""
    from sail_tpu_torch.ops.cuda import profile as pf
    params, static = scenes.cornell_mirror().pack()

    def k1(strip=None):
        if strip is None:
            return opcount.live_ops(params, static, 8, 8, 1, 0, 2)[0]
        with pf.stripped(strip):
            return opcount.live_ops(params, static, 8, 8, 1, 0, 2)[0]

    full, no_shadow, no_nee = k1(), k1("no_shadow_scan"), k1("no_nee")
    assert no_nee < no_shadow < full
    monkeypatch.setattr(opcount, "NEE_OPS", 0)
    assert k1("no_shadow_scan") == pytest.approx(no_nee, rel=1e-12)


def test_each_light_has_its_own_hand_count(monkeypatch):
    """Each light category, and each shape an area light samples, has its
    own forward and adjoint count (the rectangle's are NEE_OPS and
    ADJ_NEE_OPS, so every earlier bound stays); the counts follow the light
    each ray sampled: on config 4 the point light's count moves K1's total
    by exactly its share of the light samples."""
    params, static = scenes.area_lights().pack()
    fwd, back = opcount.light_ops(static)
    assert len(fwd) == len(back) == 7 and len(set(fwd)) == 7
    assert min(fwd) > opcount.NEE_OPS and min(back) > opcount.ADJ_NEE_OPS
    params4, static4 = scenes.lights_and_quadrics().pack()
    assert opcount.light_ops(static4) == (
        [opcount.NEE_OPS, opcount.NEE_LIGHT_OPS[C.POINT],
         opcount.NEE_LIGHT_OPS[C.SPOT]],
        [opcount.ADJ_NEE_OPS, opcount.ADJ_NEE_LIGHT_OPS[C.POINT],
         opcount.ADJ_NEE_LIGHT_OPS[C.SPOT]])
    k1 = opcount.live_ops(params4, static4, 8, 8, 1, 0, 2)[0]
    point = opcount.NEE_LIGHT_OPS[C.POINT]
    monkeypatch.setitem(opcount.NEE_LIGHT_OPS, C.POINT, point + 1000)
    more = opcount.live_ops(params4, static4, 8, 8, 1, 0, 2)[0]
    samples = (more - k1) / 1000
    assert samples == int(samples) and 0 < samples < 8 * 8 * 2
