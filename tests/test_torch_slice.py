"""The port's serving path end to end on the CPU — Renderer → update →
render_spp → output — against the JAX package's Renderer (atol = rtol =
1e-5), and the port's freedom from jax."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import sail_tpu as jsail
from sail_tpu import scenes as jscenes
import sail_tpu_torch
from sail_tpu_torch import scenes as tscenes

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror"])
def test_renderer_matches_jax(name):
    jscene = getattr(jscenes, name)()
    jr = jsail.Renderer(16, 16, seed=7, max_bounces=2)
    jr.update(jscene)
    jr.render_spp(jscene, 4)
    tscene = getattr(tscenes, name)()
    tr = sail_tpu_torch.Renderer(16, 16, seed=7, max_bounces=2, device="cpu")
    tr.update(tscene)
    tr.render_spp(tscene, 4)
    assert tr.sample_count == tscene.sample_count == 4
    for filt in ("color", "gamma"):
        jscene.filter = filt
        tscene.filter = filt
        want = jr.output(jscene)
        got = tr.output(tscene)
        assert got.shape == (16, 16, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_render_one_at_a_time_equals_render_spp():
    scene = tscenes.cornell_mirror()
    a = sail_tpu_torch.Renderer(8, 8, seed=3, max_bounces=2, device="cpu")
    a.update(scene)
    a.render_spp(scene, 2)
    b = sail_tpu_torch.Renderer(8, 8, seed=3, max_bounces=2, device="cpu")
    b.update(scene)
    b.render(scene)
    b.render(scene)
    np.testing.assert_allclose(a.output(scene), b.output(scene), atol=1e-6)


def test_moving_scene_restarts_accumulation():
    scene = tscenes.cornell_matte()
    r = sail_tpu_torch.Renderer(8, 8, seed=1, max_bounces=2, device="cpu")
    r.update(scene)
    r.render_spp(scene, 2)
    scene.objects[1].center = (0.2, -0.5, 0.1)
    scene.moving = True
    r.render_spp(scene, 1)
    assert r.sample_count == scene.sample_count == 1
    moved = tscenes.cornell_matte()
    moved.objects[1].center = (0.2, -0.5, 0.1)
    fresh = sail_tpu_torch.Renderer(8, 8, seed=1, max_bounces=2,
                                    device="cpu")
    fresh.update(moved)
    fresh.render_spp(moved, 1)
    np.testing.assert_array_equal(r.output(scene), fresh.output(moved))


def test_gbuffer_filters_not_ported():
    """Each filter that reads the G-buffer renders a finite frame
    (tests/test_torch_display.py holds the values against JAX's)."""
    scene = tscenes.cornell_matte()
    r = sail_tpu_torch.Renderer(4, 4, max_bounces=1, device="cpu")
    r.render(scene)
    for name in ("normal", "position", "wavelet"):
        scene.filter = name
        out = r.output(scene)
        assert out.shape == (4, 4, 3) and np.isfinite(out).all(), name


def test_port_imports_no_jax():
    code = ("import sys, sail_tpu_torch, sail_tpu_torch.scenes, "
            "sail_tpu_torch.render.renderer, sail_tpu_torch.ops.cuda.megakernel, "
            "sail_tpu_torch.render.control, sail_tpu_torch.render.picking, "
            "sail_tpu_torch.render.overlay, sail_tpu_torch.utils.imageio, "
            "sail_tpu_torch.utils.matrix, sail_tpu_torch.diff.boundary, "
            "sail_tpu_torch.diff.inverse, sail_tpu_torch.parallel.mesh, "
            "sail_tpu_torch.parallel.render_sharded, "
            "sail_tpu_torch.parallel.elastic, "
            "sail_tpu_torch.tools.inverse_artifact, "
            "sail_tpu_torch.tools.mp_render_worker, "
            "sail_tpu_torch.tools.dryrun_multichip; "
            "sail_tpu_torch.Renderer; sail_tpu_torch.Control; "
            "sail_tpu_torch.ElasticRenderer; "
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'sail_tpu.')) or m == 'sail_tpu'], "
            "sorted(m for m in sys.modules if m.startswith(('jax', 'sail_tpu.')))")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=sail_tpu_torch.__path__[0] + "/..")
