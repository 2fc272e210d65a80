"""The port's last tools and examples on the CPU, each against its JAX
counterpart: `tools/gpu_checks.py` (refuses the CPU, as `tpu_checks.py`
refuses it; its checks and keys through the plain version),
`tools/scaling_efficiency.py` (gloo processes; its JSON line),
and `examples/{render_scenes, inverse_render, viewer}.py` at 16² with
`device="cpu"` (the images against the JAX package's `render_image`, the
perturbation against the JAX example's, one PNG frame served to a
localhost request and a click that picks what the JAX package's `Control`
picks)."""
import ast
import importlib.util
import json
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.render.integrator import render_image as jax_render_image
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.examples import inverse_render, render_scenes, viewer
from sail_tpu_torch.scene.scene import leaf_paths
from sail_tpu_torch.tools import gpu_checks, scaling_efficiency
from sail_tpu_torch.utils import native

from test_utils import decode_png_rgb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_module(path):
    """A JAX tool or example loaded from its file (they are scripts)."""
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_keys(path):
    """The keys of the dict literal each `json.dumps(...)` call in a JAX
    tool's source prints."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys
                     if isinstance(k, ast.Constant)}
    return keys


# -- tools/gpu_checks.py ------------------------------------------------------

def test_gpu_checks_refuses_the_cpu(capsys):
    assert not torch.cuda.is_available()
    assert gpu_checks.main(["--size", "16"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA card" in out.err


def test_gpu_checks_keys_and_checks_through_the_plain_version():
    """`run` on CPU tensors (each wrapper's plain version on both sides,
    so every check holds exactly) prints tpu_checks.py's keys but
    `check_vma`, a JAX notion."""
    res = gpu_checks.run(16, 2, 2, device="cpu")
    assert set(res) == _json_keys("tools/tpu_checks.py") - {"check_vma"}
    assert res["ok"] and res["fwd_bits_equal"] and res["sharded_bits_equal"]
    assert res["grad_rel_linf"] == 0.0 and res["sharded_grad_rel_linf"] == 0
    assert res["config"] == "16x16 x2spp x2b (grads 16x16)"


# -- tools/scaling_efficiency.py ----------------------------------------------

def test_scaling_efficiency_prints_its_line_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "sail_tpu_torch.tools.scaling_efficiency",
         "--device", "cpu", "--procs", "2", "--size", "16", "--spp", "2",
         "--iters", "2"], capture_output=True, text=True, cwd=REPO,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == _json_keys("tools/scaling_efficiency.py")
    assert line["metric"] == "rays/s scaling efficiency 1->2 processes"
    d = line["detail"]
    assert d["mrays_1proc"] > 0 and d["mrays_2proc"] > 0
    assert line["value"] == pytest.approx(
        d["mrays_2proc"] / (2 * d["mrays_1proc"]), rel=0.05)
    assert d["device"] == "cpu" and "CPU" in d["note"]


def test_scaling_efficiency_cuda_needs_a_card_per_process(capsys):
    assert scaling_efficiency.main(["--device", "cuda", "--procs", "2"]) == 2
    assert "one process per card" in capsys.readouterr().err


# -- examples/render_scenes.py ----------------------------------------------

@pytest.mark.parametrize("name", ["cornell_matte", "cornell_mirror"])
def test_render_scenes_matches_jax_render(name, tmp_path):
    """The example's image against the JAX package's `render_image` (the
    goldens' bound), and its PNG holds that image; configs 3 and 4 are held
    against JAX by `test_torch_materials.py` and `test_torch_lights.py`,
    and run here through `main`."""
    path, meter, img = render_scenes.render(name, 16, 2, 2, str(tmp_path),
                                            device="cpu")
    assert path == os.path.join(str(tmp_path), f"{name}_16_2spp.png")
    assert meter.samples == 2 and meter.report()["resolution"] == "16x16"
    packed, static = getattr(jscenes, name)().pack()
    want = np.asarray(jax_render_image(packed, static, 16, 16, 2, seed=0,
                                       max_bounces=2).stack())
    np.testing.assert_allclose(img, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(decode_png_rgb(open(path, "rb").read()),
                                  native.tonemap_u8(img))


def test_render_scenes_main_writes_every_scene(tmp_path, capsys):
    assert render_scenes.main(["--size", "8", "--spp", "1", "--bounces", "1",
                               "--device", "cpu", "--out",
                               str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(render_scenes.SCENES)
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{n}_8_1spp.png" for n in render_scenes.SCENES)


# -- examples/inverse_render.py -----------------------------------------------

def test_inverse_render_perturbs_as_jax_and_fits(tmp_path):
    packed, _ = jscenes.cornell_mirror().pack()
    jperturbed = packed._replace(
        lights=tuple(lp._replace(emission=lp.emission * 0.5)
                     for lp in packed.lights),
        materials=tuple(
            m._replace(kr=m.kr * 0.4) if hasattr(m, "kr") and
            not hasattr(m, "kt") else m for m in packed.materials))
    params, static = tscenes.cornell_mirror().pack()
    got = inverse_render.perturb(params, static)
    np.testing.assert_array_equal(
        got.numpy(), np.stack([np.asarray(x, np.float32)
                               for x in jax.tree.leaves(jperturbed)]))

    res = inverse_render.main(["--size", "16", "--spp", "2", "--steps", "3",
                               "--bounces", "2", "--device", "cpu", "--out",
                               str(tmp_path)])
    assert len(res["losses"]) == 3 and res["losses"][-1] < res["losses"][0]
    e = leaf_paths(static).index(".lights[0].emission.x")
    assert float(res["start"][e]) < float(res["params"][e]) \
        < float(res["true"][e])
    assert sorted(os.listdir(tmp_path)) == [
        "inverse_initial.png", "inverse_recovered.png", "inverse_target.png"]


# -- examples/viewer.py -------------------------------------------------------

def test_viewer_serves_a_frame_and_picks_as_jax():
    jviewer = _jax_module("examples/viewer.py")
    assert viewer.DEFAULT_SCRIPT == jviewer.DEFAULT_SCRIPT
    scene = tscenes.cornell_mirror()
    scene.filter = "gamma"
    state = viewer.ViewerState(scene, 16, "cpu")
    state.script = "scene = scenes.cornell_mirror()\n"
    state.step()
    server = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/frame.png", timeout=60) as r:
            assert r.headers["Content-Type"] == "image/png"
            frame = decode_png_rgb(r.read())
        np.testing.assert_array_equal(
            frame, native.tonemap_u8(state.renderer.output(state.scene)))
        with urllib.request.urlopen(f"{url}/mouse?type=down&x=11&y=12",
                                    timeout=60) as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(f"{url}/status", timeout=60) as r:
            status = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    jscene = jscenes.cornell_mirror()
    from sail_tpu.render.control import Control as JControl
    JControl(jscene, 16, 16).mouse_down(11, 12)
    assert status == {"samples": 1, "selected": jscene.select}
    assert jscene.select is not None


def test_last_modules_import_no_jax():
    """The modules these tests cover import neither JAX nor the JAX
    package."""
    mods = ("sail_tpu_torch.utils.native", "sail_tpu_torch.utils.metrics",
            "sail_tpu_torch.oracle.cpu_tracer",
            "sail_tpu_torch.tools.gpu_checks",
            "sail_tpu_torch.tools.scaling_efficiency",
            "sail_tpu_torch.examples.render_scenes",
            "sail_tpu_torch.examples.viewer",
            "sail_tpu_torch.examples.inverse_render")
    code = (f"import sys; import {', '.join(mods)}; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m == "
            "'sail_tpu' or m.startswith(('jax.', 'sail_tpu.'))); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO)
