"""K1's per-pixel loop on the CPU.

`sail_tpu_torch/csrc/host/k1_host.cpp` compiles K1's device code
(render_block.cuh `render_pixel`, path.cuh, bsdf.cuh) with g++ through the
stub `csrc/host/cuda_runtime.h`, -ffp-contract=off as the kernels build
-fmad=false, and runs it one pixel at a time (a block of one thread).  The
shipped loop regenerates paths, tests each pending shadow ray in the same
pass as the path's next ray and reads staged rectangle frames and per-ray
reciprocals; its image must equal, bit for bit, that of the loop K1 ran
before (a sample loop around a bounce loop, each bounce with its own
shadow scan, every frame and reciprocal computed per test), and match the
plain version.  Built into the test's temporary directory; nothing is built
at import."""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.ops.cuda import profile as pf
from sail_tpu_torch.utils import build

HOST_DIR = os.path.join(build.CSRC_DIR, "host")
SPP = 2
# (scene, size, bounces, cull): the benchmark scene, config 3 and its open
# twin (paths end at different bounces), 64 spheres with and without the
# cluster boxes, one of each quadric, config 4 (area, point and spot
# lights) and an area light over each of seven shapes
CASES = (("cornell_mirror", 12, 4, False), ("material_demo", 12, 5, False),
         ("material_demo_open", 16, 5, False), ("spheres64", 8, 3, True),
         ("spheres64", 8, 3, False), ("quadrics", 12, 4, False),
         ("lights_and_quadrics", 12, 4, False), ("area_lights", 12, 4, False))
# Against the plain version: test_torch_k2_host.py's bound and reason
# (torch.sqrt made correctly rounded; the two compute each pixel's terms in
# other float32 orders only where torch batches them).
from test_torch_k2_host import PLAIN_RTOL  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
HOST_ARGTYPES = [_I] + [_P] * 2 + [_I] * 12 + [_P] * 3 + [_I] * 8


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    """The host build's image entry; skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the host build of K1's "
                    "per-pixel loop needs a C++17 compiler")
    lib = str(tmp_path_factory.mktemp("k1_host") / "k1_host.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", HOST_DIR, "-o", lib,
                    os.path.join(HOST_DIR, "k1_host.cpp")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).sail_host_render_block
    fn.argtypes, fn.restype = HOST_ARGTYPES, ctypes.c_int
    return fn


def _pack(name):
    if name.startswith("spheres"):
        return scenes.many_spheres(int(name[len("spheres"):])).pack()
    return getattr(scenes, name)().pack()


def _image(fn, params, static, size, bounces, shipped: bool, cull=False,
           strip=0, seed=0, sample0=0, rows=None, row0=0) -> np.ndarray:
    """(3, rows, size): the host loop's spp-SUM of a block of the image."""
    rows = size if rows is None else rows
    t = mk.scene_table(static)
    table = np.array(t.ints, dtype=np.int32)
    p = params.numpy().astype(np.float32)
    out = np.zeros((3, rows, size), np.float32)
    err = fn(strip, p.ctypes.data, table.ctypes.data, *mk._counts(static),
             t.offsets.camera, int(t.all_shapes), int(t.materials),
             t.n_clusters if cull else 0, t.n_frames, int(shipped),
             *(out[c].ctypes.data for c in range(3)), rows, size, SPP,
             seed, sample0, bounces, row0, size)
    assert err == 0
    return out


@pytest.mark.parametrize("name,size,bounces,cull", CASES)
def test_shipped_loop_equals_loop_by_sample(host_k1, name, size, bounces,
                                            cull):
    """Regeneration, the fused shadow test and the staged values change no
    pixel: every thread adds the same terms in the same order."""
    params, static = _pack(name)
    new = _image(host_k1, params, static, size, bounces, True, cull)
    old = _image(host_k1, params, static, size, bounces, False, cull)
    assert np.isfinite(new).all() and (new > 0).sum() >= new.size // 4
    np.testing.assert_array_equal(new, old)


def test_shipped_loop_on_a_tile_with_another_seed(host_k1):
    """A row tile of a taller image, a negative seed and a later sample0:
    the rows and samples the loop draws its streams from."""
    params, static = _pack("cornell_mirror")
    args = dict(seed=-3, sample0=5, rows=5, row0=7)
    new = _image(host_k1, params, static, 12, 5, True, **args)
    old = _image(host_k1, params, static, 12, 5, False, **args)
    np.testing.assert_array_equal(new, old)
    want = np.stack([c.numpy() for c in mk.render_block_plain(
        params, static, 5, 12, SPP, -3, 5, 5, row0=7, image_height=12)])
    np.testing.assert_allclose(new, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strip", sorted(pf.STRIPS))
def test_stripped_loop_equals_loop_by_sample(host_k1, strip):
    """K1's profiling builds run the same loop with a phase stripped
    (no_shadow_scan leaves no shadow ray pending)."""
    params, static = _pack("cornell_mirror")
    bit = pf.STRIPS[strip]
    new = _image(host_k1, params, static, 12, 4, True, strip=bit)
    old = _image(host_k1, params, static, 12, 4, False, strip=bit)
    full = _image(host_k1, params, static, 12, 4, True)
    np.testing.assert_array_equal(new, old)
    assert not np.array_equal(new, full)


def test_no_bounces_gives_zeros(host_k1):
    params, static = _pack("cornell_mirror")
    new = _image(host_k1, params, static, 8, 0, True)
    assert (new == 0).all()


@pytest.mark.parametrize("name,size,bounces,cull", CASES)
def test_host_k1_matches_plain(host_k1, name, size, bounces, cull,
                               monkeypatch):
    params, static = _pack(name)
    got = _image(host_k1, params, static, size, bounces, True, cull)
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x, *a, **k: (
        sqrt(x.double()).float() if x.dtype == torch.float32
        else sqrt(x, *a, **k)))
    want = np.stack([c.numpy() for c in mk.render_block_plain(
        params, static, size, size, SPP, 0, 0, bounces, cull=cull)])
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < PLAIN_RTOL, err


def test_host_entry_matches_its_bindings():
    with open(os.path.join(HOST_DIR, "k1_host.cpp")) as f:
        text = f.read()
    params = re.search(r'extern "C" int sail_host_render_block\(([^)]*)\)',
                       text).group(1)
    assert [_P if "*" in p else _I for p in params.split(",")] == \
        HOST_ARGTYPES
