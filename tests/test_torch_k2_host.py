"""K2's per-sample code on the CPU, and the choice of K2's build.

`sail_tpu_torch/csrc/host/k2_host.cpp` compiles the device code K2 runs
(path.cuh, bsdf.cuh, adjoint.cuh `sample_grad`) with g++ through the stub
`csrc/host/cuda_runtime.h`, -ffp-contract=off as the kernels build
-fmad=false, and gives each pixel's gradient in K2's thread order.  K2's
reverse sweep replays each bounce's recorded winner and occlusion bit in
place of the closest-hit fold and the shadow scan: its gradient must equal,
bit for bit, that of a reverse sweep that re-traces each bounce, and match
the plain version (torch autograd).  Built into the test's temporary
directory; nothing is built at import."""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.utils import build

HOST_DIR = os.path.join(build.CSRC_DIR, "host")
SIZE, SPP, BOUNCES = 8, 2, 3
# configs 2, 3 and 4 (its point and spot lights) and an area light over
# each of seven shapes (the LIGHTS adjoints)
SCENES = ("cornell_mirror", "material_demo", "lights_and_quadrics",
          "area_lights")
# Against the plain version: relative L-inf (of the largest leaf) with
# torch.sqrt made correctly rounded.  torch's CPU float32 sqrt is 1 ulp off
# sqrtf on some inputs, which flips clip ties and moves a leaf by ~1e-3 of
# the largest here; with it rounded correctly the two sum the same terms in
# other float32 orders (per pixel and sample here, autograd's reductions
# there): 1.7e-7 measured, so 1e-5 leaves the orders room.
PLAIN_RTOL = 1e-5
_P, _I = ctypes.c_void_p, ctypes.c_int
HOST_ARGTYPES = [_P] * 2 + [_I] * 10 + [_P] * 4 + [_I] * 8


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build; skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the host build of K2's "
                    "per-sample code needs a C++17 compiler")
    lib = str(tmp_path_factory.mktemp("k2_host") / "k2_host.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", HOST_DIR, "-o", lib,
                    os.path.join(HOST_DIR, "k2_host.cpp")], check=True,
                   capture_output=True)
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def host_k2(host_lib):
    """The host build's per-pixel gradient entry."""
    fn = host_lib.sail_host_pixel_grads
    fn.argtypes, fn.restype = HOST_ARGTYPES, ctypes.c_int
    return fn


def _inputs(name):
    params, static = getattr(scenes, name)().pack()
    rng = np.random.default_rng(0)
    g = Vec3(*(torch.from_numpy(rng.uniform(0.1, 1.0, (SIZE, SIZE))
                                .astype(np.float32)) for _ in range(3)))
    return params, static, g


def _pixel_grads(fn, params, static, g, replay: bool) -> np.ndarray:
    """(SIZE * SIZE, n_params): each pixel's gradient over SPP samples."""
    t = mk.scene_table(static)
    table = np.array(t.ints, dtype=np.int32)
    p = params.numpy().astype(np.float32)
    gs = [np.ascontiguousarray(c.numpy()) for c in g]
    out = np.zeros((SIZE * SIZE, p.size), np.float32)
    err = fn(p.ctypes.data, table.ctypes.data, *mk._counts(static),
             t.offsets.camera, p.size, int(t.materials), int(replay),
             *(c.ctypes.data for c in gs), out.ctypes.data, SIZE, SIZE, SPP,
             0, 0, BOUNCES, 0, SIZE)
    assert err == 0
    return out


@pytest.mark.parametrize("name", SCENES)
def test_replay_equals_retrace(host_k2, name):
    """Every pixel's gradient with the replayed decisions is the re-traced
    one bit for bit: the replay computes every other value by the same code
    in the same order."""
    params, static, g = _inputs(name)
    replay = _pixel_grads(host_k2, params, static, g, True)
    retrace = _pixel_grads(host_k2, params, static, g, False)
    assert np.abs(replay).max() > 0 and np.isfinite(replay).all()
    np.testing.assert_array_equal(replay, retrace)


@pytest.mark.parametrize("name", SCENES)
def test_host_k2_matches_plain(host_k2, name, monkeypatch):
    params, static, g = _inputs(name)
    got = _pixel_grads(host_k2, params, static, g, True).sum(0,
                                                             dtype=np.float64)
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x, *a, **k: (
        sqrt(x.double()).float() if x.dtype == torch.float32
        else sqrt(x, *a, **k)))
    want = mk.render_grad_block_plain(params, static, g, SIZE, SIZE, SPP, 0,
                                      0, BOUNCES).double().numpy()
    assert (np.abs(want) > 0).sum() >= 9
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < PLAIN_RTOL, err


def test_host_entry_matches_its_bindings():
    with open(os.path.join(HOST_DIR, "k2_host.cpp")) as f:
        text = f.read()
    for name, argtypes in (("sail_host_pixel_grads", HOST_ARGTYPES),
                           ("sail_host_grad_min_blocks",
                            mk.MIN_BLOCKS_ARGTYPES)):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           text).group(1)
        assert [_P if "*" in p else _I for p in params.split(",")] == \
            argtypes


def _pack(name):
    """(params, static) of a scene or of `spheres<n>`."""
    if name.startswith("spheres"):
        return scenes.many_spheres(int(name[len("spheres"):])).pack()
    return getattr(scenes, name)().pack()


def _grad_build_constants():
    with open(os.path.join(build.CSRC_DIR, "grad_build.h")) as f:
        text = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"(BLOCK_[XY]|MAX_BLOCK_SMEM|SM_SMEM|BLOCK_RESERVED_SMEM) = (\d+)",
        text)}
    threads = const["BLOCK_X"] * const["BLOCK_Y"]
    return const, threads, (threads + threads // 32) * 4


SIZES = {"cornell_mirror": 72, "material_demo": 126, "quadrics": 138,
         "lights_and_quadrics": 125, "area_lights": 168,
         "material_demo_open": 111, "material_check": 246, "spheres12": 203,
         "spheres16": 255, "spheres64": 879, "spheres256": 3375}


def test_k2_build_choice_fits_shared_memory():
    """K2 keeps a thread's gradient in shared memory where the block's
    columns and the warps' partial sums, (THREADS + WARPS) x n_params
    floats, fit the shared memory a block may have (`grad_build.h`):
    220 parameters, which the wrapper's SHARED_GRAD_MAX_PARAMS repeats.
    Configs 2 and 3, the quadrics, the open twin and 12 spheres take it;
    the check scene and 16 spheres or more the smallest local array of
    `grad_cap`."""
    const, _, per_param = _grad_build_constants()
    limit = const["MAX_BLOCK_SMEM"] // per_param
    assert limit == mk.SHARED_GRAD_MAX_PARAMS == 220
    assert (const["BLOCK_X"], const["BLOCK_Y"]) == mk.GRAD_BLOCK
    assert mk.grad_build(limit) == mk.SHARED_GRAD
    assert mk.grad_build(limit + 1) == mk.grad_cap(limit + 1) == 352
    sizes = {name: _pack(name)[0].numel() for name in SIZES}
    assert sizes == SIZES
    assert {k: mk.grad_build(v) for k, v in sizes.items()} == {
        "cornell_mirror": 0, "material_demo": 0, "quadrics": 0,
        "lights_and_quadrics": 0, "area_lights": 0,
        "material_demo_open": 0, "spheres12": 0, "material_check": 352,
        "spheres16": 352, "spheres64": 1024, "spheres256": 4096}


def test_k2_launch_bound_choice(host_lib):
    """The C entries choose K2's launch bound from the build the wrapper
    picks and the scene (`grad_build.h`, here through the host build): two
    blocks per SM for configs 1-2's kind (the benchmark scenes' shapes,
    matte and mirror) where two blocks' columns fit an SM's 228 KB (109
    parameters), one for every other scene."""
    fn = host_lib.sail_host_grad_min_blocks
    fn.argtypes, fn.restype = mk.MIN_BLOCKS_ARGTYPES, ctypes.c_int
    const, _, per_param = _grad_build_constants()
    two_max = (const["SM_SMEM"] // 2 - const["BLOCK_RESERVED_SMEM"]) \
        // per_param
    assert two_max == 109

    def blocks(n, static):
        t = mk.scene_table(static)
        return fn(n, mk.grad_build(n), int(t.all_shapes), int(t.materials))

    got = {name: blocks(n, _pack(name)[1]) for name, n in SIZES.items()}
    assert {name for name, b in got.items() if b == 2} == {"cornell_mirror"}
    assert set(got.values()) == {1, 2}
    mirror = _pack("cornell_mirror")[1]
    assert blocks(two_max, mirror) == 2 and blocks(two_max + 1, mirror) == 1
    # a local build never takes two blocks, whatever the scene
    assert fn(72, 352, 0, 0) == 1


@pytest.mark.parametrize("strip", ["forward_only", "no_adjoint"])
def test_stripped_k2_rows_on_the_cpu(strip):
    """K2's stripped builds' plain version: each 16x16 block's
    Σ g · (spp-SUM of radiance) in column 0 (and, without the adjoint, in
    column 2, from the replay), 0 elsewhere; a CPU tensor runs it."""
    from sail_tpu_torch.ops.cuda import profile as pf
    params, static = scenes.cornell_mirror().pack()
    rng = np.random.default_rng(1)
    h, w = 20, 24   # ragged blocks: 2 x 2 of them
    g = Vec3(*(torch.from_numpy(rng.uniform(0.1, 1.0, (h, w))
                                .astype(np.float32)) for _ in range(3)))
    rows = pf.render_grad_stripped(strip, params, static, g, h, w, 1, 0, 0,
                                   2)
    img = mk.render_block_plain(params, static, h, w, 1, 0, 0, 2)
    loss = img.x * g.x + img.y * g.y + img.z * g.z
    blocks = [loss[:16, :16], loss[:16, 16:], loss[16:, :16], loss[16:, 16:]]
    assert rows.shape == (4, params.numel())
    torch.testing.assert_close(rows[:, 0], torch.stack([b.sum()
                                                        for b in blocks]))
    cols = [0, 2] if strip == "no_adjoint" else [0]
    torch.testing.assert_close(rows[:, 2], rows[:, 0] if strip ==
                               "no_adjoint" else torch.zeros(4))
    rest = torch.ones(params.numel(), dtype=torch.bool)
    rest[cols] = False
    assert (rows[:, rest] == 0).all()
    assert pf.render_grad_stripped.launches == 0
