"""The edge terms' kernels on the CPU: KR (`csrc/trace_rays.cu`, the
straddle rays of the silhouette terms) and KP (`csrc/penumbra.cu`, the
penumbra term with its adjoint).

`sail_tpu_torch/csrc/host/edge_host.cpp` compiles their device code
(render_block.cuh `ray_radiance`, penumbra.cuh `penumbra_pixel`) with g++
through the stub `csrc/host/cuda_runtime.h`, -ffp-contract=off as the
kernels build -fmad=false (`utils/build.load_host`, into the gitignored
build/native/).  Held here:

- KR, handed K1's own camera rays, gives K1's image (`render_pixel` of the
  host build of K1) bit for bit: the loop they share is the same code;
- KR against the plain `integrator.trace_rays` on config 5's straddle rays
  and on `material_demo` (the MATS kinds), within test_torch_k2_host.py's
  PLAIN_RTOL with torch.sqrt made correctly rounded (the two add each
  ray's terms in other float32 orders where torch batches them: ~1e-7
  relative measured, not bit for bit on the CPU);
- KP per leaf within 1e-4 of the largest leaf of the plain
  `shadow_boundary_term` (config 5 at 24² with 8 curve samples, and the
  direct, mirror and indirect receivers of test_torch_boundary_shadow.py),
  the plain version held against JAX's on the same inputs; KP's partials
  against autograd's;
- both wrappers take the plain version for a CPU tensor and count no
  launch.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from sail_tpu.diff import boundary as jb
from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.ops.cuda import penumbra as kp
from sail_tpu_torch.render import integrator
from sail_tpu_torch.scene.scene import leaf_paths, unflatten
from sail_tpu_torch.utils import build

from test_torch_boundary import (adjoints, assert_leaves_close, bridged,
                                 indirect_shadow, jax_rsqrt_as_port,  # noqa
                                 mirror_penumbra, ramp_adjoint)
from test_torch_boundary_shadow import matte_shadow
from test_torch_k2_host import PLAIN_RTOL

torch.set_num_threads(1)

HOST_DIR = os.path.join(build.CSRC_DIR, "host")
HOST_SOURCE = os.path.join(HOST_DIR, "edge_host.cpp")
HOST_EXTRA = ("-std=c++17", "-ffp-contract=off", "-I", HOST_DIR)
# KP against the plain version, per leaf: |diff| <= LEAF_TOL · max|plain|
# (the bound the edge terms hold against JAX: the same float32 operations
# for the coefficients, the adjoint written out against autograd's, each
# summed in its own order)
LEAF_TOL = 1e-4

_P, _I = ctypes.c_void_p, ctypes.c_int
KR_HOST_ARGTYPES = [_P] * 2 + [_I] * 8 + [_P] * 12 + [_I] * 3
CAMERA_HOST_ARGTYPES = [_P] * 2 + [_I] * 7 + [_P] * 5 + [_I] * 4
KP_HOST_ARGTYPES = [_P] * 10 + [_I] * 4 + [_P] * 2 + [_I] * 2
K1_HOST_ARGTYPES = [_I] + [_P] * 2 + [_I] * 12 + [_P] * 3 + [_I] * 8


@pytest.fixture(scope="module")
def host():
    """The host build of edge_host.cpp; skips where there is no g++."""
    try:
        lib = build.load_host(HOST_SOURCE, HOST_EXTRA)
    except RuntimeError as e:
        if "g++ not found" in str(e):
            pytest.skip("no g++ on this machine: the host build of KR and "
                        "KP needs a C++17 compiler")
        raise
    for name, types in (("sail_host_trace_rays", KR_HOST_ARGTYPES),
                        ("sail_host_camera_rays", CAMERA_HOST_ARGTYPES),
                        ("sail_host_penumbra", KP_HOST_ARGTYPES)):
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _np(t, dtype=np.float32):
    return np.ascontiguousarray(t.detach().numpy().astype(dtype))


def _scene_args(params, static):
    t = mk.scene_table(static)
    keep = (_np(params), np.array(t.ints, dtype=np.int32))
    return keep, (keep[0].ctypes.data, keep[1].ctypes.data,
                  *mk._counts(static), t.offsets.camera)


def host_trace_rays(lib, params, static, ro, rd, noise, max_bounces):
    """KR's radiance of the rays on the host, as a Vec3 of their shape."""
    shape = torch.broadcast_shapes(ro.shape, rd.shape, noise.ii.shape,
                                   noise.jj.shape)
    rays = [_np(c.broadcast_to(shape).reshape(-1)) for c in (*ro, *rd)]
    ints = [mk._ray_ints(v, shape, "cpu").reshape(-1).numpy()
            for v in (noise.sample, noise.ii, noise.jj)]
    n = rays[0].size
    out = np.zeros((3, n), np.float32)
    keep, scene = _scene_args(params, static)
    err = lib.sail_host_trace_rays(
        *scene, mk.scene_table(static).n_frames,
        *(a.ctypes.data for a in rays + ints),
        *(out[c].ctypes.data for c in range(3)), n, mk._int32(noise.seed),
        max_bounces)
    assert err == 0
    return Vec3(*(torch.from_numpy(out[c]).view(shape) for c in range(3)))


def straddle_call(params, static, size, max_bounces=4):
    """The one trace_rays call of config 5's silhouette term (the step's
    settings at `size`²): its arguments."""
    calls = []
    w = torch.from_numpy(ramp_adjoint(size, size))

    def record(*args):
        calls.append(args)
        return mk.trace_rays(*args)

    orig = tb.trace_rays
    tb.trace_rays = record
    try:
        tb.boundary_term(params, static, Vec3(w, w, w), size, size,
                         n_edge_samples=48, n_noise=2, seed=7717,
                         max_bounces=max_bounces)
    finally:
        tb.trace_rays = orig
    (args,) = calls
    return args


@pytest.fixture
def sqrt_correctly_rounded(monkeypatch):
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x, *a, **k: (
        sqrt(x.double()).float() if x.dtype == torch.float32
        else sqrt(x, *a, **k)))


def _plain_rays(params, static, ro, rd, noise, max_bounces):
    return integrator.trace_rays(unflatten(params, static), static, ro, rd,
                                 noise, max_bounces)


def _assert_rays_close(got, want):
    got, want = got.stack().numpy(), want.stack().numpy()
    assert np.isfinite(got).all() and (want > 0).sum() >= want.size // 8
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < PLAIN_RTOL, err


@pytest.mark.parametrize("bounces", [1, 4])
def test_kr_matches_plain_on_config5_straddle_rays(host, bounces,
                                                   sqrt_correctly_rounded):
    params, static = scenes.cornell_mirror().pack()
    _, st, ro, rd, noise, mb = straddle_call(params, static, 24, bounces)
    assert ro.shape[0] == 2 and mb == bounces
    got = host_trace_rays(host, params, st, ro, rd, noise, mb)
    _assert_rays_close(got, _plain_rays(params, st, ro, rd, noise, mb))


def test_kr_matches_plain_on_material_demo(host, sqrt_correctly_rounded):
    """Rays from points inside config 3's scene in seeded directions, each
    its own sample and pixel: metal, glass, Oren-Nayar and the
    checkerboard (KR's MATS)."""
    params, static = scenes.material_demo().pack()
    rs = np.random.RandomState(3)
    n = 600
    o = torch.from_numpy((rs.rand(3, n) * 1.2 - 0.6).astype(np.float32))
    d = torch.from_numpy(rs.randn(3, n).astype(np.float32))
    d = d / d.norm(dim=0, keepdim=True)
    ro, rd = Vec3(o[0], o[1], o[2]), Vec3(d[0], d[1], d[2])
    noise = integrator.PixelNoise(
        -5, torch.from_numpy(rs.randint(0, 50, n)),
        torch.from_numpy(rs.randint(0, 64, n).astype(np.int32)),
        torch.from_numpy(rs.randint(0, 64, n).astype(np.int32)))
    got = host_trace_rays(host, params, static, ro, rd, noise, 5)
    _assert_rays_close(got, _plain_rays(params, static, ro, rd, noise, 5))


@pytest.mark.parametrize("name", ["cornell_mirror", "material_demo"])
def test_kr_on_k1_camera_rays_is_k1(host, name, tmp_path):
    """KR handed the camera rays K1 draws gives K1's 1-spp image bit for
    bit: the per-bounce loop is K1's own (`trace_loop`), here through
    KR's ALL + MATS build where K1 takes the scene's own kind."""
    import shutil
    import subprocess
    gxx = shutil.which("g++")
    params, static = getattr(scenes, name)().pack()
    size, sample, seed, bounces = 12, 3, 11, 4
    lib = str(tmp_path / "k1_host.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", HOST_DIR, "-o", lib,
                    os.path.join(HOST_DIR, "k1_host.cpp")], check=True,
                   capture_output=True)
    k1 = ctypes.CDLL(lib).sail_host_render_block
    k1.argtypes, k1.restype = K1_HOST_ARGTYPES, ctypes.c_int
    keep, scene = _scene_args(params, static)
    t = mk.scene_table(static)
    image = np.zeros((3, size, size), np.float32)
    assert k1(0, *scene, int(t.all_shapes), int(t.materials), 0,
              t.n_frames, 1, *(image[c].ctypes.data for c in range(3)),
              size, size, 1, seed, sample, bounces, 0, size) == 0
    ii, jj = (a.reshape(-1).contiguous()
              for a in integrator.pixel_grid(size, size, 0, "cpu"))
    n = ii.numel()
    smp = np.full(n, sample, np.int32)
    ro, rd = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
    assert host.sail_host_camera_rays(
        *scene, smp.ctypes.data, ii.numpy().ctypes.data,
        jj.numpy().ctypes.data, ro.ctypes.data, rd.ctypes.data, n, seed,
        size, size) == 0
    noise = integrator.PixelNoise(seed, sample, ii, jj)
    got = host_trace_rays(host, params, static,
                          Vec3(*torch.from_numpy(ro).T),
                          Vec3(*torch.from_numpy(rd).T), noise, bounces)
    got = got.stack(0).numpy().reshape(3, size, size)
    assert (image > 0).sum() >= image.size // 4
    np.testing.assert_array_equal(got, image)


def test_trace_rays_wrapper_takes_plain_version_on_cpu():
    params, static = scenes.cornell_mirror().pack()
    _, st, ro, rd, noise, mb = straddle_call(params, static, 16)
    before = mk.trace_rays.launches
    got = mk.trace_rays(params, st, ro, rd, noise, mb)
    want = _plain_rays(params, st, ro, rd, noise, mb)
    assert torch.equal(got.stack(), want.stack())
    assert mk.trace_rays.launches == before
    with pytest.raises(ValueError):
        mk.trace_rays(params, st, ro, rd, noise, -1)


# -- KP --------------------------------------------------------------------

def host_partials(lib):
    """A `penumbra_partials` on the host build: the per-pixel rows summed
    in float64."""
    def partials(spheres, xs, c):
        R, S, L, K, H, W = kp._check(spheres, xs, c)
        arrays = [_np(xs), _np(c.planes), _np(c.ints, np.int32),
                  _np(c.dl), _np(c.mats), _np(spheres),
                  _np(c.sphere_obj, np.int32), _np(c.lights),
                  _np(c.light_obj, np.int32), _np(c.cs)]
        acc = np.zeros((H * W, 1 + 4 * S), np.float32)
        gx = np.zeros((R, 3, H, W), np.float32)
        assert lib.sail_host_penumbra(*(a.ctypes.data for a in arrays), R,
                                      S, L, K, acc.ctypes.data,
                                      gx.ctypes.data, H, W) == 0
        tot = torch.from_numpy(acc.astype(np.float64).sum(0)).float()
        return tot[0], tot[1:].view(S, 4), torch.from_numpy(gx)
    return partials


def _through(partials):
    """`penumbra_scalar` routed through `partials` (KP's contract)."""
    def scalar(*args):
        return kp.penumbra_scalar_kernel(*args, partials=partials)
    return scalar


def _with_host_kp(host, monkeypatch):
    monkeypatch.setattr(kp, "penumbra_scalar", _through(host_partials(host)))


def _config5():
    from sail_tpu import scenes as jscenes
    return bridged(lambda lib: jscenes.cornell_mirror())


# (scene, size, shadow_boundary_term's keywords)
KP_CASES = {
    "config5": (_config5, 24, dict(n_curve_samples=8, seed=7717)),
    "direct": (lambda: bridged(matte_shadow), 16, dict(n_curve_samples=8)),
    "mirror": (lambda: bridged(mirror_penumbra), 48,
               dict(n_curve_samples=16)),
    "indirect": (lambda: bridged(indirect_shadow), 16,
                 dict(n_curve_samples=8, n_indirect_dirs=2, seed=3)),
}


def _assert_per_leaf(got, want, static, label):
    d = (got - want).abs()
    top = float(want.abs().max())
    assert top > 0 and bool(torch.isfinite(got).all()), label
    k = int(d.argmax())
    assert float(d.max()) <= LEAF_TOL * top, (
        f"{label}: leaf {leaf_paths(static)[k]} KP {float(got[k]):.6g} "
        f"plain {float(want[k]):.6g} (max |plain| {top:.3g})")


@pytest.mark.parametrize("name", list(KP_CASES))
def test_kp_per_leaf_matches_plain_and_plain_matches_jax(
        host, name, monkeypatch, jax_rsqrt_as_port):
    make, size, kw = KP_CASES[name]
    packed, static, params, tstatic = make()
    jdl, tdl = adjoints(ramp_adjoint(size, size, 0.1, 3.0))
    plain = tb.shadow_boundary_term(params, tstatic, tdl, size, size, **kw)
    want = jb.shadow_boundary_term(packed, static, jdl, size, size, **kw)
    assert_leaves_close(name, want, plain, tstatic)
    _with_host_kp(host, monkeypatch)
    got = tb.shadow_boundary_term(params, tstatic, tdl, size, size, **kw)
    _assert_per_leaf(got, plain, tstatic, name)


def test_kp_partials_match_autograd(host):
    """KP's value and partials against autograd of the plain version's
    scalar in the same spheres and receiver points (config 5 at 16²,
    primary and mirror receivers)."""
    params, static = scenes.cornell_mirror().pack()
    size, K = 16, 8
    captured = {}

    def capture(pk, pk_d, st, dL, receivers, x_live, pairs, k):
        captured.update(pk_d=pk_d, dL=dL, receivers=receivers, pairs=pairs,
                        x=x_live)
        return kp.penumbra_scalar_plain(pk, pk_d, st, dL, receivers, x_live,
                                        pairs, k)

    w = torch.from_numpy(ramp_adjoint(size, size, 0.1, 3.0))
    orig = kp.penumbra_scalar
    kp.penumbra_scalar = capture
    try:
        tb.shadow_boundary_term(params, static, Vec3(w, w, w), size, size,
                                n_curve_samples=K)
    finally:
        kp.penumbra_scalar = orig
    c = captured
    assert [rc.tag for rc in c["receivers"]] == ["primary", "mirror"]
    ids, inputs = kp.pack_inputs(c["pk_d"], static, c["dL"],
                                 *kp.receiver_planes(c["receivers"]),
                                 c["pairs"], K)
    p = params.clone().requires_grad_()
    pk = unflatten(p, static)
    xs = torch.stack([c["x"][rc.tag].stack(0).detach()
                      for rc in c["receivers"]]).requires_grad_()
    x_live = {rc.tag: Vec3(*xs[r]) for r, rc in enumerate(c["receivers"])}
    spheres = torch.stack([torch.stack((*pk.objects[i].center,
                                        pk.objects[i].radius)) for i in ids])
    value = kp.penumbra_scalar_plain(pk, c["pk_d"], static, c["dL"],
                                     c["receivers"], x_live, c["pairs"], K)
    g_p, g_x = torch.autograd.grad(value, (p, xs))
    keys = leaf_paths(static)
    g_s = g_p[[keys.index(f".objects[{i}].{leaf}") for i in ids
               for leaf in ("center.x", "center.y", "center.z", "radius")]
              ].view(len(ids), 4)
    v, h_s, h_x = host_partials(host)(spheres.detach().contiguous(),
                                      xs.detach().contiguous(), inputs)
    assert float(g_s.abs().max()) > 0 and float(g_x.abs().max()) > 0
    torch.testing.assert_close(v, value.detach(), rtol=1e-4, atol=0)
    for got, want in ((h_s, g_s), (h_x, g_x)):
        assert float((got - want).abs().max()) <= \
            LEAF_TOL * float(want.abs().max())


def test_penumbra_wrapper_takes_plain_version_on_cpu(monkeypatch):
    params, static = scenes.cornell_mirror().pack()
    w = torch.from_numpy(ramp_adjoint(8, 8))
    dl = Vec3(w, w, w)
    calls = []
    plain = kp.penumbra_scalar_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(kp, "penumbra_scalar_plain", counted)
    before = kp.penumbra_partials.launches
    g = tb.shadow_boundary_term(params, static, dl, 8, 8, n_curve_samples=4)
    assert calls == [1] and kp.penumbra_partials.launches == before
    assert bool(torch.isfinite(g).all())
    with pytest.raises(TypeError):
        kp.penumbra_partials(torch.zeros((1, 4)), torch.zeros((1, 3, 2, 2)),
                             None)
