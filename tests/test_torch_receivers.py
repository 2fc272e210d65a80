"""KH, the penumbra term's primary and mirror receivers as one kernel with
its adjoint (`csrc/receivers.cu`, `ops/cuda/receivers.py`), on the CPU.

`sail_tpu_torch/csrc/host/edge_host.cpp` compiles KH's device code
(`csrc/receivers.cuh`) with g++ -ffp-contract=off, as KH builds -fmad=false
(`utils/build.load_host`, into the gitignored build/native/).  Held here,
on the receivers of the plain `shadow_boundary_term` (its CPU path,
`diff/boundary._shadow_term_plain`, whose receivers and live points are
captured where it hands them to `penumbra.penumbra_scalar`):

- the forward's planes and points within 1e-5 of the plain receivers' and
  its ints equal, on config 5's scene at 32², on a scene with a textured
  planar Mirror, a textured matte floor and pixels that miss (in both
  bounces), and on every quadric with a Mirror cylinder;
- the adjoint's 14 camera partials within 2.7e-5 of the largest (the bound
  the boundary tests hold per leaf) of autograd's through the plain live
  points (`_live_points`) at a random cotangent on the receivers' pixels;
- `_shadow_term_kernel` through the host builds of KH and KP per leaf
  within 1e-4 of the largest leaf of the plain term (KP's bound), with and
  without the diffuse-bounce receivers;
- the kernel path's op count: with KH and KP stood in, at 64², it issues at
  most 150 ops, at most 3 of them over an (H, W) plane, and nothing a CUDA
  graph capture refuses (the plain receivers issued 5,677 at config 5's
  1024² for the same work);
- `shadow_boundary_term` takes the plain path for CPU tensors and counts no
  KH launch; KH's launchers refuse a CPU tensor.
"""
import ctypes
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import sail_tpu_torch as tsail
from sail_tpu_torch import scenes
from sail_tpu_torch.core.camera import CameraParams
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.ops.cuda import penumbra as kp
from sail_tpu_torch.ops.cuda import receivers as kh
from sail_tpu_torch.scene.scene import param_offsets, unflatten
from sail_tpu_torch.utils import build

from test_torch_edge_graph import FORBIDDEN, _unrecorded
from test_torch_edge_kernels import LEAF_TOL, KP_HOST_ARGTYPES, host_partials

torch.set_num_threads(1)

HOST_DIR = os.path.join(build.CSRC_DIR, "host")
HOST_SOURCE = os.path.join(HOST_DIR, "edge_host.cpp")
HOST_EXTRA = ("-std=c++17", "-ffp-contract=off", "-I", HOST_DIR)
# the forward against the plain receivers (as KR's host build is held)
PLANE_TOL = 1e-5
# the adjoint against autograd: |diff| <= CAMERA_TOL · max|autograd|
CAMERA_TOL = 2.7e-5
_P, _I = ctypes.c_void_p, ctypes.c_int
KH_HOST_ARGTYPES = [_P] * 2 + [_I] * 8 + [_P] * 3 + [_I] * 2
KH_GRAD_HOST_ARGTYPES = [_P] * 2 + [_I] * 8 + [_P] * 2 + [_I] * 2


@pytest.fixture(scope="module")
def host():
    """The host build of edge_host.cpp; skips where there is no g++."""
    try:
        lib = build.load_host(HOST_SOURCE, HOST_EXTRA)
    except RuntimeError as e:
        if "g++ not found" in str(e):
            pytest.skip("no g++ on this machine: the host build of KH needs "
                        "a C++17 compiler")
        raise
    for name, types in (("sail_host_receivers", KH_HOST_ARGTYPES),
                        ("sail_host_receivers_grad", KH_GRAD_HOST_ARGTYPES),
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


def host_kernels(lib):
    """KH's forward and adjoint (`live_receivers`' `kernels`) on the host
    build, the adjoint's per-pixel rows summed in float64."""
    def trace(params, static, height, width, R):
        keep, scene = _scene_args(params, static)
        xs = np.zeros((R, 3, height, width), np.float32)
        planes = np.zeros((R, kh.PLANES, height, width), np.float32)
        ints = np.zeros((R, 2, height, width), np.int32)
        assert lib.sail_host_receivers(*scene, R, planes.ctypes.data,
                                       ints.ctypes.data, xs.ctypes.data,
                                       height, width) == 0
        return (torch.from_numpy(xs), torch.from_numpy(planes),
                torch.from_numpy(ints))

    def adjoint(params, static, g_xs):
        R, _, H, W = g_xs.shape
        keep, scene = _scene_args(params, static)
        g = _np(g_xs)
        acc = np.zeros((H * W, kh.CAMERA), np.float32)
        assert lib.sail_host_receivers_grad(*scene, R, g.ctypes.data,
                                            acc.ctypes.data, H, W) == 0
        return torch.from_numpy(acc.astype(np.float64).sum(0)).float()
    return trace, adjoint


def planar_mirror_textured():
    """A textured planar Mirror and a checkered matte floor under a
    rectangle light, a sphere over the floor, no box: the rays off the
    floor's edges and some mirror bounces miss."""
    s = tsail.Scene()
    s.add(tsail.Camera([0.3, 0.4, 2.5], [0.0, -0.2, 0.0]))
    s.add(tsail.Rectangle([-0.9, -1.0, -0.99], [0.6, 0.9, -0.99],
                          tsail.Mirror(kr=0.9),
                          tsail.Bilerp([1, 1, 1], [0.6, 0.9, 0.7],
                                       [0.8, 0.5, 1.0], [2.0, 1.5, 1.2])))
    s.add(tsail.Rectangle([-1.1, -0.95, -0.95], [1.1, -0.95, 1.4],
                          tsail.Matte(kd=0.95),
                          tsail.Checkerboard2([0.9, 0.8, 0.7],
                                              [0.3, 0.4, 0.5], 0.25)))
    s.add(tsail.Sphere([0.1, -0.4, 0.3], 0.35, tsail.Matte(kd=0.3)))
    s.add(tsail.AreaLight(tsail.Rectangle([-0.3, 1.4, 0.1], [0.5, 1.4, 0.6],
                                          tsail.Matte()), [12.0, 12.0, 12.0]))
    return s


def quadrics_shadowed():
    """Every quadric (a Mirror cylinder among them) in a Cornell box under
    a rectangle light, with a sphere to cast the penumbras."""
    s = scenes.quadrics()
    s.add(tsail.Sphere([0.3, 0.6, -0.2], 0.25, tsail.Matte(kd=0.8)))
    return s


# scene, image size
CASES = {
    "config5": (scenes.cornell_mirror, 32),
    "planar_mirror": (planar_mirror_textured, 24),
    "quadrics": (quadrics_shadowed, 24),
}
KW = dict(n_curve_samples=8, seed=5)


def _adjoint(size, seed=0):
    w = torch.rand((3, size, size), generator=torch.Generator()
                   .manual_seed(seed))
    return Vec3(*w)


def _plain_receivers(name, monkeypatch):
    """(params, static, size, planes, ints, points) of the plain term's
    primary and mirror receivers on the case's scene."""
    scene_fn, size = CASES[name]
    params, static = scene_fn().pack()
    got = {}

    def capture(pk, pk_d, st, dL, recv, x_live, pairs, K):
        got.update(recv=recv, x_live=x_live)
        return kp.penumbra_scalar_plain(pk, pk_d, st, dL, recv, x_live,
                                        pairs, K)

    monkeypatch.setattr(kp, "penumbra_scalar", capture)
    tb.shadow_boundary_term(params, static, _adjoint(size), size, size, **KW)
    recv = got["recv"]
    planes, ints = kp.receiver_planes(recv)
    xs = torch.stack([got["x_live"][rc.tag].stack(0).detach()
                      for rc in recv])
    return params, static, size, planes.detach(), ints, xs


@pytest.mark.parametrize("name", list(CASES))
def test_kh_forward_matches_the_plain_receivers(host, name, monkeypatch):
    params, static, size, planes, ints, xs = _plain_receivers(
        name, monkeypatch)
    R = xs.shape[0]
    assert R == 2, "each case has a Mirror: primary and mirror receivers"
    trace, _ = host_kernels(host)
    got_xs, got_planes, got_ints = trace(params, static, size, size, R)
    assert torch.equal(got_ints, ints)
    for what, got, want in (("planes", got_planes, planes),
                            ("points", got_xs, xs)):
        d = (got - want).abs()
        k = np.unravel_index(int(d.argmax()), d.shape)
        assert float(d.max()) <= PLANE_TOL, \
            f"{name}: {what} {tuple(k)} KH {float(got[k]):.8g} plain " \
            f"{float(want[k]):.8g}"
    # what the case reaches: receivers in both bounces, and misses
    seen = (ints[:, 0] >= 0).flatten(1).sum(1)
    assert bool((seen > 0).all()), f"{name}: receivers per bounce {seen}"
    if name == "planar_mirror":
        assert bool((ints[0, 1] < 0).any()) and bool((ints[1, 1] < 0).any())


def _live_camera_grad(params, static, size, R, g):
    """Autograd's d(Σ g · points)/d(camera) through the plain live points."""
    off = param_offsets(static)
    c = params[off.camera:off.size].clone().requires_grad_()
    cam = CameraParams(Vec3(*c[0:3]), Vec3(*c[3:6]), Vec3(*c[6:9]),
                       Vec3(*c[9:12]), c[12], c[13])
    x = tb._live_points(cam, unflatten(params, static), static, size, size,
                        params, R > 1)
    xs = torch.stack([x[tag].stack(0) for tag in ("primary", "mirror")[:R]])
    (grad,) = torch.autograd.grad((xs * g).sum(), c)
    return grad


@pytest.mark.parametrize("name", list(CASES))
def test_kh_adjoint_matches_autograd(host, name, monkeypatch):
    params, static, size, _, ints, xs = _plain_receivers(name, monkeypatch)
    R = xs.shape[0]
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3))
    g = g * (ints[:, :1] >= 0)        # KP's cotangent: receivers only
    want = _live_camera_grad(params, static, size, R, g)
    _, adjoint = host_kernels(host)
    got = adjoint(params, static, g)
    top = float(want.abs().max())
    assert top > 0 and bool(torch.isfinite(got).all())
    d = (got - want).abs()
    assert float(d.max()) <= CAMERA_TOL * top, \
        f"{name}: camera partial {int(d.argmax())} KH " \
        f"{float(got[int(d.argmax())]):.8g} autograd " \
        f"{float(want[int(d.argmax())]):.8g} (max {top:.4g})"


def _stand_ins(monkeypatch, kernels, partials):
    """`_shadow_term_kernel` with KH's launches `kernels` and KP's
    `partials`, and taken by `shadow_boundary_term` for CPU tensors."""
    live, packed = kh.live_receivers, kp.penumbra_scalar_packed
    monkeypatch.setattr(kh, "live_receivers",
                        lambda *a: live(*a, kernels=kernels))
    monkeypatch.setattr(kp, "penumbra_scalar_packed",
                        lambda *a: packed(*a, partials=partials))
    monkeypatch.setattr(tb, "_shadow_term_plain", tb._shadow_term_kernel)


@pytest.mark.parametrize("name, kw", [
    ("config5", {}), ("config5", dict(n_indirect_dirs=2)),
    ("planar_mirror", {})])
def test_kernel_path_matches_the_plain_term(host, name, kw, monkeypatch):
    scene_fn, _ = CASES[name]
    size = 16
    params, static = scene_fn().pack()
    dl = _adjoint(size, 1)
    plain = tb.shadow_boundary_term(params, static, dl, size, size, **KW,
                                    **kw)
    _stand_ins(monkeypatch, host_kernels(host), host_partials(host))
    got = tb.shadow_boundary_term(params, static, dl, size, size, **KW, **kw)
    top = float(plain.abs().max())
    d = (got - plain).abs()
    assert top > 0 and bool(torch.isfinite(got).all())
    assert float(d.max()) <= LEAF_TOL * top, \
        f"{name} {kw}: leaf {int(d.argmax())} kernel path " \
        f"{float(got[int(d.argmax())]):.8g} plain " \
        f"{float(plain[int(d.argmax())]):.8g} (max {top:.4g})"
    off = param_offsets(static)
    assert float(plain[off.camera:].abs().max()) > 0, "the camera moves"


def _zero_kernels():
    """KH's and KP's contracts, zeros: the ops around them are what is
    counted, not their values."""
    def trace(params, static, height, width, R):
        return (torch.zeros((R, 3, height, width)),
                torch.zeros((R, kh.PLANES, height, width)),
                torch.zeros((R, 2, height, width), dtype=torch.int32))

    def adjoint(params, static, g_xs):
        return torch.zeros(kh.CAMERA)

    def partials(spheres, xs, inputs):
        return (xs.new_zeros(()), torch.zeros_like(spheres),
                torch.zeros_like(xs))
    return ((_unrecorded(trace), _unrecorded(adjoint)),
            _unrecorded(partials))


class _Ops(TorchDispatchMode):
    """Every op dispatched under it: its name, and for an op that may
    launch a kernel (not a view, not an allocation) the most elements of
    a tensor it returns."""
    FREE = ("aten.empty.", "aten.empty_strided.", "aten.empty_like.")

    def __init__(self):
        super().__init__()
        self.names, self.counted = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        self.names.append(name)
        if not (func.is_view or name.startswith(self.FREE)):
            self.counted.append((name, max(
                (t.numel() for t in tree_leaves(out)
                 if isinstance(t, torch.Tensor)), default=0)))
        return out


# the kernel path's ops at config 5's step (the plain receivers' 5,677 at
# 1024² made this bound worth holding): all of them, and those over a
# whole (H, W) plane or more
MAX_OPS = 150
MAX_PLANE_OPS = 3


def test_kernel_path_op_count(monkeypatch):
    """The ops `shadow_boundary_term` issues on its kernel path on config
    5 at 64² with KH and KP stood in (their own ops not recorded): views
    and allocations aside, at most MAX_OPS, at most MAX_PLANE_OPS of them
    over an (H, W) plane (KP's backward product and the loss adjoint's
    stack for KP), and none that a CUDA graph capture refuses.  The plain
    receivers it replaces issued 5,677 ops at config 5's 1024², 4,850 of
    them over a plane (70 here, 2 over a plane)."""
    size = 64
    params, static = scenes.cornell_mirror().pack()
    _stand_ins(monkeypatch, *_zero_kernels())
    dl = _adjoint(size)
    kw = dict(n_curve_samples=32, seed=5)
    tb.shadow_boundary_term(params, static, dl, size, size, **kw)  # tables
    with torch.device("meta"), _Ops() as ops:
        tb.shadow_boundary_term(params, static, dl, size, size, **kw)
    refused = sorted({n for n in ops.names if n.startswith(FORBIDDEN)})
    assert not refused, refused
    plane = [n for n, big in ops.counted if big >= size * size]
    assert len(ops.counted) <= MAX_OPS, \
        f"{len(ops.counted)} ops: {[n for n, _ in ops.counted]}"
    assert len(plane) <= MAX_PLANE_OPS, f"over an (H, W) plane: {plane}"


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    params, static = scenes.cornell_mirror().pack()
    size = 8
    dl = _adjoint(size)
    counts = (kh.trace_receivers.launches, kh.receivers_adjoint.launches)
    got = tb.shadow_boundary_term(params, static, dl, size, size, **KW)
    plain = []
    orig = tb._shadow_term_plain
    monkeypatch.setattr(tb, "_shadow_term_plain",
                        lambda *a: plain.append(1) or orig(*a))
    again = tb.shadow_boundary_term(params, static, dl, size, size, **KW)
    assert plain == [1] and torch.equal(got, again)
    assert (kh.trace_receivers.launches,
            kh.receivers_adjoint.launches) == counts
    with pytest.raises(TypeError):
        kh.trace_receivers(params, static, size, size, 2)
    with pytest.raises(TypeError):
        kh.receivers_adjoint(params, static, torch.zeros((2, 3, size, size)))
