"""KA, the sphere-mirror silhouette's detached Alhazen solve as one kernel
(`csrc/alhazen.cu`), on the CPU.

`sail_tpu_torch/csrc/host/edge_host.cpp` compiles KA's device code
(`csrc/alhazen.cuh`) with g++ -ffp-contract=off, as KA builds -fmad=false
(`utils/build.load_host`, into the gitignored build/native/), and
`sail_host_alhazen` runs it with the centre's scan searched in order where
the kernel takes a ballot.  Handed to `alhazen.solve_kernel` in KA's place,
it is held against the plain `alhazen.solve_plain` on three pairs:

- config 5's mirror sphere and matte sphere at the inverse traffic's
  azimuths (192 edge samples: 96 midpoints and 97 boundaries), where a
  third of the azimuths cross the mirror's rim;
- a sphere partly behind the mirror, so that some azimuths cross the rim
  and some have their first radial sample already positive;
- the eye, the mirror's centre and the sphere's centre in line, where the
  frame's plane normal comes from `ortho` and no centre is found.

The masks must be equal and ψ0, h'(ψ0), β0 and g'(β0) within 1e-5
relative, with torch's sqrt, cos, sin, acos and asin made correctly rounded
(through float64) as the host build takes them: the slopes are central
differences of step 1e-4, so an ulp in a curve value moves them by ~1e-4
of themselves.  Measured: bit for bit on all three.  The wrapper takes the
plain version for CPU tensors and counts no launch.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import sail_tpu_torch as tsail
from sail_tpu_torch import constants as C
from sail_tpu_torch import scenes
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.ops.cuda import alhazen as ka
from sail_tpu_torch.scene.scene import unflatten
from sail_tpu_torch.utils import build

torch.set_num_threads(1)

HOST_DIR = os.path.join(build.CSRC_DIR, "host")
HOST_SOURCE = os.path.join(HOST_DIR, "edge_host.cpp")
HOST_EXTRA = ("-std=c++17", "-ffp-contract=off", "-I", HOST_DIR)
RTOL = 1e-5
# the inverse traffic's edge samples; boundary_term solves max(16, n // 2)
# midpoints and as many + 1 boundaries of each sphere-mirror curve
EDGE_SAMPLES = 192


@pytest.fixture(scope="module")
def host():
    """The host build of edge_host.cpp; skips where there is no g++."""
    try:
        lib = build.load_host(HOST_SOURCE, HOST_EXTRA)
    except RuntimeError as e:
        if "g++ not found" in str(e):
            pytest.skip("no g++ on this machine: the host build of KA needs "
                        "a C++17 compiler")
        raise
    lib.sail_host_alhazen.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 2
    lib.sail_host_alhazen.restype = ctypes.c_int
    return lib


@pytest.fixture
def transcendentals_correctly_rounded(monkeypatch):
    """torch's float32 sqrt, cos, sin, acos and asin through float64, as
    the host build takes them."""
    for name in ("sqrt", "cos", "sin", "acos", "asin"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda x, *a, fn=fn, **k: (
            fn(x.double()).float() if x.dtype == torch.float32
            else fn(x, *a, **k)))


def host_roots(lib):
    """`alhazen_roots`' contract through the host build."""
    def roots(frame_t, table, cphi, sphi):
        n = cphi.shape[0]
        keep = [np.ascontiguousarray(t.numpy(), np.float32)
                for t in (frame_t, table, cphi, sphi)]
        out = np.zeros(2 + 2 * n, np.float32)
        mask = np.zeros(n, np.uint8)
        assert lib.sail_host_alhazen(*(a.ctypes.data for a in keep), n,
                                     out.ctypes.data, mask.ctypes.data) == 0
        return torch.from_numpy(out), torch.from_numpy(mask.astype(bool))
    return roots


def _pair(sphere_center, sphere_radius):
    """A sphere mirror (the JAX package's curved-mirror test's) and an
    emissive sphere."""
    s = tsail.Scene()
    s.add(tsail.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(tsail.Sphere([0.0, 0.0, -0.3], 0.7, tsail.Mirror(kr=1.0)))
    s.add(tsail.Sphere(sphere_center, sphere_radius,
                       emission=[1.0, 1.0, 1.0]))
    return s


# scene, (mirror, sphere) object indices
CASES = {
    "config5": (scenes.cornell_mirror, (1, 2)),
    "rim": (lambda: _pair([1.0, 0.0, -1.2], 0.6), (0, 1)),
    "in_line": (lambda: _pair([0.0, 0.0, 3.6], 0.8), (0, 1)),
}


def _inputs(name):
    """The detached frame of the case's pair and the azimuths' cos and sin,
    as boundary_term hands them to the solve."""
    scene_fn, (m_idx, s_idx) = CASES[name]
    params, static = scene_fn().pack()
    cats = static.object_categories
    assert cats[m_idx] == cats[s_idx] == C.SPHERE
    assert tb._material_of(static, m_idx) == C.MIRROR
    f = tb._detach(ka.frame(unflatten(params, static), m_idx, s_idx))
    n = max(16, EDGE_SAMPLES // 2)
    ts = torch.cat((tb._arange(n, params, 0.5),
                    tb._arange(n + 1, params, div=n)))
    ang = tb.TWO_PI * ts
    return f, torch.cos(ang), torch.sin(ang)


@pytest.mark.parametrize("name", list(CASES))
def test_host_build_matches_plain_solve(name, host,
                                        transcendentals_correctly_rounded):
    f, cphi, sphi = _inputs(name)
    got = ka.solve_kernel(f, cphi, sphi, roots=host_roots(host))
    want = ka.solve_plain(f, cphi, sphi)
    mask = want[4]
    assert torch.equal(got[4], mask), \
        f"{name}: masks differ at {int((got[4] != mask).sum())} azimuths"
    for label, g, w in zip(("psi0", "dh", "beta0", "gp"), got, want):
        assert bool(torch.isfinite(g).all()), f"{name}: {label} not finite"
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=0,
                                   err_msg=f"{name}: {label}")
    # each case reaches its branch
    n_masked = int((~mask).sum())
    if name == "in_line":
        pn_raw = f.u1.cross(f.c - f.m)
        assert float(pn_raw.length()) <= 1e-7 and n_masked == mask.numel()
    else:
        assert 0 < n_masked < mask.numel(), f"{name}: {n_masked} masked"


def test_solve_takes_the_plain_version_on_cpu():
    f, cphi, sphi = _inputs("config5")
    launches = ka.alhazen_roots.launches
    got = ka.solve(f, cphi, sphi)
    want = ka.solve_plain(f, cphi, sphi)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ka.alhazen_roots.launches == launches
    with pytest.raises(TypeError, match="CUDA tensors"):
        ka.alhazen_roots(ka.pack_frame(f), ka.scan_table(cphi.device,
                                                         cphi.dtype),
                         cphi, sphi)
