"""`boundary_term`'s straddle rays traced in one batch against the same
sites traced one by one (`batched=False`: `_edge_radiance_delta`, the
primitive, called for each site's points alone), on the CPU.

Each straddle ray draws its random numbers from its own edge pixel, and
the batch only concatenates the sites' points (one offset per point) and
splits the radiance back, so the two paths give the same Δf and, with the
sites' scalars added in the same order, the same gradient: held bit for
bit (NaN where both are NaN: the quadrics scene's paraboloid is cut at
z0 = 0, whose rim radius has an infinite derivative in both packages,
ROADMAP queue 3).  Scenes: config 2 (boxes, spheres, the Alhazen solve in
the mirror sphere), the quadrics (every revolution curve), and
`test_torch_boundary.py`'s planar and sphere mirrors and revolution
scene, at 16² with 32 edge samples.  That file's per-leaf checks against
the JAX package run the batched path."""
import numpy as np
import pytest
import torch

import sail_tpu_torch as tsail
from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.scene.scene import unflatten

from test_torch_boundary import (curved_mirror, planar_mirror, ramp_adjoint,
                                 revolution)

torch.set_num_threads(1)

SIZE = 16
KW = dict(n_edge_samples=32, n_noise=2, seed=7717, max_bounces=3)
SCENES = {
    "cornell_mirror": scenes.cornell_mirror,
    "quadrics": scenes.quadrics,
    "planar_mirror": lambda: planar_mirror(tsail),
    "curved_mirror": lambda: curved_mirror(tsail),
    "revolution": lambda: revolution(tsail),
}


def _adjoint():
    w = torch.from_numpy(ramp_adjoint(SIZE, SIZE))
    return Vec3(w, w, w)


def _bits(t):
    """The float32 bit patterns (NaN compares equal to a NaN of its own
    pattern)."""
    return t.detach().contiguous().view(torch.int32)


def _count_traces(monkeypatch):
    calls = []
    trace = tb.trace_rays

    def counted(*args, **kw):
        calls.append(args[2].x.shape)
        return trace(*args, **kw)

    monkeypatch.setattr(tb, "trace_rays", counted)
    return calls


@pytest.mark.parametrize("extrapolate", [True, False])
@pytest.mark.parametrize("name", list(SCENES))
def test_batched_boundary_term_equals_per_site(name, extrapolate,
                                               monkeypatch):
    params, static = SCENES[name]().pack()
    dl = _adjoint()
    calls = _count_traces(monkeypatch)
    site = tb.boundary_term(params, static, dl, SIZE, SIZE, batched=False,
                            extrapolate=extrapolate, **KW)
    n_sites = len(calls)
    batch = tb.boundary_term(params, static, dl, SIZE, SIZE,
                             extrapolate=extrapolate, **KW)
    assert len(calls) == n_sites + 1, "the batch is one trace_rays call"
    # every site's points (and their δ/4 twins) in that one call
    assert calls[-1][-1] == sum(shape[-1] for shape in calls[:n_sites])
    assert calls[-1][0] == KW["n_noise"], "noise passes on a leading axis"
    finite = torch.isfinite(site)
    assert bool(finite.any()) and bool(site[finite].abs().max() > 0)
    assert torch.equal(_bits(site), _bits(batch)), (
        f"{name}: max |diff| "
        f"{float((site - batch)[finite].abs().max()):.3g}")


def test_straddles_split_back_each_sites_delta():
    """`_Straddles` over requests of different sizes and offsets gives each
    request the primitive's Δf on its own points, bit for bit."""
    params, static = scenes.cornell_mirror().pack()
    pk = unflatten(params, static)
    rs = np.random.RandomState(0)
    kw = dict(height=SIZE, width=SIZE, seed=7717, n_noise=2, max_bounces=3)
    requests = []
    for m, delta in ((12, 0.35), (7, 0.0875), (30, 0.35), (1, 0.5)):
        pts = torch.from_numpy(rs.rand(4, m).astype(np.float32))
        cols, rows = pts[0] * (SIZE + 2) - 1, pts[1] * (SIZE + 2) - 1
        ang = pts[2] * 6.2831855
        requests.append((cols, rows, (torch.cos(ang), torch.sin(ang)),
                         delta))
    batch = tb._Straddles(pk, static, batched=True, **kw)
    handles = [batch.add(*r) for r in requests]
    batch.trace()
    for h, (cols, rows, normals, delta) in zip(handles, requests):
        want = tb._edge_radiance_delta(pk, static, cols, rows, normals,
                                       delta_px=delta, **kw)
        for got_c, want_c in zip(batch[h], want):
            assert torch.equal(got_c, want_c)


def _plain_bisect(f, lo, hi, steps=30):
    """The bisection as the JAX package writes it: f(lo) evaluated again
    at every step."""
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        same = f(mid) * f(lo) > 0.0
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    return lo, hi


def test_bisect_carrying_f_lo_equals_evaluating_it_again():
    rs = np.random.RandomState(1)
    lo = torch.from_numpy(rs.rand(257).astype(np.float32) * 0.5)
    hi = lo + torch.from_numpy(rs.rand(257).astype(np.float32) * 2.0)

    def f(x):
        return torch.cos(3.0 * x) - 0.2 * x * x + 0.1

    for got, want in zip(tb._bisect(f, lo, hi), _plain_bisect(f, lo, hi)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["cornell_mirror", "curved_mirror"])
def test_alhazen_pair_equals_two_solves(name):
    """The sphere mirror's silhouette points of both sets (live at the
    midpoints, detached at the interval bounds) from one center solve and
    one radial bisection, against a solve for each set: points, masks and
    the points' gradient bit for bit."""
    params, static = SCENES[name]().pack()
    mirror = next(i for i in tb._categories(static, (tb.C.SPHERE,))
                  if tb._material_of(static, i) == tb.C.MIRROR)
    other = next(i for i in tb._categories(static, (tb.C.SPHERE,))
                 if i != mirror)
    pts_fn = tb._mirror_sphere_silhouette_fn(mirror, other)
    n = 24
    tm = tb._arange(n, params, 0.5)
    tbounds = tb._arange(n + 1, params, div=n)
    grads = []
    outs = []
    for joint in (True, False):
        p = params.detach().clone().requires_grad_()
        pk, pkd = unflatten(p, static), unflatten(params.detach(), static)
        if joint:
            (mid, mm), (bnd, bm) = pts_fn.pair(pk, tm, pkd, tbounds)
        else:
            (mid, mm), (bnd, bm) = pts_fn(pk, tm), pts_fn(pkd, tbounds)
        (g,) = torch.autograd.grad((mid.x + 2.0 * mid.y - mid.z).sum(), p)
        grads.append(g)
        outs.append((mid.stack().detach(), mm, bnd.stack(), bm))
    assert bool(outs[0][1].any()), "no azimuth of the silhouette was found"
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert torch.equal(grads[0], grads[1])
