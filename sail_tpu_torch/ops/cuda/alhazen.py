"""KA: the detached Alhazen solve of the sphere-mirror silhouette term
(`diff/boundary._mirror_sphere_silhouette_fn`) as one CUDA kernel.

A sphere seen in a sphere mirror has a silhouette with no closed form.  For
each (mirror sphere, sphere) pair the term finds, from the pair's `frame`,
the mirror point whose reflected eye ray aims at the sphere's centre (the
Alhazen centre, ψ0 with the slope h'(ψ0)), and then per azimuth the view
angle of the silhouette (β0 with the slope g'(β0), and a mask): scans and
halvings of `alignment` and `radial_residual`.  That solve is detached: the
gradient comes from one live Newton step from its roots (`center_frame`,
and `radial_residual` at β0), which stays eager torch in boundary.py.

`solve` gives (ψ0, h'(ψ0), β0, g'(β0), mask): on a CPU tensor by the plain
version (`solve_plain`, eager torch: ~6,400 ops a pair at 193 azimuths); on
a CUDA tensor through `solve_kernel`, which packs the frame and launches KA
(`csrc/alhazen.cu`, `alhazen_roots`), one launch a pair, capturable inside
the edge terms' CUDA graph.  No fallback from one to the other.

KA replaces no TPU kernel: the JAX package's solve is XLA's inside the
jitted train step (`sail_tpu/parallel/render_sharded.py:257`).
`alhazen_roots.launches` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...core import vecmath as vm
from ...core.vecmath import Vec3
from ...utils import build
from ...utils.metrics import spanned
from . import megakernel as mk

_SOURCE = "alhazen"
# the centre scan's and the radial scan's samples, and the finite
# differences' step (csrc/alhazen.cuh: KA_NS, KA_NB, KA_FD_EPS)
NS = 64
NB = 48
FD_EPS = 1e-4
# the frame's floats as KA reads them
FRAME_FLOATS = 21


class Frame(NamedTuple):
    """A (mirror sphere, sphere) pair as the solve reads it: the eye e,
    the mirror's centre m and radius R, the sphere's centre c and radius r,
    d_em = |e − m|, u1 = (e − m) / d_em, u2 ⊥ u1 in the plane of e, m and c
    (turned toward c), and that plane's normal pn (any plane through the
    axis where the three are in line)."""
    e: Vec3
    m: Vec3
    R: torch.Tensor
    c: Vec3
    r: torch.Tensor
    d_em: torch.Tensor
    u1: Vec3
    u2: Vec3
    pn: Vec3


def frame(pk, m_idx: int, s_idx: int) -> Frame:
    """The Frame of sphere `s_idx` seen in the sphere mirror `m_idx`, live
    in `pk`'s parameters."""
    mp, sp = pk.objects[m_idx], pk.objects[s_idx]
    e, m, R = pk.camera.eye, mp.center, mp.radius
    c, r = sp.center, sp.radius
    em = e - m
    d_em = em.length()
    u1 = em * (1.0 / vm.clip(d_em, 1e-9))
    cm = c - m
    pn_raw = u1.cross(cm)
    pn_len = pn_raw.length()
    pn = vm.where(pn_len > 1e-7,
                  pn_raw * (1.0 / vm.clip(pn_len, 1e-12)),
                  vm.ortho(u1).normalize())
    u2 = pn.cross(u1)
    u2 = u2 * torch.where(u2.dot(cm) < 0.0, -1.0, 1.0)
    return Frame(e, m, R, c, r, d_em, u1, u2, pn)


def alignment(f: Frame, pn: Vec3, psi):
    """h(ψ): how far the eye ray reflected at the mirror point q(ψ) = m +
    (u1 cos ψ + u2 sin ψ) R turns from the sphere's centre, about `pn`;
    zero at the Alhazen centre."""
    q = f.m + (f.u1 * torch.cos(psi) + f.u2 * torch.sin(psi)) * f.R
    d_in = (q - f.e).normalize()
    n_q = (q - f.m) * (1.0 / vm.clip(f.R, 1e-9))
    d_r = d_in - n_q * (2.0 * d_in.dot(n_q))
    cq = (f.c - q).normalize()
    return d_r.cross(cq).dot(pn)


def center_frame(f: Frame, pn: Vec3, psi0, dh):
    """The image centre's ray a and its frame (e1, e2), one Newton step
    ψ0 − h(ψ0) / h'(ψ0) from the detached root: live in `f`'s parameters,
    with the implicit-function derivative at the root."""
    psi_live = psi0 - alignment(f, pn, psi0) / dh.detach()
    q_c = f.m + (f.u1 * torch.cos(psi_live)
                 + f.u2 * torch.sin(psi_live)) * f.R
    a = (q_c - f.e).normalize()
    e1 = vm.ortho(a).normalize()
    return a, e1, a.cross(e1)


def radial_residual(f: Frame, a: Vec3, e1: Vec3, e2: Vec3, cphi, sphi,
                    beta):
    """(g(β), ok) for the view ray v = a cos β + (e1 cos φ + e2 sin φ)
    sin β: the distance of its reflection in the mirror from the sphere's
    centre less r where it hits the mirror and reflects toward the sphere
    (`ok`), else 1e3."""
    v = (a * torch.cos(beta) + (e1 * cphi + e2 * sphi) * torch.sin(beta))
    oc = f.e - f.m
    B = oc.dot(v)
    disc = B * B - (oc.length_sq() - f.R * f.R)
    t_hit = -B - torch.sqrt(vm.clip(disc, 0.0))
    hitm = (disc > 0.0) & (t_hit > 1e-6)
    q = f.e + v * t_hit
    n_q = (q - f.m) * (1.0 / vm.clip(f.R, 1e-9))
    d_r = v - n_q * (2.0 * v.dot(n_q))
    w = f.c - q
    toward = w.dot(d_r) > 0.0
    dist = w.cross(d_r).length()
    ok = hitm & toward
    return torch.where(ok, dist - f.r, 1e3), ok


def first_true(mask: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Index of the first True along `dim`, 0 where there is none
    (`jnp.argmax` of a bool array)."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


@spanned("sail.bisect")
def bisect(f, lo, hi, steps: int = 30):
    """`steps` halvings of [lo, hi] keeping the sign change of f; f(lo) is
    carried from the step that moved lo (the same value f would give it
    again), so each step evaluates f once."""
    f_lo = f(lo)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        f_mid = f(mid)
        same = f_mid * f_lo > 0.0
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
        f_lo = torch.where(same, f_mid, f_lo)
    return lo, hi


def scan_fractions(like: torch.Tensor):
    """The centre scan's NS fractions linspace(1e-3, 1, NS) and the radial
    scan's NB fractions (k + 1) / NB of β_max, in `like`'s dtype and
    device."""
    lin = torch.linspace(1e-3, 1.0, NS, dtype=like.dtype, device=like.device)
    frac = ((torch.arange(NB, dtype=like.dtype, device=like.device) + 1.0)
            / NB)
    return lin, frac


def solve_plain(f: Frame, cphi, sphi, tally: dict = None):
    """The plain version: (ψ0, h'(ψ0), β0, g'(β0), mask) of the detached
    frame `f` at the azimuths whose cos and sin are `cphi`, `sphi`.

      1. The centre: the first sign change of h over NS samples of
         [1e-3, ψ_hi − 1e-3], 30 halvings, ψ0 their midpoint and h'(ψ0) a
         central difference (moved to ±1e-9 where smaller).
      2. Per azimuth, from the centre's ray and frame: the first positive
         g of NB samples of (0, β_max], 30 halvings from the sample before
         it, β0 and g'(β0) (±1e-6).  Masked: no centre, the eye inside the
         mirror, no positive sample, the first one off the mirror or not
         reflecting toward the sphere (the bracket crossed the mirror's
         rim), or the first sample already positive.

    `tally` (a dict) counts the work KA does for these inputs
    (`utils/opcount.alhazen_ops`): the azimuths, and the radial scan's
    samples up to each azimuth's first positive one; it changes no
    value."""
    R, d_em = f.R, f.d_em
    h = functools.partial(alignment, f, f.pn)
    lin, frac = scan_fractions(R)

    # -- the Alhazen centre (a scalar solve) -----------------------------
    psi_hi = torch.acos(vm.clip(R / torch.maximum(d_em, R + 1e-6),
                                0.0, 1.0 - 1e-7))
    psis = lin * (psi_hi - 2e-3) + 1e-3
    hs = h(psis)
    change = hs[:-1] * hs[1:] <= 0.0
    found_c = change.any()
    idx = first_true(change)
    # gathered on the device: a tensor index would read idx on the host
    bracket = psis.index_select(0, torch.stack((idx, idx + 1)))
    lo0, hi0 = bisect(h, bracket[0], bracket[1])
    psi0 = 0.5 * (lo0 + hi0)
    dh = (h(psi0 + FD_EPS) - h(psi0 - FD_EPS)) / (2.0 * FD_EPS)
    dh = torch.where(torch.abs(dh) < 1e-9,
                     torch.where(dh < 0.0, -1e-9, 1e-9), dh)

    # -- the radial solve per azimuth ------------------------------------
    a, e1, e2 = center_frame(f, f.pn, psi0, dh)

    def g(beta):
        return radial_residual(f, a, e1, e2, cphi, sphi, beta)

    beta_max = 2.2 * torch.asin(vm.clip(R / torch.maximum(d_em, R + 1e-6),
                                        0.0, 1.0))
    bs = (frac[:, None] * beta_max).expand(NB, cphi.shape[0])
    gs, oks = g(bs)
    pos = gs > 0.0
    found_b = pos.any(0)
    bidx = first_true(pos)                          # first positive
    # the first positive sample must still hit the mirror and reflect
    # forward, else the bracket crossed the mirror's rim (masked)
    ok_hi = torch.gather(oks, 0, bidx[None, :])[0]
    lo = torch.where(bidx > 0, torch.gather(
        bs, 0, torch.clamp(bidx - 1, min=0)[None, :])[0],
        torch.zeros_like(cphi))
    hi = torch.gather(bs, 0, bidx[None, :])[0]
    lo, hi = bisect(lambda b: g(b)[0], lo, hi)
    beta0 = 0.5 * (lo + hi)
    gp = (g(beta0 + FD_EPS)[0] - g(beta0 - FD_EPS)[0]) / (2.0 * FD_EPS)
    gp = torch.where(torch.abs(gp) < 1e-6,
                     torch.where(gp < 0.0, -1e-6, 1e-6), gp)
    mask = (found_c & (d_em > R * (1.0 + 1e-4)) & found_b & ok_hi
            & (bidx > 0))
    if tally is not None:
        tally["azimuths"] = cphi.shape[0]
        tally["radial_scan"] = int(torch.where(found_b, bidx + 1, NB).sum())
    return psi0, dh, beta0, gp, mask


def pack_frame(f: Frame) -> torch.Tensor:
    """The frame's FRAME_FLOATS values in KA's order, one tensor."""
    return torch.stack((*f.e, *f.m, f.R, *f.c, f.r, f.d_em, *f.u1, *f.u2,
                        *f.pn))


@functools.lru_cache(maxsize=16)
def scan_table(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`scan_fractions` as one tensor on `device`, made once: a capture of
    the edge terms finds it made by the key's eager call."""
    return torch.cat(scan_fractions(torch.empty(0, dtype=dtype,
                                                device=device)))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.load(_SOURCE)
    limits = (ctypes.c_int * 4)()
    lib.sail_alhazen_limits(limits)
    if tuple(limits[:3]) != (FRAME_FLOATS, NS, NB):
        raise RuntimeError(f"KA was built for (frame floats, NS, NB) "
                           f"{tuple(limits[:3])}, the wrapper expects "
                           f"{(FRAME_FLOATS, NS, NB)}")
    fn = lib.sail_alhazen
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def alhazen_roots(frame_t: torch.Tensor, table: torch.Tensor,
                  cphi: torch.Tensor, sphi: torch.Tensor):
    """KA on the card: (out, mask) with out = (ψ0, h'(ψ0), β0 (n), g'(β0)
    (n)) and mask (n) bool, for the packed frame, `scan_table` and the n
    azimuths' cos and sin.  Raises for a tensor not on a card."""
    if not cphi.is_cuda:
        raise TypeError("alhazen_roots runs KA on the card: the inputs must "
                        "be CUDA tensors")
    n = cphi.shape[0] if cphi.dim() == 1 else -1
    dev = cphi.device
    for name, t, numel in (("frame", frame_t, FRAME_FLOATS),
                           ("table", table, NS + NB), ("cphi", cphi, n),
                           ("sphi", sphi, n)):
        if not (t.dim() == 1 and t.numel() == numel and t.numel() > 0
                and t.dtype == torch.float32 and t.is_contiguous()
                and t.device == dev):
            raise TypeError(f"KA's {name} must be a contiguous 1-D float32 "
                            f"tensor of {numel} values on {dev}; got "
                            f"{tuple(t.shape)} {t.dtype} on {t.device}")
    out = torch.empty(2 + 2 * n, dtype=torch.float32, device=dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(frame_t.data_ptr(), table.data_ptr(), cphi.data_ptr(),
                       sphi.data_ptr(), n, out.data_ptr(), mask.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"KA launch failed: cudaError_t {err}")
    mk.count_launch(alhazen_roots)
    return out, mask


alhazen_roots.launches = 0


def solve_kernel(f: Frame, cphi, sphi, roots=alhazen_roots):
    """`solve_plain`'s results through KA (`roots`: the kernel, or a
    function of the same contract)."""
    n = cphi.shape[0]
    out, mask = roots(pack_frame(f), scan_table(cphi.device, cphi.dtype),
                      cphi.contiguous(), sphi.contiguous())
    return out[0], out[1], out[2:2 + n], out[2 + n:], mask


def solve(f: Frame, cphi, sphi):
    """(ψ0, h'(ψ0), β0, g'(β0), mask) of the detached frame `f` at the
    azimuths (cos, sin): the plain version for CPU tensors, KA for CUDA
    ones."""
    if cphi.device.type == "cpu":
        return solve_plain(f, cphi, sphi)
    if not cphi.is_cuda:
        raise ValueError(f"no KA for device {cphi.device}")
    return solve_kernel(f, cphi, sphi)
