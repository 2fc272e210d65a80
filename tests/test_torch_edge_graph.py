"""`full_boundary_term` holds nothing a CUDA graph capture refuses, on the
CPU.

On a card the edge terms are captured once and replayed as one CUDA graph
(`diff/boundary.full_boundary_term`, `utils/graphs.Replay`).  A capture
refuses a host sync (`.item()`, a tensor used as an index, `nonzero`, a
boolean mask) and a host-to-device copy (`torch.tensor` of host data on
every call).  So every op the term dispatches on its second call (after
the first has filled the cached tables) is recorded here with a
`TorchDispatchMode`, with "meta" the default device (so a tensor made
without `device=`, on a card a host-to-device copy, cannot meet the term's
CPU tensors), over the scenes the boundary tests build: boxes and
spheres, every revolution curve, the planar and sphere mirrors, and the
penumbra term's direct, mirror and diffuse-bounce receivers with the
secondary-vertex silhouette.  KR, KP and KA, each one launch on the card,
run here as stand-ins whose own ops are not recorded: KR's plain
integrator, zero partials under `penumbra_scalar_kernel` and the plain
Alhazen solve under `alhazen.solve_kernel` (whose packing is recorded).
The card test (`test_torch_edge_graph_card.py`) holds the replay against
the eager term bit for bit.  `Replay`'s capture and replays run on the
inputs' device whichever device is current, held here with stand-ins for
`torch.cuda`'s device guard, stream and graph.
"""
import functools

import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

import sail_tpu_torch as tsail
from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.ops.cuda import alhazen as ka
from sail_tpu_torch.ops.cuda import penumbra as kp
from sail_tpu_torch.utils import graphs

from test_torch_boundary import (curved_mirror, indirect_shadow,
                                 mirror_penumbra, planar_mirror, ramp_adjoint,
                                 revolution, secondary_silhouette)
from test_torch_boundary_shadow import matte_shadow

torch.set_num_threads(1)

SIZE = 8
EDGE = dict(n_edge_samples=16, n_noise=2, seed=7717, max_bounces=2,
            n_curve_samples=8)
# scene, full_boundary_term's keywords beyond EDGE
SCENES = {
    "cornell_mirror": (scenes.cornell_mirror, {}),
    "quadrics": (scenes.quadrics, {}),
    "revolution": (lambda: revolution(tsail), {}),
    "planar_mirror": (lambda: planar_mirror(tsail), {}),
    "curved_mirror": (lambda: curved_mirror(tsail), {}),
    "matte_shadow": (lambda: matte_shadow(tsail), {}),
    "mirror_penumbra": (lambda: mirror_penumbra(tsail), {}),
    "indirect_shadow": (lambda: indirect_shadow(tsail),
                        dict(n_indirect_dirs=2)),
    "secondary_silhouette": (lambda: secondary_silhouette(tsail),
                             dict(indirect_silhouette=True)),
}
# what a capture refuses: a host read of a device value, and a tensor made
# from host data
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero",
             "aten.masked_select", "aten.lift_fresh", "aten.is_nonzero",
             "aten.equal")


class _Ops(TorchDispatchMode):
    """The name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _unrecorded(fn):
    """`fn` with the recording mode off and the CPU the default device: a
    kernel's stand-in."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with _disable_current_modes(), torch.device("cpu"):
            return fn(*args, **kwargs)
    return inner


def _zero_partials(spheres, xs, inputs):
    """KP's contract (value, d/d spheres, d/d receiver points), zeros: the
    ops around KP are what is held here, not its values."""
    return (xs.new_zeros(()), torch.zeros_like(spheres),
            torch.zeros_like(xs))


def _plain_roots(frame_t, table, cphi, sphi):
    """KA's contract (out, mask) from the plain solve of the packed
    frame."""
    v = frame_t.unbind()
    f = ka.Frame(Vec3(*v[0:3]), Vec3(*v[3:6]), v[6], Vec3(*v[7:10]), v[10],
                 v[11], Vec3(*v[12:15]), Vec3(*v[15:18]), Vec3(*v[18:21]))
    psi0, dh, beta0, gp, mask = ka.solve_plain(f, cphi, sphi)
    return torch.cat((psi0[None], dh[None], beta0, gp)), mask


@pytest.fixture
def card_kernels_as_stand_ins(monkeypatch):
    monkeypatch.setattr(tb, "trace_rays", _unrecorded(tb.trace_rays))
    partials = _unrecorded(_zero_partials)
    monkeypatch.setattr(kp, "penumbra_scalar", lambda *args: (
        kp.penumbra_scalar_kernel(*args, partials=partials)))
    roots = _unrecorded(_plain_roots)
    monkeypatch.setattr(ka, "solve", lambda *args: (
        ka.solve_kernel(*args, roots=roots)))


def _bits(t):
    """The float32 bit patterns (the quadrics' paraboloid, cut at z0 = 0,
    gives NaN leaves, equal here to a NaN of their own pattern)."""
    return t.contiguous().view(torch.int32)


def _adjoint():
    w = torch.from_numpy(ramp_adjoint(SIZE, SIZE))
    return Vec3(w, w, w)


@pytest.mark.parametrize("name", list(SCENES))
def test_second_call_dispatches_nothing_a_capture_refuses(
        name, card_kernels_as_stand_ins):
    scene_fn, kw = SCENES[name]
    params, static = scene_fn().pack()
    dl = _adjoint()
    first = tb.full_boundary_term(params, static, dl, SIZE, SIZE, **EDGE,
                                  **kw)
    with torch.device("meta"), _Ops() as ops:
        second = tb.full_boundary_term(params, static, dl, SIZE, SIZE,
                                       **EDGE, **kw)
    refused = sorted({n for n in ops.names if n.startswith(FORBIDDEN)})
    assert not refused, f"{name}: {refused}"
    assert len(ops.names) > 100, "the term ran op by op"
    assert torch.equal(_bits(first), _bits(second))


def test_cpu_tensors_take_the_eager_path():
    """On the CPU `full_boundary_term` is its eager inner function, bit for
    bit, counted as eager, with no graph captured or replayed."""
    params, static = scenes.cornell_mirror().pack()
    dl = _adjoint()
    counts = (tb.full_boundary_term.eager, tb.full_boundary_term.captures,
              tb.full_boundary_term.replays)
    got = [tb.full_boundary_term(params, static, dl, SIZE, SIZE, **EDGE)
           for _ in range(2)]
    want = tb._full_boundary_term(params, static, dl, SIZE, SIZE, **EDGE)
    assert all(torch.equal(_bits(g), _bits(want)) for g in got)
    assert (tb.full_boundary_term.eager, tb.full_boundary_term.captures,
            tb.full_boundary_term.replays) == (counts[0] + 2, *counts[1:])


class _FakeCuda:
    """Stand-ins for `torch.cuda.device`, `Stream`, `CUDAGraph` and
    `graph` that record the device current at each step."""

    def __init__(self, current):
        self.current = [current]
        self.log = []

    def device(self, dev):
        fake = self

        class Guard:
            def __enter__(self):
                fake.current.append(dev)

            def __exit__(self, *exc):
                fake.current.pop()
        return Guard()

    def Stream(self, dev):
        self.log.append(("stream", dev))
        return ("stream", dev)

    def CUDAGraph(self):
        fake = self

        class Graph:
            def replay(self):
                fake.log.append(("replay", fake.current[-1]))
        return Graph()

    def graph(self, g, stream=None):
        fake = self

        class Capture:
            def __enter__(self):
                fake.log.append(("capture", fake.current[-1], stream))

            def __exit__(self, *exc):
                pass
        return Capture()


def test_replay_runs_on_the_inputs_device(monkeypatch):
    """With another device current, `Replay` captures on a stream of the
    inputs' device with that device current, runs `fn` there, and replays
    there: the static buffers take the new inputs, and the output handed
    back is a copy of the graph's."""
    fake = _FakeCuda("cuda:0")
    for name in ("device", "Stream", "CUDAGraph", "graph"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    x = torch.arange(4.0)
    ran_on = []

    def fn(t):
        ran_on.append(fake.current[-1])
        return t * 2.0

    r = graphs.Replay(fn, (x,))
    here = x.device
    assert ran_on == [here]
    assert fake.log == [("stream", here), ("capture", here, ("stream", here))]
    out = r.replay(x + 1.0)
    assert fake.log[-1] == ("replay", here) and fake.current == ["cuda:0"]
    assert torch.equal(r.inputs[0], x + 1.0)
    assert torch.equal(out, r.output)
    assert out.data_ptr() != r.output.data_ptr()
