"""On the card: `full_boundary_term` replayed as one CUDA graph against its
eager inner function (`diff/boundary._full_boundary_term`) on the same
inputs.

- Config 5 over three Adam steps of `make_train_step` (a new loss adjoint
  each step): the key's first call runs eagerly, the second captures, the
  third replays; each result equals the eager term bit for bit (the eager
  term, run twice on each step's inputs, first shows that it is bit-stable
  on its own); `full_boundary_term.eager`, `.captures` and `.replays`
  count each call, and the wrappers' `launches` (KR, KP, the reduce after
  KP) count the eager call's launches only.  A replay's KR, KP and reduce
  kernels are counted from the profiler's kernel events by name: as many
  as the eager call launched.
- A new key (another `n_noise`, another image size) runs eagerly, then
  captures a graph of its own.
- Other inputs the same code takes: config 5's scene with the diffuse-
  bounce receivers and the secondary-vertex silhouette, every quadric,
  and a planar mirror, each over three fresh adjoints.
- On a host with two cards or more: config 5's train step over the
  default mesh (every card, cuda:0 current), each rank's term captured
  and replayed on its own card.

Skips without a card (the last without a second card).  Run on a card,
without `tests/conftest.py` (which imports JAX): `python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_edge_graph_card.py -q`.
"""
import collections

import pytest
import torch

import sail_tpu_torch as tsail
from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.diff import boundary as tb
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.ops.cuda import penumbra as kp
from sail_tpu_torch.parallel import render_sharded as rs
from sail_tpu_torch.parallel.mesh import make_mesh
from sail_tpu_torch.scene.scene import leaf_paths

SIZE = 256
SPP = 4
BOUNCES = 4
# make_train_step's edge terms
EDGE = dict(n_edge_samples=192, n_noise=2, max_bounces=BOUNCES,
            n_curve_samples=32)
KERNELS = (mk.trace_rays, kp.penumbra_partials, mk.reduce_grad_rows)


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh_graphs(monkeypatch):
    """An empty graph cache for the test, dropped after it."""
    monkeypatch.setattr(tb, "_GRAPHS", collections.OrderedDict())


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _counts():
    f = tb.full_boundary_term
    return ((f.eager, f.captures, f.replays),
            tuple(k.launches for k in KERNELS))


def _delta(before, after):
    return tuple(tuple(b - a for a, b in zip(x, y))
                 for x, y in zip(before, after))


# the hand-written kernels' names in the profiler, in KERNELS' order
KERNEL_NAMES = ("trace_rays_kernel", "penumbra_kernel",
                "reduce_grad_rows_kernel")


class _Calls:
    """`full_boundary_term` recording, per call, its result, what it
    counted, and the eager inner function's result twice on the same
    inputs."""

    def __init__(self):
        self.rows = []

    def __call__(self, *args, **kw):
        before = _counts()
        got = tb.full_boundary_term(*args, **kw)
        torch.cuda.synchronize()
        counted = _delta(before, _counts())
        eager = [tb._full_boundary_term(*args, **kw) for _ in range(2)]
        self.rows.append((args[0].device, got, counted, eager))
        return got

    def check(self, label):
        """Each result is the eager term's bit for bit; on each device the
        counters say eager, capture, replay, replay, ..., and the wrappers
        count KR, KP and its reduce on the eager call only."""
        by_device = collections.defaultdict(list)
        for dev, *row in self.rows:
            by_device[dev].append(row)
        for dev, rows in by_device.items():
            where = f"{label} on {dev}"
            eager_launches = rows[0][1][1]
            assert sum(eager_launches) > 0, \
                f"{where}: eager launches {eager_launches}"
            for i, (got, (calls, launched), (e1, e2)) in enumerate(rows):
                assert got.device == dev, f"{where}: call {i} on {got.device}"
                assert torch.equal(_bits(e1), _bits(e2)), \
                    f"{where}: the eager term is not bit-stable (call {i})"
                assert torch.equal(_bits(got), _bits(e1)), \
                    f"{where}: call {i} differs from the eager term by " \
                    f"{(got - e1).abs().max().item()}"
                want = [(1, 0, 0), (0, 1, 1)][i] if i < 2 else (0, 0, 1)
                assert calls == want, f"{where}: call {i} counted {calls}"
                if i:
                    assert launched == (0,) * len(KERNELS), \
                        f"{where}: call {i} counted launches {launched}"
        return by_device


def _kernels_by_name(fn, *args, **kw):
    """How many of each of KERNEL_NAMES the device ran during `fn`, from
    the profiler's kernel events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*args, **kw)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == cuda]
    return tuple(sum(k in n for n in names) for k in KERNEL_NAMES)


@pytest.mark.card
def test_config5_train_steps_replay_the_eager_term(card, fresh_graphs,
                                                   monkeypatch):
    params, static = scenes.cornell_mirror().pack()
    keys = leaf_paths(static)
    mesh = make_mesh(1, device=card)
    with torch.no_grad():
        target = rs.render_sharded(params.to(card), static, mesh, SIZE, SIZE,
                                   SPP, seed=5, max_bounces=BOUNCES)
    params[keys.index(".objects[2].center.x")] = 0.58
    params[keys.index(".materials[1].kr")] = 0.45
    p = params.to(card).clone()
    opt = torch.optim.Adam([p], lr=0.02)
    calls = _Calls()
    monkeypatch.setattr(rs, "full_boundary_term", calls)
    step = rs.make_train_step(static, mesh, SIZE, SIZE, SPP, opt, seed=5,
                              max_bounces=BOUNCES)
    for _ in range(3):
        step(target)
    assert len(calls.rows) == 3
    assert not torch.equal(calls.rows[0][3][0], calls.rows[2][3][0]), \
        "each step has its own adjoint"
    calls.check("config 5")
    assert min(calls.rows[0][2][1]) > 0, "config 5 launches KR, KP, reduce"
    # a replay runs KR, KP and its reduce as often as the eager call
    # launched them: counted on the device, by name
    gen = torch.Generator().manual_seed(11)
    adj = Vec3(*(torch.rand((3, SIZE, SIZE), generator=gen).to(card)
                 * 1e-6))
    replays = tb.full_boundary_term.replays
    replayed = _kernels_by_name(
        tb.full_boundary_term, p.detach(), static, adj, SIZE, SIZE,
        seed=5 + 7717, **EDGE)
    assert tb.full_boundary_term.replays == replays + 1
    assert replayed == calls.rows[0][2][1], \
        f"the replay ran {replayed} KR/KP/reduce kernels, the eager call " \
        f"launched {calls.rows[0][2][1]}"

    # a new key: another noise count, then another size
    q = p.detach().clone()
    for size, kw in ((SIZE, dict(EDGE, n_noise=1)), (SIZE // 2, EDGE)):
        other = _Calls()
        for _ in range(3):
            adj = Vec3(*(torch.rand((3, size, size), generator=gen)
                         .to(card) * 1e-6))
            other(q, static, adj, size, size, seed=5 + 7717, **kw)
        other.check(f"{size}² {kw}")
    assert tb.full_boundary_term.captures >= 3


def _planar_mirror():
    """A planar mirror showing a matte sphere and its shadow under a
    rectangle light."""
    s = tsail.Scene()
    s.add(tsail.Camera([0.0, 0.0, 2.5], [0.0, 0.0, 0.0]))
    s.add(tsail.Rectangle([-0.9, -1.2, -0.99], [0.9, 0.9, -0.99],
                          tsail.Mirror(kr=1.0)))
    s.add(tsail.Rectangle([-1.4, -0.95, -0.95], [1.4, -0.95, 3.7],
                          tsail.Matte(kd=0.95)))
    s.add(tsail.Sphere([0.1, 0.0, 0.6], 0.45, tsail.Matte(kd=0.3)))
    s.add(tsail.AreaLight(tsail.Rectangle(
        [-0.3, 1.6, 0.35], [0.5, 1.6, 0.85], tsail.Matte()),
        [12.0, 12.0, 12.0]))
    return s


OTHER = {
    "config5_indirect": (scenes.cornell_mirror,
                         dict(n_indirect_dirs=2, indirect_silhouette=True)),
    "quadrics": (scenes.quadrics, {}),
    "planar_mirror": (_planar_mirror, {}),
}


@pytest.mark.card
@pytest.mark.parametrize("name", list(OTHER))
def test_other_inputs_replay_the_eager_term(name, card, fresh_graphs):
    scene_fn, kw = OTHER[name]
    params, static = scene_fn().pack()
    params = params.to(card)
    size = 96
    gen = torch.Generator().manual_seed(3)
    calls = _Calls()
    for _ in range(3):
        adj = Vec3(*(torch.rand((3, size, size), generator=gen).to(card)
                     * 1e-5))
        calls(params, static, adj, size, size, seed=9, **EDGE, **kw)
    calls.check(name)


@pytest.fixture
def cards():
    """Every CUDA device, with cuda:0 current; skips the test with fewer
    than two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    torch.cuda.set_device(0)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.card
def test_every_card_of_the_default_mesh_replays_its_own_term(
        cards, fresh_graphs, monkeypatch):
    """Config 5's train step over the default mesh (a rank on each card,
    in its order) with cuda:0 current: each rank's term runs eagerly,
    captures and replays on its own card, equal to the eager term there."""
    params, static = scenes.cornell_mirror().pack()
    keys = leaf_paths(static)
    mesh = make_mesh()
    assert [r.device for _, r in mesh.local_ranks] == cards
    with torch.no_grad():
        target = rs.render_sharded(params.to(cards[0]), static, mesh, SIZE,
                                   SIZE, SPP, seed=5, max_bounces=BOUNCES)
    params[keys.index(".objects[2].center.x")] = 0.58
    p = params.to(cards[0]).clone()
    opt = torch.optim.Adam([p], lr=0.02)
    calls = _Calls()
    monkeypatch.setattr(rs, "full_boundary_term", calls)
    step = rs.make_train_step(static, mesh, SIZE, SIZE, SPP, opt, seed=5,
                              max_bounces=BOUNCES)
    for _ in range(3):
        step(target)
        assert torch.cuda.current_device() == 0
    by_device = calls.check("config 5 over every card")
    assert sorted(by_device, key=str) == cards
    assert all(len(rows) == 3 for rows in by_device.values())
    assert bool(torch.isfinite(p.detach()).all())
