"""The port's textures (`sail_tpu_torch/ops/textures.py`) on the CPU, each
against the JAX package's (`sail_tpu/ops/textures.py`) on the same seeded
(u, v) and points: the six uv textures, `surface_color`'s row dispatch and
Cornell-wall override, and the Perlin library (`perlin`, `fbm`,
`turbulence`); then the host classes' packed rows.

Tolerance: the uv textures and the dispatch exactly (the same float32
operations, no multiply-add to fuse but bilerp's, held at 1e-6); Perlin
noise at 1e-5 (a few chained multiply-adds, which XLA:CPU fuses).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sail_tpu.scene.texture as jtex_cls
from sail_tpu.core.vecmath import Vec3 as JVec3
from sail_tpu.ops import textures as jtex
import sail_tpu_torch as sail
from sail_tpu_torch import constants as C
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops import textures
from sail_tpu_torch.scene import texture as ttex_cls
from sail_tpu_torch.scene.bridge import params_from_jax_leaves
from sail_tpu_torch.scene.scene import _view

torch.set_num_threads(1)

N = 4096

TEXTURES = {
    "checkerboard": jtex_cls.Checkerboard(0.1, 0.02),
    "checkerboard2": jtex_cls.Checkerboard2((0.9, 0.2, 0.1), (0.1, 0.3, 0.8),
                                            0.25),
    "bilerp": jtex_cls.Bilerp((1.0, 0.3, 0.2), (0.2, 1.0, 0.3),
                              (0.3, 0.2, 1.0), (0.9, 0.9, 0.2)),
    "mix": jtex_cls.Mix((0.9, 0.9, 1.0), (0.6, 1.0, 0.8), 0.3),
    "scale": jtex_cls.ScaleT((0.9, 0.6, 0.5), (0.8, 1.0, 0.9)),
    "uv": jtex_cls.UV(),
    "uniform": jtex_cls.UniformColor((0.25, 0.5, 0.75)),
}


def _port_params(tex):
    """The JAX texture's packed row, through the bridge, as the port's
    NamedTuple (the layout the scene table reads)."""
    flat = params_from_jax_leaves([np.asarray(l) for l in
                                   jax.tree.leaves(tex.pack())])
    return _view(*ttex_cls.LAYOUTS[tex.category], flat, 0)


def _uv(seed=0):
    rng = np.random.default_rng(seed)
    # beyond [0, 1): sphere and box u, v stay inside, but floor and the
    # checkers see any value; negatives exercise the remainder's sign
    u, v = rng.uniform(-1.5, 2.5, (2, N)).astype(np.float32)
    return (jnp.asarray(u), jnp.asarray(v)), (torch.from_numpy(u),
                                              torch.from_numpy(v))


def _stack(vec):
    return np.stack([np.broadcast_to(np.asarray(c, np.float64), (N,))
                     for c in vec])


@pytest.mark.parametrize("name", sorted(n for n in TEXTURES if n != "uniform"))
def test_uv_texture_matches_jax(name):
    tex = TEXTURES[name]
    (ju, jv), (tu, tv) = _uv()
    want = jtex._TEX_FNS[tex.category](tex.pack(), ju, jv)
    got = textures._TEX_FNS[tex.category](_port_params(tex), tu, tv)
    np.testing.assert_allclose(_stack(got), _stack(want), rtol=1e-6,
                               atol=1e-6)


def test_surface_color_dispatch_and_override():
    """Every texture row at once, each ray reading the row its index names;
    rays on a Cornell wall take the wall's color instead."""
    names = sorted(TEXTURES)
    rows = [TEXTURES[n] for n in names]
    (ju, jv), (tu, tv) = _uv(1)
    rng = np.random.default_rng(2)
    row = rng.integers(0, len(rows), N).astype(np.int32)
    use = (rng.uniform(size=N) < 0.2).astype(np.int32)
    over = rng.uniform(size=(3, N)).astype(np.float32)

    class Static:
        texture_categories = tuple(t.category for t in rows)

    want = jtex.surface_color(tuple(t.pack() for t in rows), Static, row,
                              None, ju, jv,
                              JVec3(*(jnp.asarray(c) for c in over)),
                              jnp.asarray(use))
    got = textures.surface_color(tuple(_port_params(t) for t in rows),
                                 Static, torch.from_numpy(row), None, tu, tv,
                                 Vec3(*(torch.from_numpy(c.copy())
                                        for c in over)),
                                 torch.from_numpy(use))
    np.testing.assert_allclose(_stack(got), _stack(want), rtol=1e-6,
                               atol=1e-6)


def _points(seed=3, scale=4.0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-scale, scale, (3, N)).astype(np.float32)
    return (JVec3(*(jnp.asarray(c) for c in p)),
            Vec3(*(torch.from_numpy(c.copy()) for c in p)))


def test_perlin_matches_jax():
    jp, tp = _points()
    np.testing.assert_allclose(textures.perlin(tp).numpy(),
                               np.asarray(jtex.perlin(jp)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fn", ["fbm", "turbulence"])
@pytest.mark.parametrize("omega,octaves", [(0.5, 4), (0.6, 5)])
def test_noise_sums_match_jax(fn, omega, octaves):
    """Odd octave counts take the partial octave's smoothstep weight."""
    jp, tp = _points(4, 2.0)
    want = getattr(jtex, fn)(jp, omega, octaves)
    got = getattr(textures, fn)(tp, omega, octaves)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_texture_rows_pack_in_jax_order():
    """Each host class packs its fields in `jax.tree.flatten` order, with
    the widths its layout row names."""
    port = {
        "checkerboard": sail.Checkerboard(0.1, 0.02),
        "checkerboard2": sail.Checkerboard2((0.9, 0.2, 0.1), (0.1, 0.3, 0.8),
                                            0.25),
        "bilerp": sail.Bilerp((1.0, 0.3, 0.2), (0.2, 1.0, 0.3),
                              (0.3, 0.2, 1.0), (0.9, 0.9, 0.2)),
        "mix": sail.Mix((0.9, 0.9, 1.0), (0.6, 1.0, 0.8), 0.3),
        "scale": sail.ScaleT((0.9, 0.6, 0.5), (0.8, 1.0, 0.9)),
        "uv": sail.UV(),
        "uniform": sail.UniformColor((0.25, 0.5, 0.75)),
    }
    for name, tex in TEXTURES.items():
        leaves = [float(l) for l in jax.tree.leaves(tex.pack())]
        packed = port[name].pack()
        assert port[name].category == tex.category
        assert len(packed) == sum(ttex_cls.LAYOUTS[tex.category][1])
        np.testing.assert_array_equal(np.float32(packed), np.float32(leaves))
    assert sail.Color.create_texture(sail.Color.RED).pack() == C.RED
    assert sail.Checkerboard(-1.0, -1.0).pack() == (0.3, 0.03)
