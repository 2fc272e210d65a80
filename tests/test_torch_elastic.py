"""Failure detection and elastic recovery in the port
(`sail_tpu_torch/parallel/elastic.py`) on an 8-rank CPU layout: the twin of
tests/test_elastic.py, on `cornell_matte` at 16², 4 spp, 2 bounces, its
inputs from JAX's scene through the bridge.

After losing half the ranks mid-render the finished image is bit for bit
the uninterrupted 8-rank render's (global sample indices and a stateless
hash make finished work independent of where it ran).  Against JAX's
`ElasticRenderer` on the conftest's 8 virtual CPU devices at the same
arguments: within 1e-5 (atol = rtol, as tests/test_torch_sharding.py's
images).
"""
import jax
import numpy as np
import pytest
import torch

from sail_tpu import scenes as jscenes
from sail_tpu.parallel.elastic import ElasticRenderer as JaxElasticRenderer
from sail_tpu_torch.parallel.elastic import (DeviceFailure, ElasticRenderer,
                                             probe_devices)
from sail_tpu_torch.parallel.mesh import as_ranks, make_mesh
from sail_tpu_torch.parallel.render_sharded import render_sharded
from sail_tpu_torch.scene.bridge import params_from_jax_leaves, static_from_jax

torch.set_num_threads(1)

SIZE = 16
SPP = 4
BOUNCES = 2
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def setup():
    packed, jstatic = jscenes.cornell_matte().pack()
    params = params_from_jax_leaves([np.asarray(l)
                                     for l in jax.tree.leaves(packed)])
    static = static_from_jax(jstatic)
    ref = render_sharded(params, static, make_mesh(devices=CPU8), SIZE, SIZE,
                         SPP, seed=0, max_bounces=BOUNCES)
    return packed, jstatic, params, static, ref.stack()


def _renderer(setup, **kw):
    _, _, params, static, _ = setup
    return ElasticRenderer(params, static, SIZE, SIZE, max_bounces=BOUNCES,
                           devices=CPU8, **kw)


def test_probe_devices_filters_faulty():
    ranks = as_ranks(CPU8)
    healthy = probe_devices(ranks, faulty=lambda r: r.id % 2 == 1)
    assert [r.id for r in healthy] == [r.id for r in ranks if r.id % 2 == 0]
    assert probe_devices(CPU8) == ranks


def test_elastic_render_no_faults_matches(setup):
    er = _renderer(setup)
    img = er.render(SPP, seed=0, chunk_spp=2)
    assert torch.equal(img.stack(), setup[4])
    assert er.events == []


def test_elastic_survives_device_loss_bit_identical(setup):
    dead = {r.id for r in as_ranks(CPU8)[4:]}   # the second half dies
    tripped = []

    def fault_hook(chunk):
        if chunk == 1 and not tripped:
            tripped.append(True)
            raise DeviceFailure("injected: device powered off")

    er = _renderer(setup, fault_hook=fault_hook,
                   faulty=lambda r: r.id in dead)
    img = er.render(SPP, seed=0, chunk_spp=2)
    assert any(e["event"] == "mesh_shrink" for e in er.events)
    assert er.events[0] == {"event": "chunk_failed", "chunk": 1,
                            "error": "injected: device powered off"}
    assert len(er.devices) == 4 and er.mesh.shape == {"tile": 2, "spp": 2}
    assert {r.id for r in er.devices} == {0, 1, 2, 3}
    assert torch.equal(img.stack(), setup[4])


def test_elastic_gives_up_when_nothing_healthy(setup):
    def fault_hook(chunk):
        raise DeviceFailure("injected: total outage")

    er = _renderer(setup, fault_hook=fault_hook, faulty=lambda r: True,
                   max_retries=2)
    with pytest.raises(DeviceFailure):
        er.render(SPP, seed=0, chunk_spp=2)


def test_elastic_raises_a_runtime_error_after_its_retries(setup):
    """A RuntimeError out of every chunk is retried on a probed mesh at
    most max_retries times, then raised: never swallowed."""
    def fault_hook(chunk):
        raise RuntimeError("CUDA error: an illegal memory access")

    er = _renderer(setup, fault_hook=fault_hook, max_retries=2)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        er.render(SPP, seed=0, chunk_spp=2)
    failed = [e for e in er.events if e["event"] == "chunk_failed"]
    assert failed == [{"event": "chunk_failed", "chunk": 0,
                       "error": "RuntimeError"}] * 2


def test_elastic_defaults_to_the_cards(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, params, static, _ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticRenderer(params, static, SIZE, SIZE)


def test_elastic_matches_jax(setup):
    packed, jstatic, _, _, _ = setup
    want = JaxElasticRenderer(packed, jstatic, SIZE, SIZE,
                              max_bounces=BOUNCES).render(SPP, seed=0,
                                                          chunk_spp=2)
    got = _renderer(setup).render(SPP, seed=0, chunk_spp=2)
    np.testing.assert_allclose(got.stack().numpy(), np.asarray(want.stack()),
                               atol=1e-5, rtol=1e-5)
