"""Two real OS processes of the port's worker
(`sail_tpu_torch/tools/mp_render_worker.py`) join one torch.distributed
process group over gloo on localhost, 2 CPU ranks each, and render
`cornell_matte` at 16², 2 spp, 2 bounces over a mesh spanning both: the
twin of tests/test_multiprocess.py.

- Each process's gathered image against its own one-rank render: within
  1e-5 on the 2 × 2 layout, bit for bit on 4 × 1 (rows split only).
- `sharded_value_and_grad` across the two processes against the same
  4-rank layout in this one process: bit for bit (the blocks, the image,
  the loss adjoint and the ranks' gradients are the same float32
  operations in the same order on both sides; gloo only moves bits).

Against hangs: a free port, the process group's timeout (`--timeout`),
`communicate(timeout=...)` that kills both workers and fails, one torch
thread a worker.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.parallel.mesh import make_mesh
from sail_tpu_torch.parallel.render_sharded import (render_sharded,
                                                    sharded_value_and_grad)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SPP, BOUNCES = 16, 2, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, spp_axis) -> list:
    """Both workers' JSON results; fails on a hang or a non-zero exit."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"proc{pid}.json"
        outs.append(out)
        cmd = [sys.executable, "-m", "sail_tpu_torch.tools.mp_render_worker",
               "--process-id", str(pid), "--num-processes", "2",
               "--coordinator", f"127.0.0.1:{port}", "--device", "cpu",
               "--local-devices", "2", "--size", str(SIZE), "--spp",
               str(SPP), "--bounces", str(BOUNCES), "--grad", "--timeout",
               "120", "--out", str(out)]
        if spp_axis is not None:
            cmd += ["--spp-axis", str(spp_axis)]
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
            q.communicate()
        pytest.fail("a multi-process worker hung")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return [json.loads(out.read_text()) for out in outs]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {axis: _run_pair(tmp_path_factory.mktemp(f"axis{axis}"), axis)
            for axis in (None, 1)}


@pytest.mark.parametrize("spp_axis,mesh", [(None, {"tile": 2, "spp": 2}),
                                           (1, {"tile": 4, "spp": 1})])
def test_two_process_sharded_render(results, spp_axis, mesh):
    for pid, res in enumerate(results[spp_axis]):
        assert res["ok"], res
        assert res["process_id"] == pid and res["backend"] == "gloo"
        assert res["process_count"] == 2
        assert res["global_devices"] == 4
        assert res["mesh"] == mesh
        assert res["max_abs_diff_vs_single"] < 1e-5
    if spp_axis == 1:
        assert all(r["bit_identical_vs_single"] for r in results[spp_axis])


def test_two_process_gradient_matches_in_process(results):
    params, static = scenes.cornell_matte().pack()
    mesh = make_mesh(devices=["cpu"] * 4)
    target = render_sharded(params, static, mesh, SIZE, SIZE, SPP,
                            max_bounces=BOUNCES)
    loss, grad = sharded_value_and_grad(params * 1.02, target, static, mesh,
                                        SIZE, SIZE, SPP,
                                        max_bounces=BOUNCES)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    for res in results[None]:
        assert res["loss"] == float(loss)
        assert torch.equal(torch.tensor(res["grad"], dtype=torch.float32),
                           grad)
