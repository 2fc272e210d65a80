"""Failure detection and elastic recovery (port of
`sail_tpu/parallel/elastic.py`).

The random numbers are a stateless hash of (seed, global sample index,
global pixel), so a render is a sum of per-sample terms that do not care
which rank computed them.  Recovery is therefore a matter of bookkeeping:
render the samples in chunks, add each chunk's raw spp-sum, and after a
failure rebuild a smaller mesh from the ranks that still answer and run
the same chunk again.  The image is bit for bit the uninterrupted render's
where every chunk divides over the spp axis as that render's samples did.

Detection: `probe_devices` runs a round trip (2·2 == 4) on each rank's
device; a RuntimeError out of a chunk (a CUDA error, an injected
`DeviceFailure`) marks it failed.  Fault injection for tests:
`fault_hook(chunk_index)` raises, `faulty(rank)` marks ranks dead.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .. import constants as C
from ..core.vecmath import Vec3
from .mesh import as_ranks, global_ranks, make_mesh, process_count, \
    process_index
from .render_sharded import render_sharded


class DeviceFailure(RuntimeError):
    """Raised by fault-injection hooks, and when no rank is left."""


def _answers(device: torch.device) -> bool:
    try:
        x = torch.tensor(2.0, device=device)
        return float(x * x) == 4.0
    except RuntimeError:
        return False


def probe_devices(devices: Optional[Sequence] = None,
                  faulty: Callable = None) -> list:
    """The ranks of `devices` (ranks or devices; default every CUDA device
    of every process) whose device completes a round trip.  `faulty(rank)`:
    a test hook marking ranks dead without a real failure.  A rank of
    another process is probed there; its verdict comes back through one
    `all_gather`, so across processes every process must call this
    together."""
    ranks = global_ranks() if devices is None else as_ranks(devices)
    me = process_index()
    ok = [r.process == me and not (faulty is not None and faulty(r))
          and _answers(r.device) for r in ranks]
    if any(r.process != me for r in ranks):
        votes = [torch.tensor(ok) for _ in range(process_count())]
        dist.all_gather(votes, torch.tensor(ok))
        ok = [bool(votes[r.process][i]) for i, r in enumerate(ranks)]
    return [r for r, good in zip(ranks, ok) if good]


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class ElasticRenderer:
    """Progressive sharded renderer that survives losing ranks mid-render.

    Renders `spp` samples in `chunk_spp`-sized chunks, each on the current
    mesh.  When a chunk fails, the ranks are probed again, the mesh shrinks
    to the largest power-of-two subset that answers, and the SAME chunk
    runs again: global sample indices make the retried chunk produce
    exactly what the lost mesh would have.  `params` is the flat scene
    tensor; `devices` ranks or devices (default every CUDA device of every
    process)."""

    def __init__(self, params: torch.Tensor, static, height: int, width: int,
                 max_bounces: int = C.MAX_BOUNCES,
                 devices: Optional[Sequence] = None,
                 fault_hook: Callable[[int], None] = None,
                 faulty: Callable = None, max_retries: int = 3):
        self.params = params
        self.static = static
        self.height = height
        self.width = width
        self.max_bounces = max_bounces
        self.devices = global_ranks() if devices is None else as_ranks(
            devices)
        self.fault_hook = fault_hook
        self.faulty = faulty
        self.max_retries = max_retries
        self.mesh = make_mesh(devices=self.devices)
        self.events: list[dict] = []       # what failed when
        self._chunk_index = 0

    def _fit_mesh(self, chunk_n: int):
        """A mesh over the current ranks whose axes divide the work
        (chunk_n % spp axis == 0, height % tile axis == 0): the default
        split, else spp axis 1 (any chunk splits over rows), else half the
        ranks, until the tile axis divides the image height."""
        ranks = list(self.devices)
        while ranks:
            mesh = make_mesh(devices=ranks)
            if (chunk_n % mesh.n_spp == 0
                    and self.height % mesh.n_tile == 0):
                self.devices, self.mesh = ranks, mesh
                return
            mesh = make_mesh(devices=ranks, spp_axis=1)
            if self.height % mesh.n_tile == 0:
                self.devices, self.mesh = ranks, mesh
                self.events.append({"event": "mesh_reshape",
                                    "reason": "spp_remainder"})
                return
            ranks = ranks[:len(ranks) // 2]
        raise DeviceFailure(f"no rank subset fits height={self.height}")

    def _shrink_mesh(self, reason: str, chunk_n: int):
        healthy = probe_devices(self.devices, self.faulty)
        if not healthy:
            raise DeviceFailure("no healthy devices left")
        self.devices = healthy[:_largest_pow2_leq(len(healthy))]
        self._fit_mesh(chunk_n)
        self.events.append({"event": "mesh_shrink", "reason": reason,
                            "devices": len(self.devices)})

    def render(self, spp: int, seed: int = 0, chunk_spp: int = None) -> Vec3:
        """Mean image over `spp` samples, elastically, on the final mesh's
        device.  Bit-identical to render_sharded(spp) on a mesh that never
        fails, where each chunk splits over the spp axis as that render
        does.  The raw spp-sums of the chunks are added on the host, so a
        lost card takes none of them with it, and divided once at the
        end."""
        if chunk_spp is None:
            chunk_spp = max(spp // 4, 1)
        acc = torch.zeros((3, self.height, self.width), dtype=torch.float32)
        done = 0
        while done < spp:
            n = min(chunk_spp, spp - done)
            if n % self.mesh.n_spp or self.height % self.mesh.n_tile:
                self._fit_mesh(n)
            retries = 0
            while True:
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(self._chunk_index)
                    out = render_sharded(
                        self.params, self.static, self.mesh, self.height,
                        self.width, n, seed=seed,
                        max_bounces=self.max_bounces, sample0=done,
                        return_sum=True)
                    out = torch.stack(out).cpu()
                    break
                except RuntimeError as e:
                    retries += 1
                    if retries > self.max_retries:
                        raise
                    reason = (str(e) if isinstance(e, DeviceFailure)
                              else type(e).__name__)
                    self.events.append({"event": "chunk_failed",
                                        "chunk": self._chunk_index,
                                        "error": reason})
                    self._shrink_mesh(reason, n)
            self._chunk_index += 1
            acc = acc + out
            done += n
        return Vec3(*(acc * (1.0 / spp)).to(self.mesh.device))
