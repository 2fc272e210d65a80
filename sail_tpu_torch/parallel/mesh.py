"""The device layout of a render (port of `sail_tpu/parallel/mesh.py`).

The JAX package lays devices out on a ("tile", "spp") mesh: image rows
shard over "tile", samples per pixel over "spp".  Here a mesh is a grid of
ranks.  A rank is one block of that work: it has an id of its own, a torch
device and the process that owns it.  Several ranks may share a device
(eight ranks on "cuda:0", or on "cpu"), as XLA's virtual CPU devices share
one host; they take their turns there.  Once `initialize_distributed` has
run, a mesh may span processes: each renders its own ranks' blocks, and
`render_sharded`'s collectives join them.
"""
from __future__ import annotations

import datetime
import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve


class Rank(NamedTuple):
    """One block of a mesh's work.  `id` stays with the rank when a mesh is
    rebuilt from a subset (`parallel/elastic.py` marks ranks faulty by it);
    `process` is the torch.distributed rank of the process that owns it."""
    id: int
    device: torch.device
    process: int


def process_index() -> int:
    """This process's torch.distributed rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes of the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device(d) -> torch.device:
    device = resolve(d, "make_mesh")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def global_ranks(local_devices: Sequence | None = None) -> list:
    """Every rank of every process, each process holding one rank on each
    of `local_devices` (default: every CUDA device of this process; with no
    card this raises, as the port never falls back to the CPU).  Process p's
    j-th rank has id p·k + j, k ranks a process."""
    if local_devices is None:
        resolve(None, "global_ranks")
        local_devices = [torch.device("cuda", j)
                         for j in range(torch.cuda.device_count())]
    local = [_device(d) for d in local_devices]
    k = len(local)
    return [Rank(p * k + j, local[j], p) for p in range(process_count())
            for j in range(k)]


def as_ranks(devices: Sequence) -> list:
    """`devices` as ranks: a Rank stays as it is; a device (or its name)
    becomes a rank of this process whose id is its place in the list."""
    return [d if isinstance(d, Rank) else Rank(i, _device(d), process_index())
            for i, d in enumerate(devices)]


@dataclass(frozen=True)
class Mesh:
    """A (tile, spp) grid of ranks, row-major: `ranks[di]` renders tile
    di // n_spp and spp shard di % n_spp (JAX's flat device index
    tile·n_spp + spp)."""
    ranks: tuple
    n_tile: int
    n_spp: int

    @property
    def shape(self) -> dict:
        return {"tile": self.n_tile, "spp": self.n_spp}

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def local_ranks(self) -> tuple:
        """(di, rank) for each rank this process owns, in mesh order."""
        me = process_index()
        return tuple((di, r) for di, r in enumerate(self.ranks)
                     if r.process == me)

    @property
    def device(self) -> torch.device:
        """Where this process keeps what the mesh returns: its first
        rank's device."""
        local = self.local_ranks
        if not local:
            raise ValueError("this process owns no rank of the mesh")
        return local[0][1].device

    @property
    def gathers(self) -> bool:
        """Whether render_sharded joins the ranks' blocks through
        torch.distributed: a process group is up and each of its processes
        owns ranks of the mesh (at world size 1, every mesh)."""
        return dist.is_initialized() and {r.process for r in self.ranks} \
            == set(range(process_count()))


def make_mesh(n_devices: int | None = None, spp_axis: int | None = None,
              devices: Sequence | None = None, device=None) -> Mesh:
    """A ("tile", "spp") mesh over `devices` (ranks, or devices that may
    repeat: eight ranks on "cuda:0"), by default every CUDA device of every
    process (`global_ranks`); `device=` is the one-rank mesh on that
    device.  `n_devices` takes the first so many; `spp_axis` is the size of
    the spp axis (default: the near-square split that favours tiles, so 8
    ranks are 4 × 2).  Raises ValueError when fewer ranks exist than asked
    or `spp_axis` does not divide them."""
    if device is not None:
        if devices is not None:
            raise ValueError("pass devices or device, not both")
        devices = [device]
    ranks = global_ranks() if devices is None else as_ranks(devices)
    if n_devices is not None:
        if len(ranks) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-rank mesh but only {len(ranks)} "
                f"rank(s) are available ({[str(r.device) for r in ranks]})")
        ranks = ranks[:n_devices]
    n = len(ranks)
    if n == 0:
        raise ValueError("a mesh needs at least one rank")
    if spp_axis is None:
        spp_axis = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    if spp_axis < 1 or n % spp_axis:
        raise ValueError(f"an spp axis of {spp_axis} does not divide {n} "
                         f"ranks")
    return Mesh(tuple(ranks), n // spp_axis, spp_axis)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           timeout: float = 600.0) -> None:
    """Join this process to a torch.distributed process group: at
    `coordinator_address` ("host:port", over tcp://) as process
    `process_id` of `num_processes`, or from the environment (env://:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) without one.  `backend`
    defaults to NCCL, which needs a card; ask for "gloo" for CPU ranks.  A
    collective that waits longer than `timeout` seconds raises."""
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device and "
                           "torch.cuda.is_available() is False; pass "
                           "backend='gloo' for CPU ranks")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    address = coordinator_address
    if address is not None and "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address or "env://",
                            timeout=datetime.timedelta(seconds=timeout), **kw)
