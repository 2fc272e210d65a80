"""The device layout of a render (port of `sail_tpu/parallel/mesh.py`).

The JAX package lays devices out on a ("tile", "spp") mesh: image rows
shard over "tile", samples per pixel over "spp".  This slice of the port
runs one rank on one device, so its layout is the 1 × 1 mesh on the card
(or on the CPU where the caller asks); a layout of more devices, and the
multi-process bring-up (`initialize_distributed`), come with the
`torch.distributed` slice (ROADMAP.md queue 1, item 6).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve


class Mesh(NamedTuple):
    """A (tile, spp) layout of one rank on `device`."""
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"tile": 1, "spp": 1}

    @property
    def size(self) -> int:
        return 1


def make_mesh(n_devices: int | None = None, spp_axis: int | None = None,
              device=None) -> Mesh:
    """The ("tile", "spp") layout of one rank on `device` (the card unless
    the caller asks for another).  More than one device raises
    NotImplementedError."""
    if (n_devices or 1) != 1 or (spp_axis or 1) != 1:
        raise NotImplementedError(
            f"a mesh of {n_devices} devices (spp axis {spp_axis}) needs the "
            "multi-process port of parallel/ on torch.distributed "
            "(ROADMAP.md queue 1, item 6); this slice runs one rank")
    device = resolve(device, "make_mesh")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(device)
