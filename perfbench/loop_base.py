"""What every loop shares.  A loop (`loops/<loop>.py`, class `Loop`) is
made from the cell, the seed and the device; `setup()` builds the program's
objects from the configuration's data and warms up every shape the traffic
uses (`warm()`); `unit(rec, spans)` runs one unit of work (a step, a
frame), records in `rec` what the readers count and times its calls into
the program with `spans(name)`; `release()` frees what the check
does not need; `outputs()` gives what the timed path produced, and
`reference(dtype)` the same quantities worked out by the reference;
`compare(program, reference)` gives the numbers, by name, that the cell's
limits hold.

A loop of a multi-card cell runs in each of the cell's processes, as rank
`rank` of `world` on its own device: it joins the program's process group
itself (`initialize_distributed()`, from the environment the harness sets;
gloo on the CPU) where `world` > 1, and leaves it in `release()`, which
every rank calls.  Only rank 0's `outputs`, `reference` and `compare` feed
the check.  At `world` 1 the same loop runs in one process, as the CPU
tests run it."""
from __future__ import annotations

import numpy as np
import torch

SEED_MOD = 1 << 31


class LoopBase:
    def __init__(self, cell: dict, seed: int, device: torch.device,
                 rank: int = 0, world: int = 1):
        self.cell = cell
        self.config = cell["config"]
        self.t = cell["traffic"]
        self.seed = seed
        # the seed the program's counter-based RNG takes (an int32)
        self.rseed = seed % SEED_MOD
        self.rng = np.random.default_rng(seed)
        self.device = device
        self.rank, self.world = rank, world

    def setup(self):
        raise NotImplementedError

    def warm(self):
        """The traffic's `warmup_units` units, outside the window."""
        from .harness import Spans
        for _ in range(self.t["warmup_units"]):
            self.unit({}, Spans())

    def unit(self, rec: dict, spans):
        raise NotImplementedError

    def release(self):
        pass

    def outputs(self) -> dict:
        raise NotImplementedError

    def reference(self, dtype) -> dict:
        raise NotImplementedError

    def compare(self, program: dict, reference: dict) -> list:
        raise NotImplementedError

    def check(self) -> list:
        """The numbers, the program's outputs against the reference's."""
        return self.compare(self.outputs(), self.reference(torch.float32))

    def control(self) -> list:
        """The numbers with the reference in bfloat16 in the program's
        place: what the limits have to fail."""
        return self.compare(self.reference(torch.bfloat16),
                            self.reference(torch.float32))
