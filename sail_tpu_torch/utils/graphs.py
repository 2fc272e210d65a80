"""One call captured as a CUDA graph and replayed: for a stretch of many
small eager kernels whose launches, not the kernels, set its time
(`diff/boundary.full_boundary_term`, ~16k launches a config-5 step).

A replay runs the captured kernels on the static input buffers, so it does
the same work on the same inputs as the eager call it was captured from;
what the call's Python decided (shapes, branches, sample counts) is fixed
at capture, and the caller keys its graphs on everything that decides it.
"""
from __future__ import annotations

import torch


class Replay:
    """`fn(*inputs)` captured once into one CUDA graph over static copies of
    `inputs` (tensors on one CUDA device), then replayed on new inputs of
    the same shapes and dtypes: `replay(*inputs)` copies them into the
    static buffers, replays, and returns a clone of the static output, so
    no caller holds memory that the next replay overwrites.

    The capture and each replay run with the inputs' device current, the
    capture on a stream of that device (`stream`), so a graph on one card
    holds that card's kernels whichever device the caller had current.
    `fn` must make no host sync and no host-to-device copy (a capture
    refuses both), and must have run once eagerly on this device (kernels
    built, cached tables filled)."""

    def __init__(self, fn, inputs):
        self.device = inputs[0].device
        with torch.cuda.device(self.device):
            self.inputs = [t.detach().clone(
                memory_format=torch.contiguous_format) for t in inputs]
            self.stream = torch.cuda.Stream(self.device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=self.stream):
                self.output = fn(*self.inputs)

    def replay(self, *inputs) -> torch.Tensor:
        with torch.cuda.device(self.device):
            for buf, t in zip(self.inputs, inputs):
                buf.copy_(t)
            self.graph.replay()
            return self.output.clone()
