"""Observability: ray counts, render timing and a profiler trace (port of
`sail_tpu/utils/metrics.py`).

`RenderMeter.stop(sync=t)` waits for `t`'s CUDA device, where the JAX
package blocks until `t` is ready.  `profile_trace` runs
`torch.profiler` (the CPU and, where there is a card, CUDA activities)
and writes a Chrome trace, in which the program's own host ranges
(`span`: the train step, the edge terms, the repack, the display) show
beside torch's operations; `kernel_launches` and `kernels_named` count a
finished run's launches and kernels.  The JAX package's `xla_flops` and `mfu`
count XLA's compiled operations and are not ported; the port's count of
the kernels' work is `utils/opcount.live_ops`.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler


def rays_per_sample(height: int, width: int, bounces: int,
                    nee: bool = True) -> int:
    """Rays traced per 1-spp pass: one closest-hit per bounce, plus one NEE
    shadow ray per bounce when lights are present."""
    per_pixel = bounces * (2 if nee else 1)
    return height * width * per_pixel


def _synchronize(t):
    """Wait for the work that produces `t` (a tensor, or a Vec3 or tuple
    of them): its CUDA device's queue; a CPU tensor is ready already."""
    if isinstance(t, torch.Tensor):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return
    for c in t:
        _synchronize(c)


@dataclass
class RenderMeter:
    """Accumulates wall-clock time and ray counts across progressive
    passes."""
    height: int
    width: int
    bounces: int
    nee: bool = True
    samples: int = 0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, samples: int = 1, sync=None):
        if sync is not None:
            _synchronize(sync)
        self.seconds += time.perf_counter() - self._t0
        self.samples += samples

    @property
    def total_rays(self) -> int:
        return rays_per_sample(self.height, self.width, self.bounces,
                               self.nee) * self.samples

    @property
    def mrays_per_s(self) -> float:
        return self.total_rays / max(self.seconds, 1e-12) / 1e6

    def report(self) -> dict:
        return {
            "samples": self.samples,
            "seconds": round(self.seconds, 4),
            "mrays_per_s": round(self.mrays_per_s, 2),
            "resolution": f"{self.height}x{self.width}",
            "bounces": self.bounces,
        }

    def __str__(self):
        return json.dumps(self.report())


# the calls of the CUDA runtime (cuda*) and of libcuda (cu*) that launch a
# kernel, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler over the block (CPU activity, and CUDA's where a card
    is present), its Chrome trace written to `logdir/trace.json` at the
    end; yields the profiler, whose `events()` the caller may read (see
    `kernel_launches`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range called `name` over a `with` block while a torch
    profiler records, else one shared context that does nothing.  The
    range is a plain CPU operation, not a user annotation, so the profiler
    gives it no device-side twin and it adds no device event; ranges nest
    by time on the calling thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """A decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def kernels_named(prof, names) -> tuple:
    """How many kernels whose name holds each of `names` the device ran in
    a finished torch.profiler run: a CUDA graph's kernels, which no wrapper
    counts, included."""
    cuda = torch.autograd.DeviceType.CUDA
    ran = [e.name for e in prof.events() if e.device_type == cuda]
    return tuple(sum(part in n for n in ran) for part in names)


def kernel_launches(prof) -> dict:
    """{"launch_calls": the CUDA launch calls the host made, "kernels": the
    kernels the device ran (memory copies and sets excluded)} of a finished
    `profile_trace`."""
    calls = kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.lower()
            kernels += not (name.startswith("memcpy")
                            or name.startswith("memset"))
        elif e.name in LAUNCH_CALLS:
            calls += 1
    return {"launch_calls": calls, "kernels": kernels}
