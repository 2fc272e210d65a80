"""The program's own host ranges in the traced sub-window: `sail.<name>`,
which `sail_tpu_torch.utils.metrics.span` records while a profiler runs,
on the clock of the device's events.  A range's time is the union of its
intervals; a launch is a host call that launches a kernel; the device's
idle time inside a range is the part of `Profile.gaps()` it covers.  Every
function gives None where the range never ran (a program without it), and
a per-unit figure is over `Profile.n_units`."""
from __future__ import annotations

from bisect import bisect_right

from perfbench.devtrace import _union

# the calls of the CUDA runtime (cuda*) and of libcuda (cu*) that launch a
# kernel, as the profiler names them (a copy of the program's
# `utils/metrics.LAUNCH_CALLS`)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def intervals(profile, name: str) -> list:
    """(start, end) in µs of each occurrence of the range `name`."""
    return [(s, t) for n, s, t in profile.host if n == name]


def ms_per_unit(profile, name: str):
    """Milliseconds a unit inside `name`: the union of its intervals."""
    iv = _union(intervals(profile, name))
    if not iv:
        return None
    return sum(t - s for s, t in iv) * 1e-3 / profile.n_units


def mean_ms(profile, name: str):
    """Milliseconds of one occurrence of `name`, the mean over the
    sub-window's."""
    iv = intervals(profile, name)
    if not iv:
        return None
    return sum(t - s for s, t in iv) * 1e-3 / len(iv)


def launches_per_unit(profile, name: str):
    """Launch calls a unit whose start lies inside `name`."""
    iv = _union(intervals(profile, name))
    if not iv:
        return None
    starts = [s for s, _ in iv]
    n = 0
    for call, s, _ in profile.host:
        if call in LAUNCH_CALLS:
            i = bisect_right(starts, s) - 1
            n += i >= 0 and s <= iv[i][1]
    return n / profile.n_units


def idle_ms_per_unit(profile, name: str):
    """Milliseconds a unit in which the device ran nothing while `name`
    was under way on the host."""
    iv = _union(intervals(profile, name))
    if not iv:
        return None
    idle = 0.0
    for gs, gt in profile.gaps():
        for s, t in iv:
            idle += max(0.0, min(gt, t) - max(gs, s))
    return idle * 1e-3 / profile.n_units
