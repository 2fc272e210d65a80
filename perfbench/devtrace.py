"""The traced sub-window, read from torch.profiler's events: device
activity (kernels, copies, sets), its union (`busy_s`), the window
(`window_s`: the span `perfbench.traced`, which ends after a synchronize),
kernel time by name, and the idle gaps with what the host was doing in
each (`tools/measure.py`'s device-side events, here merged into a union
rather than summed, so overlapping work counts once)."""
from __future__ import annotations

from collections import defaultdict

WINDOW_SPAN = "perfbench.traced"
# copies and sets are device activity but not kernels
NOT_KERNELS = ("memcpy", "memset")


class Profile:
    def __init__(self, events, n_units: int):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.n_units = n_units
        self.device = []   # (name, start, end) in µs
        self.host = []
        for e in events:
            r = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == cuda:
                # the device-side copies of the benchmark's own ranges
                # (`perfbench.*`) are annotations, not work
                if not (e.name.startswith("perfbench.")
                        or "Buffer Request" in e.name):
                    self.device.append(r)
            else:
                self.host.append(r)
        span = [h for h in self.host if h[0] == WINDOW_SPAN]
        self.start, self.end = span[0][1], span[0][2]
        self.device = [(n, max(s, self.start), min(t, self.end))
                       for n, s, t in self.device if t > self.start
                       and s < self.end]
        self.intervals = _union([(s, t) for _, s, t in self.device])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.intervals) * 1e-6

    def kernels(self, part: str = "") -> list:
        """(name, seconds) of each device kernel whose name holds `part`,
        copies and sets left out."""
        return [(n, (t - s) * 1e-6) for n, s, t in self.device
                if part in n and not n.lower().startswith(NOT_KERNELS)]

    def gaps(self) -> list:
        """(start, end) in µs of each stretch of the window with no device
        activity, longest first."""
        edges = [self.start] + [x for iv in self.intervals for x in iv] \
            + [self.end]
        out = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
               if edges[i + 1] > edges[i]]
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_at(self, t: float) -> str:
        """What the host was doing at `t`: the innermost operation under
        way, with the benchmark's span around it; between operations (the
        program's own Python), the operation it had last ended."""
        under = [h for h in self.host if h[1] <= t <= h[2]
                 and h[0] != WINDOW_SPAN]
        outer = [h[0] for h in under if h[0].startswith("perfbench.")]
        under = [h for h in under if not h[0].startswith("perfbench.")]
        if under:
            what = min(under, key=lambda h: h[2] - h[1])[0]
        else:
            before = [h for h in self.host if h[2] < t
                      and not h[0].startswith("perfbench.")]
            what = ("python after " + max(before, key=lambda h: h[2])[0]
                    if before else "python")
        return " / ".join(outer[:1] + [what])

    def breakdown(self) -> dict:
        per = defaultdict(float)
        for n, s, t in self.device:
            per[short(n)] += (t - s) * 1e-6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
        gaps = [[self.host_at(0.5 * (s + t)), (t - s) * 1e-6]
                for s, t in self.gaps()[:10]]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": gaps}


def _union(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [tuple(iv) for iv in out]


def short(name: str) -> str:
    """A kernel's name without `void` and its argument list."""
    if not name.startswith("void "):
        return name
    name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i]
    return name
