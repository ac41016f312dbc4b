"""What a traced run reads from torch.profiler: the device's operations
(kernels, copies, memsets), the host ops recorded beside them, and the
harness's own spans around the profiled jobs."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import frozen

WINDOW_SPAN = "bench.window"
JOB_SPAN = "bench.job"
_KERNEL = re.compile(r"::(\w+)_kernel\b")


@dataclass
class Trace:
    window_us: tuple            # (start, end) of the profiled jobs
    device: list                # [(name, start_us, end_us)]
    host: list                  # [(name, start_us, end_us)], top-level ops
    jobs: list                  # [(job index, start_us, end_us)]
    busy_s: float = 0.0
    kernel_us: dict = field(default_factory=dict)     # wrapper -> us
    kernel_count: dict = field(default_factory=dict)  # wrapper -> launches

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def span(name: str):
    import torch
    return torch.profiler.record_function(name)


def read(prof) -> Trace:
    """The Trace of a stopped profiler."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, jobs = [], [], []
    window = None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        ours = e.name.startswith("bench.")
        if e.device_type == cuda:
            if not ours:     # the spans' own annotation of the timeline
                device.append((e.name, s, t))
        elif e.name == WINDOW_SPAN:
            window = (s, t)
        elif e.name.startswith(JOB_SPAN):
            jobs.append((e.name[len(JOB_SPAN) + 1:], s, t))
        elif (e.cpu_parent is None or
              e.cpu_parent.name.startswith("bench.")):
            host.append((e.name, s, t))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window
    device = [(n, max(s, lo), min(t, hi)) for n, s, t in device
              if t > lo and s < hi]
    tr = Trace(window, device, host, sorted(jobs, key=lambda j: j[1]))
    tr.busy_s = frozen.busy_us([(s, t) for _, s, t in device]) / 1e6
    for name, s, t in device:
        m = _KERNEL.search(name)
        if m and m.group(1) in frozen.KERNELS:
            k = m.group(1)
            tr.kernel_us[k] = tr.kernel_us.get(k, 0.0) + (t - s)
            tr.kernel_count[k] = tr.kernel_count.get(k, 0) + 1
    return tr


def idle_gaps(tr: Trace):
    """[(start_us, end_us)] of the window where no device operation ran."""
    gaps = []
    at = tr.window_us[0]
    for _, s, t in sorted(tr.device, key=lambda d: d[1]):
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if tr.window_us[1] > at:
        gaps.append((at, tr.window_us[1]))
    return gaps


def _label(tr: Trace, a: float, b: float) -> str:
    """What the host did during (a, b), by the job it fell in and the
    recorded torch op that overlaps it most; where recorded ops cover
    under half of it, the host ran Python and numpy code the profiler
    does not record."""
    job = max(tr.jobs, key=lambda j: min(b, j[2]) - max(a, j[1]),
              default=("?",))[0]
    best, cover = None, 0.0
    for name, s, t in tr.host:
        ov = min(b, t) - max(a, s)
        if ov > cover:
            best, cover = name, ov
    if cover < 0.5 * (b - a):
        return f"job {job}: untraced host code"
    return f"job {job}: {best}"


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type, cut to `limit` letters."""
    if name.startswith("void "):
        name = name[5:]
    return name if len(name) <= limit else name[:limit - 3] + "..."


def breakdown(tr: Trace, top: int = 10):
    """The device operations that took the most time, and the longest idle
    gaps labelled by the host's recorded activity, in seconds."""
    by_name = {}
    for name, s, t in tr.device:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (t - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(tr), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[_label(tr, a, b), (b - a) / 1e6]
                          for a, b in gaps]}
