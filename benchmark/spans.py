"""The program's span log joined to a traced run's device timeline.

Each job's stats (stats.finalize()) carry its span log, `spans`: [id,
parent id, name, start_ns, end_ns] per span on CLOCK_REALTIME, the
clock torch.profiler places its events on; the root span ("compute")
covers the whole compute() call.  A Trace's times are microseconds from
the profiler's start, which it does not keep: `origin_ns` recovers it as
the smallest (root span start - its `bench.job` range's start) over the
profiled jobs, since the root span opens microseconds after that range.
A job whose log overflowed its bound (stats "spans_dropped" above 0) is
refused: its last spans to start are missing.  A program without a span
log (an older checkout) gives no spans, and the readers built on them
return None.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

ROOT_SPAN = "compute"
SOLVE_SPAN = "batched pair solve"


@dataclass
class Span:
    id: int
    parent: object      # parent id, None for the root
    name: str
    start_us: float     # on the trace's axis
    end_us: float


def _root(log):
    return next((s for s in log if s[1] is None and s[2] == ROOT_SPAN),
                None)


def whole(job) -> bool:
    """The job carries a span log with its root and nothing dropped."""
    return (_root(job.stats.get("spans") or ()) is not None and
            not job.stats.get("spans_dropped"))


def profiled_jobs(run):
    """[(job, (start_us, end_us) of its `bench.job` range)] of the
    profiled jobs that completed and carry a whole span log."""
    if run.trace is None:
        return []
    where = {name: (s, t) for name, s, t in run.trace.jobs}
    return [(j, where[str(j.index)]) for j in run.done
            if j.profiled and str(j.index) in where and whole(j)]


def origin_ns(run):
    """The profiler's start on CLOCK_REALTIME, in ns; None without a
    profiled job that has a span log."""
    gaps = [_root(j.stats["spans"])[3] - round(s * 1000)
            for j, (s, _) in profiled_jobs(run)]
    return min(gaps) if gaps else None


def job_spans(run):
    """[(job, [Span])] of the profiled jobs, their spans on the trace's
    axis."""
    origin = origin_ns(run)
    return [(j, [Span(i, p, name, (a - origin) / 1000, (b - origin) / 1000)
                 for i, p, name, a, b in j.stats["spans"]])
            for j, _ in profiled_jobs(run)]


def named(run, name: str):
    """[(start_us, end_us)] of every span called `name` in the profiled
    jobs, with the jobs that hold them: (intervals, jobs)."""
    out, jobs = [], []
    for j, spans in job_spans(run):
        mine = [(s.start_us, s.end_us) for s in spans if s.name == name]
        if mine:
            out += mine
            jobs.append(j)
    return out, jobs


class Busy:
    """The union of the device's operation intervals, for the busy time
    and the operations started inside any (a, b)."""

    def __init__(self, device):
        self.starts = sorted(s for _, s, _ in device)
        merged = []
        for s, e in sorted((s, e) for _, s, e in device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.lo = [m[0] for m in merged]
        self.hi = [m[1] for m in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + e - s)

    def busy_us(self, a: float, b: float) -> float:
        """Microseconds of (a, b) in which some operation ran."""
        if b <= a:
            return 0.0
        i = bisect.bisect_right(self.hi, a)        # first ending after a
        k = bisect.bisect_left(self.lo, b)         # first starting at b+
        if i >= k:
            return 0.0
        total = self.cum[k] - self.cum[i]
        total -= max(0.0, a - self.lo[i])
        total -= max(0.0, self.hi[k - 1] - b)
        return total

    def started(self, a: float, b: float) -> int:
        """Operations that started in [a, b)."""
        return (bisect.bisect_left(self.starts, b) -
                bisect.bisect_left(self.starts, a))
