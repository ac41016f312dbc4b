"""Hierarchical wall-clock timer, the TimerOutputs.jl equivalent, with a
log of the job's timestamped spans.

Parity reference: src/Circuitscape.jl:16 (global CSTIMER), src/run.jl:39-43
(reset per job, table printed at DEBUG level).  Thread-safe: sections are
keyed by path and guarded by a lock, replacing the reference's per-task
timer merge (src/core.jl:264,274-277).

Besides the table ({path: [ncalls, seconds]}), every section and every
`span` takes one entry of the span log when it starts and fills it when
it ends: (id, parent id, name, start_ns, end_ns).  The parent is the
innermost section or span open on the same thread when it started (None
at the top of a thread).  A `span` enters the log only, not the table,
so the table's paths never see it.  Timestamps are `time.time_ns()`
(CLOCK_REALTIME), the clock torch.profiler places its events on, so a
trace and the log can be joined.  `job` starts a job's log: it empties
the log and opens the root span.  The log keeps the first MAX_SPANS
spans of a job to start and counts the rest in `dropped`: the root span
is always kept, as is the parent of every span kept, and a reader that
needs the whole job refuses a log with `dropped` above 0.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

MAX_SPANS = 4096


class Timer:
    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()
        self.reset_spans()

    def reset(self):
        """Empties the table; the span log is `job`'s to reset."""
        with getattr(self, "_lock", threading.Lock()):
            self._data = {}  # path tuple -> [ncalls, total_seconds]

    def reset_spans(self):
        with self._lock:
            self._spans = []
            self.dropped = 0

    @contextmanager
    def job(self, name: str):
        """The root span of a job, on an emptied log."""
        self.reset_spans()
        with self.span(name):
            yield

    @contextmanager
    def span(self, name: str):
        """A span in the log only."""
        parents = getattr(self._local, "open", ())
        parent = parents[-1] if parents else None
        with self._lock:
            log = self._spans
            if len(log) < MAX_SPANS:
                sid = len(log)
                log.append(None)
            else:
                sid = None
                self.dropped += 1
        self._local.open = parents + (sid,)
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            self._local.open = parents
            if sid is not None:
                with self._lock:
                    log[sid] = (sid, parent, name, t0, t1)

    @contextmanager
    def __call__(self, name: str):
        stack = getattr(self._local, "stack", ())
        path = stack + (name,)
        self._local.stack = path
        t0 = time.perf_counter()
        try:
            with self.span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._local.stack = stack
            with self._lock:
                ent = self._data.setdefault(path, [0, 0.0])
                ent[0] += 1
                ent[1] += dt

    def spans(self) -> list:
        """The log: [id, parent id, name, start_ns, end_ns] per span
        that has ended, in the order the spans started."""
        with self._lock:
            return [list(s) for s in self._spans if s is not None]

    def table(self) -> str:
        with self._lock:
            items = sorted(self._data.items())
        lines = [f"{'section':<52s} {'ncalls':>8s} {'time':>12s}"]
        for path, (n, t) in items:
            indent = "  " * (len(path) - 1)
            lines.append(f"{indent + path[-1]:<52s} {n:>8d} {t:>11.4f}s")
        return "\n".join(lines)

    def total(self, name: str) -> float:
        with self._lock:
            return sum(t for p, (n, t) in self._data.items() if p[-1] == name)


CSTIMER = Timer()
