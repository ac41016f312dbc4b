"""Hierarchical wall-clock timer, the TimerOutputs.jl equivalent.

Parity reference: src/Circuitscape.jl:16 (global CSTIMER), src/run.jl:39-43
(reset per job, table printed at DEBUG level).  Thread-safe: sections are
keyed by path and guarded by a lock, replacing the reference's per-task
timer merge (src/core.jl:264,274-277).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Timer:
    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self):
        with getattr(self, "_lock", threading.Lock()):
            self._data = {}  # path tuple -> [ncalls, total_seconds]

    @contextmanager
    def __call__(self, name: str):
        stack = getattr(self._local, "stack", ())
        path = stack + (name,)
        self._local.stack = path
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._local.stack = stack
            with self._lock:
                ent = self._data.setdefault(path, [0, 0.0])
                ent[0] += 1
                ent[1] += dt

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
