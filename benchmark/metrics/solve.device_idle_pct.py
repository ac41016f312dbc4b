"""solve.device_idle_pct: 100 x (1 - the union of the device's
operations inside the program's "batched pair solve" spans / those spans'
length), over the profiled jobs: how much of the solve loop the device
waits on the host (benchmark/spans.py joins the spans to the trace)."""

from benchmark import spans


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    solves, _ = spans.named(run, spans.SOLVE_SPAN)
    total = sum(b - a for a, b in solves)
    if total <= 0:
        return None
    busy = spans.Busy(run.trace.device)
    return 100.0 * (1.0 - sum(busy.busy_us(a, b) for a, b in solves) /
                    total)
