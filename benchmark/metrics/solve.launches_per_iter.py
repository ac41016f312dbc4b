"""solve.launches_per_iter: device operations (kernels, copies, memsets)
that start inside the program's "batched pair solve" spans, over the
profiled jobs, per CG iteration of those jobs (their stats counter
cg_iters)."""

from benchmark import spans


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    solves, jobs = spans.named(run, spans.SOLVE_SPAN)
    iters = sum(j.stats.get("cg_iters") or 0 for j in jobs)
    if not iters:
        return None
    busy = spans.Busy(run.trace.device)
    return sum(busy.started(a, b) for a, b in solves) / iters
