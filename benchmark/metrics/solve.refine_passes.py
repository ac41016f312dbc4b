"""solve.refine_passes: the float64 refinement passes a job ran, counted
from the program's "refinement pass" spans inside its "batched pair
solve" spans, mean per job.  A job whose log holds no such span (a
program that does not log the passes of this solve) leaves the metric
out."""

from benchmark import spans

PASS_SPAN = "refinement pass"


def _passes(log) -> int:
    by_id = {s[0]: s for s in log}

    def in_solve(s):
        while s[1] is not None and s[1] in by_id:
            s = by_id[s[1]]
            if s[2] == spans.SOLVE_SPAN:
                return True
        return False
    return sum(1 for s in log if s[2] == PASS_SPAN and in_solve(s))


def read(run):
    counts = [_passes(j.stats["spans"]) for j in run.span_jobs
              if spans.whole(j)]
    if not counts or 0 in counts:
        return None
    return sum(counts) / len(counts)
