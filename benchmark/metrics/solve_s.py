"""solve_s: seconds a job spends in the batched pair solves (CSTIMER
"batched pair solve"), mean per job."""

from benchmark import frozen

SECTIONS = ("batched pair solve",)


def read(run):
    return frozen.mean_sections(run.span_jobs, SECTIONS)
