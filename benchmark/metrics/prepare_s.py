"""prepare_s: seconds a job spends building the stencil operator and the
multigrid hierarchy (CSTIMER "prepare stencil solver (upload + MG
setup)"), mean per job."""

from benchmark import frozen

SECTIONS = ("prepare stencil solver (upload + MG setup)",)


def read(run):
    return frozen.mean_sections(run.span_jobs, SECTIONS)
