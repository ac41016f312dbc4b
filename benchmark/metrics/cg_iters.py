"""cg_iters: device CG iterations of a job, over all its chunks and
refinement passes (the program's stats counter cg_iters), mean per job."""


def read(run):
    its = [j.stats.get("cg_iters") for j in run.span_jobs]
    if not its or None in its:
        return None
    return sum(its) / len(its)
