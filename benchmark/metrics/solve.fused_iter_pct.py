"""solve.fused_iter_pct: 100 x the CG iterations whose body ran the fused
glue kernels (the program's stats counter fused_iters) / its CG
iterations (stats cg_iters), mean per job.  A job without the counter
(a program without the fused body) leaves the metric out."""


def read(run):
    pcts = []
    for j in run.span_jobs:
        fused, iters = j.stats.get("fused_iters"), j.stats.get("cg_iters")
        if fused is None or not iters:
            return None
        pcts.append(100.0 * fused / iters)
    return sum(pcts) / len(pcts) if pcts else None
