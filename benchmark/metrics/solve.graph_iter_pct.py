"""solve.graph_iter_pct: 100 x the CG iterations a job ran as a replayed
CUDA graph (the program's stats counter graph_replays) / its CG
iterations (stats cg_iters), mean per job.  A job without the counter
(a program without the graph route) leaves the metric out."""


def read(run):
    pcts = []
    for j in run.span_jobs:
        replays, iters = j.stats.get("graph_replays"), j.stats.get("cg_iters")
        if replays is None or not iters:
            return None
        pcts.append(100.0 * replays / iters)
    return sum(pcts) / len(pcts) if pcts else None
