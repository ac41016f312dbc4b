"""driver_rest_s: the rest of a job's "complete job" seconds once the
sections of load_graph_s, prepare_s, solve_s and maps_s are taken out
(components, node maps, nodemap inversion, anchor bookkeeping, shortcut
reconstruction, the resistance writer), mean per job."""

from benchmark import frozen

MEASURED = ("load raster data", "construct graph",
            "prepare stencil solver (upload + MG setup)",
            "batched pair solve", "fetch maps", "node currents + reduce",
            "write maps", "write cumulative current maps")


def read(run):
    jobs = run.span_jobs
    if not jobs:
        return None
    rest = [frozen.stage_seconds(j.sections, ("complete job",)) -
            frozen.stage_seconds(j.sections, MEASURED) for j in jobs]
    return sum(rest) / len(rest)
