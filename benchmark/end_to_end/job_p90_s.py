"""job_p90_s: the 90th percentile of every job's wall time in the window
(host clock; statistics.quantiles, the exclusive method)."""

import statistics


def read(run):
    times = [j.seconds for j in run.jobs]
    if len(times) < 10 or len(run.done) != len(run.jobs):
        return None
    return statistics.quantiles(times, n=10)[8]
