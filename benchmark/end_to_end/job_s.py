"""job_s: the window's wall time over the jobs completed in it (whole
jobs, back to back; host clock)."""


def read(run):
    if not run.done or len(run.done) != len(run.jobs):
        return None
    return run.window_s / len(run.jobs)
