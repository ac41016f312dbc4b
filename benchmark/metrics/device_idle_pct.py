"""device_idle_pct: 100 x (1 - the union of the device's kernel, copy
and memset intervals / the profiled window), over the profiled jobs."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
