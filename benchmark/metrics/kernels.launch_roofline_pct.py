"""kernels.launch_roofline_pct: the port's seven stencil kernels against
their byte bound, as kernels.roofline_pct reads them, with each launch's
own batch B: sum over their launches in the profiled jobs of the bytes
each must move (frozen.kernel_bytes at the launch's (B, H, W), from the
program's per-launch counter, stats `launches_bhw`) over the card's peak
memory rate, divided by the device time the profiler gave those
launches.  A job without the counter, a card without a known peak, or
launch counts that differ from the trace's leave the metric out."""

import sys

from benchmark import frozen


def read(run):
    tr = run.trace
    rate = frozen.peak_bytes_per_s(run.card["kind"])
    if tr is None or rate is None or not tr.kernel_us:
        return None
    need, launches = 0, {}
    for j in run.done:
        if not j.profiled:
            continue
        if j.stats.get("launches_bhw") is None:
            return None
        for name, B, H, W, n in j.stats["launches_bhw"]:
            need += n * frozen.kernel_bytes(name, B, H, W)
            launches[name] = launches.get(name, 0) + n
    if {k: v for k, v in launches.items() if v} != tr.kernel_count:
        print(f"kernels.launch_roofline_pct: launches {launches} against "
              f"the trace's {tr.kernel_count}", file=sys.stderr)
        return None
    return 100.0 * (need / rate) / (sum(tr.kernel_us.values()) / 1e6)
