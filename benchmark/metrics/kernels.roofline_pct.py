"""kernels.roofline_pct: the port's seven stencil kernels against their
byte bound: sum over their launches in the profiled jobs of the bytes
each must move (frozen.kernel_bytes) over the card's peak memory rate,
divided by the device time the profiler gave those launches.

A launch's (H, W) comes from the program's LAUNCHES_AT counter; its batch
B is the job's chunk width padded to a power of two, which is exact only
where every chunk of the job had that width (col_iters == B x cg_iters).
A job with chunks of several widths, a card without a known peak, or
launch counts that differ from the trace's leave the metric out."""

import sys

from benchmark import frozen


def _pow2(n):
    return 1 << max(0, n - 1).bit_length()


def read(run):
    tr = run.trace
    rate = frozen.peak_bytes_per_s(run.card["kind"])
    if tr is None or rate is None or not tr.kernel_us:
        return None
    need, launches = 0, {}
    for j in run.done:
        if not j.profiled:
            continue
        st = j.stats
        if not st.get("batch_width") or not st.get("cg_iters"):
            return None
        B = _pow2(int(st["batch_width"]))
        if st.get("col_iters") != B * st["cg_iters"]:
            return None
        for (name, H, W), n in j.launches_at.items():
            need += n * frozen.kernel_bytes(name, B, H, W)
            launches[name] = launches.get(name, 0) + n
    if {k: v for k, v in launches.items() if v} != tr.kernel_count:
        print(f"kernels.roofline_pct: launches {launches} against the "
              f"trace's {tr.kernel_count}", file=sys.stderr)
        return None
    return 100.0 * (need / rate) / (sum(tr.kernel_us.values()) / 1e6)
