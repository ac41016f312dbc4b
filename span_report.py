"""Where a benchmark cell's jobs spend their time, by the program's spans.

    python3 span_report.py --workload <name> --seed <n> [--seconds 51] \\
        [--out spans.jsonl]

Runs one traced run of the cell (benchmark/run.py's run_cell, on the
CUDA card; exit 2 without one) and, from its jobs' span logs
(stats.finalize()["spans"]) joined to the trace by benchmark/spans.py:

  idle_by_span     device-idle microseconds a profiled job inside its
                   root span, by the innermost span open at the time
  root_alone_pct   the share of that idle time under the root span alone
  kernels_in_pct   the share of the seven port kernels' device time that
                   lies inside the prepare and solve spans
  self_s           host seconds a job by span name, less the span's
                   children: the mean over every job of the window, and
                   (self_max_s) the most in any one job
  spans_per_job    spans in each job's log, and the cost of one span on
                   this host (a section timed 20000 times, empty)
  refused_jobs     jobs left out of all of the above because their log
                   overflowed its bound (stats "spans_dropped" above 0)
  graph            each job's CG iterations (stats "cg_iters"), the
                   CUDA graphs the loop captured and the iterations it
                   replayed ("graph_captures", "graph_replays"; None
                   where the program has no graph route) and the
                   replayed share in percent; the iterations whose body
                   carried a per-column penalty field ("pen_iters") and
                   their share; the iterations whose body ran the fused
                   glue kernels ("fused_iters"; None where the program
                   has no fused body) and their share
  passes           each job's "refinement pass" spans, by the span that
                   holds them ("batched pair solve" in every solve)

The spans of the one-to-all and advanced solves ("penalty fields", a
"refinement pass" per float64 pass) appear under their names in
idle_by_span_s and self_s like every other span.

Prints the report as one JSON line and writes it to --out.  The result
line of the run is in the report too (its per-layer metrics).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path[0] = ROOT

IN_SPANS = ("prepare stencil solver (upload + MG setup)",
            "batched pair solve")


def _depths(spans):
    by_id = {s.id: s for s in spans}

    def depth(s):
        d = 0
        while s.parent is not None and s.parent in by_id:
            s, d = by_id[s.parent], d + 1
        return d
    return {s.id: depth(s) for s in spans}


def idle_by_span(spans, busy):
    """{span name: device-idle us} inside the root span: each stretch
    between two span boundaries goes to the deepest span covering it."""
    depth = _depths(spans)
    root = min(spans, key=lambda s: depth[s.id])
    cuts = sorted({t for s in spans for t in (s.start_us, s.end_us)
                   if root.start_us <= t <= root.end_us})
    out = {}
    for a, b in zip(cuts, cuts[1:]):
        cover = [s for s in spans if s.start_us <= a and s.end_us >= b]
        inner = max(cover, key=lambda s: depth[s.id])
        idle = (b - a) - busy.busy_us(a, b)
        out[inner.name] = out.get(inner.name, 0.0) + idle
    return out


def kernel_us_inside(spans, device, names=IN_SPANS):
    """(us of the port kernels' device time inside spans called `names`,
    us of it in the job's root span)."""
    from benchmark import frozen, tracing
    depth = _depths(spans)
    root = min(spans, key=lambda s: depth[s.id])
    inside = [(s.start_us, s.end_us) for s in spans if s.name in names]
    got = tot = 0.0
    for name, a, b in device:
        m = tracing._KERNEL.search(name)
        if not (m and m.group(1) in frozen.KERNELS):
            continue
        if not root.start_us <= a < root.end_us:
            continue
        tot += b - a
        if any(s <= a < e for s, e in inside):
            got += b - a
    return got, tot


def self_seconds(log):
    """{name: host seconds less the children's} of one job's raw log."""
    kids = {}
    for i, p, _, a, b in log:
        kids[p] = kids.get(p, 0) + (b - a)
    out = {}
    for i, p, name, a, b in log:
        out[name] = out.get(name, 0.0) + (b - a - kids.get(i, 0)) / 1e9
    return out


def span_cost_us(n: int = 20000) -> float:
    """Microseconds of one empty section, every one of them kept in the
    log (a job of MAX_SPANS - 1 sections at a time)."""
    from circuitscape_tpu_torch.timer import MAX_SPANS, Timer
    t = Timer()
    dt, done = 0.0, 0
    while done < n:
        k = min(n - done, MAX_SPANS - 1)
        with t.job("cost"):
            t0 = time.perf_counter()
            for _ in range(k):
                with t("section"):
                    pass
            dt += time.perf_counter() - t0
        assert t.dropped == 0
        done += k
    return dt / n * 1e6


def graph_share(st: dict) -> dict:
    """A job's CG iterations, graph captures and replays, the replayed
    share of its iterations in percent, its penalty-body iterations and
    their share, and its iterations through the fused glue and their
    share."""
    its, replays = st.get("cg_iters"), st.get("graph_replays")
    pen, fused = st.get("pen_iters"), st.get("fused_iters")

    def pct(n):
        return 100.0 * n / its if its and n is not None else None
    return {"cg_iters": its, "graph_captures": st.get("graph_captures"),
            "graph_replays": replays, "replay_pct": pct(replays),
            "pen_iters": pen, "pen_pct": pct(pen),
            "fused_iters": fused, "fused_pct": pct(fused)}


def passes_by_parent(log) -> dict:
    """{parent span name: "refinement pass" spans under it} of one job's
    raw log."""
    names = {i: name for i, _, name, _, _ in log}
    out = {}
    for _, p, name, _, _ in log:
        if name == "refinement pass":
            out[names.get(p)] = out.get(names.get(p), 0) + 1
    return out


def report(run) -> dict:
    from benchmark import spans as sp
    busy = sp.Busy(run.trace.device)
    idle, got, tot = {}, 0.0, 0.0
    jobs = sp.job_spans(run)
    for _, spans in jobs:
        for name, us in idle_by_span(spans, busy).items():
            idle[name] = idle.get(name, 0.0) + us
        g, t = kernel_us_inside(spans, run.trace.device)
        got, tot = got + g, tot + t
    root_idle = idle.get(sp.ROOT_SPAN, 0.0)
    n = max(1, len(jobs))
    whole = [j for j in run.done if sp.whole(j)]
    selfs = [self_seconds(j.stats["spans"]) for j in whole]
    names = sorted({k for s in selfs for k in s})
    return {
        "profiled_jobs": len(jobs),
        "idle_by_span_s": {k: v / 1e6 / n for k, v in
                           sorted(idle.items(), key=lambda kv: -kv[1])},
        "root_alone_pct": (100.0 * root_idle / sum(idle.values())
                           if idle else None),
        "kernels_in_pct": 100.0 * got / tot if tot else None,
        "self_s": {k: sum(s.get(k, 0.0) for s in selfs) / len(selfs)
                   for k in names},
        "self_max_s": {k: max(s.get(k, 0.0) for s in selfs)
                       for k in names},
        "job_s": [j.seconds for j in whole],
        "spans_per_job": [len(j.stats["spans"]) for j in whole],
        "refused_jobs": len(run.done) - len(whole),
        "graph": [graph_share(j.stats) for j in whole],
        "passes": [passes_by_parent(j.stats["spans"]) for j in whole],
        "span_cost_us": span_cost_us(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    started = time.perf_counter()
    import torch

    from benchmark import cells, run as bench_run
    bench_run.quiet_environment(ROOT)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    seen = []

    class Captured(bench_run.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    bench_run.Run = Captured
    bench = cells.load_benchmark(ROOT)
    result, _ = bench_run.run_cell(ROOT, bench, args.workload, args.seed,
                                   args.seconds, True, "cuda", started)
    rec = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0),
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "correct": result["correct"], **report(seen[-1])}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
