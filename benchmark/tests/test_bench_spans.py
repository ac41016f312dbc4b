"""The readers that join the program's span log to the trace
(spans.py, solve.device_idle_pct, solve.launches_per_iter,
kernels.launch_roofline_pct): hand-computed answers on a made-up run,
None where there is nothing to read, and the join on a real CPU
profiler run."""

import time

import pytest
import torch

from benchmark import cells, frozen, spans, tracing
from benchmark.run import Job, Run

H100 = "NVIDIA H100 80GB HBM3"
# the profiler's start on CLOCK_REALTIME in the made-up run
ORIGIN = 1_790_000_000_123_456_789


def _log(root_us, solves, delay_us=0.0):
    """A job's span log: a root span opening delay_us after its bench.job
    range starts at root_us (trace axis), "batched pair solve" spans at
    `solves`, each under "complete job"."""
    ns = lambda us: ORIGIN + round(us * 1000)   # noqa: E731
    start = root_us + delay_us
    log = [[0, None, "compute", ns(start), ns(start + 9000)],
           [1, 0, "complete job", ns(start + 10), ns(start + 8990)]]
    for k, (a, b) in enumerate(solves):
        log.append([2 + k, 1, "batched pair solve", ns(a), ns(b)])
    return log


def _run(trace=True, with_spans=True, bhw=True):
    """Two profiled jobs and one unprofiled one; job 0's root span opens
    10 us after its range, job 1's at once (so the origin is exact)."""
    logs = [_log(100.0, [(1000.0, 3000.0)], delay_us=10.0),
            _log(11000.0, [(12000.0, 13000.0)])]
    launches = [[["matvec", 32, 64, 64, 2]], [["matvec", 12, 64, 64, 1]]]
    jobs = []
    for k, (log, iters) in enumerate(zip(logs, (2, 6))):
        st = {"cg_iters": iters}
        if with_spans:
            st["spans"] = log
        if bhw:
            st["launches_bhw"] = launches[k]
        jobs.append(Job(k, 0.01, stats=st, profiled=True))
    jobs.append(Job(2, 0.01, stats={"cg_iters": 100, "spans": logs[0]}))
    tr = None
    if trace:
        device = [("k1", 1000.0, 1500.0), ("k2", 1400.0, 1800.0),
                  ("k3", 2500.0, 3500.0), ("k5", 5000.0, 5100.0),
                  ("k4", 12100.0, 12600.0)]
        tr = tracing.Trace((0.0, 21000.0), device, [],
                           [("0", 100.0, 10100.0), ("1", 11000.0, 20000.0)],
                           kernel_us={"matvec": 100.0},
                           kernel_count={"matvec": 3})
    return Run({}, {}, {"kind": H100}, 0.0, 1.0, 0, jobs, tr)


def _read(name, run):
    return cells.reader(name, True)(run)


def test_origin_and_spans_on_the_trace():
    run = _run()
    assert spans.origin_ns(run) == ORIGIN
    placed = dict((j.index, s) for j, s in spans.job_spans(run))
    assert set(placed) == {0, 1}            # the profiled jobs only
    root = next(s for s in placed[0] if s.name == "compute")
    assert root.start_us == pytest.approx(110.0)
    assert spans.named(run, "batched pair solve")[0] == [
        pytest.approx((1000.0, 3000.0)), pytest.approx((12000.0, 13000.0))]


def test_busy_union_and_starts():
    busy = spans.Busy([("a", 0.0, 10.0), ("b", 5.0, 20.0),
                       ("c", 30.0, 40.0)])
    assert busy.busy_us(0.0, 50.0) == 30.0
    assert busy.busy_us(8.0, 35.0) == 17.0
    assert busy.busy_us(20.0, 30.0) == 0.0
    assert busy.busy_us(12.0, 15.0) == 3.0
    assert busy.started(0.0, 5.0) == 1 and busy.started(5.0, 31.0) == 2


def test_solve_device_idle():
    # job 0: 1000-1800 and 2500-3000 busy of 2000 us; job 1: 500 of 1000
    assert _read("solve.device_idle_pct", _run()) == pytest.approx(
        100.0 * (1 - 1800.0 / 3000.0))


def test_solve_launches_per_iter():
    # k1, k2, k3 start in job 0's solve, k4 in job 1's; k5 in neither;
    # the profiled jobs' 2 + 6 iterations
    assert _read("solve.launches_per_iter", _run()) == pytest.approx(
        4 / 8)


def test_launch_roofline_takes_each_launch_batch():
    need = 2 * frozen.kernel_bytes("matvec", 32, 64, 64) + \
        frozen.kernel_bytes("matvec", 12, 64, 64)
    assert need == 2 * 4 * (2 * 32 + 5) * 4096 + 4 * (2 * 12 + 5) * 4096
    assert _read("kernels.launch_roofline_pct", _run()) == pytest.approx(
        100.0 * (need / 3.35e12) / 100e-6)
    # the chunk-width reader leaves this run out (no batch_width)
    assert _read("kernels.roofline_pct", _run()) is None


def test_launch_counts_must_match_the_trace():
    run = _run()
    run.trace.kernel_count = {"matvec": 4}
    assert _read("kernels.launch_roofline_pct", run) is None


@pytest.mark.parametrize("name", ["solve.device_idle_pct",
                                  "solve.launches_per_iter",
                                  "kernels.launch_roofline_pct"])
def test_nothing_to_read(name):
    assert _read(name, _run(trace=False)) is None
    # a program without the span log and the launch counter
    assert _read(name, _run(with_spans=False, bhw=False)) is None
    run = _run()
    run.card = {"kind": "cpu"}
    run.trace.device = []
    assert _read(name, run) is None


def test_overflowed_log_is_refused():
    """A job whose log dropped spans leaves every reader; with none left
    they read nothing."""
    run = _run()
    run.done[0].stats["spans_dropped"] = 3
    assert [j.index for j, _ in spans.profiled_jobs(run)] == [1]
    assert spans.origin_ns(run) == ORIGIN
    # job 1 alone: 500 of its 1000 us busy, k4 in its 6 iterations
    assert _read("solve.device_idle_pct", run) == pytest.approx(50.0)
    assert _read("solve.launches_per_iter", run) == pytest.approx(1 / 6)
    run.done[1].stats["spans_dropped"] = 1
    assert spans.origin_ns(run) is None
    assert _read("solve.device_idle_pct", run) is None
    assert _read("solve.launches_per_iter", run) is None


JOBS = 3
REPEATS = 5
ATTEMPTS = 5


def _profiled_jobs(cfg):
    """One profiled window of JOBS jobs, each with REPEATS pairs of a
    program span and a profiler range around one sleep: (origin's
    distance from the profiler's start in ns, {side: the closest pair's
    distance in us})."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.timer import CSTIMER

    prof = tracing.start()
    jobs = []
    with tracing.span(tracing.WINDOW_SPAN):
        for k in range(JOBS):
            with tracing.span(f"{tracing.JOB_SPAN} {k}"):
                cst.compute(cfg, device="cpu")
                for _ in range(REPEATS):
                    with torch.profiler.record_function("opens"), \
                            CSTIMER.span("opens"):
                        time.sleep(0.002)
                    with CSTIMER.span("closes"), \
                            torch.profiler.record_function("closes"):
                        time.sleep(0.002)
            jobs.append(Job(k, 0.0, stats=stats.finalize(), profiled=True))
    prof.stop()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    tr = tracing.read(prof)
    run = Run({}, {}, {"kind": "cpu"}, 0.0, 1.0, 0, jobs, tr)
    closest = {}
    for side, name in ((0, "opens"), (1, "closes")):
        theirs = sorted((s, t) for n, s, t in tr.host if n == name)
        mine = sorted(spans.named(run, name)[0])
        assert len(theirs) == len(mine) == JOBS * REPEATS
        closest[name] = min(abs(a[side] - b[side])
                            for a, b in zip(theirs, mine))
    return abs(spans.origin_ns(run) - start_ns), closest


def test_join_on_a_real_profiler_run(tmp_path, monkeypatch):
    """Jobs of the program under the harness's ranges: the recovered
    origin lies within 200 us of the profiler's own start, and a program
    span and a profiler range around one sleep agree within 200 us where
    they open (the range outside) and where they close (the span
    outside).  A loaded host stretches any one entry or exit, so each
    bound is held by the closest of the JOBS x REPEATS pairs (the origin,
    by the closest of the JOBS jobs, as spans.origin_ns takes it).  The
    profiler maps its timestamps onto CLOCK_REALTIME by a line through
    the window's two ends; a host that slews or steps CLOCK_REALTIME in
    the window (a virtual machine's clock sync) moves time.time_ns() off
    that line, so the window is taken again, up to ATTEMPTS times, and
    the bounds hold in one of them."""
    from chip_smoke import make_job

    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    cfg, _ = make_job(str(tmp_path), 48, 48, npoints=4)
    seen = []
    for _ in range(ATTEMPTS):
        origin, closest = _profiled_jobs(cfg)
        seen.append((origin, closest))
        if origin <= 200_000 and max(closest.values()) <= 200:
            break
    else:
        pytest.fail(f"no window within the bounds: {seen}")
