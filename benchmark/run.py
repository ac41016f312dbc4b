"""The benchmark of circuitscape_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

A run is a closed loop with one client, as a user's batch script runs
jobs: set-up writes the cell's inputs from the seed (benchmark/inputs.py)
and runs one warm-up job; then jobs run back to back through
circuitscape_tpu_torch.compute(cfg, "cuda") from their files on disk,
each on its own inputs, until --seconds have passed (the last job started
runs to its end).  After the window, a sample of the jobs drawn from the
seed is held against the plain reference (benchmark/reference/), which
decides `correct`.

With --trace 0 the result line holds the cell's end-to-end metrics; with
--trace 1 torch.profiler records the first whole jobs of the window and
the line holds the per-layer metrics, the device's busy seconds and a
breakdown.  The last line of standard output is the result; the last
lines of standard error are the numbers compared, each beside its limit.

Exits 2 without as many CUDA devices as the cell asks for (there is no
fallback to the CPU), 3 when JAX or the JAX package was loaded, 1 on any
other failure, each without a result line.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "circuitscape_tpu")
# the traced run profiles whole jobs until this share of the window, or
# this many seconds, has passed
TRACE_SECONDS = 6.0
TRACE_SHARE = 0.25


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return time.time() - (btime + start_ticks / os.sysconf("SC_CLK_TCK"))


def quiet_environment(root: str) -> None:
    """Default routing, and the compile caches in fixed directories of
    the checkout."""
    for k in [k for k in os.environ if k.startswith("CS_")]:
        del os.environ[k]
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build",
                                                      "torch_extensions")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info(device: str, chips: int) -> dict:
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "power_limit": None}
    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        power = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit": power}


@dataclass
class Job:
    index: int
    seconds: float
    sections: dict = field(default_factory=dict)   # CSTIMER {path: [n, s]}
    stats: dict = field(default_factory=dict)      # stats.finalize()
    launches_at: dict = field(default_factory=dict)
    profiled: bool = False
    error: str = ""


@dataclass
class Run:
    """What a metric's reader reads."""
    config: dict
    traffic: dict
    card: dict
    setup_s: float
    window_s: float
    peak_bytes: int
    jobs: list
    trace: object = None        # tracing.Trace of the profiled jobs

    @property
    def done(self):
        return [j for j in self.jobs if not j.error]

    @property
    def span_jobs(self):
        """Jobs whose host spans the profiler did not slow: the
        unprofiled ones where there are any."""
        quiet = [j for j in self.done if not j.profiled]
        return quiet or self.done


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _job(k, files, device, profiled=False) -> Job:
    """Job k through compute(), the program's spans and counters of it."""
    import circuitscape_tpu_torch as cst
    from benchmark import tracing
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil
    from circuitscape_tpu_torch.timer import CSTIMER

    cfg = files.job(k)[0]
    cuda_stencil.reset_launch_counts()
    job = Job(k, 0.0, profiled=profiled)
    ts = time.perf_counter()
    try:
        if profiled:
            with tracing.span(f"{tracing.JOB_SPAN} {k}"):
                cst.compute(cfg, device=device)
                _sync(device)
        else:
            cst.compute(cfg, device=device)
            _sync(device)
    except Exception:
        job.error = traceback.format_exc()
        log(f"job {k} failed:\n{job.error}")
    job.seconds = time.perf_counter() - ts
    job.sections = {p: list(v) for p, v in CSTIMER._data.items()}
    job.stats = stats.finalize()
    job.launches_at = dict(cuda_stencil.LAUNCHES_AT)
    log(f"job {k}: {job.seconds:.4f} s, cg_iters {job.stats.get('cg_iters')}")
    return job


def _window(files, seconds, device, trace):
    """Jobs back to back until `seconds` have passed, the last one run to
    its end; with `trace`, the profiler over the first whole jobs.
    Returns (jobs, window seconds, tracing.Trace or None)."""
    from benchmark import tracing

    jobs = []
    prof = tracing.start() if trace else None
    t0 = time.perf_counter()
    if trace:
        until = min(TRACE_SECONDS, TRACE_SHARE * seconds)
        with tracing.span(tracing.WINDOW_SPAN):
            while not jobs or time.perf_counter() - t0 < until:
                jobs.append(_job(len(jobs), files, device, True))
        prof.stop()
    while time.perf_counter() - t0 < seconds:
        jobs.append(_job(len(jobs), files, device))
    window_s = time.perf_counter() - t0
    return jobs, window_s, tracing.read(prof) if prof is not None else None


def _check(run: Run, files, seed: int, device: str, limits: dict):
    """The sampled jobs against the reference: (correct, check rows)."""
    import numpy as np

    from benchmark import check, inputs

    kinds = run.traffic["compare"]
    done = [j.index for j in run.done]
    rng = np.random.default_rng(inputs.seed_words(seed, 2))
    picked = done[-1:]
    rest = done[:-1]
    n_more = min(len(rest), run.config["check_jobs"] - len(picked))
    if n_more > 0:
        picked += sorted(rng.choice(rest, n_more, replace=False).tolist())
    ref_mod = check.reference(run.config["reference"])
    unread = {n: float("inf") for kind in kinds for n in check.NAMES[kind]}
    readings = []
    for k in picked:
        _, habitat, points = files.job(k)
        t = time.perf_counter()
        ref = ref_mod.pairwise(habitat, points, device=device,
                               maps="cum_curmap" in kinds,
                               **check.graph_options(run.config))
        try:
            got = check.read_outputs(ref_mod, files.output_dir(k), kinds)
            readings.append(check.compare(got, ref, kinds))
        except (OSError, ValueError) as e:
            log(f"job {k}: its answers cannot be read: {e}")
            readings.append(unread)
        log(f"reference of job {k}: {time.perf_counter() - t:.3f} s, "
            f"{ref['iters']} PCG iterations, relres {ref['relres']:.3e}")
    ok, rows = check.judge(check.worst(readings) if readings else unread,
                           limits)
    return ok and len(done) == len(run.jobs) and bool(done), rows


def run_cell(root: str, bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str, started: float, base: str = None):
    """One run of the cell `name`; returns (result dict, check rows)."""
    import torch

    import circuitscape_tpu_torch as cst
    from benchmark import cells, inputs, tracing

    base = base or os.path.join(root, "benchmark")
    w = cells.workload(bench, name)
    config = cells.config(bench, root, w["config"])
    traffic = cells.traffic(w["traffic"], base)
    limits = dict(traffic["limits"], **config.get("limits", {}))
    card = card_info(device, w["chips"])
    print(f"# card: {card['kind']}, count {card['count']}, power limit "
          f"{card['power_limit']}", flush=True)

    tmp = tempfile.mkdtemp(prefix="cs-bench-")
    try:
        files = inputs.JobInputs(tmp, config, traffic, seed, base)
        try:
            cst.compute(files.job(inputs.WARM)[0], device=device)
            _sync(device)
        except Exception:
            log(f"warm-up job failed:\n{traceback.format_exc()}")
        gc.collect()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - started
        log(f"set-up {setup_s:.3f} s; window of {seconds} s")

        jobs, window_s, tr = _window(files, seconds, device, trace)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        log(f"window {window_s:.3f} s: {len(jobs)} jobs")
        run = Run(config, traffic, card, setup_s, window_s, peak, jobs, tr)

        def read(per_layer):
            out = {}
            for m in cells.metrics(bench, name, per_layer):
                v = cells.reader(m["name"], per_layer, base)(run)
                if v is not None:
                    out[m["name"]] = {"value": v, "unit": m["unit"]}
            return out

        metrics = read(trace)
        if not trace:   # the layers' spans of the untraced window, logged
            log("layers (untraced): " + json.dumps(
                {k: v["value"] for k, v in read(True).items()}))

        # the program's state goes before the reference runs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ok, rows = _check(run, files, seed, device, limits)

        device_rec = {"platform": card["platform"], "kind": card["kind"],
                      "count": card["count"], "memory_peak_bytes": peak}
        result = {"correct": ok, "attempted": len(jobs),
                  "failed": len(jobs) - len(run.done), "metrics": metrics,
                  "device": device_rec}
        if trace:
            device_rec["busy_s"] = tr.busy_s
            device_rec["window_s"] = tr.window_s
            result["breakdown"] = tracing.breakdown(tr)
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, v, lim in rows}
        return result, rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        started = time.perf_counter() - process_seconds()
    except (OSError, ValueError, StopIteration):
        started = time.perf_counter()
    quiet_environment(ROOT)

    import torch

    from benchmark import cells
    bench = cells.load_benchmark(ROOT)
    chips = cells.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" found")
        return 2
    result, rows = run_cell(ROOT, bench, args.workload, args.seed,
                            args.seconds, bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        log(f"benchmark: loaded {', '.join(found)}: no run may load JAX "
            f"or the JAX package")
        return 3
    for k, v, lim in rows:
        log(f"check {k}: {v!r} (limit {lim!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
