"""Benchmark suite of circuitscape_tpu_torch: bench_suite.py's table
through the port.

    python3 bench_suite_torch.py                # on the CUDA device
    python3 bench_suite_torch.py --device cpu   # the same rows on the CPU
    CS_SUITE_SIZES=200 CS_SUITE_SCENARIOS=shortcut,onetoall \\
        python3 bench_suite_torch.py --device cpu --out /tmp/suite.json

Every row runs end to end through the public compute(cfg, device)
surface on the synthetic problems of bench_suite.py (uniform(0.5, 3)
conductances, ~10% NODATA, scattered focal points), drawn from one
default_rng(42) in bench_suite.py's scenario order, so that at the same
sizes the port reads byte for byte the files bench_suite.py writes:

  shortcut     pairwise, shortcut mode, 32 points, at each size
               (default 1000, 2450, 3465: 1M, 6M and 12M cells);
  maps         pairwise with current, max and voltage maps, 16 points;
  cholmod      the direct tier (solver = cholmod, double) at 1000^2;
  onetoall     one-to-all, 32 points;
  advanced     64 sources, 64 grounds, current maps;
  network      the 100,000-node lattice, 20 focal nodes, 190 pairs, with
               the default routing (the host Cholesky) and again with
               CS_NETWORK_DIRECT_MAX=0 (the iterative tier);
  provisioned  a fresh process that times the CUDA context, one that
               runs warmup.warmup of the shortcut job, and a fresh one
               that runs the job, at each size;
  spmv         cuda_stencil.matvec (matvec_kernel, the CG loop's
               hand-written kernel) at 1000^2, B = 32, beside its byte
               bound.

Per record: cold_s (the first compute() of the job in this process:
kernel library load, CUDA context and allocator growth included) and
warm_s (the second), each run synchronized (chip_smoke.time_job), the
stats of each run (cold_run, warm_run: CG iterations, MG kernel routes,
peak device memory, seconds per stage with each timer second counted
once), vs_* ratios against the reference's published 20-core Xeon
timings (docs/src/benchmark/plot.jl:7-9), the device and the card's
name and power limit as nvidia-smi gives them (null on the CPU).

CS_SUITE_SIZES and CS_SUITE_SCENARIOS filter as in bench_suite.py;
CS_SUITE_APPEND=1 appends to the output file's records.  Writes
BENCH_SUITE_TORCH.json (or --out) after every row and prints one JSON
line per record at the end.  A failing row is recorded (scenario
"FAILED", the error) and the suite goes on; the exit code is then 1.
Without a CUDA device the script exits 2 unless --device cpu is given:
there is no fallback to the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# BASELINE.md rows: cells -> (julia CG+AMG seconds, julia CHOLMOD seconds)
BASELINES = {
    1_000_000: (106.40, 89.60),
    6_002_500: (1217.90, 543.06),
    12_006_225: (2337.55, 1124.28),
}
# grid sides: 1M / ~6M / ~12M cells
ALL_SIZES = [1000, 2450, 3465]
SCENARIOS = ("shortcut", "maps", "cholmod", "onetoall", "advanced",
             "network", "provisioned", "spmv")
OUT = "BENCH_SUITE_TORCH.json"

# the port's timer sections (timer.CSTIMER) that make up each stage; a
# section nested under another section of any stage is not added again
STAGE_SECTIONS = {
    "setup_s": ("prepare stencil solver (upload + MG setup)",
                "invert nodemap", "construct local nodemap",
                "construct preconditioner/factorization"),
    "solve_s": ("batched pair solve", "solve and accumulate pairs"),
    "output_s": ("write maps", "fetch maps", "node currents + reduce",
                 "postprocess", "write cumulative current maps",
                 "write cumulative currents"),
}
PRECISION_NOTE = ("single-precision inner iterations, refined to true f64 "
                  "relres <= 1e-6")


def note(msg):
    print(msg, file=sys.stderr, flush=True)


# --- recipes: bench_suite.py's inputs, one builder per scenario ----------

def make_raster(d, rng, side, npts):
    g = rng.uniform(0.5, 3.0, (side, side))
    g[rng.random((side, side)) < 0.10] = -9999.0
    np.save(os.path.join(d, "cell.npy"), g)
    pts = np.zeros((side, side))
    placed = 0
    while placed < npts:
        r, c = rng.integers(0, side, 2)
        if g[r, c] > 0 and pts[r, c] == 0:
            placed += 1
            pts[r, c] = placed
    np.save(os.path.join(d, "pts.npy"), pts)
    return g, pts


def _raster_cfg(d, scenario="pairwise", point_file="pts.npy", **kw):
    cfg = {
        "data_type": "raster", "scenario": scenario,
        "habitat_file": f"{d}/cell.npy",
        "habitat_map_is_resistances": "False",
        "point_file": f"{d}/{point_file}",
        "output_file": f"{d}/o.out",
        "solver": "cg+amg", "precision": "single",
        "suppress_messages": "True",
    }
    cfg.update(kw)
    return cfg


def shortcut_job(d, rng, side, points=32):
    """Pairwise in shortcut mode (bench_suite.py's pairwise-shortcut and
    provisioned-cold rows)."""
    make_raster(d, rng, side, points)
    return _raster_cfg(d)


def maps_job(d, rng, side, points=32):
    """Pairwise with the first half of the points and per-pair current
    and voltage maps, the cumulative and the max current map."""
    _, pts = make_raster(d, rng, side, points)
    np.save(f"{d}/pts16.npy", np.where(pts <= points // 2, pts, 0))
    return _raster_cfg(d, point_file="pts16.npy", write_cur_maps="True",
                       write_max_cur_maps="True", write_volt_maps="True")


def cholmod_job(d, rng, side=1000, points=32):
    """Pairwise on the direct tier in double precision."""
    make_raster(d, rng, side, points)
    return _raster_cfg(d, solver="cholmod", precision="double")


def onetoall_job(d, rng, side, points=32):
    make_raster(d, rng, side, points)
    return _raster_cfg(d, scenario="one-to-all")


def advanced_job(d, rng, side, sources=64, grounds=64):
    """Unit sources, then grounds (alternately 1 and 0 conductance), on
    habitat cells, current maps."""
    g, _ = make_raster(d, rng, side, 2)
    src = np.zeros((side, side))
    gnd = np.full((side, side), -9999.0)
    placed = 0
    while placed < sources + grounds:
        r, c = rng.integers(0, side, 2)
        if g[r, c] > 0 and src[r, c] == 0 and gnd[r, c] == -9999:
            placed += 1
            if placed <= sources:
                src[r, c] = 1.0
            else:
                gnd[r, c] = 1.0 if placed % 2 else 0.0
    np.save(f"{d}/src.npy", src)
    np.save(f"{d}/gnd.npy", gnd)
    cfg = _raster_cfg(d, scenario="advanced", source_file=f"{d}/src.npy",
                      ground_file=f"{d}/gnd.npy",
                      ground_file_is_resistances="False",
                      write_cur_maps="True")
    del cfg["point_file"]
    return cfg


def lattice_edges(n):
    """Edges of network_job's lattice on n nodes."""
    side = int(np.sqrt(n))
    return (n - 1) + (n - side)


def network_job(d, rng, n=100_000, focal=20):
    """An n-node lattice (node i joined to i + 1 and i + isqrt(n)) with
    uniform(0.5, 3) conductances and `focal` focal nodes."""
    side = int(np.sqrt(n))
    i0 = np.arange(n)
    E = []
    for off in (1, side):
        m = i0 + off < n
        E.append(np.column_stack([i0[m], (i0 + off)[m]]))
    E = np.vstack(E)
    w = rng.uniform(0.5, 3.0, len(E))
    np.savetxt(f"{d}/net.txt", np.column_stack([E[:, 0], E[:, 1], w]),
               fmt="%.6g")
    fp = rng.choice(n, focal, replace=False)
    np.savetxt(f"{d}/fp.txt", fp, fmt="%d")
    return {
        "data_type": "network", "scenario": "pairwise",
        "habitat_file": f"{d}/net.txt",
        "habitat_map_is_resistances": "False",
        "point_file": f"{d}/fp.txt",
        "output_file": f"{d}/n.out",
        "solver": "cg+amg", "precision": "single",
        "suppress_messages": "True",
    }


# --- per-run stats and checks --------------------------------------------

def stage_seconds(sections):
    """{stage: seconds} from a timer's {path: [calls, seconds]}: each
    section of STAGE_SECTIONS adds its seconds to its stage unless a
    section of any stage encloses it (its seconds are already counted)."""
    owner = {s: stage for stage, names in STAGE_SECTIONS.items()
             for s in names}
    out = {}
    for path, (_, secs) in sections.items():
        stage = owner.get(path[-1])
        if stage and not any(p in owner for p in path[:-1]):
            out[stage] = out.get(stage, 0.0) + secs
    return out


def job_stats(device):
    """The stats of the job that just ran: bench_suite.py's fields less
    sustained_nnz_per_s, its refinement passes,
    batch width and hierarchy build where it has them, peak device
    memory since the last reset (cuda), and stages in seconds."""
    import torch
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.timer import CSTIMER
    d = stats.finalize()
    rec = {k: d[k] for k in (
        "cg_iters", "mg_kernels", "pass_iters", "batch_width",
        "mg_build") if k in d}
    if torch.device(device).type == "cuda":
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    stages = job_stages(dict(CSTIMER._data))
    if stages:
        rec["stages"] = stages
    return rec


def job_stages(sections):
    """stage_seconds of one job's timer sections, with the rest of its
    "complete job" seconds (IO load, graph build, components, the Python
    driver) as other_s and the whole as total_s."""
    stages = stage_seconds(sections)
    total = sum(t for p, (_, t) in sections.items()
                if p == ("complete job",))
    if total:
        stages["other_s"] = total - sum(stages.values())
        stages["total_s"] = total
    return stages


def check_pairwise(r, n, label):
    from chip_smoke import check_resistances
    check_resistances(np.asarray(r), label, n=n)


def check_onetoall(r, n, label):
    """(point id, resistance) rows: n of them, finite and positive."""
    r = np.asarray(r)
    if r.shape != (n, 2) or not np.all(np.isfinite(r[:, 1])) or \
            not np.all(r[:, 1] > 0):
        raise AssertionError(f"{label}: one-to-all results {r!r}")


def check_advanced(v, cfg, label):
    """Voltages finite and >= 0 on habitat, a current map written."""
    v = np.asarray(v)
    g = np.load(cfg["habitat_file"])
    on = g > 0
    if v.shape != g.shape or not np.all(np.isfinite(v[on])) or \
            not v[on].min() >= -1e-6 * v[on].max():
        raise AssertionError(f"{label}: voltages not finite and >= 0")
    cur = cfg["output_file"][:-4] + "_curmap.asc"
    if not os.path.exists(cur):
        raise AssertionError(f"{label}: no current map {cur}")


def check_maps(r, cfg, label):
    """16 x 16 resistances; 120 per-pair current maps, 120 per-pair
    voltage maps, the cumulative and the max current map."""
    check_pairwise(r, 16, label)
    d, stem = os.path.split(cfg["output_file"][:-4])
    names = os.listdir(d)
    cur = [f for f in names if f.startswith(f"{stem}_curmap_")]
    volt = [f for f in names if f.startswith(f"{stem}_voltmap_")]
    summary = {f"{stem}_cum_curmap.asc", f"{stem}_max_curmap.asc"}
    if len(cur) != 120 or len(volt) != 120 or not summary <= set(names):
        raise AssertionError(f"{label}: {len(cur)} current maps, "
                             f"{len(volt)} voltage maps, summary maps "
                             f"{sorted(summary & set(names))}")


def check_network(r, cfg, label):
    """20 x 20 resistances, and the resistances file holding the same
    pairs."""
    check_pairwise(r, 20, label)
    path = cfg["output_file"][:-4] + "_resistances.out"
    f = np.loadtxt(path)
    if f.shape != np.shape(r) or not np.allclose(f, r, rtol=1e-6,
                                                 atol=0.0):
        raise AssertionError(f"{label}: {path} does not hold the returned "
                             f"resistances")


def run_cold_warm(name, cfg, device, check):
    """Two compute(cfg, device) runs in this process (chip_smoke.time_job:
    synchronized, launch counters zeroed before each); each run's result
    goes through check.  Returns (cold s, warm s, [stats of each run])."""
    import torch
    from chip_smoke import time_job
    cuda = torch.device(device).type == "cuda"
    per_run = []

    def after(r):
        check(r)
        per_run.append(job_stats(device))
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _, times, _, _, _ = time_job(dict(cfg), 2, device, f"  {name}", note,
                                 after=after)
    return times[0], times[1], per_run


def cold_warm_record(scenario, cold, warm, runs, **kw):
    return {"scenario": scenario, **kw, "cold_s": cold, "warm_s": warm,
            "cold_run": runs[0], "warm_run": runs[1]}


# --- rows -----------------------------------------------------------------

def row_shortcut(rng, side, device):
    with tempfile.TemporaryDirectory() as d:
        cfg = shortcut_job(d, rng, side)
        note(f"pairwise-shortcut {side}x{side}")
        cold, warm, st = run_cold_warm(
            "pairwise-shortcut", cfg, device,
            lambda r: check_pairwise(r, 32, f"shortcut {side}"))
    rec = cold_warm_record("pairwise-shortcut", cold, warm, st,
                           cells=side * side, points=32,
                           note=PRECISION_NOTE)
    if side * side in BASELINES:
        cg, chol = BASELINES[side * side]
        rec.update(baseline_julia_cgamg_s=cg, baseline_julia_cholmod_s=chol,
                   vs_cholmod_warm=chol / warm, vs_cholmod_cold=chol / cold)
    return rec


def row_maps(rng, side, device):
    with tempfile.TemporaryDirectory() as d:
        cfg = maps_job(d, rng, side)
        note(f"pairwise-maps {side}x{side}")
        cold, warm, st = run_cold_warm(
            "pairwise-maps", cfg, device,
            lambda r: check_maps(r, cfg, f"maps {side}"))
    cg, _ = BASELINES[1_000_000]
    # the reference's published 1M-cell numbers are the closest baseline
    # (BigTests pairwise writes cumulative maps; per-pair map files are
    # extra work on both sides)
    return cold_warm_record("pairwise-maps+volt+max", cold, warm, st,
                            cells=side * side, points=16,
                            baseline_julia_cgamg_s=cg,
                            vs_cgamg_warm=cg / warm, note=PRECISION_NOTE)


def row_cholmod(rng, device, side=1000):
    with tempfile.TemporaryDirectory() as d:
        cfg = cholmod_job(d, rng, side)
        note(f"pairwise-cholmod {side}x{side}")
        cold, warm, st = run_cold_warm(
            "pairwise-cholmod", cfg, device,
            lambda r: check_pairwise(r, 32, "cholmod"))
    rec = cold_warm_record("pairwise-cholmod-direct", cold, warm, st,
                           cells=side * side, points=32,
                           note="native supernodal Cholesky "
                                "(native/cholesky.cpp, built by "
                                "native_build.py) on the host, f64")
    if side * side in BASELINES:
        chol = BASELINES[side * side][1]
        rec.update(baseline_julia_cholmod_s=chol,
                   vs_cholmod_warm=chol / warm, vs_cholmod_cold=chol / cold)
    return rec


def row_onetoall(rng, side, device):
    with tempfile.TemporaryDirectory() as d:
        cfg = onetoall_job(d, rng, side)
        note(f"one-to-all {side}x{side}")
        cold, warm, st = run_cold_warm(
            "one-to-all", cfg, device,
            lambda r: check_onetoall(r, 32, "one-to-all"))
    return cold_warm_record("one-to-all", cold, warm, st, cells=side * side,
                            points=32, note=PRECISION_NOTE)


def row_advanced(rng, side, device):
    with tempfile.TemporaryDirectory() as d:
        cfg = advanced_job(d, rng, side)
        note(f"advanced {side}x{side}")
        cold, warm, st = run_cold_warm(
            "advanced", cfg, device,
            lambda v: check_advanced(v, cfg, "advanced"))
    return cold_warm_record("advanced+curmap", cold, warm, st,
                            cells=side * side, sources=64, grounds=64,
                            note=PRECISION_NOTE)


def rows_network(suite, rng, device, n=100_000):
    """The network job with the default routing, then on the forced
    iterative tier (CS_NETWORK_DIRECT_MAX=0, restored afterwards)."""
    from chip_smoke import forced_iterative_tier
    with tempfile.TemporaryDirectory() as d:
        cfg = network_job(d, rng, n)
        size = {"nodes": n, "edges": lattice_edges(n), "points": 20,
                "pairs": 190}

        def direct():
            note("network-pairwise (direct tier routing)")
            cold, warm, st = run_cold_warm(
                "network-pairwise", cfg, device,
                lambda r: check_network(r, cfg, "network"))
            return cold_warm_record(
                "network-pairwise", cold, warm, st, **size,
                note="cg+amg jobs at direct-tier sizes route to the native "
                     "supernodal Cholesky (CS_NETWORK_DIRECT_MAX)")

        def forced():
            note("network-pairwise (forced cg+amg tier)")
            with forced_iterative_tier():
                cold, warm, st = run_cold_warm(
                    "network-amg", cfg, device,
                    lambda r: check_network(r, cfg, "network, forced"))
            return cold_warm_record(
                "network-pairwise-amg-forced", cold, warm, st, **size,
                note="CS_NETWORK_DIRECT_MAX=0 (routing disabled)")

        suite.row("network", direct)
        suite.row("network-amg-forced", forced)


def _child(code):
    """Run code in a fresh interpreter in the repo; returns (wall s, last
    line of its stdout).  Raises when the child fails."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                       capture_output=True, text=True)
    wall = time.perf_counter() - t
    if r.returncode != 0:
        raise RuntimeError(f"child process exited {r.returncode}: "
                           f"{r.stderr[-1500:]}")
    return wall, (r.stdout.strip().splitlines() or [""])[-1]


def attach_seconds(device):
    """A fresh process's torch import and first op on the device."""
    _, out = _child(
        "import time; t0 = time.perf_counter()\n"
        "import torch\n"
        f"torch.ones((8, 128), device={device!r}).sum().item()\n"
        "print(time.perf_counter() - t0)")
    return float(out)


def row_provisioned(rng, side, device, attach_s):
    """warmup.warmup of the shortcut job in one process, then the job in
    a fresh one (its compute() timed inside it, resistances checked, its
    timer sections sent back for the record's stages)."""
    with tempfile.TemporaryDirectory() as d:
        job = repr(shortcut_job(d, rng, side))
        warm_wall, _ = _child(
            "import sys; sys.path.insert(0, '.')\n"
            "from circuitscape_tpu_torch.warmup import warmup\n"
            f"print(warmup({job}, points=32, device={device!r}))")
        _, out = _child(
            "import json, sys, time; sys.path.insert(0, '.')\n"
            "import numpy as np, torch\n"
            "import circuitscape_tpu_torch as cst\n"
            "from circuitscape_tpu_torch.timer import CSTIMER\n"
            "t0 = time.perf_counter()\n"
            f"r = cst.compute(dict({job}), device={device!r})\n"
            f"if torch.device({device!r}).type == 'cuda':\n"
            "    torch.cuda.synchronize()\n"
            "dt = time.perf_counter() - t0\n"
            "m = np.asarray(r)[1:, 1:]\n"
            "off = ~np.eye(len(m), dtype=bool)\n"
            "if m.shape != (32, 32) or not np.all(np.isfinite(m)) or "
            "not np.all(m[off] > 0):\n"
            "    sys.exit('provisioned job: bad resistances')\n"
            "print(json.dumps([dt, [[p, t] for p, (_, t) in "
            "CSTIMER._data.items()]]))")
    prov, sections = json.loads(out)
    stages = job_stages({tuple(p): (1, t) for p, t in sections})
    note(f"provisioned-cold {side}: warmup_wall {warm_wall:.1f} s, job "
         f"{prov:.3f} s")
    rec = {"scenario": "provisioned-cold", "cells": side * side,
           "points": 32, "backend_attach_s": attach_s,
           "warmup_wall_s": warm_wall, "provisioned_cold_s": prov,
           "provisioned_run": {"stages": stages},
           "note": "fresh process after warmup.warmup in another; "
                   "includes the process's own CUDA context, not its "
                   "imports"}
    if side * side in BASELINES:
        chol = BASELINES[side * side][1]
        rec.update(baseline_julia_cholmod_s=chol,
                   vs_cholmod_provisioned_cold=chol / prov)
    return rec


def spmv_record(device, side=1000, batch=32, k=100, reps=5):
    """The CG loop's matvec kernel at the bench shape: k back-to-back
    launches of cuda_stencil.matvec alternating between two input blocks
    (CUDA events, chip_smoke.cuda_ms), the median of reps; beside its
    byte bound at the card's memory rate.  On the CPU the wrapper runs
    its plain version, timed with the host clock."""
    import torch
    from chip_smoke import _crop_operator, cuda_ms, kernel_bytes
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.solve.stencil import stencil_activity_stats
    rng = np.random.default_rng(0)
    H = W = side
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.10] = 0.0
    nnz = stencil_activity_stats(g, False)
    dev = torch.device(device)
    A, _ = _crop_operator(g, H, W, dev)
    xs = [torch.as_tensor(rng.standard_normal((batch, H, W)),
                          dtype=torch.float32, device=dev)
          for _ in range(2)]
    n = [0]

    def launch():
        n[0] += 1
        return cs.matvec(A, xs[n[0] % 2])

    if dev.type == "cuda":
        ts = [cuda_ms(launch, n=k) / 1e3 for _ in range(reps)]
    else:
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            for _ in range(k):
                launch()
            ts.append((time.perf_counter() - t) / k)
    s = float(np.median(ts))
    rec = {"scenario": "spmv-kernel",
           "kernel": "cuda_stencil.matvec (matvec_kernel, "
                     "circuitscape_tpu_torch/csrc/stencil_kernels.cu)"
                     if dev.type == "cuda" else
                     "cuda_stencil.matvec_plain (torch, cpu)",
           "cells": H * W, "batch": batch, "nnz": nnz,
           "s_per_matvec": s, "spmv_nnz_per_s": nnz * batch / s,
           "s_per_matvec_runs": ts,
           "note": f"{k} back-to-back launches alternating between two "
                   "input blocks, median of "
                   f"{reps}; the renormalisation that the JAX loop fuses "
                   "into each step is not launched"}
    rate = (stats.device_bytes_per_s(torch.cuda.get_device_name(dev))
            if dev.type == "cuda" else None)
    if rate:
        bound = kernel_bytes("matvec", batch, H, W) / rate
        rec.update(byte_bound_s=bound, pct_of_byte_bound=100 * bound / s)
    return rec


# --- the suite ------------------------------------------------------------

def prebuild(device):
    """Build what the rows load (the CUDA kernel library on the card,
    the native Cholesky and ASC libraries), once for the checkout and
    outside every timed run, as an installation would."""
    import torch
    from circuitscape_tpu_torch.io import fastio
    from circuitscape_tpu_torch.solve import cuda_stencil, native_chol
    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        cuda_stencil.build()
    native_chol._load()
    fastio.load()
    note(f"libraries built or found in {time.perf_counter() - t:.1f} s")


class Suite:
    """The records of one suite run, written to `out` after every row;
    each row's record carries the device and the card."""

    def __init__(self, out, device, records=()):
        import torch
        from chip_smoke import card_line
        self.out = out
        self.records = list(records)
        self.failed = 0
        cuda = torch.device(device).type == "cuda"
        self.tags = {"device": (torch.cuda.get_device_name(device) if cuda
                                else "cpu"),
                     "card": card_line() if cuda else None}

    def row(self, name, fn):
        """Run one row; on failure record the error and go on, so one
        failure cannot lose the rest of the table."""
        try:
            rec = fn()
        except Exception as e:
            traceback.print_exc()
            self.failed += 1
            rec = {"scenario": "FAILED", "row": name,
                   "error": f"{type(e).__name__}: {str(e)[:1500]}"}
            note(f"  FAILED: {rec['error'][:300]}")
        self.records.append({**rec, **self.tags})
        self.dump()

    def dump(self):
        with open(self.out, "w") as f:
            json.dump(self.records, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(HERE, OUT))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_suite_torch: no CUDA device available (--device cpu "
              "runs the suite on the CPU)", file=sys.stderr)
        return 2
    dev = args.device
    sizes = [int(s) for s in os.environ.get(
        "CS_SUITE_SIZES", ",".join(map(str, ALL_SIZES))).split(",") if s]
    wanted = set(os.environ.get("CS_SUITE_SCENARIOS",
                                ",".join(SCENARIOS)).split(","))
    records = []
    if os.environ.get("CS_SUITE_APPEND") and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    prebuild(dev)
    suite = Suite(args.out, dev, records)
    rng = np.random.default_rng(42)

    if "shortcut" in wanted:
        for side in sizes:
            suite.row(f"shortcut {side}",
                      lambda side=side: row_shortcut(rng, side, dev))
    if "maps" in wanted:
        suite.row("maps", lambda: row_maps(rng, sizes[0], dev))
    if "cholmod" in wanted:
        suite.row("cholmod", lambda: row_cholmod(rng, dev))
    if "onetoall" in wanted:
        suite.row("onetoall", lambda: row_onetoall(rng, sizes[0], dev))
    if "advanced" in wanted:
        suite.row("advanced", lambda: row_advanced(rng, sizes[0], dev))
    if "network" in wanted:
        rows_network(suite, rng, dev)
    if "provisioned" in wanted:
        attach = []

        def provisioned(side):
            if not attach:
                attach.append(attach_seconds(dev))
            return row_provisioned(rng, side, dev, attach[0])
        for side in sizes:
            suite.row(f"provisioned {side}",
                      lambda side=side: provisioned(side))
    if "spmv" in wanted:
        note("spmv-kernel")
        suite.row("spmv", lambda: spmv_record(dev))

    for r in suite.records:
        print(json.dumps(r))
    return 1 if suite.failed else 0


if __name__ == "__main__":
    sys.exit(main())
