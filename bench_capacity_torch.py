"""Capacity job of circuitscape_tpu_torch: bench_capacity.py's >= 100M-cell
pairwise job through the port, on real cards.

    python3 bench_capacity_torch.py                   # rows a, b and c
    python3 bench_capacity_torch.py --rows c --out /tmp/capacity.json
    python3 bench_capacity_torch.py --side 4096       # one job, default routing
    python3 bench_capacity_torch.py --device cpu --side 256
        # bench_capacity.py's own setting: eight virtual CPU shards,
        # CS_FORCE_MESH=1

The job is bench_capacity.py's, byte for byte (capacity_job): a side x
side raster of uniform(0.5, 3.0) conductances from default_rng(7) with
~10% NODATA, four focal points placed by its rejection loop, pairwise,
cg+amg, single precision, shortcut mode (3 anchor solves), through the
public compute(cfg, device) surface.  Inputs go under build/capacity/
and are deleted after each row.  The rows (bench_capacity.py's own
record: its first row's size and its third's, and the size at one
card's limit) are meant for a machine with four cards:

  a  10240^2 (104.9M cells)  one card by default routing (no mesh),
                             the large-grid route (mg_build "host");
  b  14336^2 (205.5M cells)  the mesh forced (CS_FORCE_MESH=1, default
                             shape (2,2), the streamed build), then one
                             card (CS_DISABLE_MESH=1, chunked, "host");
                             the two runs agree within 1e-4 relative;
  c  20992^2 (440.7M cells)  the mesh by default routing, shape (2,2),
                             then under CS_MESH_SHAPE=4,1; streamed.

Each row records which route the default routing takes
(parallel/mesh.active_mesh, with no routing variable set).  Every run
is checked: resistances finite, symmetric and positive with 6 pairs
solved; each anchor column's float64 relative residual, recomputed
against the float64 operator (chip_smoke.anchor_residuals, a shard at
a time on a mesh), at most consts.CG_RTOL; stats mg_build and the mesh
shape as the row says, and "/shard" levels on a mesh; the later runs
of a row within 1e-4 relative of its first (the reference's
single-precision tolerance).

One record per run, with bench_capacity.py's keys (scenario, cells,
grid, points, mesh, wall_s, all_finite, pairs_solved,
fixed_bytes_per_shard_gb, host_peak_rss_gb, note), where
fixed_bytes_per_shard_gb is measured (the most any card holds after
setup, before the first solve; GiB) and host_peak_rss_gb is the peak
resident set of this process during the run (GiB, sampled every 20 ms);
and per card its
fixed bytes, peak (max_memory_allocated, reset on every card before
the run) and the capacity model's figure (CARD_BYTES_PER_CELL a cell
of its share of the padded grid); the chunk budget and the column
bytes each card held against dispatch.COLUMN_BYTES_PER_CELL; CG
iterations per refinement pass, the batch width, stages (each timer
second once, bench_suite_torch.stage_seconds), the residuals, the
device and the card's name and power limit as nvidia-smi gives them.
wall_s leaves out the residual check's seconds (residual_check_s).

Writes BENCH_CAPACITY_TORCH.json (or --out) after every run and prints one JSON line per record at the end.  A
failing run is recorded (with an "error") and the rows go on; the exit
code is then 1.  Without a CUDA device the script exits 2 unless
--device cpu is given: there is no fallback to the CPU.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import resource
import shutil
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

OUT = "BENCH_CAPACITY_TORCH.json"
INPUTS = os.path.join(HERE, "build", "capacity")
POINTS = 4
AGREE_TOL = 1e-4
# the variables that route a job between one device and the mesh; the
# rows set their own and clear the caller's
ROUTING = ("CS_FORCE_MESH", "CS_DISABLE_MESH", "CS_MESH_SHAPE",
           "CS_MESH_MIN_CELLS")


@dataclasses.dataclass(frozen=True)
class Run:
    label: str
    env: dict            # routing variables of this run
    mesh: tuple | None   # the (nodes, batch) shape it must take; None: one device
    build: str           # the stats mg_build it must take


ROWS = {
    "a": (10240, (Run("one card, default routing", {}, None, "host"),)),
    "b": (14336, (Run("mesh (2,2), forced", {"CS_FORCE_MESH": "1"}, (2, 2),
                      "host streamed"),
                  Run("one card, mesh disabled", {"CS_DISABLE_MESH": "1"},
                      None, "host"))),
    "c": (20992, (Run("mesh (2,2), default routing", {}, (2, 2),
                      "host streamed"),
                  Run("mesh (4,1)", {"CS_MESH_SHAPE": "4,1"}, (4, 1),
                      "host streamed"))),
}


def note(msg):
    print(msg, file=sys.stderr, flush=True)


def capacity_job(d, side):
    """bench_capacity.py's inputs for a side x side grid, byte for byte
    and in its order, as cell.npy and pts.npy in d; returns its job
    dict."""
    import bench_suite_torch as bst
    bst.make_raster(d, np.random.default_rng(7), side, POINTS)
    return bst._raster_cfg(d)


# --- host memory ------------------------------------------------------------

def _rss_gb() -> float:
    """This process's resident set in GiB (VmRSS; the peak, ru_maxrss,
    where /proc has none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


class host_peak:
    """While active, the peak of this process's resident set (GiB),
    sampled every 20 ms on a thread: the kernel's own peak (VmHWM)
    cannot be reset in every container, and one process runs every
    row."""

    def __enter__(self):
        self.gb = _rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.gb = max(self.gb, _rss_gb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.gb = max(self.gb, _rss_gb())


# --- one run ----------------------------------------------------------------

def default_route(cells, device):
    """What the default routing picks for a grid of `cells` on device
    (no routing variable set): "mesh (r,c)" or "one device"."""
    from chip_smoke import env_set
    from circuitscape_tpu_torch.parallel.mesh import active_mesh
    with env_set(**dict.fromkeys(ROUTING)):
        m = active_mesh(cells, device)
    return ("one device" if m is None else
            f"mesh ({m.shape['nodes']},{m.shape['batch']})")


def expected_build(cells, mesh) -> str:
    """The stats mg_build a grid of `cells` takes on a mesh (or None: one
    device): prepare.py's routes and their thresholds, read now."""
    if mesh is not None:
        streamed = cells > int(os.environ.get("CS_STREAM_BUILD_MIN",
                                              "4000000"))
        return "host streamed" if streamed else "host"
    return ("host" if cells > int(os.environ.get("CS_DEVICE_MG_MAX",
                                                 "1200000")) else "device")


def _free_all(devices):
    import torch
    gc.collect()
    for d in devices:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()


def run_capacity(cfg, side, run, device, keep=False):
    """One compute(cfg, device) run of a capacity job under the run's
    routing, with the launch counters zeroed and every card's peak reset
    just before it.  Returns (record, extras): extras holds the result,
    the launches per shape, the padded batch per column group and, with
    keep=True, each pair solve's (S64, prec).  A failed check leaves an
    "error" in the record."""
    import torch
    import circuitscape_tpu_torch as cst
    from chip_smoke import (_sync, anchor_residuals, cards, check_resistances,
                            chunk_footprint, env_set, reset_peaks)
    from bench_suite_torch import job_stages
    from circuitscape_tpu_torch import consts, stats
    from circuitscape_tpu_torch.parallel.mesh import CARD_BYTES_PER_CELL
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.solve.dispatch import COLUMN_BYTES_PER_CELL
    from circuitscape_tpu_torch.timer import CSTIMER
    cuda = torch.device(device).type == "cuda"
    devs = cards() if cuda else []
    _free_all(devs)
    reset_peaks(devs)
    fp_ctx = chunk_footprint() if cuda else contextlib.nullcontext()
    with env_set(**run.env), fp_ctx as fp, anchor_residuals(fp, keep) as res:
        _sync(devs)
        cs.reset_launch_counts()
        with host_peak() as host:
            t = time.perf_counter()
            r = cst.compute(dict(cfg), device=device)
            _sync(devs)
            wall = time.perf_counter() - t - res.seconds
    launches_at = dict(cs.LAUNCHES_AT)
    sd = stats.finalize()
    m = np.asarray(r, np.float64)[1:, 1:]
    mesh = res.meshes[0] if res.meshes else None
    ncol = mesh[1] if mesh else 1
    width = 1 << (int(sd.get("batch_width", 1)) - 1).bit_length()
    width = -(-width // ncol) * ncol
    rec = {
        "scenario": ("capacity-mesh" if mesh else "capacity-one-device"),
        "cells": side * side, "grid": f"{side}x{side}", "points": POINTS,
        "mesh": (None if mesh is None else
                 {"nodes": mesh[0], "batch": mesh[1]}),
        "wall_s": wall,
        "all_finite": bool(np.all(np.isfinite(m)) and np.all(m >= -1)),
        "pairs_solved": int(np.sum(m[np.triu_indices_from(m, 1)] > 0)),
        "fixed_bytes_per_shard_gb": None,
        "host_peak_rss_gb": host.gb,
        "note": ("bench_capacity.py's job through compute() on "
                 + (f"{len(devs)} card(s)" if cuda else
                    "virtual CPU shards") + "; fixed bytes measured on "
                 "each card after setup, before the first solve (GiB); "
                 "host peak resident set of the run, sampled every 20 ms "
                 "(GiB); wall_s without the residual check"),
        "run": run.label, "padded_cells": sd.get("cells"),
        "mg_build": sd.get("mg_build"), "mg_kernels": sd.get("mg_kernels"),
        "cg_iters": sd.get("cg_iters"), "pass_iters": sd.get("pass_iters"),
        "batch_width": sd.get("batch_width"), "padded_width": width,
        "stages": job_stages(dict(CSTIMER._data)),
        "residuals": [x for rel in res.rel for x in rel.tolist()],
        "residual_check_s": res.seconds,
        "launches": dict(cs.LAUNCHES),
    }
    if cuda and fp.cells is not None:
        cells = fp.cells
        per_col = fp.per_card_column(width)
        rec["cards_memory"] = [{
            "device": str(d), "fixed_gb": fp.resident[d] / 2**30,
            "peak_gb": fp.peak(d) / 2**30,
            "model_gb": CARD_BYTES_PER_CELL * cells * fp.share(d) / 2**30,
            "free_at_budget_gb": fp.free[d] / 2**30,
            "column_bytes_per_cell": per_col[d],
            # the widest batch this card's free memory holds at the
            # column bytes it was measured to take
            "width_it_holds": int(0.9 * fp.free[d] //
                                  (per_col[d] * cells * fp.share(d))),
        } for d in fp.devices]
        rec["fixed_bytes_per_shard_gb"] = max(
            c["fixed_gb"] for c in rec["cards_memory"])
        rec["chunk"] = {"budget_bytes": fp.budget,
                        "model_column_bytes_per_cell": COLUMN_BYTES_PER_CELL,
                        "admitted_width": sd.get("batch_width")}
    errors = []
    try:
        check_resistances(np.asarray(r), run.label, n=POINTS)
    except AssertionError as e:
        errors.append(str(e))
    if rec["pairs_solved"] != POINTS * (POINTS - 1) // 2:
        errors.append(f"{rec['pairs_solved']} pairs solved")
    if len(rec["residuals"]) != POINTS - 1 or not all(
            x <= consts.CG_RTOL for x in rec["residuals"]):
        errors.append(f"float64 relative residuals {rec['residuals']} "
                      f"(at most {consts.CG_RTOL} each, {POINTS - 1} "
                      f"anchor columns)")
    if sd.get("mg_build") != run.build:
        errors.append(f"hierarchy built {sd.get('mg_build')!r}, not "
                      f"{run.build!r}")
    if mesh != run.mesh:
        errors.append(f"ran on {mesh or 'one device'}, not "
                      f"{run.mesh or 'one device'}")
    shard = any(k.endswith("/shard") for k in sd.get("mg_kernels", []))
    if shard != (run.mesh is not None):
        errors.append(f"mg_kernels {sd.get('mg_kernels')}")
    if errors:
        rec["error"] = "; ".join(errors)
    extras = {"result": np.asarray(r, np.float64),
              "launches_at": launches_at,
              "batch": width // ncol, "solves": res.solves}
    return rec, extras


def run_row(key, side, runs, device, record, after=None, catch=True):
    """The runs of one row on one set of inputs (made here, deleted
    after): each run's record goes to record(rec); after(run, rec,
    extras) runs once a run's record is made.  A run's later siblings
    are held to its first run's resistances (AGREE_TOL).  With catch, a
    run that raises is recorded (its error) and the row goes on; without
    it, the error propagates, as does a failed check.  Returns the
    records."""
    from chip_smoke import _rel
    os.makedirs(INPUTS, exist_ok=True)
    d = tempfile.mkdtemp(dir=INPUTS)
    recs, first = [], None
    try:
        t = time.perf_counter()
        cfg = capacity_job(d, side)
        note(f"row {key}: {side}x{side} inputs in "
             f"{time.perf_counter() - t:.1f} s")
        route = default_route(side * side, device)
        note(f"row {key}: the default routing takes {route}")
        for run in runs:
            try:
                note(f"row {key}: {run.label}")
                rec, extras = run_capacity(cfg, side, run, device,
                                           keep=after is not None)
                rec.update(row=key, default_route=route)
                if first is None:
                    first = (run.label, extras["result"])
                else:
                    rel = _rel(extras["result"], first[1])
                    rec["agreement"] = {"with": first[0], "max_rel": rel,
                                        "tol": AGREE_TOL}
                    note(f"row {key}: {run.label} agrees with "
                         f"{first[0]} to {rel:.6e} relative")
                    if not rel <= AGREE_TOL:
                        rec["error"] = "; ".join(filter(None, [
                            rec.get("error"), f"resistances differ from "
                            f"{first[0]}'s by {rel} relative"]))
                if after is not None:
                    after(run, rec, extras)
                del extras
                if "error" in rec and not catch:
                    raise AssertionError(f"row {key}, {run.label}: "
                                         f"{rec['error']}")
            except Exception as e:
                if not catch:
                    raise
                traceback.print_exc()
                rec = {"scenario": "FAILED", "row": key, "run": run.label,
                       "cells": side * side, "grid": f"{side}x{side}",
                       "error": f"{type(e).__name__}: {str(e)[:1500]}"}
            if "error" in rec:
                note(f"  FAILED: {rec['error'][:300]}")
            recs.append(rec)
            record(rec)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return recs


def _tags(device):
    import torch
    from chip_smoke import card_line
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "card": None, "count": 0}
    return {"device": torch.cuda.get_device_name(0), "card": card_line(),
            "count": torch.cuda.device_count()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="rows to run, of " + ",".join(ROWS))
    ap.add_argument("--side", type=int,
                    help="one job of this side on the default routing "
                         "(on the CPU: eight virtual shards, the mesh "
                         "forced) in place of the rows")
    ap.add_argument("--out", default=os.path.join(HERE, OUT))
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.side:
        ap.error("--device cpu needs --side")
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_capacity_torch: no CUDA device available (--device cpu "
              "--side N runs one job on the CPU)", file=sys.stderr)
        return 2
    from chip_smoke import env_set, virtual_mesh
    dev = args.device
    records = []
    tags = _tags(dev)
    failed = []

    def record(rec):
        records.append({**rec, **tags})
        if "error" in rec:
            failed.append(rec)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)

    if dev == "cpu":
        # bench_capacity.py's own setting: eight virtual devices, the
        # mesh forced, default shape (2,4)
        run = Run("eight virtual CPU shards, mesh forced",
                  {"CS_FORCE_MESH": "1"}, (2, 4),
                  expected_build(args.side ** 2, (2, 4)))
        with virtual_mesh("cpu", "2,4"):
            run_row("side", args.side, (run,), dev, record)
    else:
        from circuitscape_tpu_torch.io import fastio
        from circuitscape_tpu_torch.solve import cuda_stencil
        cuda_stencil.build()
        fastio.load()
        with env_set(**dict.fromkeys(ROUTING)):
            if args.side:
                route = default_route(args.side ** 2, dev)
                mesh = (None if route == "one device" else
                        tuple(int(v) for v in route[6:-1].split(",")))
                run_row("side", args.side,
                        (Run(f"default routing ({route})", {}, mesh,
                             expected_build(args.side ** 2, mesh)),),
                        dev, record)
            else:
                for key in args.rows.split(","):
                    side, runs = ROWS[key]
                    run_row(key, side, runs, dev, record)
    for r in records:
        print(json.dumps(r))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
