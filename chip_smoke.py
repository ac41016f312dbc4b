"""Smoke run of circuitscape_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from circuitscape_tpu_torch/csrc with nvcc;
     print nvcc's version and the card's name and power limit;
  2. hold each kernel against its plain-torch version on the card, at
     B in {1, 2, 3, 4, 5, 8} on grids from 1 x 1 up, with odd sides and
     widths that are not a multiple of 32 or 4, and at B = 32 on those
     and the main path's 1024 x 1024 (tolerance: max |kernel - plain|
     <= 1e-5 * max |plain|, float32 sum order); require matvec_pap to
     give bit-identical results on two calls with the same input;
     time each kernel and its plain version with CUDA events at the main
     path's shapes, beside the least time the card could take and, for
     matvec (the one with a single-call library form), a CSR sparse
     product; on every level shape of the bench job's hierarchy
     (1024^2 down to 32^2) where the main path launches a kernel, hold
     it at B = 32 against its plain version (same tolerance) and time
     it beside its byte bound (and matvec's beside the sparse product,
     held against the plain version there too), one line per kernel
     and level; and poly_project (torch glue, not a TPU kernel) with the
     polygon job's projector at B = 32 on 1024^2: bit-identical on two
     calls, within 1e-6 of max |ref| of a float64 CPU reference, timed
     beside its byte bound; and each kernel at B = 1 (the advanced job's
     width) and B = 32 on every level of the advanced job's
     penalty-baked hierarchy (phase 7's ground field coarsened into every
     diagonal), compared per cell: |kernel - plain| <= 1e-5 * (|plain| +
     max |plain| over unpenalized cells); and on every level of the
     scale job's hierarchy (7040^2, the width where the TPU tiles
     _kernel and _cheb_kernel by columns, down to 28^2) at its batch
     (B = 4), each kernel its pair solve launches there, on the scale
     map's own operator: held against its plain version, timed beside
     its byte bound (the plain version at 7040^2 and 3520^2, matvec
     beside the sparse product); then each kernel once at B = 44 on
     7040^2 (2.18e9 floats a block, past 2^31), its first and last
     columns against the plain version on those columns;
  3. drive the main path: the bench.py job (seed 42, 1000 x 1000
     conductance raster with ~10% NODATA, 32 focal points, cg+amg,
     single precision, shortcut mode) through compute(..., "cuda"):
     one warm run, then two timed runs (time_job, which bench_torch.py
     times with too), each with the launch counters set to 0 just
     before it; check the resistances (finite, positive off the
     diagonal, symmetric), the CG iteration count (10) and that every
     kernel launched; print bench_torch.py's JSON line of the two runs
     (with phase 18's default-route verdict as cuda_golden); then print
     each kernel's time per bench job (phase 2's level times weighted by
     this run's launches per level) beside its byte bound, one per_job
     line per kernel;
  4. drive the maps path: the same job with write_cum_cur_map_only and
     write_max_cur_maps (all 496 pairs solved in chunks of 32, two
     1M-cell ASC maps written): one warm run, then one timed run with
     the counters set to 0 just before it; check that every kernel
     launched, that the resistances agree with phase 3's shortcut
     matrix to 1e-4 relative, and that the cumulative map is finite,
     >= 0 on active cells and > 0 somewhere;
  5. drive the polygon job: the bench job with 20 short-circuit polygons
     (make_polygon_job; points 7 and 8 share one): one warm run, then
     one timed run with the counters zeroed just before it; check the
     resistances (finite, symmetric, >= 0, R[7,8] = 0, none above phase
     3's and one at least 1e-3 below: shorts only lower resistance),
     that matvec launched on the 1024^2 level each CG iteration and
     matvec_pap never (the projected CG body), and print per_job lines;
  6. drive the focal-region job: the bench raster with 8 focal regions
     (5 x 5 blocks on points 1-8), 28 pairs in one chunk with a
     per-column projector, maps off: one run; resistances finite,
     symmetric, positive, none above phase 3's between the same points;
  7. drive the advanced job (make_advanced_job: the bench raster, 16
     sources, 8 finite and 8 direct grounds, voltage and current maps):
     one run with the counters zeroed just before it; the residual of
     its float64 solution, against graph/build's sparse Laplacian, under
     the gate; voltages >= -1e-6 max with the maximum at
     a source, every kernel launched and matvec_pap at 1024^2 each CG
     iteration;
  8. drive the one-to-all job (the bench points in one batch of 32, maps
     off) and the all-to-one job (cumulative and per-point current maps):
     one run each with the counters zeroed just before it; one-to-all
     results positive, finite and at most the bench job's smallest
     resistance from the same point, every kernel launched and
     matvec_pap at 1024^2 every CG iteration (its columns solve the
     penalty-baked operator); all-to-one results 0 and the cumulative
     map finite, >= 0, > 0 somewhere, matvec at 1024^2 every CG
     iteration and matvec_pap never; per_job lines;
  9. run 256 x 256 jobs of the same recipes on "cuda" and on "cpu": the
     shortcut job (resistances agree to 1e-5 relative) and an 8-point
     maps job with per-pair current and voltage maps and the max map
     (the same files, every map within 1e-5 of max |cpu map|); then the
     polygon shortcut job, an 8-point polygon maps job, a 4-region
     focal-region maps job, the advanced job with and without polygons,
     an 8-point one-to-all polygon job and an 8-point all-to-one job
     with per-point current maps (Kirchhoff: each point's map at its
     ground carries the other points' current); the first three with
     the same CG iteration count on both devices, the last four with
     each of the card's CG passes replayed on the CPU from its own
     inputs stopping within one iteration of the card's;
  10. drive the network pairwise job (make_network_job: the reference's
     100,000-node lattice benchmark, 20 focal nodes, 190 pairs, cg+amg,
     single precision, current files) on the general sparse-graph tier:
     with CS_NETWORK_DIRECT_MAX=0 (ELL PCG with the SA-AMG V-cycle on the
     card) a warm and a timed run, printing the CG iterations, AMG
     levels, host-timer sections and peak device memory; then with the
     default routing (the native Cholesky on the host) one run.
     Resistances finite, symmetric, positive off the diagonal and within
     1e-4 of a SciPy float64 solve of the same regularized system, 380
     per-pair and 2 cumulative current files; the tiers' difference in
     single precision printed (their regularizations differ), and in
     double precision the tiers agreeing to 1e-4 (resistances relative,
     one pair's node currents of their max); time
     ell_matvec (torch ops, not a TPU kernel) at the job's fine level and
     B = 256 beside its bound and a CSR torch.sparse.mm (held to 1e-5 of
     max against it);
  11. drive the network advanced job (make_network_advanced_job: 16
     sources, 8 finite and 8 direct grounds, double precision) on the
     card's iterative tier: the float64 residual of its voltages against scipy's Laplacian
     of the edge list under 1e-4, and agreement with the direct tier to
     1e-4 of max |v|;
  12. (in phase 9) three general-tier jobs on "cuda" and on "cpu": a
     10,000-node lattice network (forced iterative tier), a 150 x 150
     raster maps job (below CS_PAIRWISE_DEVICE_MIN) and a 100 x 100
     one-to-all job with included pairs (the per-point loop): results
     to 1e-5 relative, every output file to 1e-5 of its max, and equal
     CG iteration counts or each card pass, replayed on the CPU, within
     one iteration;
  13. (after phase 8) drive the scale job (make_scale_job: bench_scale.py's
     6930 x 6930 raster, 48M cells, 4 points, cg+amg, single precision,
     shortcut mode) once with the counters zeroed just before it: the
     large-grid route (a host-built hierarchy), resistances finite,
     symmetric and positive, each anchor column's float64 relative
     residual, recomputed from the solve's output, under 1e-6, matvec
     and cheb_step launched at 7040^2 and the fused smoother at 3520^2;
     print its CG iterations per refinement pass, batch width,
     host-timer sections, peak device memory, wall time and per_job
     lines; then the same recipe with 32 points (31 anchor columns)
     under the default chunk budget; in both, the solve's device bytes
     per cell and column above what is resident when the budget is
     taken (peak minus resident over cells x padded batch width) within
     the chunk model (dispatch.COLUMN_BYTES_PER_CELL); and (in phase 9)
     a 256 x 256 job with CS_DEVICE_MG_MAX=1
     (the host-built route on both devices) and a 128 x 4200 job (fine
     level 128 x 4224) on "cuda" and on "cpu": resistances to 1e-5
     relative and the same CG iteration count;
  14. (first, right after the build) warmup() of the bench job in a
     process that has run no job yet, then the bench job: both walls;
  15. (after phase 9) eight 301 x 301 Omniscape windows of the bench
     map (radius 150, a source of 1 on every habitat cell, one ground
     of value 1 at a habitat centre, tests/test_internal.py's cs_cfg
     with cg+amg) through compute_omniscape_current on the card, with
     the counters zeroed just before the eight: ms per window, launches
     per kernel and shape, every kernel launched, each window's map
     within 1e-5 of max of the CPU run's, and every kernel held against
     its plain version at each shape the windows launched it at, on
     that level of the last window's pen-baked hierarchy, at B = 1 and
     with phase 2's per-cell tolerance for a penalty-baked level;
  16. the mesh on virtual shards of the card (parallel/mesh.py's device
     list patched to cuda:0 four times): the bench job on (4,1) and
     (2,2) (a warm run, then the one checked), resistances within 1e-5 relative of phase 3's; the advanced
     job on (4,1) (the masked preconditioner), voltages within 1e-5 of
     max of phase 7's; a 256 x 256 job on a (2,2) mesh of the card and
     of the CPU, CG passes within one, resistances within 1e-5; a 2048 x
     2048 job (4.19M cells, above CS_STREAM_BUILD_MIN) on (4,1) through
     the streamed build, its hierarchy equal to the materialized build's
     array for array, resistances within 1e-5 of the materialized run's;
     per-pass CG counts and launches per shape printed for each, and
     every kernel each run launched held against its plain version on
     every shard of that run's hierarchy at the shard's halo-extended
     shape and the run's batch per column group (phase 2's tolerance),
     shard 0's launch timed beside its byte bound;
  17. print the total time, the kernels line, the card line and, last,
     the result line;
  19. (after phase 13) bench_suite_torch.py's rows no other phase runs,
     its recipes drawn from its default_rng(42) in its order: the
     2450 x 2450 and 3465 x 3465 pairwise jobs (6M and 12M cells, 32
     points, shortcut mode; 2560^2 and 3584^2 padded) once each with the
     counters zeroed just before it: resistances finite, symmetric,
     positive, the host-built hierarchy (stats mg_build), every kernel
     launched; CG iterations per pass, batch width, peak device memory,
     timer sections and wall printed; then every kernel held against its
     plain version (phase 2's tolerance) at each shape that run launched
     it at, at the run's padded batch width on the job's own map, timed
     beside its byte bound, and per_job lines; the suite's 1000 x 1000
     raster with solver = cholmod in double precision (the host
     Cholesky) and with cg+amg in single: resistances within 1e-4
     relative (the reference's single-precision tolerance), sections
     printed; the suite's SpMV record (matvec at 1000^2, B = 32, beside
     its byte bound);
  18. (after phase 14) tpu_golden.py's twelve golden cases through
     torch_golden.run_subset on the card, on the default route (raster
     goldens on the general tier, network cg+amg on the host Cholesky)
     and on the device route (raster pairwise and advanced cg+amg cases
     on the stencil path, networks on the iterative tier), each held to
     its golden files at the reference harness's tolerances; with the
     counters zeroed just before the device route, every kernel
     launched there; verdicts, CG passes per case and launches per
     shape printed.

  21. (after phase 4) the CG loop's graph route against the eager loop
     (stencil._cg_loop with _eager) on the bench job and its maps
     recipe: after a warm run, a graph run, an eager run and a graph
     run under torch.profiler, each with the counters zeroed just before
     it; the same CG iterations per refinement pass, each pair solve's X
     within 1e-6 relative per column, the same launches on both routes,
     and in the profiled run the launches counted equal to the trace's
     kernels of each name; walls, solve seconds, replays and captures
     printed.

  22. (after phase 21) the CG iteration's and the V-cycle's glue kernels
     (csrc/cg_kernels.cu: cg_update_xr and its replacement variant,
     cg_dots, cg_update_p, prolong_add) against their plain versions
     run by torch on the card, at B = 32 on every level of the bench
     hierarchy (1024^2 down to 32^2): elementwise outputs to the bit,
     cg_dots's column sums within 1e-5 relative and the same bits on a
     second call; each timed beside its byte bound; then the bench job
     and its maps recipe with the fused body and the composite one
     (stencil._fused_body swapped): CG iterations of every pass within
     one, fused_iters equal to cg_iters and 0, results within 1e-5
     relative, solve seconds printed.

  20. (--cards only) bench_capacity_torch.py's row b: its 14336 x 14336
     job (205.5M cells, bench_capacity.py's recipe, 4 points, shortcut
     mode) on a mesh of every card (CS_FORCE_MESH=1, the default shape,
     the streamed build) and on one card (CS_DISABLE_MESH=1, chunked,
     the host-built hierarchy), with that script's checks: resistances
     finite, symmetric, positive, 6 pairs solved, each anchor column's
     float64 relative residual (computed a shard at a time on the mesh)
     under 1e-6, the build and mesh shape expected, the two runs within
     1e-4 relative; every kernel each run launched held against its
     plain version on every shard of its hierarchy at the shard's
     halo-extended shape (phase 2's tolerance), shard 0's launch timed
     beside its byte bound; launches per shape, per-card fixed bytes
     and peaks printed.

With --cards, on a machine with two cards or more, it runs only the
build, the bench and advanced jobs on one card, and phase 16 across
every card in place of the virtual shards (n cards: shapes (n,1) and
the squarest (r,n/r)), each check held against the one-card runs;
then phase 20 and the result line.  `--cards --capacity-out PATH`
also writes phase 20's two records there, as bench_capacity_torch.py
writes its rows'.

Exits 2 without printing a result when no CUDA device is available.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

TOL = 1e-5
BATCHES = (1, 2, 3, 4, 5, 8, 32)
SHAPES = ((1, 1), (2, 3), (31, 33), (37, 53), (64, 100), (129, 257),
          (130, 100), (257, 333), (1024, 1024))
MAIN_B, MAIN_HW = 32, (1024, 1024)
# the bench job's multigrid levels (1000 x 1000 bucketed to 1024^2), and
# the levels where its V-cycle (or, for matvec_pap, its CG loop) launches
# each kernel: the fused smoother on levels of 64 rows or more, the
# generic one (cheb_step, matvec) below
LEVELS = tuple((n, n) for n in (1024, 512, 256, 128, 64, 32))
LEVEL_KERNELS = (
    ("matvec", LEVELS[-1:]), ("matvec_pap", LEVELS[:1]),
    ("cheb_step", LEVELS[-1:]), ("residual_restrict", LEVELS),
    ("cheb_init", LEVELS[:-1]), ("residual_init", LEVELS[:-1]),
    ("cheb_finish", LEVELS[:-1]))

# the CG iteration's and the V-cycle's glue kernels (csrc/cg_kernels.cu),
# by the names their launches count under (cuda_stencil.FUSED_LAUNCHES)
# and the profiler shows; none replaces a TPU kernel
GLUE_KERNELS = ("cg_update_xr", "cg_dots", "cg_dots_finish", "cg_update_p",
                "prolong_add")

# float32 rate outside the tensor cores (NVIDIA data sheets); first
# match of torch.cuda.get_device_name() wins
FP32_FLOPS = (("H100 PCIe", 51e12), ("H100", 67e12), ("H200", 67e12))

# (name, TPU kernel it replaces, flops per cell and column)
KERNELS = (
    ("matvec", "circuitscape_tpu/solve/pallas_stencil.py:175", 17),
    ("matvec_pap", "circuitscape_tpu/solve/pallas_stencil.py:820", 19),
    ("cheb_step", "circuitscape_tpu/solve/pallas_stencil.py:307", 23),
    ("residual_restrict", "circuitscape_tpu/solve/pallas_stencil.py:724",
     19),
    ("cheb_init", "circuitscape_tpu/solve/pallas_stencil.py:473", 24),
    ("residual_init", "circuitscape_tpu/solve/pallas_stencil.py:573", 21),
    ("cheb_finish", "circuitscape_tpu/solve/pallas_stencil.py:595", 25),
)
CG_ITERS = 10     # the bench job's CG iterations (one chunk of 31 pairs)
# the scale job (bench_scale.py's 48M-cell job, 6930^2 bucketed to
# 7040^2): its batch (3 anchor columns, padded to 4 by the pair solve),
# and the batch at which one launch at its fine level moves more than
# 2^31 floats a block (44 x 7040^2 = 2.18e9)
SCALE_SIDE, SCALE_HW = 6930, (7040, 7040)
SCALE_B, SCALE_BIG_B = 4, 44
PEN_BATCHES = (1, MAIN_B)   # the advanced job's width, and the others'
SOURCE = "circuitscape_tpu_torch/csrc/stencil_kernels.cu"


def note(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_bytes(name, B, H, W) -> int:
    """Bytes the function must move: each input read once, each output
    written once (float32).  The smoother kernels count six planes (the
    five of L and Dinv), whatever a design reads."""
    cells = H * W
    coarse = -(-H // 2) * -(-W // 2)
    return 4 * {
        "matvec": (2 * B + 5) * cells,
        "matvec_pap": (2 * B + 5) * cells + B,
        "cheb_step": (6 * B + 6) * cells,
        "residual_restrict": (2 * B + 5) * cells + B * coarse,
        "cheb_init": (2 * B + 6) * cells,
        "residual_init": (4 * B + 6) * cells,
        "cheb_finish": (3 * B + 6) * cells,
    }[name]


def cuda_ms(fn, n=20, warm=3) -> float:
    """Device ms per call of fn over n back-to-back calls.  A spin
    kernel (~500k cycles, ~0.25 ms, per call) holds the card while the
    host queues the calls, so a kernel shorter than its launch's host
    cost is timed on the device and not at the host's enqueue rate (with
    100k cycles a call, cheb_step's 32^2 launches, whose wrapper queues
    three outputs, read 3-25 us on the H100 from one run to the next)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(500_000 * n)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def make_job(d, H, W, npoints=32, seed=42):
    """The bench.py job: conductance raster with ~10% NODATA and npoints
    focal points, as NPY files in d; returns (config dict, gmap)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.10] = -9999.0
    np.save(os.path.join(d, "cellmap.npy"), g)
    pts = np.zeros((H, W))
    placed = 0
    while placed < npoints:
        r, c = rng.integers(0, H), rng.integers(0, W)
        if g[r, c] > 0 and pts[r, c] == 0:
            placed += 1
            pts[r, c] = placed
    np.save(os.path.join(d, "points.npy"), pts)
    cfg = {
        "data_type": "raster", "scenario": "pairwise",
        "habitat_file": os.path.join(d, "cellmap.npy"),
        "habitat_map_is_resistances": "False",
        "point_file": os.path.join(d, "points.npy"),
        "output_file": os.path.join(d, "job.out"),
        "solver": "cg+amg", "precision": "single",
        "connect_four_neighbors_only": "False",
        "connect_using_avg_resistances": "False",
        "suppress_messages": "True",
    }
    return cfg, np.where(g > 0, g, 0.0)


def make_polygon_job(d, H, W, npoints=32, seed=42):
    """The bench job plus short-circuit polygons: 20 squares, ids 1-20,
    scaled to the grid (21 x 21 at 1000 x 1000): 1-6 centred on focal
    points 1-6, 7 two 5 x 5 squares around points 7 and 8 (which merges
    the two points into one node), 8-20 placed with default_rng(7) and
    painted first.  Polygon cells keep their conductance, NODATA
    included.  Returns (config dict, gmap, polygon map)."""
    cfg, gmap = make_job(d, H, W, npoints, seed)
    pts = np.load(cfg["point_file"])
    big = max(1, round(10 * H / 1000))
    small = max(1, round(2 * H / 1000))
    poly = np.zeros((H, W))

    def square(r, c, h, pid):
        poly[max(r - h, 0):r + h + 1, max(c - h, 0):c + h + 1] = pid

    prng = np.random.default_rng(7)
    for pid in range(8, 21):
        square(prng.integers(0, H), prng.integers(0, W), big, pid)
    for pid in range(1, 7):
        square(*np.argwhere(pts == pid)[0], big, pid)
    for p in (7, 8):
        square(*np.argwhere(pts == p)[0], small, 7)
    path = os.path.join(d, "polygons.npy")
    np.save(path, poly)
    return dict(cfg, use_polygons="True", polygon_file=path), gmap, poly


def make_regions_job(d, H, W, nregions, half=2, seed=42):
    """The bench raster with nregions focal regions: (2 half + 1)^2
    blocks centred on bench points 1..nregions, every cell made active
    with |g| + 0.5 (as tests/test_regions_device.py builds its regions);
    the point file holds the regions only.  Returns the config dict."""
    cfg, _ = make_job(d, H, W, seed=seed)
    g = np.load(cfg["habitat_file"])
    pts = np.load(cfg["point_file"])
    regions = np.zeros_like(pts)
    for k in range(1, nregions + 1):
        r, c = np.argwhere(pts == k)[0]
        blk = np.s_[max(r - half, 0):r + half + 1, max(c - half, 0):c + half + 1]
        g[blk] = np.abs(g[blk]) + 0.5
        regions[blk] = k
    np.save(cfg["habitat_file"], g)
    np.save(cfg["point_file"], regions)
    return cfg


def make_advanced_job(d, H, W, polygons=False, seed=42):
    """The bench raster (with make_polygon_job's polygons if asked) as an
    advanced job on its 32 focal points: 1-16 sources of strength 1-16,
    17-24 finite grounds (resistance 2.0), 25-32 direct grounds
    (resistance 0, with ground_file_is_resistances), voltage and current
    maps on.  Returns (config dict, gmap, source grid, ground conductance
    grid with inf at direct grounds)."""
    if polygons:
        cfg, gmap, _ = make_polygon_job(d, H, W, seed=seed)
    else:
        cfg, gmap = make_job(d, H, W, seed=seed)
    pts = np.load(cfg["point_file"])
    src = np.where((pts >= 1) & (pts <= 16), pts, 0.0)
    gnd = np.full(pts.shape, -9999.0)
    gnd[(pts >= 17) & (pts <= 24)] = 2.0
    gnd[pts >= 25] = 0.0
    for name, a in (("sources", src), ("grounds", gnd)):
        np.save(os.path.join(d, f"{name}.npy"), a)
    cond = np.where(gnd == 2.0, 0.5, np.where(gnd == 0.0, np.inf, 0.0))
    return dict(cfg, scenario="advanced",
                source_file=os.path.join(d, "sources.npy"),
                ground_file=os.path.join(d, "grounds.npy"),
                ground_file_is_resistances="True", write_volt_maps="True",
                write_cur_maps="True",
                output_file=os.path.join(d, "adv.out")), gmap, src, cond


def make_onetoall_polygons(d, H, W, npoints=8, seed=42):
    """make_polygon_job's polygons without those that hold a focal point
    (1-7 are centred on points; a focal point inside a polygon makes the
    one-to-all device path diverge, in the JAX package as here), as a
    one-to-all job.  Returns the config dict."""
    cfg, _, poly = make_polygon_job(d, H, W, npoints, seed)
    pts = np.load(cfg["point_file"])
    for pid in np.unique(poly[(pts > 0) & (poly > 0)]):
        poly[poly == pid] = 0
    np.save(cfg["polygon_file"], poly)
    return dict(cfg, scenario="one-to-all")


def _lattice(d, n, seed):
    """The reference's network benchmark graph (bench_suite.py:342-366):
    n nodes, side int(sqrt(n)), an edge from node i to i + 1 and to
    i + side wherever that node exists, conductances uniform(0.5, 3.0),
    written 0-based to d/net.txt.  Returns (edges, weights, rng)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    i0 = np.arange(n)
    E = np.vstack([np.column_stack([i0[i0 + off < n], (i0 + off)[i0 + off < n]])
                   for off in (1, side)])
    w = rng.uniform(0.5, 3.0, len(E))
    np.savetxt(os.path.join(d, "net.txt"), np.column_stack([E, w]),
               fmt="%.6g")
    return E, w, rng


def make_network_job(d, n=100_000, nfocal=20, seed=42):
    """The reference's network pairwise benchmark job: _lattice's graph,
    nfocal focal nodes drawn without replacement (0-based file), cg+amg,
    single precision, per-pair and cumulative current files.  Returns
    the config dict."""
    _, _, rng = _lattice(d, n, seed)
    np.savetxt(os.path.join(d, "fp.txt"), rng.choice(n, nfocal,
                                                     replace=False), fmt="%d")
    return {"data_type": "network", "scenario": "pairwise",
            "habitat_file": os.path.join(d, "net.txt"),
            "habitat_map_is_resistances": "False",
            "point_file": os.path.join(d, "fp.txt"),
            "output_file": os.path.join(d, "n.out"),
            "write_cur_maps": "True", "solver": "cg+amg",
            "precision": "single", "suppress_messages": "True"}


def make_network_advanced_job(d, n=100_000, seed=42):
    """Network advanced on _lattice's graph: 16 source nodes (strengths
    1-16) and 16 ground nodes, 8 finite (resistance 2) and 8 direct
    (resistance 0), all distinct; voltages and currents written; cg+amg,
    double precision (in single precision the direct tier's 10 eps
    shift, a float32 leak to ground at every node, moves its voltages by
    ~3e-4 of their max on a 10,000-node lattice).  Returns (config dict, edges, weights, sources,
    grounds) with 0-based node ids."""
    E, w, rng = _lattice(d, n, seed)
    nodes = rng.choice(n, 32, replace=False)
    src = np.column_stack([nodes[:16], np.arange(1, 17)])
    gnd = np.column_stack([nodes[16:], np.r_[np.full(8, 2.0), np.zeros(8)]])
    np.savetxt(os.path.join(d, "src.txt"), src, fmt="%.6g")
    np.savetxt(os.path.join(d, "gnd.txt"), gnd, fmt="%.6g")
    return {"data_type": "network", "scenario": "advanced",
            "habitat_file": os.path.join(d, "net.txt"),
            "habitat_map_is_resistances": "False",
            "source_file": os.path.join(d, "src.txt"),
            "ground_file": os.path.join(d, "gnd.txt"),
            "ground_file_is_resistances": "True",
            "remove_src_or_gnd": "keepall",
            "output_file": os.path.join(d, "a.out"),
            "write_volt_maps": "True", "write_cur_maps": "True",
            "solver": "cg+amg", "precision": "double",
            "suppress_messages": "True"}, E, w, src, gnd


def make_scale_job(d, side=SCALE_SIDE, npoints=4):
    """bench_scale.py's job (the JAX package's 48M-cell single-device
    run): a side x side raster of conductances uniform(0.5, 3.0) from
    default_rng(7) with ~10% NODATA and npoints focal points (4 in
    bench_scale.py) placed as bench_scale.py places them, as NPY files
    in d; cg+amg, single precision, shortcut mode.  Returns (config
    dict, gmap)."""
    rng = np.random.default_rng(7)
    g = rng.uniform(0.5, 3.0, (side, side))
    g[rng.random((side, side)) < 0.10] = -9999.0
    np.save(os.path.join(d, "cell.npy"), g)
    pts = np.zeros((side, side))
    placed = 0
    while placed < npoints:
        r, c = rng.integers(0, side, 2)
        if g[r, c] > 0 and pts[r, c] == 0:
            placed += 1
            pts[r, c] = placed
    np.save(os.path.join(d, "pts.npy"), pts)
    del pts
    np.maximum(g, 0.0, out=g)
    return {"data_type": "raster", "scenario": "pairwise",
            "habitat_file": os.path.join(d, "cell.npy"),
            "habitat_map_is_resistances": "False",
            "point_file": os.path.join(d, "pts.npy"),
            "output_file": os.path.join(d, "o.out"),
            "solver": "cg+amg", "precision": "single",
            "suppress_messages": "True"}, g


def check_resistances(r, label, n=32, merged=False):
    """Finite, symmetric, n x n, positive off the diagonal (>= 0 when
    polygons may merge two points into one node)."""
    m = r[1:, 1:]
    off = ~np.eye(m.shape[0], dtype=bool)
    if m.shape != (n, n) or not np.all(np.isfinite(m)):
        raise AssertionError(f"{label}: resistances not finite {n}x{n}")
    if not np.all(m[off] >= 0 if merged else m[off] > 0):
        raise AssertionError(f"{label}: off-diagonal resistance "
                             f"{m[off].min()}")
    asym = np.abs(m - m.T).max() / np.abs(m).max()
    if asym > TOL:
        raise AssertionError(f"{label}: resistances not symmetric ({asym})")


def phase_build():
    """Build and load the kernels' library; beside the build, nvcc
    compiles each source once more to a cubin with `-Xptxas -v`, and
    each kernel's registers, shared memory and spills are printed as
    ptxas reports them (`registers ...` lines)."""
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    nvcc = cs._nvcc()
    note(subprocess.run([nvcc, "--version"], capture_output=True,
                        text=True, check=True).stdout.strip())
    t = time.perf_counter()
    os.makedirs(cs.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cs.BUILD_DIR) as tmp:
        flags = [f for f in cs.NVCC_FLAGS if f != "-shared"]
        ptxas = [subprocess.Popen(
            [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o",
             os.path.join(tmp, src.stem + ".cubin"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sorted(cs.CSRC.glob("*.cu"))]
        try:
            lib = cs.build()
            cs._load()
        finally:
            reports = [(p.communicate()[0], p.returncode) for p in ptxas]
    note(f"built {os.path.relpath(lib, HERE)} in "
         f"{time.perf_counter() - t:.1f} s")
    for out, rc in reports:
        if rc != 0:
            raise AssertionError(f"nvcc -Xptxas -v failed:\n{out}")
        for line in ptxas_kernels(out):
            note(line)


def ptxas_kernels(out):
    """`registers <kernel>: ...` lines from ptxas's -v report: each
    entry function's registers, shared memory (0 where ptxas names none)
    and spill bytes (a template's int or bool argument after its name:
    <4>, <1>)."""
    lines, name, spill = [], None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d([a-z][a-z_]*_kernel)(?:IL[ib](\d+)E)?",
                          m.group(1))
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                    if k else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f", spills {m.group(1)} / {m.group(2)} bytes"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                      line)
        if m and name:
            lines.append(f"registers {name}: {m.group(1)} registers, "
                         f"{m.group(2) or 0} bytes smem{spill}")
            name, spill = None, ""
    return lines


def _crop_operator(gmap, H, W, dev):
    """A float32 fine operator of an (H, W) crop of gmap (zero-padded
    where gmap is smaller) and its Dinv, on dev."""
    from circuitscape_tpu_torch.solve.stencil import (
        _to_dtype, stencil_from_gmap_device)
    g = np.zeros((H, W))
    h, w = min(H, gmap.shape[0]), min(W, gmap.shape[1])
    g[:h, :w] = gmap[:h, :w]
    A = _to_dtype(stencil_from_gmap_device(torch.as_tensor(g, device=dev),
                                           False, False), torch.float32)
    dinv = torch.where(A.diag > 0,
                       1.0 / torch.where(A.diag == 0, 1.0, A.diag),
                       0.0).contiguous()
    return A, dinv


def _inputs(gmap, B, H, W, rng, dev):
    """_crop_operator's operator and Dinv, and four random (B, H, W)
    blocks drawn on the host from rng, on dev."""
    A, dinv = _crop_operator(gmap, H, W, dev)
    blocks = [torch.as_tensor(rng.standard_normal((B, H, W)),
                              dtype=torch.float32, device=dev)
              for _ in range(4)]
    return A, dinv, blocks


def _card_blocks(B, H, W, dev, seed, n=4):
    """n standard normal (B, H, W) float32 blocks drawn on the card (a
    host draw at the scale job's shapes takes seconds a block)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, H, W), generator=gen, device=dev)
            for _ in range(n)]


def _pairs(name, A, dinv, blocks):
    """(kernel call, plain call) for one kernel on the given inputs."""
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    x, b, r, d = blocks
    ca, cb = 0.37, 1.21
    c = 0.8
    return {
        "matvec": (lambda: cs.matvec(A, x), lambda: cs.matvec_plain(A, x)),
        "matvec_pap": (lambda: cs.matvec_pap(A, x),
                       lambda: cs.matvec_pap_plain(A, x)),
        "cheb_step": (lambda: cs.cheb_step(A, dinv, r, d, x, ca, cb),
                      lambda: cs.cheb_step_plain(A, dinv, r, d, x, ca, cb)),
        "residual_restrict": (lambda: cs.residual_restrict(A, b, x),
                              lambda: cs.residual_restrict_plain(A, b, x)),
        "cheb_init": (lambda: cs.cheb_init(A, dinv, b, c, ca, cb),
                      lambda: cs.cheb_init_plain(A, dinv, b, c, ca, cb)),
        "residual_init": (lambda: cs.residual_init(A, dinv, b, x, c),
                          lambda: cs.residual_init_plain(A, dinv, b, x, c)),
        "cheb_finish": (lambda: cs.cheb_finish(A, dinv, r, x, c, ca, cb),
                        lambda: cs.cheb_finish_plain(A, dinv, r, x, c, ca,
                                                     cb)),
    }[name]


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def _csr_laplacian(A):
    """The operator's nonzeros as one (H*W, H*W) CSR matrix on its
    device: the input of the library sparse product timed beside the
    matvec kernel."""
    H, W = A.shape
    idx = torch.arange(H * W, device=A.diag.device).reshape(H, W)
    keep = A.diag.ravel() != 0
    rows, cols, vals = [idx.ravel()[keep]], [idx.ravel()[keep]], \
        [A.diag.ravel()[keep]]
    for p, di, dj in ((A.we, 0, 1), (A.ws, 1, 0), (A.wse, 1, 1),
                      (A.wne, -1, 1)):
        i0, i1 = max(0, -di), H - max(0, di)
        j0, j1 = max(0, -dj), W - max(0, dj)
        w = p[i0:i1, j0:j1].ravel()
        keep = w != 0
        src = idx[i0:i1, j0:j1].ravel()[keep]
        dst = idx[i0 + di:i1 + di, j0 + dj:j1 + dj].ravel()[keep]
        rows += [src, dst]
        cols += [dst, src]
        vals += [-w[keep], -w[keep]]
    with warnings.catch_warnings():
        # torch warns that sparse CSR is beta and invariant checks are off
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]),
            torch.cat(vals), (H * W, H * W)).coalesce().to_sparse_csr()


def _library_matvec(A, x):
    """One PyTorch call that computes y = L x: a CSR sparse product
    (cuSPARSE) on x's (H*W, B) column-major view.  Returns the call,
    after holding its result against the plain matvec."""
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    B, H, W = x.shape
    L = _csr_laplacian(A)
    xt = x.reshape(B, H * W).t()

    def call():
        return torch.sparse.mm(L, xt)
    ref = cs.matvec_plain(A, x)
    err = float((call().t().reshape(B, H, W) - ref).abs().max())
    if not err <= TOL * float(ref.abs().max()):
        raise AssertionError(f"library sparse product disagrees with the "
                             f"plain matvec by {err} at B={B} {H}x{W}")
    return call


def check_kernel(name, kern, plain, label) -> float:
    """Hold one kernel call against its plain version (max |kernel -
    plain| <= TOL * max |plain| on every output; matvec_pap's p.Ap also
    bit-identical on a second call).  Returns the max abs error."""
    got, ref = _as_tuple(kern()), _as_tuple(plain())
    if name == "matvec_pap":
        # fixed-order block sums: p.Ap must repeat to the bit
        again = kern()
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            raise AssertionError(f"matvec_pap {label}: two calls on the "
                                 f"same input differ")
    torch.cuda.synchronize()
    worst = 0.0
    for g_, r_ in zip(got, ref):
        err = float((g_ - r_).abs().max())
        scale = float(r_.abs().max())
        if not err <= TOL * scale:
            raise AssertionError(f"{name} {label}: max err {err} > "
                                 f"{TOL} * {scale}")
        worst = max(worst, err)
    return worst


def phase_kernels(gmap, dev, dev_name):
    """Every kernel against its plain version; timings at the main
    path's shapes.  Returns {name: row of the kernels line}."""
    from circuitscape_tpu_torch import stats
    rng = np.random.default_rng(7)
    rate = stats.device_bytes_per_s(dev_name)
    flops = next((f for k, f in FP32_FLOPS if k in dev_name), None)
    if rate is None or flops is None:
        raise AssertionError(f"no published peaks for {dev_name}")
    rows = {}
    for H, W in SHAPES:
        for B in BATCHES:
            if (H, W) == MAIN_HW and B != MAIN_B:
                continue
            A, dinv, blocks = _inputs(gmap, B, H, W, rng, dev)
            for name, replaces, fl in KERNELS:
                kern, plain = _pairs(name, A, dinv, blocks)
                row = rows.setdefault(name, {
                    "name": name, "route": "cuda", "source": SOURCE,
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": 0.0})
                row["max_abs_err"] = max(
                    row["max_abs_err"],
                    check_kernel(name, kern, plain, f"B={B} {H}x{W}"))
                if (H, W) == MAIN_HW:
                    nbytes = kernel_bytes(name, B, H, W)
                    nops = fl * B * H * W
                    t_bytes, t_ops = nbytes / rate * 1e3, nops / flops * 1e3
                    row.update(
                        ms=cuda_ms(kern), plain_ms=cuda_ms(plain, n=5),
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations",
                        library_ms=None)
                    if name == "matvec":
                        # the only one of the seven that one PyTorch call
                        # computes; the others have no single-call form
                        lib = _library_matvec(A, blocks[0])
                        row["library_ms"] = cuda_ms(lib)
                        del lib
            del A, dinv, blocks
        note(f"kernels agree with their plain versions at {H}x{W}, "
             f"B in {BATCHES if (H, W) != MAIN_HW else (MAIN_B,)}")
    for row in rows.values():
        note(f"{row['name']}: {row['ms']:.4f} ms (plain "
             f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, "
             f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
             f"B={MAIN_B} {MAIN_HW}")
    return rows, time_levels(gmap, dev, rate, rows)


def time_levels(gmap, dev, rate, rows):
    """Every kernel at B = 32 on each level shape of the bench hierarchy
    where the main path launches it: held against its plain version
    there (check_kernel; the error joins its row of the kernels line),
    then timed beside its byte bound and, for matvec, the library sparse
    product on the same inputs.  Each time is the least of three runs of
    50 launches: on the small levels a run whose host falls behind the
    spin kernel reads several times slow.  Returns {name: {(H, W): (ms,
    bound ms)}}."""
    rng = np.random.default_rng(11)
    times = {name: {} for name, _ in LEVEL_KERNELS}
    for H, W in LEVELS:
        A, dinv, blocks = _inputs(gmap, MAIN_B, H, W, rng, dev)
        for name, levels in LEVEL_KERNELS:
            if (H, W) not in levels:
                continue
            kern, plain = _pairs(name, A, dinv, blocks)
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], check_kernel(
                name, kern, plain, f"level B={MAIN_B} {H}x{W}"))
            ms = min(cuda_ms(kern, n=50) for _ in range(3))
            bound = kernel_bytes(name, MAIN_B, H, W) / rate * 1e3
            times[name][(H, W)] = (ms, bound)
            lib = ""
            if name == "matvec":
                call = _library_matvec(A, blocks[0])
                lib = (f", library "
                       f"{min(cuda_ms(call, n=50) for _ in range(3)):.4f} ms")
            note(f"level {name} B={MAIN_B} {H}x{W}: {ms:.4f} ms{lib}, byte "
                 f"bound {bound:.4f} ms, {100 * bound / ms:.1f}% of bound")
        del A, dinv, blocks
    return times


def hierarchy_shapes(H, W, coarse_cells=256, max_levels=12):
    """The level shapes of a multigrid hierarchy over an (H, W) fine
    level: the loop of the port's build_geo_mg and build_geo_mg_device."""
    shapes = []
    while (H * W > coarse_cells and len(shapes) < max_levels and
           min(H, W) >= 2):
        shapes.append((H, W))
        H, W = -(-H // 2), -(-W // 2)
    return tuple(shapes)


def pair_solve_kernels(shapes):
    """Per kernel, the level shapes where a pair solve on a hierarchy of
    these shapes launches it: matvec_pap and matvec (the CG body and its
    residual replacement) on the fine level, residual_restrict on every
    level, the fused smoother (cheb_init, residual_init, cheb_finish)
    where geomg.fused_smoother_supported admits the level, cheb_step and
    matvec elsewhere."""
    from circuitscape_tpu_torch.solve.geomg import fused_smoother_supported
    fused = tuple(s for s in shapes if fused_smoother_supported(s))
    generic = tuple(s for s in shapes if not fused_smoother_supported(s))
    return (("matvec", tuple(dict.fromkeys(shapes[:1] + generic))),
            ("matvec_pap", shapes[:1]), ("cheb_step", generic),
            ("residual_restrict", shapes), ("cheb_init", fused),
            ("residual_init", fused), ("cheb_finish", fused))


def time_scale_levels(gmap, dev, rate, rows):
    """Every kernel at the scale job's batch (B = 4) on each level shape
    of its hierarchy where its pair solve launches it (7040^2: the
    TPU's column-tiled _kernel / _cheb_kernel width; 3520^2 down to
    110^2: the fused smoother), on the operator of the scale job's own
    conductance map (time_shapes; the plain version timed too at the two
    finest levels).  Returns {name: {(H, W): (ms, bound ms)}}."""
    shapes = hierarchy_shapes(*SCALE_HW)
    return time_shapes(gmap, dict(pair_solve_kernels(shapes)), SCALE_B,
                       dev, rate, rows, "scale level", plain_at=shapes[:2])


def time_shapes(gmap, per_kernel, B, dev, rate, rows, tag, plain_at=()):
    """Each kernel at batch B on each of its shapes in per_kernel ({name:
    shapes}), on _crop_operator's operator of gmap there: held against
    its plain version (check_kernel; the error joins its row of the
    kernels line), timed (least of three runs of 20 launches) beside its
    byte bound; at the shapes of plain_at the plain version timed too,
    and matvec beside the library sparse product wherever it launches.
    Returns {name: {(H, W): (ms, bound ms)}}."""
    shapes = sorted({hw for hws in per_kernel.values() for hw in hws},
                    reverse=True)
    times = {name: {} for name in per_kernel}
    for H, W in shapes:
        A, dinv = _crop_operator(gmap, H, W, dev)
        blocks = _card_blocks(B, H, W, dev, seed=H)
        for name, levels in per_kernel.items():
            if (H, W) not in levels:
                continue
            kern, plain = _pairs(name, A, dinv, blocks)
            label = f"{tag} B={B} {H}x{W}"
            rows[name]["max_abs_err"] = max(
                rows[name]["max_abs_err"],
                check_kernel(name, kern, plain, label))
            ms = min(cuda_ms(kern, n=20) for _ in range(3))
            bound = kernel_bytes(name, B, H, W) / rate * 1e3
            times[name][(H, W)] = (ms, bound)
            extra = ""
            if (H, W) in plain_at:
                extra += f", plain {cuda_ms(plain, n=3, warm=1):.4f} ms"
            if name == "matvec":
                call = _library_matvec(A, blocks[0])
                extra += (f", library "
                          f"{min(cuda_ms(call, n=20) for _ in range(3)):.4f}"
                          " ms")
                del call
            note(f"{label} {name}: {ms:.4f} ms{extra}, byte bound "
                 f"{bound:.4f} ms, {100 * bound / ms:.1f}% of bound")
        del A, dinv, blocks
        torch.cuda.empty_cache()
    return times


def check_past_2_31(gmap, dev, rows, names=None):
    """Each kernel (of names, default all) launched once at B = 44 on
    the scale job's 7040^2 fine level, 2.18e9 floats a block (past 2^31,
    where an int offset across the batch would wrap): its first and last
    columns held against the plain version run on those columns alone,
    max |kernel - plain| <= TOL * max |plain|; the error joins the
    kernel's entry of rows.  Two 8.7 GB input blocks u and v, which a
    kernel with more inputs reads in several roles."""
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    H, W = SCALE_HW
    B = SCALE_BIG_B
    if not B * H * W > 2**31:
        raise AssertionError(f"B*H*W = {B * H * W} does not pass 2^31")
    A, dinv = _crop_operator(gmap, H, W, dev)
    u, v = _card_blocks(B, H, W, dev, seed=31, n=2)
    c, ca, cb = 0.8, 0.37, 1.21
    calls = {
        "matvec": (lambda u, v: cs.matvec(A, v),
                   lambda u, v: cs.matvec_plain(A, v)),
        "matvec_pap": (lambda u, v: cs.matvec_pap(A, v),
                       lambda u, v: cs.matvec_pap_plain(A, v)),
        "cheb_step": (
            lambda u, v: cs.cheb_step(A, dinv, u, v, u, ca, cb),
            lambda u, v: cs.cheb_step_plain(A, dinv, u, v, u, ca, cb)),
        "residual_restrict": (
            lambda u, v: cs.residual_restrict(A, u, v),
            lambda u, v: cs.residual_restrict_plain(A, u, v)),
        "cheb_init": (lambda u, v: cs.cheb_init(A, dinv, u, c, ca, cb),
                      lambda u, v: cs.cheb_init_plain(A, dinv, u, c, ca,
                                                      cb)),
        "residual_init": (
            lambda u, v: cs.residual_init(A, dinv, u, v, c),
            lambda u, v: cs.residual_init_plain(A, dinv, u, v, c)),
        "cheb_finish": (
            lambda u, v: cs.cheb_finish(A, dinv, u, v, c, ca, cb),
            lambda u, v: cs.cheb_finish_plain(A, dinv, u, v, c, ca, cb)),
    }
    for name, (kern, plain) in calls.items():
        if names is not None and name not in names:
            continue
        got = _as_tuple(kern(u, v))
        torch.cuda.synchronize()
        worst = 0.0
        for k in (0, B - 1):
            ref = _as_tuple(plain(u[k:k + 1], v[k:k + 1]))
            for g_, r_ in zip(got, ref):
                err = float((g_[k:k + 1] - r_).abs().max())
                scale = float(r_.abs().max())
                if not err <= TOL * scale:
                    raise AssertionError(
                        f"{name} at B={B} {H}x{W}: column {k} differs from "
                        f"the plain version by {err} > {TOL} * {scale}")
                worst = max(worst, err)
        del got, ref
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], worst)
        note(f"{name} at B={B} {H}x{W} ({B * H * W} floats a block, past "
             f"2^31): columns 0 and {B - 1} agree with the plain version "
             f"to {worst:.3e}")
    del u, v, A, dinv
    torch.cuda.empty_cache()


def note_per_job(level_times, launches_at, label=""):
    """Each kernel's time per job: its time on each level shape (B = 32)
    times the launches the job made there (cuda_stencil.LAUNCHES_AT of
    the job's run), summed, beside the same sum of its byte bounds.
    Fails on a launch at a shape phase 2 did not time."""
    for name, per_level in level_times.items():
        at = {(H, W): n for (k, H, W), n in launches_at.items() if k == name}
        if set(at) - set(per_level):
            raise AssertionError(f"{name} launched at untimed shapes "
                                 f"{sorted(set(at) - set(per_level))}")
        total = sum(at.values())
        ms = sum(per_level[hw][0] * n for hw, n in at.items())
        bound = sum(per_level[hw][1] * n for hw, n in at.items())
        if not total:
            note(f"per_job{label} {name}: not launched")
            continue
        counts = set(at.values())
        split = (f"{counts.pop()} per level" if len(counts) == 1 else
                 ", ".join(f"{n} at {H}x{W}" for (H, W), n in
                           sorted(at.items(), reverse=True)))
        note(f"per_job{label} {name}: {ms:.4f} ms over {total} launches "
             f"({split}), byte bound {bound:.4f} ms, "
             f"{100 * bound / ms:.1f}% of bound")


def time_job(cfg, runs=2, device="cuda", label="main path", log=note,
             after=None):
    """`runs` full compute(cfg, device) runs, each with the launch
    counters set to 0 just before it and every card synchronized before
    and after it (a mesh job runs on several; the timing of
    bench_torch.py, bench_suite_torch.py and phase 3).  Logs each run's
    wall time and, untimed, passes each run's result to `after` where
    one is given (bench_suite_torch.py reads each run's stats there).
    Returns (the last result, the wall seconds of each run, the last
    run's launches and launches per shape, its stats.finalize())."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs

    def sync():
        if torch.device(device).type == "cuda":
            _sync(cards())

    times = []
    for run in range(runs):
        sync()
        cs.reset_launch_counts()
        t = time.perf_counter()
        r = cst.compute(cfg, device=device)
        sync()
        times.append(time.perf_counter() - t)
        launches = dict(cs.LAUNCHES)
        launches_at = dict(cs.LAUNCHES_AT)
        log(f"{label} run {run}: {times[-1]:.6f} s, launches {launches}")
        if after is not None:
            after(r)
    return r, times, launches, launches_at, stats.finalize()


def phase_main(cfg, rows, golden):
    """The bench job on the card: warm run, then two timed runs with the
    launch counters zeroed just before each (time_job); prints
    bench_torch.py's JSON line of the two runs, with `golden` (the
    golden replay's default-route verdict) as its cuda_golden."""
    import bench_torch
    import circuitscape_tpu_torch as cst

    cst.compute(cfg, device="cuda")
    r, times, launches, launches_at, st = time_job(cfg)
    best = min(times)
    check_resistances(r, "main path")
    check_launched(launches, "main path")
    for name, n in launches.items():
        rows[name]["launches"] = n
    note(f"main path: best of 2 = {best:.3f} s, cg_iters "
         f"{st.get('cg_iters')}, mg_kernels {st.get('mg_kernels')}, "
         f"solve_s {st.get('solve_s'):.3f}")
    if st.get("cg_iters") != CG_ITERS:
        raise AssertionError(f"main path: {st.get('cg_iters')} CG "
                             f"iterations, expected {CG_ITERS}")
    line = bench_torch.bench_line(times, st, "cuda")
    line["cuda_golden"] = golden
    print(json.dumps(line), flush=True)
    return r, launches_at


def check_launched(launches, label):
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{label}")


def phase_pen_kernels(gmap, cond, dev):
    """Each kernel against its plain version on every level of the
    advanced job's penalty-baked hierarchy (1024^2 down to 32^2, the
    ground field coarsened into every diagonal), at B = 1 (the advanced
    job's width, whose launches split the grid differently) and B = 32
    (one-to-all's and all-to-one's chunk width).  A penalized
    cell's value is ~1e8 times its neighbours', so a tolerance relative
    to max |plain| would hide every other cell: the comparison is per
    cell, |kernel - plain| <= TOL * (|plain| + max |plain| over the
    unpenalized cells), and per column for matvec_pap's p.Ap.  Returns
    {B: {name: worst ratio of error to that bound's scale}}."""
    from circuitscape_tpu_torch.solve.prepare import \
        prepare_stencil_solver_from_gmap_pen
    _, prec, _, _, _ = prepare_stencil_solver_from_gmap_pen(
        gmap, False, False, cond, dev)
    rng = np.random.default_rng(17)
    names = [name for name, _, _ in KERNELS]
    worst = {B: {name: 0.0 for name in names} for B in PEN_BATCHES}
    for L in prec.levels:
        for B in PEN_BATCHES:
            for name, rel in check_pen_level(L, B, names, dev, rng).items():
                worst[B][name] = max(worst[B][name], rel)
        A = L.A
        note(f"pen-baked level {A.shape[0]}x{A.shape[1]}: "
             f"{int(_penalized(A).sum())} penalized cells, diag max/median "
             f"{float(A.diag.max() / A.diag.median()):.3g}; all seven "
             f"kernels agree per cell at B in {PEN_BATCHES}")
    for B, w in worst.items():
        note(f"pen-baked hierarchy B={B}, worst error per cell scale: " +
             ", ".join(f"{k} {v:.2e}" for k, v in w.items()))
    return worst


def _penalized(A):
    """The cells of a pen-baked level whose diagonal carries a ground."""
    from circuitscape_tpu_torch.solve.geomg import _diag_from_planes_torch
    return (A.diag - _diag_from_planes_torch(A.we, A.ws, A.wse, A.wne)) > 0


def check_pen_level(L, B, names, dev, rng):
    """Each kernel of `names` against its plain version on one level of a
    pen-baked hierarchy at batch B, per cell: |kernel - plain| <= TOL *
    (|plain| + max |plain| over the unpenalized cells), per column for
    matvec_pap's p.Ap.  Returns {name: worst ratio of error to scale}."""
    from circuitscape_tpu_torch.solve.geomg import _restrict
    A, H, W = L.A, *L.A.shape
    pen = _penalized(A)
    masks = {(H, W): pen,
             (-(-H // 2), -(-W // 2)): _restrict(pen[None].float())[0] > 0}
    blocks = [torch.as_tensor(rng.standard_normal((B, H, W)),
                              dtype=torch.float32, device=dev)
              for _ in range(4)]
    worst = {}
    for name in names:
        kern, plain = _pairs(name, A, L.inv_diag, blocks)
        for g_, r_ in zip(_as_tuple(kern()), _as_tuple(plain())):
            if r_.dim() == 1:
                scale = r_.abs()
            else:
                m = masks[tuple(r_.shape[-2:])]
                scale = r_.abs() + r_.abs()[:, ~m].max()
            rel = float(((g_ - r_).abs() / scale).max())
            if not rel <= TOL:
                raise AssertionError(
                    f"{name} on the pen-baked level {H}x{W} at B={B}: "
                    f"error {rel} of the per-cell scale > {TOL}")
            worst[name] = max(worst.get(name, 0.0), rel)
    return worst


class record_passes:
    """Records the CG iteration count of every inner pass (a call of
    mod.<fn>: by default this package's stencil_cg; with mod set to a
    solve/dispatch module and fn="cg_batched", the general tier's ELL
    CG) while active, and with keep=True the pass's arguments, each
    tensor among them copied as the pass received it (a caller may write
    the next pass's right-hand side into the same block).  The port's
    tests use it on both packages."""

    def __init__(self, keep=False, mod=None, fn="stencil_cg"):
        self.keep, self.mod, self.fn = keep, mod, fn
        self.iters, self.calls = [], []

    def __enter__(self):
        if self.mod is None:
            from circuitscape_tpu_torch.solve import stencil as st
            self.mod = st
        self.real = getattr(self.mod, self.fn)

        def rec(*a, **k):
            if self.keep:
                self.calls.append(_snapshot((a, k)))
            out = self.real(*a, **k)
            self.iters.append(int(out[2]))
            return out
        setattr(self.mod, self.fn, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.fn, self.real)

    def replay_on_cpu(self):
        """Each recorded pass rerun on the CPU (plain versions) from the
        same operator, right-hand side, tolerance, hierarchy, penalty
        and projector; returns the iteration counts."""
        return [int(self.real(*_cpu(a), **_cpu(k))[2])
                for a, k in self.calls]


def _snapshot(x):
    """Tensors, and the tuples, lists and dicts holding them, copied;
    anything else (operators, hierarchies, projectors) as it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_snapshot(v) for v in x)
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    return x


def _cpu(x):
    """Tensors, and the dataclasses, tuples and dicts holding them
    (operators, hierarchies, projectors), copied to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x


def run_job(cfg, label):
    """One run of cfg on the card with the launch counters zeroed just
    before it.  Returns (result, seconds, launches, launches per shape,
    CG iterations, CG iterations per pass)."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    with record_passes() as rp:
        t = time.perf_counter()
        r = cst.compute(cfg, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    launches, launches_at = dict(cs.LAUNCHES), dict(cs.LAUNCHES_AT)
    iters = stats.finalize().get("cg_iters")
    sections = _sections()
    at = ", ".join(f"{k} {H}x{W}: {n}" for (k, H, W), n in
                   sorted(launches_at.items()))
    note(f"{label} run: {dt:.3f} s, cg_iters {iters} (per pass "
         f"{rp.iters}), launches {launches}; per shape {at}; sections "
         f"{sections}")
    return r, dt, launches, launches_at, iters, rp.iters


def phase_advanced(cfg, gmap, src, cond):
    """The advanced job at full width (16 sources, 8 finite and 8 direct
    grounds, voltage and current maps, single precision): one run with
    the counters zeroed just before it.  The residual of its float64
    solution (the batched solve's output, before the float32 cast) in
    (L + G) v = s, over the components holding a ground, with L the
    sparse Laplacian of graph/build (not the solve's stencil builder)
    and the direct grounds' penalty 1e8 max diag L, under the gate; the job's voltages >= -1e-6 max, with the maximum at a
    source (maximum principle); all seven kernels launched, matvec_pap
    on the 1024^2 level (the CG body on the pen-baked fine operator)."""
    from scipy import ndimage

    from circuitscape_tpu_torch import consts
    from circuitscape_tpu_torch.graph import build
    from circuitscape_tpu_torch.solve import stencil as st
    solve, solutions = st.stencil_solve_advanced_batch, []

    def keep(*a, **k):
        out = solve(*a, **k)
        solutions.append(out[0])
        return out
    st.stencil_solve_advanced_batch = keep
    try:
        v, dt, launches, launches_at, iters, _ = run_job(cfg, "advanced job")
    finally:
        st.stencil_solve_advanced_batch = solve
    H, W = gmap.shape
    x = solutions[0][0, :H, :W].cpu().numpy()
    lab, _ = ndimage.label(gmap > 0, structure=np.ones((3, 3)))
    grounded = np.unique(lab[(cond > 0) & (lab > 0)])
    nodemap = build.construct_node_map(gmap, np.zeros((0, 0)))
    L = build.laplacian(build.construct_graph(gmap, nodemap, False, False))

    def nodes(a):
        out = np.zeros(L.shape[0])
        out[nodemap[nodemap > 0] - 1] = a[nodemap > 0]
        return out
    pen = nodes(np.where(np.isinf(cond), 1e8 * L.diagonal().max(), cond))
    s, xn = nodes(np.where(np.isin(lab, grounded), src, 0.0)), nodes(x)
    res = s - (L @ xn + pen * xn)
    rel = float(np.linalg.norm(res) / np.linalg.norm(s))
    if not rel < consts.RESIDUAL_GATE:
        raise AssertionError(f"advanced job: residual {rel}")
    top = np.unravel_index(np.argmax(v), v.shape)
    if not (np.all(np.isfinite(v)) and v.min() >= -1e-6 * v.max() and
            src[top] > 0):
        raise AssertionError(f"advanced job: voltages {v.min()}..{v.max()}, "
                             f"maximum at {top} (source {src[top]})")
    check_launched(launches, "advanced job")
    fine = launches_at.get(("matvec_pap", *MAIN_HW), 0)
    if fine < iters:
        raise AssertionError(f"advanced job: matvec_pap at {MAIN_HW} "
                             f"launched {fine} times for {iters} CG "
                             "iterations")
    note(f"advanced job: {dt:.3f} s, {iters} CG iterations, residual "
         f"{rel:.3e}, voltages {v.min():.3e}..{v.max():.6g}"
         f" with the maximum at source {int(src[top])}, matvec_pap at "
         f"{MAIN_HW[0]}x{MAIN_HW[1]} {fine} launches (B = 1: phase 2's "
         "B = 32 level times do not apply; profile_torch.py --advanced "
         "gives its kernel times)")
    return v


def check_unfused(label, launches, launches_at, iters):
    """The all-to-one CG body: the matvec kernel on the 1024^2 level
    every iteration, matvec_pap never; every other kernel launched."""
    fine = launches_at.get(("matvec", *MAIN_HW), 0)
    if fine < iters or launches["matvec_pap"] != 0:
        raise AssertionError(f"{label}: matvec at {MAIN_HW} launched {fine} "
                             f"times for {iters} CG iterations, matvec_pap "
                             f"{launches['matvec_pap']} times")
    check_launched({k: n for k, n in launches.items() if k != "matvec_pap"},
                   label)
    return fine


def phase_onetoall(cfg, r_plain, level_times):
    """The one-to-all job at full width: the bench raster and its 32
    points in one batch, maps off, one run with the counters zeroed just
    before it.  Each result (point i against all others grounded) is
    positive, finite and at most min over j of the bench job's R[i, j]
    (grounding the other points shorts them together).  The columns
    solve the penalty-baked operator itself (the harmonic of each
    point): every kernel launched, matvec_pap on the 1024^2 level every
    CG iteration."""
    cfg = dict(cfg, scenario="one-to-all", output_file=os.path.join(
        os.path.dirname(cfg["output_file"]), "o2a.out"))
    r, dt, launches, launches_at, iters, _ = run_job(cfg, "one-to-all job")
    m = r_plain[1:, 1:]
    bound = np.min(np.where(np.eye(32, dtype=bool), np.inf, m), axis=1)
    res = r[:, 1]
    np.testing.assert_array_equal(r[:, 0], r_plain[0, 1:])
    if not (np.all(np.isfinite(res)) and np.all(res > 0) and
            np.all(res <= bound * (1 + 1e-4))):
        raise AssertionError(f"one-to-all job: results {res} against the "
                             f"pairwise bound {bound}")
    check_launched(launches, "one-to-all job")
    fine = launches_at.get(("matvec_pap", *MAIN_HW), 0)
    if fine < iters:
        raise AssertionError(f"one-to-all job: matvec_pap at {MAIN_HW} "
                             f"launched {fine} times for {iters} CG "
                             "iterations")
    note(f"one-to-all job: {dt:.3f} s, {iters} CG iterations, result / "
         f"min pairwise R {float((res / bound).min()):.4f}.."
         f"{float((res / bound).max()):.4f}, matvec_pap at "
         f"{MAIN_HW[0]}x{MAIN_HW[1]} {fine} launches")
    note_per_job(level_times, launches_at, " one-to-all job")


def phase_alltoone(cfg, gmap, level_times):
    """The all-to-one job at full width: 32 points with the cumulative
    current map (write_cum_cur_map_only and write_cur_maps; the device
    path then writes no map per point, where the JAX package's writes
    the 32), one run with the counters zeroed just before it.  Results all
    0; the cumulative map finite, >= 0 on active cells, > 0 somewhere."""
    d = os.path.dirname(cfg["output_file"])
    cfg = dict(cfg, scenario="all-to-one", write_cum_cur_map_only="True",
               write_cur_maps="True", output_file=os.path.join(d, "a2o.out"))
    r, dt, launches, launches_at, iters, _ = run_job(cfg, "all-to-one job")
    cum = read_asc(os.path.join(d, "a2o_cum_curmap.asc"))
    active = gmap > 0
    if not (np.all(r[:, 1] == 0) and cum.shape == gmap.shape and
            np.all(np.isfinite(cum)) and np.all(cum[active] >= 0) and
            np.any(cum > 0)):
        raise AssertionError("all-to-one job: results not 0, or cumulative "
                             "map not finite, non-negative and non-zero")
    fine = check_unfused("all-to-one job", launches, launches_at, iters)
    note(f"all-to-one job: {dt:.3f} s, {iters} CG iterations, cumulative "
         f"map max {cum.max():.6g}, matvec at {MAIN_HW[0]}x{MAIN_HW[1]} "
         f"{fine} launches, matvec_pap 0")
    note_per_job(level_times, launches_at, " all-to-one job")


class chunk_footprint:
    """While active, measures the device bytes a job's batched stencil
    solve holds per grid cell and RHS column above what is resident
    when the job takes its chunk budget (the operator and the
    hierarchy), on every card the job runs on (a mesh's devices, or its
    one device).  At that call (dispatch.solve_chunk_budget) it records
    the cells, each card's allocated bytes, free bytes and peak so far,
    and resets the peaks; hold() folds each card's peak so far into the
    solve's and resets it, so a check run inside the job (residuals64)
    leaves the solve's figures alone.  per_card_column(width) is each
    card's (solve peak - resident) over its share of cells x width
    columns, the figure the chunk model (dispatch.COLUMN_BYTES_PER_CELL)
    must cover; per_cell_column(width) the largest."""

    def __enter__(self):
        from circuitscape_tpu_torch.solve import dispatch
        self.mod, self.real = dispatch, dispatch.solve_chunk_budget
        self.cells = self.mesh = self.budget = None
        self.devices, self.held = [], {}

        def rec(cells, device, *a, **k):
            self.mesh = k.get("mesh")
            self.devices = (list(dict.fromkeys(
                d for row in self.mesh.devices for d in row))
                if self.mesh is not None else [torch.device(device)])
            _sync(self.devices)
            self.cells = cells
            self.resident = {d: torch.cuda.memory_allocated(d)
                             for d in self.devices}
            self.free = {d: dispatch._free_bytes(d) for d in self.devices}
            self.setup_peak = card_peaks(self.devices)
            reset_peaks(self.devices)
            self.budget = self.real(cells, device, *a, **k)
            return self.budget
        dispatch.solve_chunk_budget = rec
        return self

    def __exit__(self, *exc):
        self.mod.solve_chunk_budget = self.real

    def hold(self):
        _sync(self.devices)
        for d, b in card_peaks(self.devices).items():
            self.held[d] = max(self.held.get(d, 0), b)
        reset_peaks(self.devices)

    def solve_peak(self, d=None):
        d = self.devices[0] if d is None else d
        return max(self.held.get(d, 0), torch.cuda.max_memory_allocated(d))

    def peak(self, d=None):
        d = self.devices[0] if d is None else d
        return max(self.setup_peak[d], self.solve_peak(d))

    def share(self, d):
        """The fraction of the grid's cells x columns card d holds: its
        mesh positions over the mesh's (1 on one device)."""
        if self.mesh is None:
            return 1.0
        return sum(x == d for row in self.mesh.devices
                   for x in row) / self.mesh.size

    def per_card_column(self, width):
        if self.cells is None:
            raise AssertionError("no chunk budget was taken")
        return {d: (self.solve_peak(d) - self.resident[d]) /
                (self.cells * self.share(d) * width) for d in self.devices}

    def per_cell_column(self, width):
        return max(self.per_card_column(width).values())


def check_chunk_model(fp, sd, label):
    """The measured bytes per cell and column of the job's padded batch
    (stats batch_width rounded up to a power of two, as the pair solve
    pads it) held to the chunk model."""
    from circuitscape_tpu_torch.solve.dispatch import COLUMN_BYTES_PER_CELL
    width = 1 << (int(sd["batch_width"]) - 1).bit_length()
    per = fp.per_cell_column(width)
    note(f"{label} chunk model: batch width {sd['batch_width']} (padded "
         f"{width}), {fp.cells} cells, resident {fp.resident[fp.devices[0]]}"
         f" B at the budget, solve peak {fp.solve_peak()} B, "
         f"job peak {fp.peak()} B ({fp.peak() / 2**30:.3f} GiB): "
         f"{per:.3f} B a cell per column against the model's "
         f"{COLUMN_BYTES_PER_CELL}")
    if per > COLUMN_BYTES_PER_CELL:
        raise AssertionError(f"{label}: {per:.3f} B a cell per column "
                             f"above the chunk model's "
                             f"{COLUMN_BYTES_PER_CELL}")


def phase_chunk_model(d):
    """The scale job's recipe with 32 points (31 anchor columns) once
    under the default chunk budget, where the budget, not the pair
    count, sets the batch width: resistances finite, symmetric and
    positive, and the solve's bytes per cell and column within the
    chunk model."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    cfg, _ = make_scale_job(d, npoints=32)
    torch.cuda.empty_cache()
    with chunk_footprint() as fp:
        t = time.perf_counter()
        r = cst.compute(cfg, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    sd = stats.finalize()
    note(f"chunk-model job (6930^2, 32 points): {dt:.3f} s wall, "
         f"{sd.get('cg_iters')} CG iterations (per refinement pass "
         f"{sd.get('pass_iters')}), sections {_sections()}")
    check_resistances(r, "chunk-model job", n=32)
    check_chunk_model(fp, sd, "chunk-model job")
    torch.cuda.empty_cache()


def _column_rows(X, k, lo, hi, dev):
    """Rows [lo, hi) of column k of X (a full (B, H, W) tensor or a
    batched MeshBlock) as one (hi - lo, W) tensor on dev, zero rows
    where the range passes the grid's top or bottom."""
    H, W = X.shape[-2:]
    out = []
    if lo < 0:
        out.append(torch.zeros((-lo, W), dtype=X.dtype, device=dev))
    a, b = max(lo, 0), min(hi, H)
    if not hasattr(X, "parts"):
        out.append(X[k, a:b].to(dev))
    else:
        j, kk = 0, k
        while kk >= X.col_counts[j]:
            kk -= X.col_counts[j]
            j += 1
        r0 = 0
        for i, n in enumerate(X.row_counts):
            if r0 < b and a < r0 + n:
                out.append(X.parts[i][j][kk, max(a, r0) - r0:
                                         min(b, r0 + n) - r0].to(dev))
            r0 += n
    if hi > H:
        out.append(torch.zeros((hi - H, W), dtype=X.dtype, device=dev))
    return torch.cat(out)


def residuals64(S64, src, dst, X):
    """Each anchor column's float64 relative residual ||b - L x|| / ||b||
    against the float64 operator S64, b the column's pair right-hand
    side (-1 at src, +1 at dst, as stencil._pairs_rhs scatters it) and x
    column k of X (full, or a MeshBlock).  One column at a time and, on a
    mesh (S64 a ShardStencil), one row shard at a time on the shard's
    device from its halo-extended planes, so no (B, H, W) float64 block
    beyond X, and no full plane on a mesh, is formed."""
    from circuitscape_tpu_torch.solve.stencil import stencil_matvec
    H, W = S64.shape
    if hasattr(S64, "ops"):
        h = S64.h_local
        shards = [(row[0], i * h, h, S64.halo)
                  for i, row in enumerate(S64.ops)]
    else:
        shards = [(S64, 0, H, False)]
    rel = []
    for k in range(len(src)):
        rr = bb = 0.0
        for op, r0, h, halo in shards:
            dev = op.diag.device
            x = _column_rows(X, k, r0 - halo, r0 + h + halo, dev)
            y = stencil_matvec(op, x[None])[0]
            y = y[1:-1] if halo else y
            b = torch.zeros((h, W), dtype=torch.float64, device=dev)
            for (r, c), v in ((src[k], -1.0), (dst[k], 1.0)):
                if r0 <= r < r0 + h:
                    b[r - r0, c] += v
            res = b - y
            rr += float((res * res).sum())
            bb += float((b * b).sum())
        rel.append(math.sqrt(rr / bb))
    return np.asarray(rel)


class anchor_residuals:
    """While active, every stencil pair solve of a job (on one card or a
    mesh; stencil.stencil_solve_pairs) has each anchor column's float64
    relative residual recomputed from its output (residuals64) right
    after it returns, before the next chunk: rel holds them per solve,
    meshes the (nodes, batch) shape of each solve's operator (None on
    one device), seconds the time the checks took (for the caller to
    take out of the job's wall) and, with keep=True, solves each
    solve's (S64, prec).  With a chunk_footprint fp, fp.hold() runs
    before each check and the peaks reset after it, so the check's
    memory is not the solve's."""

    def __init__(self, fp=None, keep=False):
        self.fp, self.keep = fp, keep

    def __enter__(self):
        from circuitscape_tpu_torch.solve import stencil as st
        self.mod, self.real = st, st.stencil_solve_pairs
        self.rel, self.meshes, self.solves, self.seconds = [], [], [], 0.0

        def rec(S64, src, dst, **k):
            X, rel, it = self.real(S64, src, dst, **k)
            if self.fp is not None:
                self.fp.hold()
            t = time.perf_counter()
            self.rel.append(residuals64(S64, np.asarray(src),
                                        np.asarray(dst), X))
            self.seconds += time.perf_counter() - t
            if self.fp is not None:
                reset_peaks(self.fp.devices)
            mesh = getattr(S64, "mesh", None)
            self.meshes.append(None if mesh is None else
                               (mesh.shape["nodes"], mesh.shape["batch"]))
            if self.keep:
                self.solves.append((S64, k.get("prec")))
            return X, rel, it
        st.stencil_solve_pairs = rec
        return self

    def __exit__(self, *exc):
        self.mod.stencil_solve_pairs = self.real


def phase_scale(cfg, level_times):
    """The scale job (make_scale_job: 6930^2, 48M cells, bucketed to
    7040^2) once through compute(..., "cuda") with the launch counters
    zeroed just before it.  It must take the large-grid route (a
    host-built hierarchy, stats mg_build), give finite, symmetric
    resistances positive off the diagonal, and leave each anchor
    column's final float64 relative residual, recomputed from the
    solve's output against the float64 device operator
    (anchor_residuals), under the job's tolerance (consts.CG_RTOL);
    matvec_pap, matvec and cheb_step launched at 7040^2 (the fine level
    is wider than 4094 cells) and the fused smoother at 3520^2.  Prints
    the CG iterations per refinement pass, the batch width, the
    host-timer sections, peak device memory and the wall time (the
    residual check's seconds taken out), and per_job lines from
    time_scale_levels."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import consts, stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    with chunk_footprint() as fp, anchor_residuals(fp) as res:
        t = time.perf_counter()
        r = cst.compute(cfg, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t - res.seconds
    launches, launches_at = dict(cs.LAUNCHES), dict(cs.LAUNCHES_AT)
    peak = fp.peak()
    sd = stats.finalize()
    check_chunk_model(fp, sd, "scale job")
    note(f"scale job: {dt:.3f} s wall, {sd.get('cg_iters')} CG iterations "
         f"(per refinement pass {sd.get('pass_iters')}), batch width "
         f"{sd.get('batch_width')}, {sd.get('cells')} cells, hierarchy "
         f"built on the {sd.get('mg_build')}, mg_kernels "
         f"{sd.get('mg_kernels')}, peak device memory {peak} B "
         f"({peak / 2**30:.3f} GiB), solve_s {sd.get('solve_s'):.3f}")
    note(f"scale job sections {_sections()}")
    if sd.get("mg_build") != "host":
        raise AssertionError(f"scale job: hierarchy built on the "
                             f"{sd.get('mg_build')}, not the host")
    check_resistances(r, "scale job", n=4)
    if not res.rel:
        raise AssertionError("scale job: no pair solve ran")
    for rel in res.rel:
        note(f"scale job: float64 relative residuals {rel.tolist()} of "
             f"{len(rel)} columns on the {sd.get('cells')}-cell operator "
             f"({res.seconds:.3f} s to check)")
        if not np.all(rel <= consts.CG_RTOL):
            raise AssertionError(f"scale job: relative residuals {rel} "
                                 f"above {consts.CG_RTOL}")
    worst = float(max(rel.max() for rel in res.rel))
    check_launched(launches, "scale job")
    fine, half = SCALE_HW, (SCALE_HW[0] // 2, SCALE_HW[1] // 2)
    need = [("matvec_pap",) + fine, ("matvec",) + fine,
            ("cheb_step",) + fine, ("cheb_init",) + half,
            ("residual_init",) + half, ("cheb_finish",) + half]
    missing = [k for k in need if launches_at.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"scale job: no launches at {missing}")
    note("scale job launches per shape " + ", ".join(
        f"{k} {H}x{W}: {n}" for (k, H, W), n in sorted(launches_at.items())))
    note_per_job(level_times, launches_at, " scale job")
    torch.cuda.empty_cache()
    return {"s": dt, "iters": sd.get("cg_iters"), "peak": peak,
            "residual": worst}


SUITE_SIDES = (2450, 3465)   # bench_suite.py's 6M- and 12M-cell rasters


def phase_suite(d, rate, rows):
    """19. bench_suite_torch.py's rows that no other phase runs: its
    recipes drawn from its default_rng(42) in its order (the 1000^2
    raster first, then 2450^2 and 3465^2), each of the two large
    pairwise jobs once (suite_pairwise), the 1000^2 raster on the direct
    tier against the iterative one (direct_vs_iterative), and the SpMV
    record's line.  Returns each part's summary (by side, "direct",
    "spmv")."""
    import bench_suite_torch as bst
    rng = np.random.default_rng(42)
    d1 = tempfile.mkdtemp(dir=d)
    cfg1 = bst.shortcut_job(d1, rng, 1000)
    out = {}
    for side in SUITE_SIDES:
        dd = tempfile.mkdtemp(dir=d)
        out[side] = suite_pairwise(bst.shortcut_job(dd, rng, side), side,
                                   rate, rows)
        shutil.rmtree(dd)
    out["direct"] = direct_vs_iterative(cfg1)
    shutil.rmtree(d1)
    spmv = bst.spmv_record("cuda")
    note(f"spmv record {json.dumps(spmv)}")
    out["spmv"] = spmv
    return out


def suite_pairwise(cfg, side, rate, rows):
    """One suite pairwise job (32 points, shortcut mode) on the card, the
    launch counters zeroed just before it (time_job): resistances
    finite, symmetric, positive; the large-grid route (stats mg_build
    "host"); every kernel launched.  Prints the CG iterations per pass,
    the batch width, peak device memory, the timer sections and the
    wall; then holds every kernel against its plain version at each
    (name, H, W) the run launched it at, at the run's padded batch width
    on the job's own conductance map, timed beside its bound
    (time_shapes), and prints per_job lines of the run's launches."""
    label = f"suite pairwise {side}^2"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r, (dt,), launches, launches_at, sd = time_job(cfg, 1, "cuda", label)
    peak = torch.cuda.max_memory_allocated()
    note(f"{label}: {dt:.3f} s wall, {sd.get('cg_iters')} CG iterations "
         f"(per refinement pass {sd.get('pass_iters')}), batch width "
         f"{sd.get('batch_width')}, {sd.get('cells')} cells, hierarchy "
         f"built on the {sd.get('mg_build')}, mg_kernels "
         f"{sd.get('mg_kernels')}, peak device memory {peak} B "
         f"({peak / 2**30:.3f} GiB), solve_s {sd.get('solve_s'):.3f}")
    note(f"{label} sections {_sections()}")
    check_resistances(r, label)
    if sd.get("mg_build") != "host":
        raise AssertionError(f"{label}: hierarchy built on the "
                             f"{sd.get('mg_build')}, not the host")
    check_launched(launches, label)
    note(f"{label} launches per shape " + ", ".join(
        f"{k} {H}x{W}: {n}" for (k, H, W), n in sorted(launches_at.items())))
    per_kernel = {}
    for (name, H, W) in launches_at:
        per_kernel.setdefault(name, set()).add((H, W))
    B = 1 << (int(sd["batch_width"]) - 1).bit_length()
    gmap = np.maximum(np.load(cfg["habitat_file"]), 0.0)
    times = time_shapes(gmap, per_kernel, B, torch.device("cuda"), rate,
                        rows, f"{label} level")
    del gmap
    note_per_job(times, launches_at, f" suite {side}^2")
    return {"s": dt, "iters": sd.get("pass_iters"), "peak": peak,
            "batch": sd.get("batch_width")}


def direct_vs_iterative(cfg):
    """The suite's 1000^2 raster (32 points) once with solver = cholmod in
    double precision (the native Cholesky on the host) and once with
    cg+amg in single precision (the stencil path on the card): the
    resistances agree within 1e-4 relative off the diagonal (the
    reference's single-precision tolerance, test/test_utils.jl:167).
    Prints the worst error and each run's timer sections."""
    res = {}
    for solver, precision in (("cholmod", "double"), ("cg+amg", "single")):
        c = dict(cfg, solver=solver, precision=precision)
        r, (dt,), _, _, _ = time_job(c, 1, "cuda", f"1M raster, {solver}")
        check_resistances(r, f"1M raster, {solver}")
        note(f"1M raster, {solver} {precision}: {dt:.3f} s, sections "
             f"{_sections()}")
        res[solver] = (r[1:, 1:], dt)
    off = ~np.eye(32, dtype=bool)
    a, b = res["cg+amg"][0], res["cholmod"][0]
    worst = float(np.max(np.abs(a - b)[off] / np.abs(b)[off]))
    note(f"1M raster: cg+amg (single) within {worst:.3e} relative of "
         f"cholmod (double)")
    if not worst <= 1e-4:
        raise AssertionError(f"1M raster: cg+amg and cholmod differ by "
                             f"{worst} relative")
    return {"worst": worst, "cholmod_s": res["cholmod"][1],
            "cgamg_s": res["cg+amg"][1]}


def phase_poly_project(gmap, poly, dev, rate):
    """poly_project (torch glue, not a TPU kernel) with the polygon job's
    shared projector on a 1024 x 1024, B = 32 float32 block: two calls
    give the same bits, the result is within 1e-6 of max |ref| of a
    float64 CPU reference, and its time (CUDA events) stands beside its
    byte bound (the block read and written once)."""
    from circuitscape_tpu_torch.graph.build import construct_node_map
    from circuitscape_tpu_torch.solve.stencil import (build_poly_projector,
                                                      poly_project)
    nm = construct_node_map(gmap, poly)
    proj = build_poly_projector(nm, MAIN_HW, dev)
    ref_proj = build_poly_projector(nm, MAIN_HW, "cpu")
    x = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (MAIN_B,) + MAIN_HW), dtype=torch.float32, device=dev)
    a, b = poly_project(proj, x), poly_project(proj, x)
    if not torch.equal(a, b):
        raise AssertionError("poly_project: two calls on the same input "
                             "differ")
    ref = poly_project(ref_proj, x.double().cpu())
    err = float((a.double().cpu() - ref).abs().max())
    if not err <= 1e-6 * float(ref.abs().max()):
        raise AssertionError(f"poly_project: max err {err} against the "
                             f"float64 reference")
    ms = cuda_ms(lambda: poly_project(proj, x))
    bound = 2 * x.numel() * 4 / rate * 1e3
    note(f"poly_project: {ms:.4f} ms, byte bound {bound:.4f} ms "
         f"({100 * bound / ms:.1f}%), {proj.nseg - 1} polygons of "
         f"{proj.cells.numel()} cells, max err {err:.3e}, bit-identical "
         f"on two calls, at B={MAIN_B} {MAIN_HW}")


def phase_polygons(cfg, r_plain, level_times):
    """The polygon job at full width: warm run, then one timed run with
    the launch counters zeroed just before it.  Resistances finite,
    symmetric, >= 0; points 7 and 8 share a node (R = 0); no pair above
    the bench job's (Rayleigh: shorts only lower resistance), one at
    least 1e-3 below; matvec launched on the 1024^2 level every CG
    iteration and matvec_pap never (the projected body)."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.timer import CSTIMER

    cfg = dict(cfg, output_file=os.path.join(
        os.path.dirname(cfg["output_file"]), "poly.out"))
    cst.compute(cfg, device="cuda")
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t = time.perf_counter()
    r = cst.compute(cfg, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches, launches_at = dict(cs.LAUNCHES), dict(cs.LAUNCHES_AT)
    st = stats.finalize()
    sections = {"/".join(p[1:]): round(tot, 4)
                for p, (_, tot) in sorted(CSTIMER._data.items())
                if len(p) > 1}
    note(f"polygon job run: {dt:.3f} s, cg_iters {st.get('cg_iters')}, "
         f"launches {launches}, sections {sections}")
    check_resistances(r, "polygon job", merged=True)
    m, plain = r[1:, 1:], r_plain[1:, 1:]
    if not m[6, 7] == m[7, 6] == 0:
        raise AssertionError(f"polygon job: R[7,8] = {m[6, 7]}, expected 0 "
                             "(one polygon holds both points)")
    off = ~np.eye(32, dtype=bool)
    ratio = m[off] / plain[off]
    if not (np.all(ratio <= 1 + 1e-4) and np.any(ratio < 1 - 1e-3)):
        raise AssertionError(f"polygon job: resistance / bench resistance "
                             f"spans {ratio.min()}..{ratio.max()}")
    fine = launches_at.get(("matvec", *MAIN_HW), 0)
    if fine < st.get("cg_iters") or launches["matvec_pap"] != 0:
        raise AssertionError(f"polygon job: matvec at {MAIN_HW} launched "
                             f"{fine} times for {st.get('cg_iters')} CG "
                             f"iterations, matvec_pap "
                             f"{launches['matvec_pap']} times")
    check_launched({k: n for k, n in launches.items() if k != "matvec_pap"},
                   "polygon job")
    note(f"polygon job: {dt:.3f} s, {st.get('cg_iters')} CG iterations, "
         f"matvec at {MAIN_HW[0]}x{MAIN_HW[1]} {fine} launches, "
         f"resistance / bench resistance {ratio.min():.4f}..{ratio.max():.6f}")
    note_per_job(level_times, launches_at, " polygon job")


def phase_regions(cfg, r_plain, nregions=8):
    """The focal-region job at full width, maps off: one run.  Its 28
    pairs solve in one chunk with a per-column projector; resistances
    finite, symmetric, positive, each no higher than the bench job's
    between the same two points (regions only merge and add
    conductance)."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.timer import CSTIMER

    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t = time.perf_counter()
    r = cst.compute(cfg, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    st = stats.finalize()
    sections = {"/".join(p[1:]): round(tot, 4)
                for p, (_, tot) in sorted(CSTIMER._data.items())
                if len(p) > 1}
    note(f"focal-region job run: {dt:.3f} s, cg_iters {st.get('cg_iters')}, "
         f"launches {dict(cs.LAUNCHES)}, sections {sections}")
    check_resistances(r, "focal-region job", n=nregions)
    m, plain = r[1:, 1:], r_plain[1:nregions + 1, 1:nregions + 1]
    off = ~np.eye(nregions, dtype=bool)
    ratio = m[off] / plain[off]
    if not np.all(ratio <= 1 + 1e-4):
        raise AssertionError(f"focal-region job: resistance above the "
                             f"bench job's, ratio {ratio.max()}")
    note(f"focal-region job: {dt:.3f} s, {st.get('cg_iters')} CG "
         f"iterations, resistance / bench resistance "
         f"{ratio.min():.4f}..{ratio.max():.4f}")


def read_asc(path):
    return np.loadtxt(path, skiprows=6, ndmin=2)


def phase_maps(cfg, gmap, r_shortcut):
    """The bench job with the cumulative and max current maps: every
    pair solved on the card.  Warm run, then one timed run with the
    launch counters zeroed just before it."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.timer import CSTIMER

    cfg = dict(cfg, output_file=os.path.join(
        os.path.dirname(cfg["output_file"]), "maps.out"),
        write_cum_cur_map_only="True", write_max_cur_maps="True")
    cst.compute(cfg, device="cuda")
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t = time.perf_counter()
    r = cst.compute(cfg, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = dict(cs.LAUNCHES)
    st = stats.finalize()
    sections = {k: round(CSTIMER.total(k), 4) for k in (
        "batched pair solve", "node currents + reduce", "write maps",
        "write cumulative current maps")}
    note(f"maps path run: {dt:.3f} s, cg_iters {st.get('cg_iters')}, "
         f"launches {launches}, sections {sections}")
    check_launched(launches, "maps path")
    check_resistances(r, "maps path")
    off = ~np.eye(r.shape[0] - 1, dtype=bool)
    a, b = r[1:, 1:][off], r_shortcut[1:, 1:][off]
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    if not rel <= 1e-4:
        raise AssertionError(f"maps path resistances differ from the "
                             f"shortcut matrix by {rel} relative")
    prefix = os.path.join(os.path.dirname(cfg["output_file"]), "maps")
    cum = read_asc(prefix + "_cum_curmap.asc")
    mx = read_asc(prefix + "_max_curmap.asc")
    active = gmap > 0
    if not (cum.shape == gmap.shape == mx.shape and
            np.all(np.isfinite(cum)) and np.all(cum[active] >= 0) and
            np.any(cum > 0)):
        raise AssertionError("maps path: cumulative map not finite, "
                             "non-negative and non-zero")
    note(f"maps path: resistances agree with the shortcut matrix to "
         f"{rel:.3e} relative; cumulative map max {cum.max():.6g}")


class swapped:
    """mod.name replaced by make(the original) while active."""

    def __init__(self, mod, name, make):
        self.mod, self.name, self.make = mod, name, make

    def __enter__(self):
        self.real = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.make(self.real))
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def graph_run(cfg, eager=False, profiled=False):
    """One run of cfg on the card with the launch counters zeroed just
    before it, on the CG loop's graph route or (eager) the eager loop.
    Returns (seconds, stats.finalize(), launches (the seven's per wrapper
    and the glue kernels' per kernel), the X of every pair solve in
    order, the profiler's kernel count per name or None)."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.solve import stencil as st
    from torch.profiler import ProfilerActivity, profile
    xs = []

    def keep(real):
        def solve(*a, **k):
            out = real(*a, **k)
            xs.append(out[0].clone())
            return out
        return solve

    def loop(real):
        return (lambda *a, **k: real(*a, _eager=True, **k)) if eager else real

    prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled else
            None)
    with swapped(st, "stencil_solve_pairs", keep), \
            swapped(st, "_cg_loop", loop):
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t = time.perf_counter()
        if prof is not None:
            prof.start()
        cst.compute(cfg, device="cuda")
        torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
        dt = time.perf_counter() - t
    kernels = None
    if prof is not None:
        names = {k for k, _, _ in KERNELS} | set(GLUE_KERNELS)
        kernels = {}
        for e in prof.events():
            m = re.search(r"::(\w+)_kernel\b", e.name)
            if (e.device_type == torch.autograd.DeviceType.CUDA and m and
                    m.group(1) in names):
                kernels[m.group(1)] = kernels.get(m.group(1), 0) + 1
    launches = {k: v for k, v in cs.LAUNCHES.items() if v}
    for (name, _, _, _), n in cs.FUSED_LAUNCHES.items():
        launches[name] = launches.get(name, 0) + n
    return dt, stats.finalize(), launches, xs, kernels


def phase_graph(cfg):
    """Phase 21: the CG loop's graph route (one card's default) against
    the eager loop (stencil._cg_loop's _eager), on the bench job and its
    maps recipe: after a warm run, a graph run, an eager run, then a
    graph run under torch.profiler.  The same CG iterations in every
    refinement pass, every pair solve's X within 1e-6 relative per
    column (2-norms), and in the profiled run the launches the wrappers
    counted equal to the trace's kernels of each name.  Returns the
    figures printed."""
    maps = dict(cfg, output_file=os.path.join(
        os.path.dirname(cfg["output_file"]), "graph_maps.out"),
        write_cum_cur_map_only="True", write_max_cur_maps="True")
    out = {}
    for label, c in (("bench", cfg), ("maps", maps)):
        graph_run(c)                    # warm
        g_s, g_st, g_launch, g_xs, _ = graph_run(c)
        e_s, e_st, e_launch, e_xs, _ = graph_run(c, eager=True)
        p_s, _, p_launch, _, kernels = graph_run(c, profiled=True)
        if g_st["pass_iters"] != e_st["pass_iters"]:
            raise AssertionError(
                f"graph route {label}: CG iterations per pass "
                f"{g_st['pass_iters']}, eager loop {e_st['pass_iters']}")
        if len(g_xs) != len(e_xs):
            raise AssertionError(f"graph route {label}: {len(g_xs)} pair "
                                 f"solves, eager loop {len(e_xs)}")
        worst = 0.0
        for xg, xe in zip(g_xs, e_xs):
            n = xe.flatten(1).norm(dim=1)
            d = (xg - xe).flatten(1).norm(dim=1)
            worst = max(worst, float((d / torch.where(n == 0, 1.0, n))
                                     .max()))
        if not worst <= 1e-6:
            raise AssertionError(f"graph route {label}: X differs from the "
                                 f"eager loop's by {worst} relative")
        if g_launch != e_launch or p_launch != kernels:
            raise AssertionError(
                f"graph route {label}: launches {g_launch}, eager loop "
                f"{e_launch}; profiled run counted {p_launch}, the trace "
                f"holds {kernels}")
        its = g_st["cg_iters"]
        out[label] = {
            "graph_s": round(g_s, 4), "eager_s": round(e_s, 4),
            "profiled_s": round(p_s, 4), "cg_iters": its,
            "pass_iters": g_st["pass_iters"],
            "graph_replays": g_st.get("graph_replays"),
            "graph_captures": g_st.get("graph_captures"),
            "graph_iter_pct": round(100.0 * g_st.get("graph_replays", 0) /
                                    its, 2),
            "fused_iters": g_st.get("fused_iters"),
            "x_rel_worst": worst, "launches": g_launch,
            "solve_s": {"graph": round(g_st["solve_s"], 4),
                        "eager": round(e_st["solve_s"], 4)}}
        note(f"graph route {label}: {json.dumps(out[label])}")
    return out


def glue_bytes(name, B, H, W) -> int:
    """Bytes a glue kernel must move (float32): each block read once and
    written once where it is an output; the per-column scalars and
    cg_dots's partials are left out (under 0.1% at the main path's
    shapes)."""
    cells = H * W
    coarse = -(-H // 2) * -(-W // 2)
    return 4 * B * {
        "cg_update_xr": 6 * cells,
        "cg_update_xr_replace": 3 * cells,
        "cg_dots": 2 * cells,
        "cg_update_p": 3 * cells,
        "prolong_add": 2 * cells + coarse,
    }[name]


def _glue_pairs(B, H, W, dev, seed):
    """{name: (kernel call, plain call, timed call)} for the glue kernels
    on fresh (B, H, W) inputs on dev.  The first two work on copies of
    the inputs and return (outputs compared to the bit, outputs compared
    within TOL); the third is the kernel alone, in place on inputs of its
    own (their values drift from call to call, its bytes do not)."""
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    R, X, P, AP, u = _card_blocks(B, H, W, dev, seed, n=5)
    Z = R * (1.25 + 0.75 * torch.tanh(u))     # R.Z > 0, as M gives it
    xc = _card_blocks(B, -(-H // 2), -(-W // 2), dev, seed + 1, n=1)[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rz, pAp = (0.5 + 0.5 * torch.rand(B, generator=gen, device=dev)
               for _ in range(2))
    pAp[0] = 0.0                            # the guard: alpha = 0
    norm = torch.sqrt(torch.sum(R.double() * R.double(), dim=(-2, -1)))
    tol = norm * torch.where(torch.arange(B, device=dev) % 2 == 0, 0.5, 2.0)
    safe = norm.float()

    def xr(fn, replace):
        def call():
            x, r = X.clone(), R.clone()
            fn(x, r, P, AP, rz, pAp, replace)
            return (x, r), ()
        return call

    def dots(fn):
        def call():
            z_rz, rn2, stop = rz.clone(), torch.empty_like(rz), \
                torch.empty(2, device=dev)
            beta = fn(R, Z, z_rz, rn2, safe, tol, stop)
            return (stop[1:],), (z_rz, rn2, beta, stop[:1])
        return call

    def upd_p(fn):
        def call():
            p = P.clone()
            fn(p, Z, rz)
            return (p,), ()
        return call

    def prolong(fn):
        def call():
            return (fn(X.clone(), xc, 1.9),), ()
        return call

    Xt, Rt, Pt, rzt = X.clone(), R.clone(), P.clone(), rz.clone()
    rn2t, stopt = torch.empty_like(rz), torch.empty(2, device=dev)
    half = torch.full_like(rz, 0.5)
    return {
        "cg_update_xr": (
            xr(cs.cg_update_xr, False), xr(cs.cg_update_xr_plain, False),
            lambda: cs.cg_update_xr(Xt, Rt, P, AP, rz, pAp, False)),
        "cg_update_xr_replace": (
            xr(cs.cg_update_xr, True), xr(cs.cg_update_xr_plain, True),
            lambda: cs.cg_update_xr(Xt, Rt, P, AP, rz, pAp, True)),
        "cg_dots": (dots(cs.cg_dots), dots(cs.cg_dots_plain),
                    lambda: cs.cg_dots(R, Z, rzt, rn2t, safe, tol, stopt)),
        "cg_update_p": (upd_p(cs.cg_update_p), upd_p(cs.cg_update_p_plain),
                        lambda: cs.cg_update_p(Pt, Z, half)),
        "prolong_add": (prolong(cs.prolong_add),
                        prolong(cs.prolong_add_plain),
                        lambda: cs.prolong_add(Xt, xc, 1.9)),
    }


def check_glue(name, kern, plain, label):
    """A glue kernel's outputs against its plain version run by torch on
    the card: elementwise outputs (and cg_dots's stop flag) to the bit,
    cg_dots's column sums, beta and worst relative residual within TOL
    relative (their order of additions), and cg_dots's outputs the same
    bits on a second call."""
    (exact, sums), (ex_ref, sum_ref) = kern(), plain()
    if name == "cg_dots":
        again = kern()
        if not all(torch.equal(a, b) for a, b in zip(exact + sums,
                                                     again[0] + again[1])):
            raise AssertionError(f"cg_dots {label}: two calls on the same "
                                 f"inputs differ")
    for g, r in zip(exact, ex_ref):
        if not torch.equal(g, r):
            raise AssertionError(f"{name} {label}: not the plain version's "
                                 f"bits (max diff "
                                 f"{float((g - r).abs().max())})")
    worst = 0.0
    for g, r in zip(sums, sum_ref):
        rel = float(((g.double() - r.double()).abs() /
                     r.double().abs().clamp_min(1e-30)).max())
        if not rel <= TOL:
            raise AssertionError(f"{name} {label}: sums {rel} relative "
                                 f"from the plain version's")
        worst = max(worst, rel)
    return worst


def phase_glue(cfg, dev, rate):
    """Phase 22: the CG iteration's and the V-cycle's glue kernels
    (csrc/cg_kernels.cu).  Each against its plain version, run by torch
    on the card (check_glue), at B = 32 on every level shape of the bench
    and maps hierarchy (1024^2 down to 32^2: prolong_add's levels, and
    the CG body's at its fine level and below), timed beside its byte
    bound at each; then the bench job and its maps recipe with the
    fused body and with the composite one (stencil._fused_body
    swapped to refuse): CG iterations of every refinement pass within
    one, fused_iters = cg_iters on the first and 0 on the second,
    resistances within 1e-5 relative, solve seconds printed.  Returns
    {name: {(H, W): (ms, bound ms)}}."""
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import stencil as st
    import circuitscape_tpu_torch as cst
    times = {}
    for H, W in LEVELS:
        pairs = _glue_pairs(MAIN_B, H, W, dev, seed=H)
        for name, (kern, plain, timed) in pairs.items():
            err = check_glue(name, kern, plain, f"B={MAIN_B} {H}x{W}")
            ms = min(cuda_ms(timed, n=50) for _ in range(3))
            bound = glue_bytes(name, MAIN_B, H, W) / rate * 1e3
            times.setdefault(name, {})[(H, W)] = (ms, bound)
            note(f"glue {name} B={MAIN_B} {H}x{W}: {ms:.4f} ms, byte bound "
                 f"{bound:.4f} ms, {100 * bound / ms:.1f}% of bound; sums "
                 f"{err:.2e} relative")
        del pairs
    maps = dict(cfg, output_file=os.path.join(
        os.path.dirname(cfg["output_file"]), "glue_maps.out"),
        write_cum_cur_map_only="True", write_max_cur_maps="True")
    out = {}
    for label, c in (("bench", cfg), ("maps", maps)):
        runs = {}
        for body in ("fused", "composite", "fused"):
            refuse = (lambda real: lambda *a, **k: False)
            with (swapped(st, "_fused_body", refuse) if body == "composite"
                  else contextlib.nullcontext()):
                stats.reset()
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = cst.compute(c, device="cuda")
                torch.cuda.synchronize()
                runs[body] = (time.perf_counter() - t, stats.finalize(),
                              np.asarray(r, dtype=np.float64))
        (f_s, f_st, f_r), (c_s, c_st, c_r) = runs["fused"], runs["composite"]
        fp, cp = f_st["pass_iters"], c_st["pass_iters"]
        if len(fp) != len(cp) or any(abs(a - b) > 1 for a, b in zip(fp, cp)):
            raise AssertionError(f"glue {label}: CG iterations per pass "
                                 f"{fp} fused, {cp} composite")
        if (f_st.get("fused_iters") != f_st["cg_iters"] or
                c_st.get("fused_iters") != 0):
            raise AssertionError(
                f"glue {label}: fused_iters {f_st.get('fused_iters')} of "
                f"{f_st['cg_iters']} fused, {c_st.get('fused_iters')} "
                f"composite")
        rel = float(np.max(np.abs(f_r - c_r) /
                           np.maximum(np.abs(c_r), 1e-30)))
        if not rel <= 1e-5:
            raise AssertionError(f"glue {label}: results {rel} relative "
                                 f"apart")
        out[label] = {"fused_s": round(f_s, 4), "composite_s": round(c_s, 4),
                      "solve_s": {"fused": round(f_st["solve_s"], 4),
                                  "composite": round(c_st["solve_s"], 4)},
                      "cg_iters": [f_st["cg_iters"], c_st["cg_iters"]],
                      "result_rel": rel}
        note(f"glue {label}: {json.dumps(out[label])}")
    return times


class env_set:
    """Environment variables set (a value of None: unset) while active,
    restored after."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kw}
        for k, v in self.kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def forced_iterative_tier():
    """CS_NETWORK_DIRECT_MAX=0 while active: network cg+amg jobs run the
    iterative tier (ELL PCG with the SA-AMG V-cycle on the job's device)
    instead of routing to the native Cholesky."""
    return env_set(CS_NETWORK_DIRECT_MAX="0")


def _sections():
    from circuitscape_tpu_torch.timer import CSTIMER
    return {"/".join(p[1:]): round(tot, 4)
            for p, (_, tot) in sorted(CSTIMER._data.items()) if len(p) > 1}


def run_general(cfg, od, dev, label, keep=False):
    """One job on dev with outputs in od (prefix "n"), recording the
    general tier's CG passes; returns (result, seconds, CG iterations per
    pass, the record_passes object)."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch.solve import dispatch
    os.makedirs(od)
    if dev == "cuda":
        torch.cuda.synchronize()
    with record_passes(keep=keep, mod=dispatch, fn="cg_batched") as rp:
        t = time.perf_counter()
        r = cst.compute(dict(cfg, output_file=os.path.join(od, "n.out")),
                        device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
    note(f"{label}: {dt:.3f} s, CG iterations per pass {rp.iters}, "
         f"sections {_sections()}")
    return r, dt, rp.iters, rp


def _network_reference(cfg, dtype):
    """Resistances between every pair of the network job's focal nodes,
    solved in float64 by SciPy (independent of the port) on the system
    the iterative tier solves in dtype: the job's Laplacian with eps *
    ||entries|| added to every stored entry (the reference's
    regularization, src/core.jl:161, with dtype's eps)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    g = np.loadtxt(cfg["habitat_file"], ndmin=2)
    i, j = g[:, 0].astype(np.int64), g[:, 1].astype(np.int64)
    n = int(max(i.max(), j.max())) + 1
    A = sp.coo_matrix((g[:, 2].astype(dtype), (i, j)), shape=(n, n)).tocsr()
    A = (A + A.T).tocsr()
    L = (sp.diags(np.asarray(A.sum(axis=1)).ravel().astype(dtype)) -
         A).tocsr()
    L.data = L.data + np.finfo(dtype).eps * np.linalg.norm(L.data)
    solve = spla.factorized(L.astype(np.float64).tocsc())
    fp = np.loadtxt(cfg["point_file"], ndmin=1).astype(np.int64)
    # the focal file counts from 1 unless it holds a 0 (src/io.jl:74-82),
    # whatever the edge list does
    fp = fp if fp.min() == 0 else fp - 1
    R = np.zeros((fp.size, fp.size))
    for a in range(fp.size):
        for b in range(a + 1, fp.size):
            rhs = np.zeros(n)
            rhs[fp[a]], rhs[fp[b]] = -1.0, 1.0
            v = solve(rhs)
            R[a, b] = R[b, a] = v[fp[b]] - v[fp[a]]
    return R


def phase_network(d, rate, dev_name, n=100_000):
    """The network pairwise job (make_network_job: 100,000-node lattice,
    20 focal nodes, 190 pairs in one block of 256 columns, single
    precision).  On the forced iterative tier on "cuda": a warm and a
    timed run, printing the CG iterations, AMG levels, host-timer
    sections and peak device memory; its resistances finite, symmetric,
    positive off the diagonal and within 1e-4 relative of an independent
    float64 solve of the same regularized system (_network_reference);
    380 per-pair and 2 cumulative current files.  With the default
    routing (the native Cholesky on the host) one run; the two tiers'
    difference is printed, not gated: in single precision the iterative
    tier's regularization (float32 eps * ||entries|| on every entry, a
    leak to ground at every node) and the direct tier's 10 eps shift
    solve different systems.  In double precision, where both shifts
    vanish, the two tiers agree to 1e-4 (resistances relative, one pair's
    node currents of their max).  Then times ell_matvec at the job's fine
    level (phase_ell).  Returns a summary dict."""
    from circuitscape_tpu_torch.io import fastio
    from circuitscape_tpu_torch.solve import native_chol
    t = time.perf_counter()
    libs = [os.path.basename(native_chol._load()._name),
            os.path.basename(fastio.load()._name)]
    note(f"native libraries {libs} built in "
         f"{time.perf_counter() - t:.1f} s; Cholesky BLAS: "
         f"{native_chol.BLAS or 'none (scalar engine)'}")
    cfg = make_network_job(d, n=n)
    with forced_iterative_tier():
        run_general(cfg, os.path.join(d, "warm"), "cuda",
                    "network job, forced iterative tier, warm run")
        shutil.rmtree(os.path.join(d, "warm"))
        torch.cuda.reset_peak_memory_stats()
        r, dt, iters, rp = run_general(
            cfg, os.path.join(d, "forced"), "cuda",
            "network job, forced iterative tier", keep=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = _sections()
    A, B, prec = rp.calls[0][0][:3]
    del rp
    levels = [(L.A.n, L.A.n_pad, L.A.idx.shape[1]) for L in prec.levels]
    setup = secs.get("solve pairwise resistances/construct "
                     "preconditioner/factorization")
    note(f"network job: AMG levels (n, n_pad, K) {levels}, coarse "
         f"{tuple(prec.coarse_pinv.shape)}, block {tuple(B.shape)}, AMG "
         f"setup {setup} s, peak device memory {peak:.3f} GiB")
    del B, prec
    check_resistances(r, "network job", n=20)
    files = sorted(f for f in os.listdir(os.path.join(d, "forced"))
                   if f.endswith(".txt"))
    if len(files) != 2 * 190 + 2 or not {"n_node_currents_cum.txt",
                                         "n_branch_currents_cum.txt"} <= \
            set(files):
        raise AssertionError(f"network job: wrote {len(files)} current "
                             "files, expected 380 per-pair and 2 cumulative")
    off = ~np.eye(20, dtype=bool)

    def rel(a, b):
        return float(np.max(np.abs(a - b)[off] / np.abs(b)[off]))
    ref = rel(r[1:, 1:], _network_reference(cfg, np.float32))
    rd, dt_d, _, _ = run_general(cfg, os.path.join(d, "direct"), "cuda",
                                 "network job, default routing (native "
                                 "Cholesky)")
    single = rel(r[1:, 1:], rd[1:, 1:])
    note(f"network job: {dt:.3f} s forced iterative tier, {dt_d:.3f} s "
         f"direct tier; iterative tier within {ref:.3e} relative of the "
         f"float64 solve of its system; the tiers differ by {single:.3e} "
         f"relative in single precision")
    if not ref <= 1e-4:
        raise AssertionError(f"network job: iterative tier {ref} relative "
                             "from the float64 solve of its system")
    for sub in ("forced", "direct"):
        shutil.rmtree(os.path.join(d, sub))

    dcfg = dict(cfg, precision="double")
    with forced_iterative_tier():
        r64, _, iters64, _ = run_general(
            dcfg, os.path.join(d, "forced"), "cuda",
            "network job, double precision, forced iterative tier")
    rd64, _, _, _ = run_general(dcfg, os.path.join(d, "direct"), "cuda",
                                "network job, double precision, default "
                                "routing")
    agree = rel(r64[1:, 1:], rd64[1:, 1:])
    pair = files[files.index("n_node_currents_cum.txt") - 1]
    a = np.loadtxt(os.path.join(d, "forced", pair))
    b = np.loadtxt(os.path.join(d, "direct", pair))
    cur = float(np.abs(a - b).max() / np.abs(b).max())
    note(f"network job, double precision: the tiers agree to {agree:.3e} "
         f"relative (resistances), {cur:.3e} of max ({pair})")
    if not (agree <= 1e-4 and cur <= 1e-4):
        raise AssertionError(f"network job, double precision: iterative "
                             f"and direct tiers differ by {agree} "
                             f"(resistances), {cur} ({pair})")
    for sub in ("forced", "direct"):
        shutil.rmtree(os.path.join(d, sub))
    ell = phase_ell(A, rate, dev_name)
    return {"forced_s": dt, "direct_s": dt_d, "iters": iters,
            "iters_double": iters64, "peak_gib": peak, "levels": levels,
            "setup_s": setup, "ell": ell}


def phase_ell(A, rate, dev_name):
    """ell_matvec (torch ops, not a TPU kernel) at the network job's fine
    level and B = 256 on the card: held against a CSR torch.sparse.mm of
    the same matrix (1e-5 of max), and both timed with CUDA events
    beside the bound: the larger of the bytes (idx, w, diag and x read
    once, y written once) over the card's memory rate and the float32
    operations (2K + 2 per row and column) over its float32 rate."""
    from circuitscape_tpu_torch.solve.operators import ell_matvec
    B = 256
    x = torch.as_tensor(np.random.default_rng(17).standard_normal(
        (A.n_pad, B)), dtype=torch.float32, device=A.diag.device)
    K = A.idx.shape[1]
    rows = torch.arange(A.n_pad, device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(
            torch.stack([torch.cat([rows.repeat_interleave(K), rows]),
                         torch.cat([A.idx.reshape(-1), rows])]),
            torch.cat([A.w.reshape(-1), A.diag]),
            (A.n_pad, A.n_pad)).coalesce().to_sparse_csr()
    y = ell_matvec(A, x)
    ref = torch.sparse.mm(csr, x)
    err = float((y - ref).abs().max() / ref.abs().max())
    if not err <= TOL:
        raise AssertionError(f"ell_matvec: {err} of max from the CSR "
                             f"product")
    ms = cuda_ms(lambda: ell_matvec(A, x))
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, x))
    nbytes = (A.idx.numel() * A.idx.element_size() + A.w.numel() * 4 +
              A.diag.numel() * 4 + 2 * x.numel() * 4)
    flops = (2 * K + 2) * A.n_pad * B
    fp32 = next(r for k, r in FP32_FLOPS if k in dev_name)
    bound = max(nbytes / rate, flops / fp32) * 1e3
    by = "bytes" if nbytes / rate >= flops / fp32 else "operations"
    note(f"ell_matvec: {ms:.4f} ms, bound {bound:.4f} ms by {by} "
         f"({100 * bound / ms:.1f}%), torch.sparse.mm {lib_ms:.4f} ms, "
         f"n_pad {A.n_pad}, K {K}, B {B}, {err:.3e} of max from the CSR "
         "product")
    return {"ms": ms, "bound_ms": bound, "library_ms": lib_ms}


def phase_network_advanced(d):
    """The network advanced job (make_network_advanced_job) on the forced
    iterative tier on "cuda": the float64 residual of its voltages in
    (L + G) v = s over the nodes that are not direct grounds, with L the
    Laplacian scipy builds from the edge list and G the finite grounds'
    conductances, under 1e-4 of ||s||; and the voltages within 1e-4 of
    max |v| of the direct tier's (default routing)."""
    import scipy.sparse as sp
    cfg, E, w, src, gnd = make_network_advanced_job(d)
    with forced_iterative_tier():
        v, dt, iters, _ = run_general(cfg, os.path.join(d, "forced"),
                                       "cuda", "network advanced job, "
                                       "forced iterative tier")
    n = int(E.max()) + 1
    A = sp.coo_matrix((w, (E[:, 0], E[:, 1])), shape=(n, n)).tocsr()
    A = A + A.T
    L = sp.diags(np.asarray(A.sum(axis=1)).ravel()) - A
    g = np.zeros(n)
    direct = gnd[gnd[:, 1] == 0, 0].astype(np.int64)
    finite = gnd[gnd[:, 1] > 0]
    g[finite[:, 0].astype(np.int64)] = 1.0 / finite[:, 1]
    s = np.zeros(n)
    s[src[:, 0].astype(np.int64)] = src[:, 1]
    keep = np.setdiff1d(np.arange(n), direct)
    volt = np.asarray(v[:, 1], np.float64)
    res = ((L + sp.diags(g)) @ volt - s)[keep]
    rel = float(np.linalg.norm(res) / np.linalg.norm(s[keep]))
    vd, dt_d, _, _ = run_general(cfg, os.path.join(d, "direct"), "cuda",
                                  "network advanced job, default routing "
                                  "(native Cholesky)")
    agree = float(np.abs(v[:, 1] - vd[:, 1]).max() / np.abs(vd[:, 1]).max())
    note(f"network advanced job: {dt:.3f} s (direct tier {dt_d:.3f} s), CG "
         f"iterations {iters}, float64 residual {rel:.3e}, voltages agree "
         f"with the direct tier to {agree:.3e} of max, at direct grounds "
         f"{float(np.abs(volt[direct]).max()):.3e}")
    if not (v.shape == (n, 2) and np.all(np.isfinite(volt)) and
            rel < 1e-4 and agree <= 1e-4 and np.all(volt[direct] == 0)):
        raise AssertionError(f"network advanced job: residual {rel}, "
                             f"agreement {agree}")
    return {"s": dt, "iters": iters, "residual": rel}


def phase_agree(d):
    """256 x 256 bench-recipe jobs on the card and on the CPU: the
    shortcut job, and a maps job with per-pair and max maps."""
    import circuitscape_tpu_torch as cst
    cfg, _ = make_job(d, 256, 256)
    rg = cst.compute(cfg, device="cuda")
    rc = cst.compute(cfg, device="cpu")
    check_resistances(rg, "256x256 cuda")
    off = ~np.eye(rg.shape[0] - 1, dtype=bool)
    a, b = rg[1:, 1:][off], rc[1:, 1:][off]
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    if not rel <= TOL:
        raise AssertionError(f"256x256: cuda and cpu resistances differ "
                             f"by {rel} relative")
    note(f"256x256 job: cuda and cpu resistances agree to {rel:.3e} "
         "relative")

    md = os.path.join(d, "maps")
    os.makedirs(md)
    cfg, _ = make_job(md, 256, 256, npoints=8)
    files = {}
    for dev in ("cuda", "cpu"):
        od = os.path.join(md, dev)
        os.makedirs(od)
        cst.compute(dict(cfg, output_file=os.path.join(od, "job.out"),
                         write_cur_maps="True", write_volt_maps="True",
                         write_max_cur_maps="True"), device=dev)
        files[dev] = sorted(f for f in os.listdir(od)
                            if f.endswith(".asc"))
    if files["cuda"] != files["cpu"] or len(files["cpu"]) != 2 * 28 + 2:
        raise AssertionError(f"256x256 maps job: cuda wrote "
                             f"{files['cuda']}, cpu {files['cpu']}")
    worst = 0.0
    for f in files["cpu"]:
        g = read_asc(os.path.join(md, "cuda", f))
        c = read_asc(os.path.join(md, "cpu", f))
        err = float(np.abs(g - c).max()) / float(np.abs(c).max())
        if not err <= TOL:
            raise AssertionError(f"256x256 maps job: {f} differs by "
                                 f"{err} of max |cpu map|")
        worst = max(worst, err)
    note(f"256x256 maps job: {len(files['cpu'])} maps, cuda and cpu agree "
         f"to {worst:.3e} of max |map|")

    pd = os.path.join(d, "poly")
    os.makedirs(pd)
    cfg, _, _ = make_polygon_job(pd, 256, 256)
    agree_jobs(pd, "256x256 polygon job", cfg, 32)
    pd = os.path.join(d, "poly_maps")
    os.makedirs(pd)
    cfg, _, _ = make_polygon_job(pd, 256, 256, npoints=8)
    agree_jobs(pd, "256x256 polygon maps job", dict(
        cfg, write_cur_maps="True", write_volt_maps="True",
        write_max_cur_maps="True"), 8, nmaps=2 * 27 + 2)
    pd = os.path.join(d, "regions")
    os.makedirs(pd)
    cfg = make_regions_job(pd, 256, 256, 4)
    agree_jobs(pd, "256x256 focal-region maps job", dict(
        cfg, write_cur_maps="True", write_volt_maps="True",
        write_max_cur_maps="True"), 4, nmaps=2 * 6 + 2)

    for polygons in (False, True):
        pd = os.path.join(d, f"advanced_{polygons}")
        os.makedirs(pd)
        cfg, _, _, _ = make_advanced_job(pd, 256, 256, polygons=polygons)
        agree_scenario(pd, "256x256 advanced " + ("polygon job" if polygons
                                                   else "job"), cfg, 2)
    pd = os.path.join(d, "o2a_poly")
    os.makedirs(pd)
    agree_scenario(pd, "256x256 one-to-all polygon job",
                   make_onetoall_polygons(pd, 256, 256))
    pd = os.path.join(d, "a2o")
    os.makedirs(pd)
    cfg, gmap = make_job(pd, 256, 256, npoints=8)
    agree_scenario(pd, "256x256 all-to-one maps job", dict(
        cfg, scenario="all-to-one", write_cur_maps="True"), 8 + 1,
        kirchhoff=gmap)

    # the large-grid route (a host-built hierarchy under the device
    # operator) with CS_DEVICE_MG_MAX set low, and a grid whose fine
    # level is wider than 4094 cells (matvec and cheb_step there, the
    # fused smoother on the coarser levels)
    pd = os.path.join(d, "host_route")
    os.makedirs(pd)
    cfg, _ = make_job(pd, 256, 256)
    with env_set(CS_DEVICE_MG_MAX="1"):
        agree_jobs(pd, "256x256 job on the host-built route", cfg, 32,
                   build="host")
    pd = os.path.join(d, "wide")
    os.makedirs(pd)
    cfg, _ = make_job(pd, 128, 4200, npoints=8, seed=3)
    agree_jobs(pd, "128x4200 job (fine level 128x4224)", cfg, 8,
               build="device")

    # the general sparse-graph tier: a lattice network on the forced
    # iterative tier, a raster maps job below CS_PAIRWISE_DEVICE_MIN and
    # a one-to-all job with included pairs (the per-point loop)
    pd = os.path.join(d, "network")
    os.makedirs(pd)
    with forced_iterative_tier():
        agree_general(pd, "10k-node network job",
                      make_network_job(pd, n=10_000, nfocal=8),
                      2 * 28 + 2 + 2)
    pd = os.path.join(d, "general_maps")
    os.makedirs(pd)
    cfg, _ = make_job(pd, 150, 150, npoints=6)
    agree_general(pd, "150x150 maps job (general tier)", dict(
        cfg, write_cur_maps="True", write_volt_maps="True"),
        2 * 15 + 1 + 2)
    pd = os.path.join(d, "general_o2a")
    os.makedirs(pd)
    cfg, _ = make_job(pd, 100, 100, npoints=6)
    with open(os.path.join(pd, "pairs.txt"), "w") as f:
        f.write("mode include\n1 2\n1 3\n2 4\n3 4\n4 5\n5 6\n")
    agree_general(pd, "100x100 one-to-all job with included pairs", dict(
        cfg, scenario="one-to-all", use_included_pairs="True",
        included_pairs_file=os.path.join(pd, "pairs.txt"),
        write_cur_maps="True"), 6 + 1)


def _branch_union(g, c):
    """Two branch-current files (node, node, |I|) as values over the
    union of their branches: the writer drops branches with |I| <= 1e-6
    (src/out.jl:117-124), so a branch at that threshold can appear in
    one file only; there it counts as 0."""
    keys = sorted({(a, b) for a, b in g[:, :2]} | {(a, b) for a, b in
                                                    c[:, :2]})
    out = []
    for m in (g, c):
        v = {(a, b): x for a, b, x in m}
        out.append(np.asarray([[a, b, v.get((a, b), 0.0)]
                               for a, b in keys]))
    return out


def agree_general(d, label, cfg, nfiles):
    """One job of the general sparse-graph tier on "cuda" and on "cpu"
    (outputs in d/cuda, d/cpu): results within 1e-5 relative (elementwise,
    where the cpu's is not 0), the same nfiles output files (current and
    voltage text files and grids, resistances), each within 1e-5 of its
    max |cpu value|, and the same CG iteration count on every pass, or
    else each of the card's passes, rerun on the CPU from its own
    operator, right-hand sides and hierarchy, within one iteration of
    its count."""
    out, passes, files = {}, {}, {}
    for dev in ("cuda", "cpu"):
        out[dev], _, passes[dev], rp = run_general(
            cfg, os.path.join(d, dev), dev, f"{label} on {dev}",
            keep=dev == "cuda")
        files[dev] = sorted(f for f in os.listdir(os.path.join(d, dev))
                            if f.endswith((".txt", ".asc")) or
                            "resistances" in f)
        if dev == "cuda":
            replayed = passes["cuda"] if passes["cuda"] == [] else \
                rp.replay_on_cpu()
            del rp
    a, b = out["cuda"], out["cpu"]
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    same = passes["cuda"] == passes["cpu"]
    near = (len(replayed) == len(passes["cuda"]) and
            all(abs(n - m) <= 1 for n, m in zip(replayed, passes["cuda"])))
    note(f"{label}: CG iterations cuda {passes['cuda']}, cpu "
         f"{passes['cpu']}" + ("" if same else f", the card's passes "
                               f"replayed on the cpu {replayed}") +
         f"; results agree to {rel:.3e}")
    if not (a.shape == b.shape and np.all(np.isfinite(a)) and rel <= TOL and
            passes["cuda"] and (same or near)):
        raise AssertionError(f"{label}: cuda and cpu results differ by "
                             f"{rel}; CG iterations {passes}, the card's "
                             f"replayed on the cpu {replayed}")
    if files["cuda"] != files["cpu"] or len(files["cpu"]) != nfiles:
        raise AssertionError(f"{label}: cuda wrote {len(files['cuda'])} "
                             f"files, cpu {len(files['cpu'])}, expected "
                             f"{nfiles}")
    worst = 0.0
    for f in files["cpu"]:
        skip = 6 if f.endswith(".asc") else 0
        g = np.loadtxt(os.path.join(d, "cuda", f), skiprows=skip, ndmin=2)
        c = np.loadtxt(os.path.join(d, "cpu", f), skiprows=skip, ndmin=2)
        if "branch_currents" in f:
            g, c = _branch_union(g, c)
        err = float(np.abs(g - c).max()) / max(float(np.abs(c).max()),
                                                 1e-30)
        if not (g.shape == c.shape and err <= TOL):
            raise AssertionError(f"{label}: {f} differs by {err} of max "
                                 "|cpu|")
        worst = max(worst, err)
    note(f"{label}: {nfiles} files agree to {worst:.3e} of max")


def agree_scenario(d, label, cfg, nmaps=0, kirchhoff=None):
    """One advanced, one-to-all or all-to-one job on "cuda" and on "cpu"
    (outputs in d/cuda, d/cpu): results within 1e-5 (of max |cpu| for an
    advanced voltage grid, relative per point otherwise), the same nmaps
    maps, each within 1e-5 of max |cpu map|, and on every pass, given
    the same inputs, the same CG iteration count within one: each of the
    card's passes rerun on the CPU from its own operator, right-hand
    side, hierarchy, penalty and projector.  Totals are not
    compared: a pass after the first solves the float32 residual of the
    one before, whose rounding differs between the kernels and their
    plain versions; within a pass the same rounding can move the
    stopping iteration by one where the residual stagnates near its
    target (the advanced polygon job, section 7 of PERF.md).  kirchhoff:
    the gmap of an all-to-one job with unit
    strengths and per-point current maps; each point's map at its own
    cell must equal the number of other points in its component (all
    the current leaves through its ground), to 1e-4 relative."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    out, iters, passes, files = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        od = os.path.join(d, dev)
        os.makedirs(od)
        with record_passes(keep=dev == "cuda") as rp:
            out[dev] = cst.compute(dict(cfg, output_file=os.path.join(
                od, "job.out")), device=dev)
        iters[dev], passes[dev] = stats.finalize().get("cg_iters"), rp.iters
        files[dev] = sorted(f for f in os.listdir(od) if f.endswith(".asc"))
        if dev == "cuda":
            replayed = rp.replay_on_cpu()
    a, b = out["cuda"], out["cpu"]
    if cfg["scenario"] == "advanced":
        rel = float(np.abs(a - b).max() / np.abs(b).max())
    else:
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    note(f"{label}: CG iterations cuda {iters['cuda']} {passes['cuda']}, "
         f"cpu {iters['cpu']} {passes['cpu']}, the card's passes replayed "
         f"on the cpu {replayed}; results agree to {rel:.3e}")
    if not (a.shape == b.shape and np.all(np.isfinite(a)) and rel <= TOL and
            len(replayed) == len(passes["cuda"]) and
            all(abs(n - m) <= 1
                for n, m in zip(replayed, passes["cuda"]))):
        raise AssertionError(f"{label}: cuda and cpu results differ by {rel}"
                             f"; CG iterations per pass {passes}, the "
                             f"card's replayed on the cpu {replayed}")
    if files["cuda"] != files["cpu"] or len(files["cpu"]) != nmaps:
        raise AssertionError(f"{label}: cuda wrote {files['cuda']}, cpu "
                             f"{files['cpu']}")
    worst = 0.0
    for f in files["cpu"]:
        g = read_asc(os.path.join(d, "cuda", f))
        c = read_asc(os.path.join(d, "cpu", f))
        err = float(np.abs(g - c).max()) / float(np.abs(c).max())
        if not err <= TOL:
            raise AssertionError(f"{label}: {f} differs by {err} of max "
                                 "|cpu map|")
        worst = max(worst, err)
    kirch = ""
    if kirchhoff is not None:
        from scipy import ndimage
        lab, _ = ndimage.label(kirchhoff > 0, structure=np.ones((3, 3)))
        pts = np.load(cfg["point_file"])
        cells = {int(p): tuple(np.argwhere(pts == p)[0])
                 for p in np.unique(pts[pts > 0])}
        for p, rc in cells.items():
            others = sum(1 for q, qc in cells.items()
                         if q != p and lab[qc] == lab[rc])
            at = read_asc(os.path.join(d, "cuda", f"job_curmap_{p}.asc"))[rc]
            if not abs(at - others) <= 1e-4 * others:
                raise AssertionError(f"{label}: point {p} carries {at}, "
                                     f"expected {others} (Kirchhoff)")
        kirch = f"; Kirchhoff holds at all {len(cells)} grounds"
    note(f"{label}: {len(files['cpu'])} maps agree to {worst:.3e} of max "
         f"|map|{kirch}")


def agree_jobs(d, label, cfg, n, nmaps=0, build=None):
    """One job on "cuda" and on "cpu" (outputs in d/cuda, d/cpu):
    resistances to 1e-5 relative (0 where the cpu has 0), the same CG
    iteration count, the same nmaps maps written, each within 1e-5 of
    max |cpu map|; with build, the hierarchy built there ("device" or
    "host", stats mg_build) on both."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    r, iters, files = {}, {}, {}
    for dev in ("cuda", "cpu"):
        od = os.path.join(d, dev)
        os.makedirs(od)
        r[dev] = cst.compute(dict(cfg, output_file=os.path.join(
            od, "job.out")), device=dev)
        sd = stats.finalize()
        iters[dev] = sd.get("cg_iters")
        if build is not None and sd.get("mg_build") != build:
            raise AssertionError(f"{label} on {dev}: hierarchy built on the "
                                 f"{sd.get('mg_build')}, not the {build}")
        files[dev] = sorted(f for f in os.listdir(od) if f.endswith(".asc"))
    check_resistances(r["cuda"], f"{label} cuda", n=n, merged=True)
    off = ~np.eye(n, dtype=bool)
    a, b = r["cuda"][1:, 1:][off], r["cpu"][1:, 1:][off]
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    if not (rel <= TOL and iters["cuda"] == iters["cpu"]):
        raise AssertionError(f"{label}: cuda and cpu resistances differ by "
                             f"{rel} relative; CG iterations {iters}")
    if files["cuda"] != files["cpu"] or len(files["cpu"]) != nmaps:
        raise AssertionError(f"{label}: cuda wrote {files['cuda']}, cpu "
                             f"{files['cpu']}")
    worst = 0.0
    for f in files["cpu"]:
        g = read_asc(os.path.join(d, "cuda", f))
        c = read_asc(os.path.join(d, "cpu", f))
        err = float(np.abs(g - c).max()) / float(np.abs(c).max())
        if not err <= TOL:
            raise AssertionError(f"{label}: {f} differs by {err} of max "
                                 "|cpu map|")
        worst = max(worst, err)
    note(f"{label}: cuda and cpu resistances agree to {rel:.3e} relative, "
         f"{iters['cuda']} CG iterations on both, {nmaps} maps agree to "
         f"{worst:.3e} of max |map|")


# --- the rest of the surface: Omniscape windows, warmup, the mesh ----------

OMNI_RADIUS = 150          # 301 x 301 windows, 90,601 cells each
OMNI_CENTRES = [(r, c) for r in (200, 400, 600, 800) for c in (250, 750)]
OMNI_CFG = {               # tests/test_internal.py:160-171, with cg+amg
    "ground_file_is_resistances": "True", "use_direct_grounds": "False",
    "output_file": "temp", "write_cum_cur_map_only": "False",
    "scenario": "Advanced", "suppress_messages": "True",
    "connect_four_neighbors_only": "False", "solver": "cg+amg",
    "cholmod_batch_size": "1000", "data_type": "raster"}


def omniscape_windows(gmap):
    """Eight moving windows of the bench map as Omniscape cuts them:
    301 x 301 conductance around a habitat centre (the nearest habitat
    cell to each of a 4 x 2 grid of centres), a source of 1 on every
    habitat cell and one ground of value 1 (a resistance) at the
    centre."""
    rad = OMNI_RADIUS
    out = []
    for r, c in OMNI_CENTRES:
        while gmap[r, c] <= 0:
            c += 1
        cond = gmap[r - rad:r + rad + 1, c - rad:c + rad + 1].copy()
        gnd = np.zeros_like(cond)
        gnd[rad, rad] = 1.0
        out.append((cond, (cond > 0).astype(np.float64), gnd))
    return out


def phase_omniscape(gmap):
    """The Omniscape entry on eight windows, on the card (launch counters
    zeroed just before the eight) and on the CPU: each window's current
    map within TOL of max of the CPU's; launches per kernel and ms per
    window printed."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.solve import prepare
    wins = omniscape_windows(gmap)
    setup, built = prepare.prepare_stencil_solver_from_gmap_pen, []

    def keep(*a, **k):       # the last window's pen-baked hierarchy
        out = setup(*a, **k)
        built[:] = [out[1]]
        return out
    prepare.prepare_stencil_solver_from_gmap_pen = keep
    try:
        cst.compute_omniscape_current(*wins[0], OMNI_CFG, device="cuda")
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        maps, times = [], []
        for w in wins:
            t = time.perf_counter()
            maps.append(cst.compute_omniscape_current(*w, OMNI_CFG,
                                                      device="cuda"))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    finally:
        prepare.prepare_stencil_solver_from_gmap_pen = setup
    launches, launches_at = dict(cs.LAUNCHES), dict(cs.LAUNCHES_AT)
    check_launched(launches, "Omniscape windows")
    # every kernel at every shape the windows launched it at, on the
    # window hierarchy's level of that shape, at the windows' B = 1
    levels = {tuple(L.A.shape): L for L in built[0].levels}
    by_level = {}
    for name, H, W in launches_at:
        if (H, W) not in levels:
            raise AssertionError(f"Omniscape: {name} launched at {H}x{W}, "
                                 f"no level of the window hierarchy has it")
        by_level.setdefault((H, W), []).append(name)
    rng, kworst = np.random.default_rng(19), {}
    for hw, names in sorted(by_level.items()):
        for name, rel in check_pen_level(levels[hw], 1, names, "cuda",
                                         rng).items():
            kworst[name] = max(kworst.get(name, 0.0), rel)
    worst = 0.0
    for k, (w, m) in enumerate(zip(wins, maps)):
        ref = cst.compute_omniscape_current(*w, OMNI_CFG, device="cpu")
        err = float(np.abs(m - ref).max()) / float(np.abs(ref).max())
        if not (m.shape == w[0].shape and np.all(np.isfinite(m)) and
                m.max() > 0 and err <= TOL):
            raise AssertionError(f"Omniscape window {k}: max {m.max()}, "
                                 f"{err} of max |cpu map|")
        worst = max(worst, err)
    note(f"Omniscape: {len(wins)} windows of {wins[0][0].shape[0]}^2 on "
         f"the card, ms per window " +
         ", ".join(f"{t * 1e3:.1f}" for t in times) +
         f"; launches over the eight {launches}; per shape "
         f"{dict(sorted(launches_at.items()))}; cuda and cpu maps "
         f"agree to {worst:.3e} of max |map|; at those shapes and B = 1 "
         f"every kernel agrees with its plain version per cell (worst "
         f"error per cell scale: " +
         ", ".join(f"{k} {v:.2e}" for k, v in sorted(kworst.items())) + ")")


def phase_golden():
    """tpu_golden.py's twelve goldens through torch_golden.run_subset on
    the card, on the default route (raster goldens on the general tier,
    network cg+amg on the host Cholesky) and on the device route (raster
    pairwise and advanced cg+amg cases on the stencil path, networks on
    the iterative tier), each case held to its golden.  Raises on any
    failure; the device route, with the launch counters zeroed just
    before it, must launch each of the seven kernels.  Returns the
    default route's verdict ("passed/total")."""
    import torch_golden
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    verdicts = []
    for route in torch_golden.ROUTES:
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t = time.perf_counter()
        passed, total, failures = torch_golden.run_subset(note, "cuda", route)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = dict(cs.LAUNCHES)
        at = ", ".join(f"{k} {H}x{W}: {n}" for (k, H, W), n in
                       sorted(cs.LAUNCHES_AT.items()))
        note(f"golden replay, {route} route: {passed}/{total} in {dt:.3f} "
             f"s, launches {launches}; per shape {at}")
        if failures:
            raise AssertionError(f"golden replay, {route} route: "
                                 f"{failures}")
        if route == "device":
            check_launched(launches, "golden replay's device route")
        verdicts.append(f"{passed}/{total}")
    note(f"torch_golden: {verdicts[0]} passed (default), {verdicts[1]} "
         f"(device)")
    return verdicts[0]


def phase_warmup(cfg):
    """warmup() of the bench job on the card, in a process that has run
    no job yet, then the bench job itself."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch.warmup import warmup
    secs = warmup(cfg, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    cst.compute(cfg, device="cuda")
    torch.cuda.synchronize()
    note(f"warmup of the bench job: {secs:.3f} s; the bench job right "
         f"after it: {time.perf_counter() - t:.3f} s")


class virtual_mesh:
    """A mesh shaped by CS_MESH_SHAPE (forced on) while active, over
    `devices` (default: virtual shards of dev, one per position):
    parallel/mesh.visible_devices patched to return them."""

    def __init__(self, dev, shape, devices=None, **env):
        n = int(np.prod([int(v) for v in shape.split(",")]))
        self.devices = list(devices or [torch.device(dev)] * n)
        self.env = env_set(CS_MESH_SHAPE=shape, CS_FORCE_MESH="1", **env)

    def __enter__(self):
        from circuitscape_tpu_torch.parallel import mesh
        self.real = mesh.visible_devices
        mesh.visible_devices = lambda: list(self.devices)
        self.env.__enter__()
        return self

    def __exit__(self, *exc):
        from circuitscape_tpu_torch.parallel import mesh
        mesh.visible_devices = self.real
        self.env.__exit__()


def _sync(devices):
    """Wait for every CUDA device among devices."""
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def cards() -> list:
    """Every visible CUDA device."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def reset_peaks(devices):
    """Zero the peak-memory count of every CUDA device among devices."""
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def card_peaks(devices) -> dict:
    """{device: peak bytes allocated since its last reset} for each
    distinct CUDA device among devices, in order."""
    return {d: torch.cuda.max_memory_allocated(d) for d in
            dict.fromkeys(torch.device(d) for d in devices)
            if d.type == "cuda"}


def mesh_job(cfg, dev, shape, label, devices=None, **env):
    """One job on a mesh (virtual shards of dev, or `devices`) with the
    launch counters zeroed just before it.  Returns (result, seconds,
    launches per shape, per-pass CG counts, stats)."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    with virtual_mesh(dev, shape, devices, **env) as vm:
        _sync(vm.devices)
        cs.reset_launch_counts()
        t = time.perf_counter()
        r = cst.compute(cfg, device=dev)
        _sync(vm.devices)
        dt = time.perf_counter() - t
    st = stats.finalize()
    if not any(k.endswith("/shard") for k in st.get("mg_kernels", [])):
        raise AssertionError(f"{label}: the job did not run on the mesh "
                             f"({st.get('mg_kernels')})")
    at = dict(cs.LAUNCHES_AT)
    note(f"{label} on a ({shape}) mesh of {dev}: {dt:.3f} s, per-pass CG "
         f"{st.get('pass_iters')}, mg_kernels {st.get('mg_kernels')}, "
         f"build {st.get('mg_build')}; LAUNCHES_AT "
         f"{dict(sorted(at.items()))}")
    return r, dt, at, st.get("pass_iters", []), st


def check_mesh_kernels(gmap, B, launches_at, dev, shape, label,
                       devices=None, **env):
    """Each kernel a mesh run launched, at each per-shard shape it
    launched at, held against its plain version on every shard of the
    run's own hierarchy (rebuilt here from gmap on the same mesh) with
    that shape (check_shard_kernels)."""
    from circuitscape_tpu_torch.solve.prepare import (
        prepare_stencil_solver_from_gmap)
    with virtual_mesh(dev, shape, devices, **env):
        _, prec, _, _ = prepare_stencil_solver_from_gmap(gmap, False, False,
                                                         dev)
    check_shard_kernels(prec, B, launches_at, label)


def _level_ops(L):
    """(operator, Dinv) of a hierarchy level at each mesh position (a
    sharded level's halo-extended ones), or the level's own on one
    device."""
    if hasattr(L.A, "ops"):
        return [(op, L.A.dinv[i][j]) for i, row in enumerate(L.A.ops)
                for j, op in enumerate(row)]
    return [(L.A, L.inv_diag)]


def check_shard_kernels(prec, B, launches_at, label):
    """Each kernel a run launched, at each (per-shard) shape it launched
    at, held against its plain version on every shard of the run's
    hierarchy prec with that shape (the shard's halo-extended planes, on
    each device that holds them; the level itself on one device), at
    the run's batch per column group B, with phase 2's tolerance; shard
    0's launch timed beside its byte bound.  Returns the lines' times
    as {(name, H, W): (ms, bound ms)}."""
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.parallel.mesh import _on
    by_shape, seen = {}, set()
    for L in prec.levels:
        for op, dinv in _level_ops(L):
            if id(op) not in seen:
                seen.add(id(op))
                by_shape.setdefault(tuple(op.shape), []).append((op, dinv))
    n, worst, times = 0, 0.0, {}
    for (name, H, W), _ in sorted(launches_at.items()):
        ops = by_shape.get((H, W))
        if not ops:
            raise AssertionError(f"{label}: {name} launched at {H}x{W}, "
                                 f"no shard of the hierarchy has it")
        for k, (op, dinv) in enumerate(ops):
            odev = op.diag.device
            with _on(odev):
                blocks = _card_blocks(B, H, W, odev, seed=100 + k)
                kern, plain = _pairs(name, op, dinv, blocks)
                worst = max(worst, check_kernel(
                    name, kern, plain,
                    f"{label} shard {k} on {odev} B={B} {H}x{W}"))
                n += 1
                if k == 0:
                    rate = stats.device_bytes_per_s(
                        torch.cuda.get_device_name(odev))
                    times[(name, H, W)] = (
                        cuda_ms(kern), kernel_bytes(name, B, H, W) / rate *
                        1e3)
                del blocks, kern, plain
    note(f"{label}: {n} per-shard kernel launches agree with their plain "
         f"versions (worst max abs err {worst:.3e}); shard 0 at B={B}: " +
         "; ".join(f"{name} {H}x{W} {ms:.4f} ms (bound {bound:.4f})"
                   for (name, H, W), (ms, bound) in times.items()))
    return times


def _rel(a, b):
    off = ~np.eye(b.shape[0] - 1, dtype=bool)
    x, y = a[1:, 1:][off], b[1:, 1:][off]
    return float(np.max(np.abs(x - y) / np.abs(y)))


def mesh_shapes(n):
    """The mesh shapes a run of n devices takes: (n, 1), and the square-
    most (r, n / r) with r > 1 where it differs."""
    r = max(k for k in range(1, math.isqrt(n) + 1) if n % k == 0)
    return [f"{n},1"] + ([f"{r},{n // r}"] if 1 < r < n else [])


def phase_mesh(d, cfg, gmap, r_plain, adv_cfg, v_adv, devices=None):
    """The mesh on `devices` (default: four virtual shards of cuda:0,
    where every seam exchange, per-shard launch and cross-shard sum runs
    on the card), against single-device runs: the bench job (r_plain)
    on each shape of mesh_shapes, the advanced job (v_adv) on (n, 1), a
    256 x 256 job on the card and on virtual CPU shards, and a 2048 x
    2048 job through the streamed build against the materialized one.
    Every kernel each run launched is held against its plain version on
    every shard that has its shape."""
    from circuitscape_tpu_torch.solve.prepare import (
        prepare_stencil_solver_from_gmap)
    dev = torch.device(devices[0]) if devices else \
        torch.device("cuda", torch.cuda.current_device())
    n = len(devices) if devices else 4
    shapes = mesh_shapes(n)
    where = f"{n} cards" if devices else f"virtual shards of {dev}"
    for shape in shapes:
        label = f"bench job on ({shape}), {where}"
        mesh_job(cfg, dev, shape, label, devices)               # warm
        r, _, at, _, _ = mesh_job(cfg, dev, shape, label, devices)
        check_resistances(r, label)
        rel = _rel(r, r_plain)
        if not rel <= TOL:
            raise AssertionError(f"{label}: resistances differ from the "
                                 f"single-device run's by {rel}")
        note(f"{label}: resistances agree with the single-device run's to "
             f"{rel:.3e} relative")
        check_mesh_kernels(gmap, 32 // int(shape.split(",")[1]), at, dev,
                           shape, label, devices)

    label = f"advanced job on ({n},1), {where}"
    v, _, at, _, st = mesh_job(adv_cfg, dev, f"{n},1", label, devices)
    err = float(np.abs(v - v_adv).max()) / float(np.abs(v_adv).max())
    if not err <= TOL:
        raise AssertionError(f"{label}: voltages differ from the "
                             f"single-device run's by {err} of max")
    note(f"{label} (masked preconditioner, {st.get('cg_iters')} CG "
         f"iterations): voltages agree with the single-device run's to "
         f"{err:.3e} of max")
    check_mesh_kernels(gmap, 1, at, dev, f"{n},1", label, devices)

    sd = os.path.join(d, "mesh256")
    os.makedirs(sd)
    cfg256, _ = make_job(sd, 256, 256)
    rg, _, _, pg, _ = mesh_job(cfg256, dev, shapes[-1], "256x256 job",
                               devices)
    rc, _, _, pc, _ = mesh_job(cfg256, torch.device("cpu"), shapes[-1],
                               "256x256 job")
    rel = _rel(rg, rc)
    if not (rel <= TOL and len(pg) == len(pc) and
            all(abs(a - b) <= 1 for a, b in zip(pg, pc))):
        raise AssertionError(f"256x256 mesh job: cuda {pg} and cpu {pc} "
                             f"CG passes, resistances differ by {rel}")
    note(f"256x256 mesh job ({where}): cuda and cpu CG passes {pg} / {pc}, "
         f"resistances agree to {rel:.3e} relative")

    bd = os.path.join(d, "mesh2048")
    os.makedirs(bd)
    cfg2k, g2k = make_job(bd, 2048, 2048, npoints=4, seed=5)
    runs, hier = {}, {}
    for route, lim in (("host streamed", None), ("host", "100000000")):
        env = {} if lim is None else {"CS_STREAM_BUILD_MIN": lim}
        r2k, _, at, _, st = mesh_job(cfg2k, dev, f"{n},1",
                                     f"2048x2048 job ({route} build)",
                                     devices, **env)
        if st.get("mg_build") != route:
            raise AssertionError(f"2048x2048 job: build {st.get('mg_build')}"
                                 f", expected {route}")
        check_resistances(r2k, "2048x2048 mesh job", n=4)
        runs[route] = r2k
        with virtual_mesh(dev, f"{n},1", devices, **env):
            _, prec, _, _ = prepare_stencil_solver_from_gmap(
                g2k, False, False, dev)
        hier[route] = [[p.cpu() for p in L.A.full().planes] +
                       [L.inv_diag.gather().cpu()] for L in prec.levels]
        del prec
    for a, b in zip(hier["host streamed"], hier["host"]):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("2048x2048: the streamed hierarchy differs "
                                 "from the materialized one")
    if len(hier["host streamed"]) != len(hier["host"]):
        raise AssertionError("2048x2048: level counts differ")
    rel = _rel(runs["host streamed"], runs["host"])
    if not rel <= TOL:
        raise AssertionError(f"2048x2048: streamed and materialized "
                             f"resistances differ by {rel}")
    note(f"2048x2048 job (4.19M cells, {where}): the streamed build's "
         f"{len(hier['host'])} levels equal the materialized build's "
         f"array for array; resistances agree to {rel:.3e} relative")
    check_mesh_kernels(g2k, 4, at, dev, f"{n},1",
                       f"2048x2048 job on ({n},1)", devices)


def phase_capacity(side=None, out=None):
    """20. bench_capacity_torch.py's row b (14336^2, 205.5M cells, or
    side^2) on a mesh of every visible card (CS_FORCE_MESH, the default
    shape) and on one card (CS_DISABLE_MESH), through
    bench_capacity_torch.run_row with that row's checks (resistances,
    6 pairs solved, each anchor column's float64 residual a shard at a
    time, the hierarchy's route, the mesh's shape, the one-card run
    within 1e-4 relative of the mesh run's); then every kernel each run
    launched held against its plain version on every shard of that
    run's own hierarchy at the shard's halo-extended shape, at the run's
    batch per column group (check_shard_kernels, phase 2's tolerance),
    shard 0's launch timed beside its byte bound.  Prints each run's
    wall, CG passes, residuals, host peak, per-card memory and launches
    per shape; with out, writes the runs' records there as
    bench_capacity_torch.py does.  A failed check raises."""
    import bench_capacity_torch as bct
    row_side, runs = bct.ROWS["b"]
    side = side or row_side
    records, tags = [], bct._tags("cuda")

    def record(rec):
        records.append({**rec, **tags})
        if out:
            with open(out, "w") as f:
                json.dump(records, f, indent=1)

    def after(run, rec, extras):
        label = f"capacity row b ({side}^2), {run.label}"
        note(f"{label}: {rec['wall_s']:.3f} s wall, per-pass CG "
             f"{rec['pass_iters']}, batch width {rec['batch_width']}, "
             f"build {rec['mg_build']}, mg_kernels {rec['mg_kernels']}, "
             f"float64 residuals {rec['residuals']}, host peak "
             f"{rec['host_peak_rss_gb']:.3f} GiB, stages {rec['stages']}")
        note(f"{label} per card: " + "; ".join(
            f"{c['device']} fixed {c['fixed_gb']:.3f} GiB, peak "
            f"{c['peak_gb']:.3f} GiB (model {c['model_gb']:.3f}), "
            f"{c['column_bytes_per_cell']:.3f} B a cell per column"
            for c in rec.get("cards_memory", [])))
        note(f"{label} launches per shape " + ", ".join(
            f"{k} {H}x{W}: {n}"
            for (k, H, W), n in sorted(extras["launches_at"].items())))
        if "error" in rec:
            raise AssertionError(f"{label}: {rec['error']}")
        for _, prec in extras["solves"][:1]:
            check_shard_kernels(prec, extras["batch"],
                                extras["launches_at"], label)

    with env_set(**dict.fromkeys(bct.ROUTING)):
        recs = bct.run_row("b", side, runs, "cuda", record, after=after,
                           catch=False)
    note(f"capacity row b ({side}^2): the one-card run agrees with the mesh "
         f"run to {recs[-1]['agreement']['max_rel']:.6e} relative (tolerance "
         f"{bct.AGREE_TOL}); the default routing takes "
         f"{recs[0]['default_route']}")


def main_cards(dev, dev_name, capacity_out=None):
    """--cards: the build and phase_mesh across every visible card,
    against one-card runs of the bench and advanced jobs; then phase 20
    (phase_capacity, its records written to capacity_out if given)."""
    import circuitscape_tpu_torch as cst
    devs = cards()
    phase_build()
    scratch = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    d = tempfile.mkdtemp(dir=scratch)
    try:
        cfg, gmap = make_job(d, 1000, 1000)
        adv_cfg, _, _, _ = make_advanced_job(tempfile.mkdtemp(dir=d),
                                             1000, 1000)
        with env_set(CS_DISABLE_MESH="1"):
            cst.compute(cfg, device=dev)
            _sync(devs)
            t = time.perf_counter()
            r1 = cst.compute(cfg, device=dev)
            _sync(devs)
            note(f"bench job on one card: {time.perf_counter() - t:.3f} s")
            v1 = cst.compute(adv_cfg, device=dev)
        phase_mesh(tempfile.mkdtemp(dir=d), cfg, gmap, r1, adv_cfg, v1,
                   devices=devs)
        t = time.perf_counter()
        phase_capacity(out=capacity_out)
        note(f"capacity row b (phase 20): {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    note(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=()):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import circuitscape_tpu_torch  # noqa: F401  (fails outside the repo)
    from circuitscape_tpu_torch import stats

    dev = torch.device("cuda", torch.cuda.current_device())
    dev_name = torch.cuda.get_device_name(dev)
    note(f"torch {torch.__version__} cuda {torch.version.cuda} on "
         f"{dev_name}")
    note(card_line())
    if "--cards" in argv:
        if torch.cuda.device_count() < 2:
            print("chip_smoke --cards: needs two cards or more",
                  file=sys.stderr)
            return 2
        out = (argv[argv.index("--capacity-out") + 1]
               if "--capacity-out" in argv else None)
        return main_cards(dev, dev_name, out)
    t_start = time.perf_counter()
    phase_build()
    scratch = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    d = tempfile.mkdtemp(dir=scratch)
    try:
        cfg, gmap = make_job(d, 1000, 1000)
        phase_warmup(cfg)
        golden = phase_golden()
        pd = tempfile.mkdtemp(dir=d)
        poly_cfg, _, poly = make_polygon_job(pd, 1000, 1000)
        rows, level_times = phase_kernels(gmap, dev, dev_name)
        rate = stats.device_bytes_per_s(dev_name)
        # the polygon job runs matvec on the fine level, timed by phase 2
        level_times["matvec"][MAIN_HW] = (
            rows["matvec"]["ms"],
            kernel_bytes("matvec", MAIN_B, *MAIN_HW) / rate * 1e3)
        adv_cfg, _, adv_src, adv_cond = make_advanced_job(
            tempfile.mkdtemp(dir=d), 1000, 1000)
        phase_pen_kernels(gmap, adv_cond, dev)
        phase_poly_project(gmap, poly, dev, rate)
        scale_cfg, scale_gmap = make_scale_job(tempfile.mkdtemp(dir=d))
        scale_times = time_scale_levels(scale_gmap, dev, rate, rows)
        check_past_2_31(scale_gmap, dev, rows)
        del scale_gmap
        r, launches_at = phase_main(cfg, rows, golden)
        note_per_job(level_times, launches_at)
        phase_maps(cfg, gmap, r)
        phase_graph(cfg)
        phase_glue(cfg, dev, rate)
        phase_polygons(poly_cfg, r, level_times)
        phase_regions(make_regions_job(tempfile.mkdtemp(dir=d), 1000, 1000,
                                       8), r)
        v_adv = phase_advanced(adv_cfg, gmap, adv_src, adv_cond)
        phase_onetoall(cfg, r, level_times)
        phase_alltoone(cfg, gmap, level_times)
        phase_scale(scale_cfg, scale_times)
        phase_chunk_model(tempfile.mkdtemp(dir=d))
        t = time.perf_counter()
        phase_suite(tempfile.mkdtemp(dir=d), rate, rows)
        note(f"suite rows (phase 19): {time.perf_counter() - t:.1f} s")
        phase_network(tempfile.mkdtemp(dir=d), rate, dev_name)
        phase_network_advanced(tempfile.mkdtemp(dir=d))
        phase_agree(tempfile.mkdtemp(dir=d))
        phase_omniscape(gmap)
        phase_mesh(tempfile.mkdtemp(dir=d), cfg, gmap, r, adv_cfg, v_adv)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    note(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    card = card_line()
    note(card)
    print(json.dumps({"kernels": [rows[k] for k, _, _ in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
