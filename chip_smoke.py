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
     and level;
  3. drive the main path: the bench.py job (seed 42, 1000 x 1000
     conductance raster with ~10% NODATA, 32 focal points, cg+amg,
     single precision, shortcut mode) through compute(..., "cuda"):
     one warm run, then two timed runs, each with the launch counters
     set to 0 just before it; check the resistances (finite, positive
     off the diagonal, symmetric), the CG iteration count (10) and that
     every kernel launched; then print each kernel's time per bench job
     (phase 2's level times weighted by this run's launches per level)
     beside its byte bound, one per_job line per kernel;
  4. drive the maps path: the same job with write_cum_cur_map_only and
     write_max_cur_maps (all 496 pairs solved in chunks of 32, two
     1M-cell ASC maps written): one warm run, then one timed run with
     the counters set to 0 just before it; check that every kernel
     launched, that the resistances agree with phase 3's shortcut
     matrix to 1e-4 relative, and that the cumulative map is finite,
     >= 0 on active cells and > 0 somewhere;
  5. run 256 x 256 jobs of the same recipe on "cuda" and on "cpu": the
     shortcut job (resistances agree to 1e-5 relative) and an 8-point
     maps job with per-pair current and voltage maps and the max map
     (the same files, every map within 1e-5 of max |cpu map|);
  6. print the kernels line, the card line and, last, the result line.

Exits 2 without printing a result when no CUDA device is available.
"""

import json
import os
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


def check_resistances(r, label):
    m = r[1:, 1:]
    off = ~np.eye(m.shape[0], dtype=bool)
    if m.shape != (32, 32) or not np.all(np.isfinite(m)):
        raise AssertionError(f"{label}: resistances not finite 32x32")
    if not np.all(m[off] > 0):
        raise AssertionError(f"{label}: non-positive off-diagonal "
                             f"resistance {m[off].min()}")
    asym = np.abs(m - m.T).max() / np.abs(m).max()
    if asym > TOL:
        raise AssertionError(f"{label}: resistances not symmetric ({asym})")


def phase_build():
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    nvcc = cs._nvcc()
    note(subprocess.run([nvcc, "--version"], capture_output=True,
                        text=True, check=True).stdout.strip())
    t = time.perf_counter()
    lib = cs.build()
    cs._load()
    note(f"built {os.path.relpath(lib, HERE)} in "
         f"{time.perf_counter() - t:.1f} s")


def _inputs(gmap, B, H, W, rng, dev):
    """A float32 fine operator of an (H, W) crop of gmap, its Dinv, and
    four random (B, H, W) blocks, on dev."""
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
    blocks = [torch.as_tensor(rng.standard_normal((B, H, W)),
                              dtype=torch.float32, device=dev)
              for _ in range(4)]
    return A, dinv, blocks


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
    spin kernel reads several times slow.  Returns {name: [(ms, bound
    ms) per level]}."""
    rng = np.random.default_rng(11)
    times = {name: [] for name, _ in LEVEL_KERNELS}
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
            times[name].append((ms, bound))
            lib = ""
            if name == "matvec":
                call = _library_matvec(A, blocks[0])
                lib = (f", library "
                       f"{min(cuda_ms(call, n=50) for _ in range(3)):.4f} ms")
            note(f"level {name} B={MAIN_B} {H}x{W}: {ms:.4f} ms{lib}, byte "
                 f"bound {bound:.4f} ms, {100 * bound / ms:.1f}% of bound")
        del A, dinv, blocks
    return times


def note_per_job(level_times, launches):
    """Each kernel's time per bench job: its level times, each times the
    launches the job makes on that level, summed, beside the same sum of
    its byte bounds.  A kernel launches equally often on each of its
    levels (the smoother kernels and residual_restrict once per V-cycle
    level, matvec_pap, cheb_step and matvec on one level), so the
    phase-3 counter divided by its number of levels gives the launches
    per level."""
    for name, per_level in level_times.items():
        n, rem = divmod(launches[name], len(per_level))
        if rem:
            raise AssertionError(f"{name}: {launches[name]} launches do not "
                                 f"split evenly over {len(per_level)} levels")
        ms = sum(t for t, _ in per_level) * n
        bound = sum(b for _, b in per_level) * n
        note(f"per_job {name}: {ms:.4f} ms over {launches[name]} launches "
             f"({n} per level), byte bound {bound:.4f} ms, "
             f"{100 * bound / ms:.1f}% of bound")


def phase_main(cfg, rows):
    """The bench job on the card: warm run, then two timed runs with the
    launch counters zeroed just before each."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs

    cst.compute(cfg, device="cuda")
    best = float("inf")
    for run in range(2):
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t = time.perf_counter()
        r = cst.compute(cfg, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = dict(cs.LAUNCHES)
        note(f"main path run {run}: {dt:.3f} s, launches {launches}")
        best = min(best, dt)
    check_resistances(r, "main path")
    check_launched(launches, "main path")
    for name, n in launches.items():
        rows[name]["launches"] = n
    st = stats.finalize()
    note(f"main path: best of 2 = {best:.3f} s, cg_iters "
         f"{st.get('cg_iters')}, mg_kernels {st.get('mg_kernels')}, "
         f"solve_s {st.get('solve_s'):.3f}, fine_spmv_pct_of_mem_roofline "
         f"{st.get('fine_spmv_pct_of_mem_roofline')}")
    if st.get("cg_iters") != CG_ITERS:
        raise AssertionError(f"main path: {st.get('cg_iters')} CG "
                             f"iterations, expected {CG_ITERS}")
    return r


def check_launched(launches, label):
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{label}")


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import circuitscape_tpu_torch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda", torch.cuda.current_device())
    dev_name = torch.cuda.get_device_name(dev)
    note(f"torch {torch.__version__} cuda {torch.version.cuda} on "
         f"{dev_name}")
    note(card_line())
    phase_build()
    scratch = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    d = tempfile.mkdtemp(dir=scratch)
    try:
        cfg, gmap = make_job(d, 1000, 1000)
        rows, level_times = phase_kernels(gmap, dev, dev_name)
        r = phase_main(cfg, rows)
        note_per_job(level_times, {k: row["launches"]
                                   for k, row in rows.items()})
        phase_maps(cfg, gmap, r)
        phase_agree(tempfile.mkdtemp(dir=d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    card = card_line()
    note(card)
    print(json.dumps({"kernels": [rows[k] for k, _, _ in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
