"""Smoke run of circuitscape_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from circuitscape_tpu_torch/csrc with nvcc;
     print nvcc's version and the card's name and power limit;
  2. hold each kernel against its plain-torch version on the card, at
     B in {1, 2, 3, 4, 8, 32} and grids with odd sides, a width that is
     not a multiple of 32, and the main path's 1024 x 1024 (tolerance:
     max |kernel - plain| <= 1e-5 * max |plain|, float32 sum order);
     time each kernel and its plain version with CUDA events at the main
     path's shapes, beside the least time the card could take and, for
     matvec (the one with a single-call library form), a CSR sparse
     product;
  3. drive the main path: the bench.py job (seed 42, 1000 x 1000
     conductance raster with ~10% NODATA, 32 focal points, cg+amg,
     single precision, shortcut mode) through compute(..., "cuda"):
     one warm run, then two timed runs, each with the launch counters
     set to 0 just before it; check the resistances (finite, positive
     off the diagonal, symmetric) and that every kernel launched;
  4. run a 256 x 256 job of the same recipe on "cuda" and on "cpu" and
     require the resistances to agree to 1e-5 relative;
  5. print the kernels line, the card line and, last, the result line.

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
BATCHES = (1, 2, 3, 4, 8, 32)
SHAPES = ((37, 53), (130, 100), (257, 333), (1024, 1024))
MAIN_B, MAIN_HW = 32, (1024, 1024)

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
)
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
    written once (float32)."""
    cells = H * W
    coarse = -(-H // 2) * -(-W // 2)
    return 4 * {
        "matvec": (2 * B + 5) * cells,
        "matvec_pap": (2 * B + 5) * cells + B,
        "cheb_step": (6 * B + 6) * cells,
        "residual_restrict": (2 * B + 5) * cells + B * coarse,
    }[name]


def cuda_ms(fn, n=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
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
    return {
        "matvec": (lambda: cs.matvec(A, x), lambda: cs.matvec_plain(A, x)),
        "matvec_pap": (lambda: cs.matvec_pap(A, x),
                       lambda: cs.matvec_pap_plain(A, x)),
        "cheb_step": (lambda: cs.cheb_step(A, dinv, r, d, x, ca, cb),
                      lambda: cs.cheb_step_plain(A, dinv, r, d, x, ca, cb)),
        "residual_restrict": (lambda: cs.residual_restrict(A, b, x),
                              lambda: cs.residual_restrict_plain(A, b, x)),
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
    (cuSPARSE) on x's (H*W, B) column-major view.  Returns the call and
    its result reshaped to (B, H, W)."""
    B, H, W = x.shape
    L = _csr_laplacian(A)
    xt = x.reshape(B, H * W).t()

    def call():
        return torch.sparse.mm(L, xt)
    return call, call().t().reshape(B, H, W)


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
                got, ref = _as_tuple(kern()), _as_tuple(plain())
                torch.cuda.synchronize()
                for g_, r_ in zip(got, ref):
                    err = float((g_ - r_).abs().max())
                    scale = float(r_.abs().max())
                    if not err <= TOL * scale:
                        raise AssertionError(
                            f"{name} B={B} {H}x{W}: max err {err} > "
                            f"{TOL} * {scale}")
                row = rows.setdefault(name, {
                    "name": name, "route": "cuda", "source": SOURCE,
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": 0.0})
                row["max_abs_err"] = max(
                    row["max_abs_err"],
                    max(float((g_ - r_).abs().max())
                        for g_, r_ in zip(got, ref)))
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
                        # the only one of the four that one PyTorch call
                        # computes; the others have no single-call form
                        lib, y = _library_matvec(A, blocks[0])
                        err = float((y - ref[0]).abs().max())
                        if not err <= TOL * float(ref[0].abs().max()):
                            raise AssertionError(
                                f"library sparse product disagrees with "
                                f"the plain matvec by {err}")
                        row["library_ms"] = cuda_ms(lib)
                        del lib, y
            del A, dinv, blocks
        note(f"kernels agree with their plain versions at {H}x{W}, "
             f"B in {BATCHES if (H, W) != MAIN_HW else (MAIN_B,)}")
    for row in rows.values():
        note(f"{row['name']}: {row['ms']:.4f} ms (plain "
             f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, "
             f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
             f"B={MAIN_B} {MAIN_HW}")
    return rows


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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
        rows[name]["launches"] = n
    st = stats.finalize()
    note(f"main path: best of 2 = {best:.3f} s, cg_iters "
         f"{st.get('cg_iters')}, mg_kernels {st.get('mg_kernels')}, "
         f"solve_s {st.get('solve_s'):.3f}, fine_spmv_pct_of_mem_roofline "
         f"{st.get('fine_spmv_pct_of_mem_roofline')}")
    return r


def phase_agree(d):
    """A 256 x 256 bench-recipe job on the card and on the CPU."""
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
        rows = phase_kernels(gmap, dev, dev_name)
        phase_main(cfg, rows)
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
