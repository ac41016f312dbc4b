"""Golden-subset replay through circuitscape_tpu_torch on the card: the
counterpart of tpu_golden.py.

    python3 torch_golden.py                # on the CUDA device
    python3 torch_golden.py --device cpu   # the same replay on the CPU

The pytest suite runs the golden corpus through the port on the CPU;
this runner replays a representative golden config per scenario family
(tpu_golden.py's twelve: both solver tiers, both precisions) on the
card, with the comparison rules of the reference harness
(test/test_utils.jl): resistances elementwise within sqrt(tol), every
written grid within a sum-of-squares difference of tol, network
node/branch files by sorted rows with the goldens' 0-based ids shifted;
tol is 1e-4 in single precision and 1e-6 in double.

Each case runs on two routes:

  default  the thresholds as they stand: the raster goldens (below
           40000 cells) take the general tier, ELL PCG with the SA-AMG
           V-cycle on the device; network cg+amg jobs route to the
           native Cholesky on the host, as in the JAX package;
  device   CS_PAIRWISE_DEVICE_MIN, CS_ADVANCED_DEVICE_MIN and
           CS_ONETOALL_DEVICE_MIN set to 1, so the raster cg+amg cases
           take the stencil path (its INIs bucket to 128 x 128 and run
           all seven CUDA kernels), but for one-to-all and all-to-one,
           whose included pairs or merged points send them, as in the
           JAX package, to the general tier; network cases with
           CS_NETWORK_DIRECT_MAX=0, the iterative tier on the device.
           The cholmod case runs the host Cholesky on either route.

Outputs go to a temporary directory (output_file, and an INI's own
log_file, rewritten), never to tests/data/output, which
tests/test_golden.py wipes and a checkout does not hold.  Prints one
verdict line; exits 1 if a case fails, 2 without a CUDA device unless
--device cpu is given (there is no fallback to the CPU).

Imports neither JAX nor circuitscape_tpu: the helpers below are copies
of tests/golden_utils.py's, which imports the JAX package.
"""

import argparse
import contextlib
import glob
import os
import shutil
import sys
import tempfile
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

DATA_DIR = os.path.join(HERE, "tests", "data")
VERIFY = os.path.join(DATA_DIR, "output_verify")

# tpu_golden.py's representative subset: >=1 config per scenario family
CASES = [
    # (label, ini, golden_resistances_or_None, solver, precision)
    ("network-pairwise", "input/network/sgNetworkVerify1.ini",
     "sgNetworkVerify1_resistances.out", "cg+amg", "double"),
    ("network-advanced", "input/network/mgNetworkVerify1.ini",
     None, "cg+amg", "double"),
    ("raster-pairwise", "input/raster/pairwise/1/sgVerify1.ini",
     "sgVerify1_resistances.out", "cg+amg", "double"),
    ("raster-pairwise-direct", "input/raster/pairwise/1/sgVerify1.ini",
     "sgVerify1_resistances.out", "cholmod", "double"),
    ("raster-pairwise-single", "input/raster/pairwise/2/sgVerify2.ini",
     "sgVerify2_resistances.out", "cg+amg", "single"),
    ("raster-advanced", "input/raster/advanced/1/mgVerify1.ini",
     None, "cg+amg", "double"),
    ("raster-advanced-single", "input/raster/advanced/1/mgVerify1.ini",
     None, "cg+amg", "single"),
    ("one-to-all", "input/raster/one_to_all/1/oneToAllVerify1.ini",
     "oneToAllVerify1_resistances.out", "cg+amg", "double"),
    ("all-to-one", "input/raster/all_to_one/1/allToOneVerify1.ini",
     "allToOneVerify1_resistances.out", "cg+amg", "single"),
    ("pairwise-maps", "input/raster/pairwise/7/sgVerify7.ini",
     "sgVerify7_resistances.out", "cg+amg", "double"),
    # the hard output modes on the real chip (r2 VERDICT weak item 9):
    # polygons + include-pairs + per-pair current AND voltage maps
    # (PolyProjector numerics on device), and focal regions (per-pair
    # batched projector path)
    ("pairwise-polygons-maps", "input/raster/pairwise/13/sgVerify13.ini",
     "sgVerify13_resistances.out", "cg+amg", "double"),
    ("pairwise-focal-regions", "input/raster/pairwise/17/sgVerify17.ini",
     "sgVerify17_resistances.out", "cg+amg", "double"),
]

ROUTES = ("default", "device")
RASTER_DEVICE_ENV = {"CS_PAIRWISE_DEVICE_MIN": "1",
                     "CS_ADVANCED_DEVICE_MIN": "1",
                     "CS_ONETOALL_DEVICE_MIN": "1"}
NETWORK_DEVICE_ENV = {"CS_NETWORK_DIRECT_MAX": "0"}
# Goldens the JAX package's stencil device path departs from, and the
# port's with it (ROADMAP section 3): sgVerify5 and 8 (4 of 21 voltage
# maps, the in_comp mask), sgVerify10 and 11 (a focal region's
# first-listed cell is NODATA: the pair stays at -1), oneToAllVerify7 (a
# focal point inside a short-circuit polygon stops at the residual
# gate).  On the device route these are held to the port's CPU run.
DEVICE_DEPARTURES = frozenset({"sgVerify5", "sgVerify8", "sgVerify10",
                               "sgVerify11", "oneToAllVerify7"})


def corpus():
    """Every INI of the golden corpus (tests/data/input) as a case of
    CASES' form: cg+amg (the card's tiers), the INI's precision
    (double throughout), the golden resistances where the corpus has
    them (pairwise, one-to-all, all-to-one); advanced jobs are held to
    their written files."""
    cases = []
    root = os.path.join(DATA_DIR, "input")
    for path in sorted(glob.glob(os.path.join(root, "**", "*.ini"),
                                 recursive=True)):
        ini = os.path.relpath(path, DATA_DIR)
        stem = os.path.splitext(os.path.basename(ini))[0]
        gold = f"{stem}_resistances.out"
        if not os.path.exists(os.path.join(VERIFY, gold)):
            gold = None
        cases.append((os.path.relpath(path, root)[:-4], ini, gold,
                      "cg+amg", "double"))
    return cases


def readdlm(path):
    return np.loadtxt(path, ndmin=2)


def read_aagrid(path):
    return np.loadtxt(path, skiprows=6, ndmin=2)


def check_resistances(x, r, tol, label=""):
    """Elementwise |diff| <= sqrt(tol) (test/test_utils.jl:140-160)."""
    x = np.asarray(x, np.float64)
    r = np.asarray(r, np.float64)
    assert x.shape == r.shape, f"{label}: shape {x.shape} vs {r.shape}"
    bad = np.abs(x - r) > np.sqrt(tol)
    if bad.any():
        idx = np.argwhere(bad)[:10]
        msgs = [f"[{i},{j}] expected={x[i, j]} got={r[i, j]}"
                for i, j in idx]
        raise AssertionError(f"{label}: {bad.sum()} mismatches: " +
                             "; ".join(msgs))
    return True


def check_grid(mine, gold, tol, label=""):
    """Sum of squared differences under tol (test/test_utils.jl:176)."""
    d2 = float(((mine - gold) ** 2).sum())
    assert d2 < tol, f"{label}: grid sum-sq diff {d2}"


def _shift_network_name(fname: str) -> str:
    """Golden network files use 0-based ids in their names
    (test/test_utils.jl:218-225)."""
    parts = fname.replace(".", "_").split("_")
    out = fname
    for p in parts:
        if p.isdigit():
            out = out.replace(f"_{p}", f"_{int(p) - 1}", 1)
    return out


def check_network_file(mine, gold, tol, label="", shift=1):
    """Node (shift 1) or branch (shift 2) current text against its
    golden: the goldens' 0-based ids in the first `shift` columns moved
    up by one, both sorted by rows, sum of squared differences under
    tol."""
    gold = np.array(gold, np.float64)
    gold[:, :shift] += 1
    a = mine[np.lexsort(mine.T[::-1])]
    b = gold[np.lexsort(gold.T[::-1])]
    assert a.shape == b.shape, f"{label}: {a.shape} vs {b.shape}"
    d2 = float(((a - b) ** 2).sum())
    assert d2 < tol, f"{label}: sum-sq diff {d2}"


def compare_outputs(outdir, stem, is_single=False, verify_dir=VERIFY,
                    golden=True):
    """golden_utils.compare_all_output on outdir against verify_dir:
    grids by sum of squares, network node/branch text by sorted rows
    (against the goldens, their 0-based ids and file names shifted;
    with golden=False, against another run's outputs in verify_dir, as
    they are).  Returns the number of files compared."""
    tol = 1e-4 if is_single else 1e-6
    n = 0
    for path in sorted(glob.glob(os.path.join(str(outdir), f"{stem}_*"))):
        f = os.path.basename(path)
        if "resistances" in f:
            continue
        if f.endswith("asc"):
            gold = os.path.join(verify_dir, f)
            assert os.path.exists(gold), f"no golden for generated {f}"
            check_grid(read_aagrid(path), read_aagrid(gold), tol, f)
            n += 1
        elif "Network" in f and f.endswith(".txt"):
            name = f if f.startswith("mg") or not golden else \
                _shift_network_name(f)
            check_network_file(
                readdlm(path), readdlm(os.path.join(verify_dir, name)), tol,
                f, shift=(2 if "branch" in f else 1) if golden else 0)
            n += 1
    return n


def has_goldens(stem):
    """Whether the corpus has golden files for the INI `stem`."""
    return bool(glob.glob(os.path.join(VERIFY, f"{stem}_*")))


def verify(stem, r, outdir, gold, precision, label=""):
    """tpu_golden.py's check of one case: the returned resistances
    against the golden file `gold` (network pairwise without its id row
    and column), then every written file.  A case with no golden
    resistances must have written a file to compare."""
    tol = 1e-4 if precision == "single" else 1e-6
    if gold is not None:
        x = readdlm(os.path.join(VERIFY, gold))
        if stem.startswith("sgNetwork"):
            check_resistances(x[1:, 1:], r[1:, 1:], tol, label)
        else:
            check_resistances(x, r, tol, label)
    n = compare_outputs(outdir, stem, precision == "single")
    assert gold is not None or n > 0, f"{label}: no output compared"
    return n


def route_env(route, ini):
    """The environment of `route` for the corpus INI `ini`."""
    if route == "default":
        return {}
    if route != "device":
        raise ValueError(f"unknown route {route!r}")
    return NETWORK_DEVICE_ENV if "/network/" in ini else RASTER_DEVICE_ENV


def run_case(ini, solver, precision, device, route, outdir):
    """One corpus INI through circuitscape_tpu_torch.compute on `device`
    and `route`, solver and precision overridden, outputs in outdir.
    Returns (stem, result, stats.finalize())."""
    import circuitscape_tpu_torch as cst
    from chip_smoke import env_set
    from circuitscape_tpu_torch import stats

    stem = os.path.splitext(os.path.basename(ini))[0]
    # the corpus INIs name their inputs relative to tests/data
    with contextlib.chdir(DATA_DIR), env_set(**route_env(route, ini)):
        cfg = cst.parse_config(ini).to_dict()
        cfg.update(solver=solver, precision=precision,
                   parallelize="false", suppress_messages="True",
                   output_file=os.path.join(outdir, f"{stem}.out"))
        if cfg["log_file"] != "None":
            # mgVerify7 logs to output/, which may be missing or wiped
            cfg["log_file"] = os.path.join(
                outdir, os.path.basename(cfg["log_file"]))
        r = cst.compute(cfg, device=device)
    return stem, r, stats.finalize()


def solved_on(st):
    """Where a job's solves ran, from its stats.finalize(): the stencil
    path's device solves count themselves (stencil_solves), the host
    Cholesky its factor time, the general tier neither.  (A one-to-all
    job with included pairs or merged points sets up the stencil path
    and then, as the JAX package does, solves on the general tier.)"""
    if "stencil_solves" in st:
        return "stencil path"
    return "host Cholesky" if "factor_s" in st else "general tier"


def run_subset(note=print, device="cuda", route="default", cases=CASES):
    """Replay `cases` on `device` and `route`.  Returns (passed, total,
    failures), failures a list of (label, message)."""
    import torch

    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")
    note(f"torch_golden: {len(cases)} cases on {device} ({name}), "
         f"route {route}")
    passed, failures = 0, []
    root = tempfile.mkdtemp(prefix="torch_golden_")
    try:
        for k, (label, ini, gold, solver, precision) in enumerate(cases):
            outdir = os.path.join(root, str(k))
            os.makedirs(outdir)
            tag = f"{label} [{solver}/{precision}]"
            try:
                stem, r, st = run_case(ini, solver, precision, device,
                                       route, outdir)
                n = verify(stem, r, outdir, gold, precision, label)
                passed += 1
                note(f"  PASS {tag} on the {solved_on(st)}: {n} files, "
                     f"cg_iters {st.get('cg_iters')}, passes "
                     f"{st.get('pass_iters')}")
            except Exception as e:
                failures.append((label, f"{type(e).__name__}: {e}"))
                note(f"  FAIL {tag}: {type(e).__name__}: {e}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return passed, len(cases), failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_golden: no CUDA device available (--device cpu runs "
              "the replay on the CPU)", file=sys.stderr)
        return 2

    def note(m):
        print(m, file=sys.stderr, flush=True)

    verdicts = []
    try:
        for route in ROUTES:
            passed, total, _ = run_subset(note, args.device, route)
            verdicts.append((route, passed, total))
    except Exception:
        traceback.print_exc()
        return 2
    first, *rest = verdicts
    print(f"torch_golden: {first[1]}/{first[2]} passed ({first[0]}), " +
          ", ".join(f"{p}/{t} ({r})" for r, p, t in rest))
    return 0 if all(p == t for _, p, t in verdicts) else 1


if __name__ == "__main__":
    sys.exit(main())
