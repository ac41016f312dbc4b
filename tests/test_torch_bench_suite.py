"""bench_suite_torch.py, the port's counterpart of bench_suite.py, on the
CPU: its recipes write bench_suite.py's inputs byte for byte in
bench_suite.py's order; each recipe's job agrees between the JAX package
and the port (the raster rows on the stencil device path, as at the
suite's sizes); the SpMV record counts the JAX operator's nonzeros; the
stages count each timer second once and name only sections the port
has; the script runs a small suite on the CPU with bench_suite.py's
record keys and exits 1 when a row fails."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench_suite
import bench_suite_torch as bst
import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from child_env import one_thread
from circuitscape_tpu.solve.stencil import stencil_from_gmap

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "circuitscape_tpu_torch")
INPUT_KEYS = ("habitat_file", "point_file", "source_file", "ground_file")
# thresholds that send a small raster job to the stencil device path
DEVICE_PATH = ("CS_PAIRWISE_DEVICE_MIN", "CS_ADVANCED_DEVICE_MIN",
               "CS_ONETOALL_DEVICE_MIN")
# bench_suite.bench_spmv_record's fields
SPMV_KEYS = {"scenario", "kernel", "cells", "batch", "nnz", "s_per_matvec",
             "spmv_nnz_per_s"}


def _inputs(cfg):
    """(file name, bytes) of every input file of a job."""
    return [(os.path.basename(cfg[k]), open(cfg[k], "rb").read())
            for k in INPUT_KEYS if k in cfg]


def _warmup_job(code):
    """The job dict of a provisioned row's warmup child."""
    m = re.search(r"warmup\((\{.*\}), points=32", code, re.S)
    return ast.literal_eval(m.group(1)) if m else None


def _suite_env(monkeypatch, tmp_path, sizes, scenarios):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CS_SUITE_SIZES", sizes)
    monkeypatch.setenv("CS_SUITE_SCENARIOS", scenarios)
    monkeypatch.delenv("CS_SUITE_APPEND", raising=False)


def _jax_suite(monkeypatch, tmp_path, sizes, scenarios):
    """bench_suite.main with its runs stubbed: the inputs each job read,
    in order, and the records it wrote."""
    jobs = []

    def run_cold_warm(name, cfg):
        jobs.append((name, _inputs(cfg)))
        return 1.0, 2.0, [{}, {}]

    class Done:
        returncode, stdout, stderr = 0, "1.5\n", ""

    def run(args, **kw):
        job = _warmup_job(args[-1])
        if job is not None:
            jobs.append(("provisioned", _inputs(job)))
        return Done

    _suite_env(monkeypatch, tmp_path, sizes, scenarios)
    monkeypatch.setattr(bench_suite, "run_cold_warm", run_cold_warm)
    monkeypatch.setattr(bench_suite, "bench_spmv_record",
                        lambda: {"scenario": "spmv-kernel"})
    monkeypatch.setattr(subprocess, "run", run)
    bench_suite.main()
    monkeypatch.undo()
    with open(tmp_path / "BENCH_SUITE.json") as f:
        return jobs, json.load(f)


def _port_suite(monkeypatch, tmp_path, sizes, scenarios):
    """bench_suite_torch.main on the CPU with its runs stubbed: the inputs
    each job read, in order, the records and the exit code."""
    jobs = []

    def run_cold_warm(name, cfg, device, check):
        jobs.append((name, _inputs(cfg)))
        return 1.0, 2.0, [{}, {}]

    def child(code):
        job = _warmup_job(code)
        if job is not None:
            jobs.append(("provisioned", _inputs(job)))
        # the job child sends its seconds and timer sections back
        return 1.0, "[1.5, []]" if "CSTIMER" in code else "1.5"

    _suite_env(monkeypatch, tmp_path, sizes, scenarios)
    monkeypatch.setattr(bst, "run_cold_warm", run_cold_warm)
    monkeypatch.setattr(bst, "_child", child)
    monkeypatch.setattr(bst, "prebuild", lambda device: None)
    monkeypatch.setattr(bst, "spmv_record",
                        lambda device: {"scenario": "spmv-kernel"})
    out = tmp_path / "port.json"
    rc = bst.main(["--device", "cpu", "--out", str(out)])
    monkeypatch.undo()
    with open(out) as f:
        return jobs, json.load(f), rc


def test_recipes_write_bench_suites_inputs(monkeypatch, tmp_path):
    """Every scenario at two small sizes, with the 1000^2 cholmod raster
    and the 100,000-node network as bench_suite.py fixes them: the port's
    jobs read, in the same order, the same files with the same bytes as
    bench_suite.py's, and its records carry bench_suite.py's keys and the
    device and card."""
    scenarios = ",".join(bst.SCENARIOS)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want, jrecs = _jax_suite(monkeypatch, tmp_path / "jax", "40,48",
                             scenarios)
    got, precs, rc = _port_suite(monkeypatch, tmp_path / "port", "40,48",
                                 scenarios)
    assert rc == 0
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(want) == 2 + 5 + 1 + 2
    for (name, a), (_, b) in zip(got, want):
        assert [f for f, _ in a] == [f for f, _ in b], name
        for (f, x), (_, y) in zip(a, b):
            assert x == y, f"{name}: {f} differs"
    assert [r["scenario"] for r in precs] == [r["scenario"] for r in jrecs]
    for p, j in zip(precs, jrecs):
        assert set(j) <= set(p), (j["scenario"], set(j) - set(p))
        assert p["device"] == "cpu" and p["card"] is None


# (recipe, builder arguments at the test's size)
RECIPES = [
    ("shortcut", {"points": 8}),
    ("maps", {"points": 8}),
    ("cholmod", {"points": 8}),
    ("onetoall", {"points": 8}),
    ("advanced", {"sources": 8, "grounds": 8}),
    ("network", {"n": 400, "focal": 6}),
]


@pytest.mark.parametrize("recipe,kw", RECIPES, ids=[r for r, _ in RECIPES])
def test_recipe_matches_jax(recipe, kw, tmp_path, monkeypatch):
    """Each recipe at 64^2 (networks at 400 nodes) with few points through
    circuitscape_tpu.compute and circuitscape_tpu_torch.compute on the
    CPU: results, and the voltage maps of the maps recipe, within rtol
    1e-5 in single precision and 1e-8 in double (cholmod against
    cholmod).  The raster jobs take the stencil device path, as the
    suite's do at its sizes."""
    for k in DEVICE_PATH:
        monkeypatch.setenv(k, "1")
    rng = np.random.default_rng(42)
    build = getattr(bst, f"{recipe}_job")
    d = str(tmp_path)
    cfg = build(d, rng, **kw) if recipe == "network" else \
        build(d, rng, 64, **kw)
    rtol = 1e-8 if cfg["precision"] == "double" else 1e-5
    out = {}
    for name, run in (("jax", lambda c: cs.compute(c)),
                      ("port", lambda c: cst.compute(c, device="cpu"))):
        os.makedirs(os.path.join(d, name))
        out[name] = np.asarray(run(dict(
            cfg, output_file=os.path.join(d, name, "o.out"))))
    a, b = out["port"], out["jax"]
    assert a.shape == b.shape and np.all(np.isfinite(b))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0)
    if recipe == "maps":
        names = sorted(f for f in os.listdir(os.path.join(d, "jax"))
                       if "_voltmap_" in f)
        assert len(names) == 6
        for f in names:
            x = np.loadtxt(os.path.join(d, "port", f), skiprows=6)
            y = np.loadtxt(os.path.join(d, "jax", f), skiprows=6)
            assert np.max(np.abs(x - y)) <= rtol * np.max(np.abs(y)), f


def test_spmv_record_counts_jax_nnz():
    """The SpMV record's nnz is the JAX operator's S.nnz on the same map
    (default_rng(0), ~10% zeros); it carries bench_suite.py's fields and
    no device rate on the CPU."""
    rec = bst.spmv_record("cpu", side=48, batch=2, k=2, reps=1)
    rng = np.random.default_rng(0)
    g = rng.uniform(0.5, 3.0, (48, 48))
    g[rng.random((48, 48)) < 0.10] = 0.0
    assert rec["nnz"] == stencil_from_gmap(g, False, False,
                                           jnp.float32).nnz
    assert SPMV_KEYS <= set(rec)
    assert rec["cells"] == 48 * 48 and rec["batch"] == 2
    assert "byte_bound_s" not in rec


def _port_sections():
    names = set()
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    names |= set(re.findall(r'CSTIMER\("([^"]+)"\)',
                                            fh.read()))
    return names


@pytest.mark.parametrize("stage", sorted(bst.STAGE_SECTIONS))
def test_stage_sections_exist_in_the_port(stage):
    """Every section of a stage is a CSTIMER section of the port, so a
    renamed section cannot drop out of its stage silently."""
    missing = set(bst.STAGE_SECTIONS[stage]) - _port_sections()
    assert not missing


def test_stages_count_each_second_once():
    """A section inside another stage's section adds nothing; sections
    outside every stage (or nested under ones outside) do."""
    sections = {
        ("complete job",): [1, 10.0],
        ("complete job", "solve pairwise resistances"): [1, 7.0],
        ("complete job", "solve pairwise resistances",
         "solve and accumulate pairs"): [1, 5.0],
        ("complete job", "solve pairwise resistances",
         "solve and accumulate pairs", "postprocess"): [3, 2.0],
        ("complete job", "solve pairwise resistances",
         "construct preconditioner/factorization"): [1, 1.5],
        ("complete job", "write cumulative currents"): [1, 0.5],
        ("complete job", "prepare stencil solver (upload + MG setup)",
         "host hierarchy"): [1, 0.25],
    }
    assert bst.stage_seconds(sections) == {
        "solve_s": 5.0, "setup_s": 1.5, "output_s": 0.5}


def test_suite_runs_on_the_cpu(tmp_path):
    """The script with --device cpu, a small size on the stencil device
    path and three scenarios (shortcut, maps, advanced): exit 0, one
    JSON line per record with bench_suite.py's keys and two runs' stats,
    the output file holding the same records."""
    out = tmp_path / "suite.json"
    env = one_thread(CS_SUITE_SIZES="40",
                     CS_SUITE_SCENARIOS="shortcut,maps,advanced",
                     **dict.fromkeys(DEVICE_PATH, "1"))
    env.pop("CS_SUITE_APPEND", None)
    p = subprocess.run([sys.executable, "bench_suite_torch.py", "--device",
                        "cpu", "--out", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    recs = [json.loads(x) for x in p.stdout.strip().splitlines()]
    with open(out) as f:
        assert json.load(f) == recs
    base = {"scenario", "cells", "cold_s", "warm_s", "cold_run", "warm_run",
            "note", "device", "card"}
    want = {"pairwise-shortcut": base | {"points"},
            "pairwise-maps+volt+max": base | {
                "points", "baseline_julia_cgamg_s", "vs_cgamg_warm"},
            "advanced+curmap": base | {"sources", "grounds"}}
    assert [r["scenario"] for r in recs] == list(want)
    for r in recs:
        assert want[r["scenario"]] <= set(r), r["scenario"]
        assert r["device"] == "cpu" and r["card"] is None
        for run in ("cold_run", "warm_run"):
            st = r[run]["stages"]
            assert st["total_s"] > 0 and st["other_s"] >= 0
            assert r[run]["cg_iters"] > 0


def test_failing_row_exits_1(tmp_path, monkeypatch):
    """A row whose answers fail its check is recorded with its error, the
    next row still runs, and the script exits 1."""
    real = cst.compute

    def nan_for_pairwise(cfg, device=None):
        r = real(cfg, device=device)
        if cfg.get("scenario") == "pairwise":
            r = np.array(r, dtype=float)
            r[1:, 1:] = np.nan
        return r

    monkeypatch.setattr(cst, "compute", nan_for_pairwise)
    monkeypatch.setattr(bst, "prebuild", lambda device: None)
    _suite_env(monkeypatch, tmp_path, "32", "shortcut,onetoall")
    rc = bst.main(["--device", "cpu", "--out", str(tmp_path / "s.json")])
    assert rc == 1
    with open(tmp_path / "s.json") as f:
        recs = json.load(f)
    assert [r["scenario"] for r in recs] == ["FAILED", "one-to-all"]
    assert recs[0]["row"] == "shortcut 32"
    assert "not finite" in recs[0]["error"]
