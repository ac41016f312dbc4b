"""bench_capacity_torch.py, the port's counterpart of bench_capacity.py, on
the CPU: its recipe writes bench_capacity.py's inputs byte for byte; the
job agrees between the JAX package's eight-device mesh and the port's
eight virtual CPU shards, both on the streamed build; the float64
residual check computed a shard at a time equals the whole-plane one;
the script writes bench_capacity.py's record keys, exits 1 when a run
fails and 2 without a card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import bench_capacity_torch as bct
import chip_smoke
from child_env import one_thread
import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from circuitscape_tpu import stats as jstats
from circuitscape_tpu_torch import stats
from circuitscape_tpu_torch.parallel import mesh as tm
from circuitscape_tpu_torch.solve import prepare as tpr
from circuitscape_tpu_torch.solve import stencil as tst

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 256          # 65536 cells: the stencil path, and the mesh on the CPU
STREAM_MIN = "1000"  # CS_STREAM_BUILD_MIN under the job: the streamed build
CPU8 = [torch.device("cpu")] * 8
F32_TOL = 1e-5


def _import_bench_capacity():
    """bench_capacity, imported with the environment it sets on import
    (CS_FORCE_MESH, JAX_PLATFORMS, XLA_FLAGS) put back: later test files
    on the same worker must not inherit the forced mesh."""
    saved = dict(os.environ)
    try:
        import bench_capacity
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return bench_capacity


def _inputs(cfg):
    return [(os.path.basename(cfg[k]), open(cfg[k], "rb").read())
            for k in ("habitat_file", "point_file")]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """bench_capacity.main at SIDE on conftest's eight CPU devices with
    the streamed build: the inputs its job read, its job dict, result
    and stats, and the record it appended to BENCH_CAPACITY.json (in a
    temporary directory)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    bench_capacity = _import_bench_capacity()
    d = tmp_path_factory.mktemp("jax")
    got = {}
    real = cs.compute

    def compute(cfg):
        got["inputs"] = _inputs(cfg)
        got["cfg"] = dict(cfg)
        got["result"] = np.asarray(real(cfg))
        got["stats"] = jstats.finalize()
        return got["result"]

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        mp.setattr(sys, "argv", ["bench_capacity.py", str(SIDE)])
        mp.setattr(cs, "compute", compute)
        for k in bct.ROUTING:
            mp.delenv(k, raising=False)
        mp.setenv("CS_FORCE_MESH", "1")
        mp.setenv("CS_STREAM_BUILD_MIN", STREAM_MIN)
        bench_capacity.main()
    with open(d / "BENCH_CAPACITY.json") as f:
        got["record"] = json.load(f)[-1]
    return got


@pytest.fixture()
def vshards(monkeypatch):
    """The port's mesh on eight virtual CPU shards, forced on, with the
    default (2, 4) shape."""
    monkeypatch.setattr(tm, "visible_devices", lambda: list(CPU8))
    for k in bct.ROUTING:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CS_FORCE_MESH", "1")
    return monkeypatch


def test_recipe_writes_bench_capacitys_inputs(jax_run, tmp_path):
    """capacity_job writes the files bench_capacity.py's job read, with
    the same bytes, and the same job dict up to the directory."""
    cfg = bct.capacity_job(str(tmp_path), SIDE)
    got = _inputs(cfg)
    assert [f for f, _ in got] == [f for f, _ in jax_run["inputs"]]
    for (f, a), (_, b) in zip(got, jax_run["inputs"]):
        assert a == b, f"{f} differs"
    jd = os.path.dirname(jax_run["cfg"]["habitat_file"])
    assert {k: v.replace(jd, "D") for k, v in jax_run["cfg"].items()} == \
        {k: v.replace(str(tmp_path), "D") for k, v in cfg.items()}


def test_job_matches_jax_mesh(jax_run, vshards, tmp_path):
    """The same job on the port's eight virtual CPU shards and on the
    JAX package's eight-device mesh, both on the streamed build:
    resistances within 1e-5 relative; CG iterations within one a pass
    (the JAX package's refinement passes run inside one jitted loop, so
    only its total is seen)."""
    vshards.setenv("CS_STREAM_BUILD_MIN", STREAM_MIN)
    cfg = bct.capacity_job(str(tmp_path), SIDE)
    r = np.asarray(cst.compute(cfg, device="cpu"), np.float64)
    sd = stats.finalize()
    assert sd["mg_build"] == "host streamed"
    assert all(k == "torch/shard" for k in sd["mg_kernels"])
    rj = jax_run["result"].astype(np.float64)
    rel = chip_smoke._rel(r, rj)
    assert rel <= F32_TOL, rel
    passes = sd["pass_iters"]
    assert abs(sd["cg_iters"] - int(jax_run["stats"]["cg_iters"])) <= \
        len(passes), (passes, jax_run["stats"]["cg_iters"])


@pytest.mark.parametrize("shape", ["2,4", "8,1"])
def test_shard_residuals_equal_whole_plane(vshards, shape):
    """residuals64 a row shard at a time on a ShardStencil (X full, or a
    MeshBlock laid out as the operator) equals the whole-plane float64
    residual of the joined operator, and that the pair solve's own."""
    vshards.setenv("CS_MESH_SHAPE", shape)
    rng = np.random.default_rng(3)
    g = rng.uniform(0.5, 3.0, (SIDE, SIDE))
    g[rng.random(g.shape) < 0.1] = 0.0
    S, prec, ap, _ = tpr.prepare_stencil_solver_streamed(
        g, False, False, tm.make_mesh(8))
    on = np.argwhere(g > 0)
    src = on[rng.integers(0, len(on), 3)]
    dst = on[rng.integers(0, len(on), 3)]
    X, rel, _ = tst.stencil_solve_pairs(S, src, dst, prec=prec,
                                        prec_apply=ap)
    full = S.full()
    H, W = S.shape
    B64 = tst._pairs_rhs(torch.as_tensor(src), torch.as_tensor(dst), H, W, 3)
    R = B64 - tst.stencil_matvec(full, X[:3])
    ref = (torch.sqrt((R * R).sum(dim=(1, 2))) /
           torch.sqrt((B64 * B64).sum(dim=(1, 2)))).numpy()
    np.testing.assert_allclose(chip_smoke.residuals64(full, src, dst, X),
                               ref, rtol=1e-12)
    np.testing.assert_allclose(chip_smoke.residuals64(S, src, dst, X), ref,
                               rtol=1e-10)
    np.testing.assert_allclose(
        chip_smoke.residuals64(S, src, dst, S.layout(X)), ref, rtol=1e-10)
    np.testing.assert_allclose(ref, rel, rtol=1e-8)
    assert np.all(ref <= 1e-6)


def test_rows_are_bench_capacitys_sizes():
    """Rows a and c are BENCH_CAPACITY.json's first and third rows, row
    b its second (one card's limit); b and c run on four cards."""
    with open(os.path.join(ROOT, "BENCH_CAPACITY.json")) as f:
        recs = json.load(f)
    assert [bct.ROWS[k][0] ** 2 for k in "abc"] == \
        [r["cells"] for r in recs[:3]]
    assert [r.mesh for r in bct.ROWS["c"][1]] == [(2, 2), (4, 1)]
    assert {r.build for k in "bc" for r in bct.ROWS[k][1] if r.mesh} == \
        {"host streamed"}


def test_cpu_run_writes_bench_capacitys_keys(jax_run, monkeypatch,
                                             tmp_path):
    """--device cpu --side N: one record with bench_capacity.py's keys,
    its job's size and mesh, every check passed, exit 0."""
    for k in bct.ROUTING:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(bct, "INPUTS", str(tmp_path / "inputs"))
    out = tmp_path / "cap.json"
    rc = bct.main(["--device", "cpu", "--side", str(SIDE), "--out",
                   str(out)])
    assert rc == 0
    recs = json.load(open(out))
    assert len(recs) == 1
    rec, want = recs[0], jax_run["record"]
    assert set(want) <= set(rec)
    for k in ("cells", "grid", "points", "mesh", "all_finite",
              "pairs_solved"):
        assert rec[k] == want[k], k
    assert "error" not in rec and rec["mg_build"] == "host"
    assert len(rec["residuals"]) == 3 and max(rec["residuals"]) <= 1e-6
    assert rec["device"] == "cpu" and rec["fixed_bytes_per_shard_gb"] is None
    assert os.environ.get("CS_FORCE_MESH") is None
    assert tm.visible_devices() == []


@pytest.mark.parametrize("how", ["raises", "wrong answer"])
def test_failed_run_exits_1(monkeypatch, tmp_path, how):
    """A run whose compute raises, or whose result fails the checks, is
    recorded with its error and the script exits 1."""
    def compute(cfg, device=None):
        if how == "raises":
            raise RuntimeError("out of memory")
        return np.full((5, 5), np.nan)
    monkeypatch.setattr(cst, "compute", compute)
    monkeypatch.setattr(bct, "INPUTS", str(tmp_path / "inputs"))
    out = tmp_path / "cap.json"
    rc = bct.main(["--device", "cpu", "--side", "64", "--out", str(out)])
    assert rc == 1
    (rec,) = json.load(open(out))
    assert "error" in rec
    if how == "raises":
        assert rec["scenario"] == "FAILED" and "out of memory" in rec["error"]
    else:
        assert "not finite" in rec["error"] and "residuals" in rec["error"]
    assert os.listdir(tmp_path / "inputs") == []    # the row's inputs went


def test_no_card_exits_2(tmp_path):
    """Without a CUDA device the script prints no record and exits 2;
    --device cpu needs --side."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "bench_capacity_torch.py", "--out",
                          str(tmp_path / "x.json")], cwd=ROOT,
                         env=one_thread(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert not (tmp_path / "x.json").exists()
    with pytest.raises(SystemExit) as e:
        bct.main(["--device", "cpu"])
    assert e.value.code == 2
