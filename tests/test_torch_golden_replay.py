"""torch_golden.py and bench_torch.py, the port's golden replay and
bench script, on the CPU: torch_golden's comparison helpers give the
verdicts of tests/golden_utils.py's on passing and failing inputs, its
twelve cases pass on both routes on the CPU (and leave the environment
as they found it), chip_smoke.make_job writes bench.make_inputs's
arrays, bench_torch.py --device cpu prints its one line with every
field, and both scripts exit 2 without a card when no device is
asked for."""

import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import golden_utils
import torch_golden as tg
from chip_smoke import make_job
from child_env import one_thread

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("metric", "value", "unit", "vs_baseline", "runs_s", "spread_s",
          "cg_iters", "mg_kernels", "device", "card", "cpu_golden")


def _verdict(fn, *a, **k):
    try:
        fn(*a, **k)
    except AssertionError:
        return "fail"
    return "pass"


@pytest.mark.parametrize("tol,offset,expected", [
    (1e-6, 0.0, "pass"), (1e-6, 9e-4, "pass"), (1e-6, 2e-3, "fail"),
    (1e-4, 9e-3, "pass"), (1e-4, 2e-2, "fail")])
def test_check_resistances_as_golden_utils(tol, offset, expected):
    """Resistances within, and off by more than, sqrt(tol) at one
    entry."""
    x = np.random.default_rng(0).uniform(1, 5, (5, 5))
    r = x.copy()
    r[2, 3] += offset
    assert (_verdict(tg.check_resistances, x, r, tol) ==
            _verdict(golden_utils.check_resistances, x, r, tol) == expected)


def _tree(tmp_path):
    """A data directory of golden_utils' layout (output/, output_verify/)
    under tmp_path."""
    for sub in ("output", "output_verify"):
        (tmp_path / sub).mkdir()
    return tmp_path


def _both(monkeypatch, data, stem, is_single):
    """The verdicts of golden_utils.compare_all_output (its DATA_DIR
    pointed at data) and torch_golden.compare_outputs on the same
    files."""
    monkeypatch.setattr(golden_utils, "DATA_DIR", str(data))
    return (_verdict(golden_utils.compare_all_output, stem, is_single),
            _verdict(tg.compare_outputs, str(data / "output"), stem,
                     is_single, str(data / "output_verify")))


@pytest.mark.parametrize("is_single", [False, True])
@pytest.mark.parametrize("share,expected", [(0.0, "pass"), (0.5, "pass"),
                                            (2.0, "fail")])
def test_grid_check_as_golden_utils(tmp_path, monkeypatch, is_single,
                                    share, expected):
    """A written grid whose sum of squared differences from its golden
    is a share of the precision's tolerance."""
    data = _tree(tmp_path)
    name = "sgVerify4_cum_curmap.asc"
    shutil.copy(os.path.join(tg.VERIFY, name), data / "output_verify")
    with open(os.path.join(tg.VERIFY, name)) as f:
        head = [next(f) for _ in range(6)]
    g = tg.read_aagrid(os.path.join(tg.VERIFY, name))
    tol = 1e-4 if is_single else 1e-6
    g[0, 0] += np.sqrt(share * tol)
    with open(data / "output" / name, "w") as f:
        f.writelines(head)
        np.savetxt(f, g, fmt="%.17g")
    assert _both(monkeypatch, data, "sgVerify4", is_single) == \
        (expected, expected)


@pytest.mark.parametrize("kind", ["node", "branch"])
@pytest.mark.parametrize("ids_shifted,expected", [(True, "pass"),
                                                  (False, "fail")])
def test_network_check_as_golden_utils(tmp_path, monkeypatch, kind,
                                       ids_shifted, expected):
    """A network current file under its 1-based name, holding the
    golden's rows with the ids moved up by one (as the port writes them)
    or left 0-based."""
    data = _tree(tmp_path)
    gold = sorted(glob.glob(os.path.join(
        tg.VERIFY, f"sgNetworkVerify1_{kind}_currents_0_*.txt")))[0]
    shutil.copy(gold, data / "output_verify")
    mine = tg.readdlm(gold)
    if ids_shifted:
        mine[:, :2 if kind == "branch" else 1] += 1
    pair = os.path.basename(gold)[:-4].split("_")[-2:]
    name = (f"sgNetworkVerify1_{kind}_currents_"
            f"{int(pair[0]) + 1}_{int(pair[1]) + 1}.txt")
    assert tg._shift_network_name(name) == os.path.basename(gold) == \
        golden_utils._shift_network_name(name)
    np.savetxt(data / "output" / name, mine[::-1], fmt="%.17g")
    assert _both(monkeypatch, data, "sgNetworkVerify1", False) == \
        (expected, expected)


@pytest.mark.parametrize("case", tg.CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("route", tg.ROUTES)
def test_run_subset_on_cpu(route, case):
    """Each of tpu_golden.py's twelve cases through run_subset on the CPU
    passes on both routes, and the route's environment does not outlive
    the case."""
    env = dict(os.environ)
    passed, total, failures = tg.run_subset(lambda m: None, "cpu", route,
                                            [case])
    assert (passed, total, failures) == (1, 1, [])
    assert dict(os.environ) == env


def test_routes_differ(tmp_path):
    """The device route sends the raster cases to the stencil path and
    the network cases to the iterative tier; cholmod stays on the
    host."""
    label, ini, gold, solver, precision = tg.CASES[2]
    seen = {}
    for route in tg.ROUTES:
        out = tmp_path / route
        out.mkdir()
        _, _, st = tg.run_case(ini, solver, precision, "cpu", route,
                               str(out))
        seen[route] = tg.solved_on(st)
    assert seen == {"default": "general tier", "device": "stencil path"}
    assert tg.route_env("device", tg.CASES[0][1]) == tg.NETWORK_DEVICE_ENV
    assert tg.route_env("default", ini) == {}


def test_run_case_writes_only_to_outdir(tmp_path):
    """mgVerify7's INI names a log file under output/ (relative to
    tests/data, which a checkout does not hold and the JAX golden tests
    wipe): run_case moves it into the case's directory with the
    outputs."""
    case = [c for c in tg.corpus() if c[0].endswith("mgVerify7")][0]
    _, v, _ = tg.run_case(case[1], case[3], case[4], "cpu", "default",
                          str(tmp_path))
    assert np.all(np.isfinite(v))
    assert (tmp_path / "mgVerify7.log").exists()
    assert tg.verify("mgVerify7", v, str(tmp_path), None, "double") > 0


def test_make_job_is_bench_inputs(tmp_path):
    """chip_smoke.make_job (which bench_torch.py runs) writes the arrays
    of bench.make_inputs, with bench.py's job flags."""
    import bench
    import circuitscape_tpu_torch as cst
    (tmp_path / "b").mkdir()
    (tmp_path / "c").mkdir()
    ini, g = bench.make_inputs(str(tmp_path / "b"))
    cfg, gmap = make_job(str(tmp_path / "c"), bench.H, bench.W,
                         bench.NPOINTS)
    for f in ("cellmap.npy", "points.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "b" / f),
                                      np.load(tmp_path / "c" / f))
    np.testing.assert_array_equal(gmap, np.where(g > 0, g, 0.0))
    a = cst.parse_config(ini).to_dict()
    for k in ("data_type", "scenario", "habitat_map_is_resistances",
              "solver", "connect_four_neighbors_only",
              "connect_using_avg_resistances"):
        assert str(a[k]).lower() == str(cfg[k]).lower(), k
    assert cfg["precision"] == "single"


def test_bench_torch_line_on_cpu():
    """bench_torch.py --device cpu at 200 x 200 and 4 points: exit 0 and
    one JSON line on stdout with every field, the replay 12/12."""
    env = one_thread(CS_BENCH_SIZE="200", CS_BENCH_POINTS="4")
    out = subprocess.run([sys.executable, "bench_torch.py", "--device",
                          "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    line = json.loads(lines[0])
    assert set(FIELDS) <= set(line), set(FIELDS) - set(line)
    assert line["metric"] == "pairwise_1Mcell_32pt_wall_clock"
    assert line["device"] == "cpu" and line["card"] is None
    assert line["cpu_golden"] == "12/12"
    assert len(line["runs_s"]) == 2 and line["value"] == min(line["runs_s"])
    assert line["vs_baseline"] == pytest.approx(89.6 / line["value"])
    assert line["spread_s"] == pytest.approx(max(line["runs_s"]) -
                                             line["value"])
    assert isinstance(line["cg_iters"], int) and line["cg_iters"] > 0


@pytest.mark.parametrize("script", ["torch_golden.py", "bench_torch.py",
                                    "bench_suite_torch.py"])
def test_scripts_need_a_card(script):
    """Without a CUDA device and without --device cpu: exit 2, nothing on
    stdout, no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, script], cwd=ROOT,
                         env=one_thread(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
