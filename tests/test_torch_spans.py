"""The port's span log (timer.CSTIMER) and its per-launch batch counter
(cuda_stencil.LAUNCHES_BHW), on the CPU: a compute() job's spans nest
under a root span that covers the call, each thread keeps its own
parents, the log starts anew with each job, the timer's table keeps the
paths it had, and every kernel wrapper counts its launch with the
block's batch."""

import ast
import inspect
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

import circuitscape_tpu_torch as cst
from chip_smoke import make_job
from child_env import one_thread
from circuitscape_tpu_torch import stats
from circuitscape_tpu_torch.solve import cuda_stencil
from circuitscape_tpu_torch.timer import MAX_SPANS, Timer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVE = ("complete job", "solve pairwise resistances")
# CSTIMER's paths of a stencil-path job, as they stood before the span log
PATHS = {
    "shortcut": {
        ("complete job",), ("complete job", "construct graph"),
        ("complete job", "load raster data"), SOLVE,
        SOLVE + ("batched pair solve",), SOLVE + ("invert nodemap",),
        SOLVE + ("prepare stencil solver (upload + MG setup)",)},
    "maps": {
        ("complete job",), ("complete job", "construct graph"),
        ("complete job", "load raster data"), SOLVE,
        SOLVE + ("batched pair solve",), SOLVE + ("fetch maps",),
        SOLVE + ("node currents + reduce",),
        SOLVE + ("prepare stencil solver (upload + MG setup)",),
        SOLVE + ("write maps",),
        ("complete job", "write cumulative current maps")},
}
PATHS["host-built"] = PATHS["shortcut"] | {
    SOLVE + ("prepare stencil solver (upload + MG setup)", name)
    for name in ("device operator", "host planes", "host hierarchy")}
MAPS = {"write_cur_maps": "True", "write_max_cur_maps": "True",
        "write_cum_cur_map_only": "True"}


def _job(tmp_path, monkeypatch, route="shortcut", npoints=5):
    """A 64 x 64 job on the stencil path: (config, ns before, ns after,
    stats.finalize())."""
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    if route == "host-built":
        monkeypatch.setenv("CS_DEVICE_MG_MAX", "1")
    cfg, _ = make_job(str(tmp_path), 64, 64, npoints=npoints)
    if route == "maps":
        cfg.update(MAPS)
    t0 = time.time_ns()
    cst.compute(cfg, device="cpu")
    t1 = time.time_ns()
    return cfg, t0, t1, stats.finalize()


@pytest.mark.parametrize("route", ["shortcut", "maps"])
def test_job_log_nests_under_its_root(tmp_path, monkeypatch, route):
    _, t0, t1, st = _job(tmp_path, monkeypatch, route)
    log = st["spans"]
    by_id = {s[0]: s for s in log}
    assert len(by_id) == len(log) and st["spans_dropped"] == 0
    roots = [s for s in log if s[1] is None]
    assert [r[2] for r in roots] == ["compute"]
    root = roots[0]
    assert t0 <= root[3] <= root[4] <= t1
    for sid, parent, name, a, b in log:
        assert a <= b
        if parent is not None:
            p = by_id[parent]           # every parent id resolves
            assert p[3] <= a and b <= p[4], (name, p[2])
    names = {s[2] for s in log}
    assert {"read config", "write config", "complete job",
            "batched pair solve", "refinement pass",
            "write resistances"} <= names
    if route == "shortcut":
        assert {"assemble anchor pairs", "fetch focal voltages",
                "fill resistances and voltmatrix",
                "update shortcut resistances"} <= names
    else:
        assert {"label components", "assemble pairs",
                "normalise columns"} <= names
    # a refinement pass per recorded pass, each inside a pair solve
    passes = [s for s in log if s[2] == "refinement pass"]
    assert len(passes) == len(st["pass_iters"])
    assert all(by_id[s[1]][2] == "batched pair solve" for s in passes)
    json.dumps(st)


@pytest.mark.parametrize("route", sorted(PATHS))
def test_table_paths_unchanged(tmp_path, monkeypatch, route):
    from circuitscape_tpu_torch.timer import CSTIMER
    _job(tmp_path, monkeypatch, route)
    assert set(CSTIMER._data) == PATHS[route]


def test_log_starts_anew_each_job(tmp_path, monkeypatch):
    _, t0, _, first = _job(tmp_path, monkeypatch)
    _, t1, _, second = _job(tmp_path, monkeypatch)
    assert [s[2] for s in first["spans"]] == [s[2] for s in second["spans"]]
    assert min(s[3] for s in second["spans"]) >= t1 > t0
    assert sum(s[1] is None for s in second["spans"]) == 1


def test_threads_keep_their_own_parents():
    t = Timer()
    gate = threading.Barrier(2, timeout=30)

    def work(tag):
        with t(f"outer {tag}"):
            gate.wait()
            with t.span(f"inner {tag}"):
                gate.wait()

    with t.job("root"):
        threads = [threading.Thread(target=work, args=(k,)) for k in "ab"]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
    by_name = {s[2]: s for s in t.spans()}
    for tag in "ab":
        assert by_name[f"inner {tag}"][1] == by_name[f"outer {tag}"][0]
        assert by_name[f"outer {tag}"][1] is None   # its thread's top
    assert by_name["root"][1] is None
    assert set(t._data) == {("outer a",), ("outer b",)}


def test_span_only_keeps_the_table():
    t = Timer()
    with t.job("root"):
        with t.span("helper"):
            with t("section"):
                pass
    assert set(t._data) == {("section",)}
    by_name = {s[2]: s for s in t.spans()}
    assert by_name["section"][1] == by_name["helper"][0]
    assert by_name["helper"][1] == by_name["root"][0]


def test_log_bounded():
    """Past MAX_SPANS the log drops the spans that start last: the root
    and the parent of every span kept stay, the rest are counted."""
    t = Timer()
    with t.job("root"):
        with t("setup"):
            for _ in range(MAX_SPANS - 3):
                with t.span("x"):
                    pass
        with t("solve"):            # the log's last slot
            for _ in range(10):
                with t.span("pass"):
                    pass
        with t("write"):
            pass
    log = t.spans()
    assert len(log) == MAX_SPANS and t.dropped == 11
    assert [s[0] for s in log] == list(range(MAX_SPANS))   # start order
    by_id = {s[0]: s for s in log}
    assert log[0][2] == "root" and log[0][1] is None
    assert log[-1][2] == "solve" and log[-1][1] == 0
    assert all(s[1] in by_id for s in log[1:])
    assert "pass" not in {s[2] for s in log}


def test_job_empties_a_full_log():
    t = Timer()
    with t.job("first"):
        for _ in range(MAX_SPANS + 1):
            with t.span("x"):
                pass
    assert t.dropped == 2
    with t.job("second"):
        with t("a"):
            pass
    assert t.dropped == 0
    assert [s[1:3] for s in t.spans()] == [[None, "second"], [0, "a"]]


def test_launch_counter_counts_each_batch():
    cuda_stencil.reset_launch_counts()
    cuda_stencil._launched("matvec", 32, 64, 64)
    cuda_stencil._launched("matvec", 32, 64, 64)
    cuda_stencil._launched("matvec", 12, 64, 64)
    cuda_stencil._launched("cheb_init", 16, 32, 32)
    assert cuda_stencil.LAUNCHES_AT == {("matvec", 64, 64): 3,
                                        ("cheb_init", 32, 32): 1}
    assert cuda_stencil.LAUNCHES_BHW == {("matvec", 32, 64, 64): 2,
                                         ("matvec", 12, 64, 64): 1,
                                         ("cheb_init", 16, 32, 32): 1}
    assert stats.finalize()["launches_bhw"] == [
        ["cheb_init", 16, 32, 32, 1], ["matvec", 12, 64, 64, 1],
        ["matvec", 32, 64, 64, 2]]
    cuda_stencil.reset_launch_counts()
    assert not cuda_stencil.LAUNCHES_AT and not cuda_stencil.LAUNCHES_BHW
    assert cuda_stencil.LAUNCHES["matvec"] == 0


def test_plain_calls_count_nothing(tmp_path, monkeypatch):
    cuda_stencil.reset_launch_counts()
    _, _, _, st = _job(tmp_path, monkeypatch)
    assert st["launches_bhw"] == [] and not cuda_stencil.LAUNCHES_AT


@pytest.mark.parametrize("name", sorted(cuda_stencil.LAUNCHES))
def test_each_wrapper_counts_its_block(name):
    """Each kernel wrapper counts its launch once, with (B, H, W) the
    leading three dimensions of the block it launched on."""
    tree = ast.parse(inspect.getsource(getattr(cuda_stencil, name)))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and
             getattr(n.func, "id", "") == "_launched"]
    assert len(calls) == 1
    first, *rest = calls[0].args
    assert ast.literal_eval(first) == name
    assert [ast.unparse(a) for a in rest] == ["B", "H", "W"]
    unpack = [n for n in ast.walk(tree) if isinstance(n, ast.Assign) and
              ast.unparse(n.targets[0]) == "(B, H, W)"]
    assert len(unpack) == 1
    assert ast.unparse(unpack[0].value).endswith(".shape")


def _spans():
    from benchmark.spans import Span
    return [Span(0, None, "compute", 0.0, 100.0),
            Span(1, 0, "complete job", 10.0, 90.0),
            Span(2, 1, "batched pair solve", 20.0, 60.0),
            Span(3, 2, "refinement pass", 30.0, 50.0)]


def test_span_report_idle_by_innermost_span():
    import span_report
    from benchmark.spans import Busy
    busy = Busy([("k", 35.0, 45.0), ("k", 55.0, 70.0)])
    got = span_report.idle_by_span(_spans(), busy)
    assert got == pytest.approx({
        "compute": 20.0, "complete job": 30.0,
        "batched pair solve": 15.0, "refinement pass": 10.0})


def test_span_report_kernels_inside_and_self_seconds():
    import span_report
    device = [("void (anonymous namespace)::matvec_kernel<4>(...)", 25.0,
               35.0),
              ("void (anonymous namespace)::cheb_init_kernel(...)", 70.0,
               75.0),
              ("at::native::vectorized_elementwise_kernel<...>", 40.0,
               45.0)]
    assert span_report.kernel_us_inside(_spans(), device) == (10.0, 15.0)
    log = [[0, None, "compute", 0, 4_000_000_000],
           [1, 0, "complete job", 1_000_000_000, 3_500_000_000],
           [2, 1, "invert nodemap", 1_000_000_000, 2_000_000_000]]
    assert span_report.self_seconds(log) == pytest.approx(
        {"compute": 1.5, "complete job": 1.5, "invert nodemap": 1.0})


def test_span_report_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "span_report.py", "--workload",
                          "testarea1_1M.resistances", "--seed", "1"],
                         cwd=ROOT, env=one_thread(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.parametrize("scenario", ["one-to-all", "all-to-one"])
def test_onetoall_log_and_penalty_counter(tmp_path, monkeypatch, scenario):
    """The one-to-all device path's batched solve logs its penalty fields
    and a refinement pass per float64 pass inside "batched pair solve",
    and the table keeps its paths.  All-to-one passes a (zero) penalty
    field to every pass, so all its CG iterations count in pen_iters;
    one-to-all's columns solve the penalty-baked operator itself, and
    none do."""
    from circuitscape_tpu_torch.timer import CSTIMER
    monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", "1")
    cfg, _ = make_job(str(tmp_path), 64, 64, npoints=5)
    cfg.update(MAPS, scenario=scenario)
    cst.compute(cfg, device="cpu")
    st = stats.finalize()
    log = st["spans"]
    by_id = {s[0]: s for s in log}
    solve = [s for s in log if s[2] == "batched pair solve"]
    passes = [s for s in log if s[2] == "refinement pass"]
    fields = [s for s in log if s[2] == "penalty fields"]
    assert len(solve) == st["stencil_solves"] == 1
    assert len(fields) == 1 and by_id[fields[0][1]][2] == "batched pair solve"
    assert 1 <= len(passes) <= 4
    assert all(by_id[s[1]][2] == "batched pair solve" for s in passes)
    assert st["cg_iters"] > 0
    assert st.get("pen_iters") == (st["cg_iters"] if scenario == "all-to-one"
                                   else None)
    assert {p[-1] for p in CSTIMER._data} >= {"batched pair solve"}
    assert not {"refinement pass", "penalty fields"} & {
        p[-1] for p in CSTIMER._data}
