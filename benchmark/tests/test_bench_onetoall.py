"""The one-to-all cell's parts on the CPU: its plain reference against an
exact dense solve, a tiny one-to-all cell of its own (200 x 200, 6
points, on make_tiny_tree's copy) that a sound run passes and three
faults of the timed path fail, the TF32 control failing it, and the
reader of its per-layer metric."""

import json
import math

import numpy as np
import pytest
import torch

from benchmark import cells, check, inputs
from benchmark.reference import grid_onetoall as go
from helpers import ROOT, TINY, make_tiny_tree, run_tiny

CELL = "testarea1_1M_onetoall.one_to_all_maps"
TINY_CELL = "tiny_o2a.one_to_all_maps"


@pytest.fixture()
def o2a_tree(tmp_path):
    """make_tiny_tree's copy with a 200 x 200 one-to-all configuration
    `tiny_o2a` (testarea1_1M_onetoall's, cut as `tiny`) and its cell,
    named in the per-layer metrics that list the one-to-all cell."""
    root, bench = make_tiny_tree(tmp_path)
    conf = root / "benchmark" / "configs"
    with open(conf / "testarea1_1M_onetoall.json") as f:
        cfg = json.load(f)
    cfg.update(TINY)
    with open(conf / "tiny_o2a.json", "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny_o2a", "source": "a test",
                             "file": "benchmark/configs/tiny_o2a.json",
                             "reduced": ["nrows", "ncols"], "why": "test"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny_o2a",
                               "traffic": "one_to_all_maps", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY_CELL)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f, indent=1)
    return root, bench


# ------------------------------------------------------------ reference

def _exact(g, cells_, avg_res):
    """One-to-all by dense solves: per point that shares its component,
    a unit current in and every other point held at 0 V; returns (R with
    -1 for a point alone, cumulative map, max map)."""
    from scipy import ndimage
    H, W = g.shape
    act = g > 0
    lab, _ = ndimage.label(act, structure=np.ones((3, 3)))
    idx = -np.ones((H, W), int)
    idx[act] = np.arange(act.sum())
    edges = []
    for dr, dc, f in ((0, 1, 2.0), (1, 0, 2.0), (1, 1, 2 * math.sqrt(2)),
                      (1, -1, 2 * math.sqrt(2))):
        for i in range(H):
            for j in range(W):
                i2, j2 = i + dr, j + dc
                if 0 <= i2 < H and 0 <= j2 < W and act[i, j] and act[i2, j2]:
                    a, b = g[i, j], g[i2, j2]
                    w = 4.0 / (1 / a + 1 / b) if avg_res else a + b
                    edges.append((idx[i, j], idx[i2, j2], w / f))
    n = int(act.sum())
    L = np.zeros((n, n))
    for a, b, w in edges:
        L[a, a] += w
        L[b, b] += w
        L[a, b] -= w
        L[b, a] -= w
    nodes = [idx[c] for c in cells_]
    comp = [lab[c] for c in cells_]
    R = -np.ones(len(cells_))
    cum, mx = np.zeros(n), np.zeros(n)
    for p, node in enumerate(nodes):
        if comp.count(comp[p]) < 2:
            continue
        free = np.nonzero(lab[act] == comp[p])[0]
        free = free[~np.isin(free, [m for m in nodes if m != node])]
        b = (free == node).astype(float)
        v = np.zeros(n)
        v[free] = np.linalg.solve(L[np.ix_(free, free)], b)
        R[p] = v[node]
        f = np.array([w * (v[s] - v[t]) for s, t, w in edges])
        f[np.abs(f) < 1e-8 * np.abs(f).max()] = 0
        inf, out = np.zeros(n), np.zeros(n)
        for (s, t, _), fl in zip(edges, f):
            if fl > 0:
                out[s] += fl
                inf[t] += fl
            else:
                inf[s] -= fl
                out[t] -= fl
        cur = np.maximum(inf, out)
        cum += cur
        mx = np.maximum(mx, cur)
    grid, mgrid = np.zeros((H, W)), np.zeros((H, W))
    grid[act], mgrid[act] = cum, mx
    return R, grid, mgrid


@pytest.mark.parametrize("rules", [(True, True), (False, False)],
                         ids=["res-avgres", "cond-avgcond"])
@pytest.mark.parametrize("coarsest", [64, 10**6])
def test_reference_against_exact(tmp_path, monkeypatch, coarsest, rules):
    """Three components: the left one with three points, the right one
    with two, and an island of habitat with one point alone (-1, no
    current)."""
    from benchmark.reference import grid_pairwise as gp
    resistances, avg_res = rules
    monkeypatch.setattr(gp, "COARSEST_CELLS", coarsest)
    with open(f"{ROOT}/benchmark/configs/testarea1_1M_onetoall.json") as f:
        cfg = dict(json.load(f), nrows=29, ncols=37)
    base = inputs.base_map(cfg, f"{ROOT}/benchmark")
    g, active = inputs.landscape(cfg, base, 4, 0)
    g[:, 17:19] = inputs.NODATA          # left and right components
    g[20:25, 3:8] = inputs.NODATA        # a ring around one cell...
    g[22, 5] = 9.0                       # ...which is the island
    active = (g != inputs.NODATA) & (g > 0)
    pts = [(3, 4), (12, 14), (26, 10), (5, 30), (24, 25), (22, 5)]
    assert all(active[p] for p in pts)
    inputs.write_asc(str(tmp_path / "g.asc"), g, cfg)
    inputs.write_points(str(tmp_path / "p.txt"), pts, cfg)
    ref = go.pairwise(str(tmp_path / "g.asc"), str(tmp_path / "p.txt"),
                      maps=True, resistances=resistances, avg_res=avg_res)
    cond = np.where(active, 1.0 / g if resistances else g, 0.0)
    R, cum, mx = _exact(cond, pts, avg_res)
    got = ref["resistances"]
    assert list(got[:, 0]) == list(range(1, 7))
    assert list(got[:, 1] == -1) == [False] * 5 + [True]
    assert np.array_equal(R == -1, got[:, 1] == -1)
    on = R > 0
    assert np.max(np.abs(got[on, 1] - R[on]) / R[on]) < 1e-9
    assert np.max(np.abs(ref["cum"] - cum)) < 1e-9 * cum.max()
    assert np.max(np.abs(ref["max"] - mx)) < 1e-9 * mx.max()
    assert ref["max"][22, 5] == 0 and ref["cum"][22, 5] == 0


# ------------------------------------------------------------- the cell

def _zeros(monkeypatch):
    """The advanced batch solve returns zeros, as converged."""
    from circuitscape_tpu_torch.solve import stencil

    def solve(S64, src_cells, *a, **k):
        H, W = S64.shape
        nb = len(src_cells)
        return (torch.zeros((nb, H, W), dtype=torch.float64),
                np.zeros(nb), 0)
    monkeypatch.setattr(stencil, "stencil_solve_advanced_batch", solve)


def _half_batch(monkeypatch):
    """Half of the columns solved, the rest given their mean."""
    from circuitscape_tpu_torch.solve import stencil
    real = stencil.stencil_solve_advanced_batch

    def solve(S64, src_cells, src_vals, gnd_cells, gnd_vals, *a, **k):
        nb = len(src_cells)
        h = max(1, nb // 2)
        # the caller's unit-current residual reads the whole batch: the
        # half stops on its right-hand side's
        k.pop("rel_to", None)
        X, rel, it = real(S64, src_cells[:h], src_vals[:h], gnd_cells[:h],
                          gnd_vals[:h], *a, **k)
        out = X.new_zeros((nb,) + tuple(X.shape[1:]))
        out[:h] = X
        out[h:] = X.mean(dim=0)
        return out, np.concatenate([rel, np.zeros(nb - h)]), it
    monkeypatch.setattr(stencil, "stencil_solve_advanced_batch", solve)


def _altered_cell(monkeypatch):
    """One cell of the cumulative map altered by a part in a hundred
    where it is written."""
    from circuitscape_tpu_torch import out
    cum = out.write_cum_maps

    def write_cum_maps(c, *a, **k):
        i = np.unravel_index(np.argmax(c.cum_curr), c.cum_curr.shape)
        c.cum_curr[i] *= 1.01
        cum(c, *a, **k)
    monkeypatch.setattr(out, "write_cum_maps", write_cum_maps)


def test_sound_run_is_correct(o2a_tree):
    root, bench = o2a_tree
    result, rows = run_tiny(root, bench, TINY_CELL, trace=True)
    assert result["correct"] is True, rows
    assert result["failed"] == 0
    assert [k for k, _, _ in rows] == ["cum_map_rel", "max_map_rel"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 1 <= m["solve.refine_passes"] <= 4
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [_zeros, _half_batch, _altered_cell])
def test_fault_is_not_correct(o2a_tree, monkeypatch, fault):
    root, bench = o2a_tree
    fault(monkeypatch)
    result, rows = run_tiny(root, bench, TINY_CELL)
    assert result["correct"] is False, rows
    # the comparison, not a failed job, finds the fault
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert any(v > lim for _, v, lim in rows), rows


def test_control_fails(o2a_tree):
    from benchmark import control
    root, bench = o2a_tree
    numbers, limits = control.control_numbers(
        str(root), bench, TINY_CELL, 5, "cpu", base=str(root / "benchmark"))
    ok, rows = check.judge(numbers, limits)
    assert not ok, rows


# ----------------------------------------------------- per-layer readers

class _Job:
    def __init__(self, spans=None, **st):
        self.stats = dict(st, spans=spans, spans_dropped=0)


class _Run:
    def __init__(self, *jobs):
        self.span_jobs = list(jobs)


def _log(*names_parents):
    """A span log under a root "compute": (name, parent index) pairs,
    parent None for the root's children."""
    log = [[0, None, "compute", 0, 100]]
    for k, (name, parent) in enumerate(names_parents, start=1):
        log.append([k, 0 if parent is None else parent, name, k, k + 1])
    return log


def test_refine_passes_counts_spans_in_the_solve():
    read = cells.reader("solve.refine_passes", True)
    solve = _log(("batched pair solve", None), ("refinement pass", 1),
                 ("refinement pass", 1), ("refinement pass", None))
    three = _log(("batched pair solve", None), ("refinement pass", 1),
                 ("refinement pass", 1), ("refinement pass", 1))
    assert read(_Run(_Job(solve), _Job(three))) == 2.5
    # a program that logs no pass of this solve leaves the metric out
    assert read(_Run(_Job(_log(("batched pair solve", None))))) is None
    assert read(_Run()) is None


def test_cell_entries():
    """The configuration is testarea1_1M's pool under one-to-all, and
    the per-layer metric of its solve's passes lists the cell."""
    bench = cells.load_benchmark(ROOT)
    w = cells.workload(bench, CELL)
    assert w["chips"] == 1 and w["traffic"] == "one_to_all_maps"
    mine = cells.config(bench, ROOT, w["config"])
    base = cells.config(bench, ROOT, "testarea1_1M")
    same = set(base) - {"about", "assumed", "reference"}
    assert {k: mine[k] for k in same} == {k: base[k] for k in same}
    assert mine["reference"] == "grid_onetoall"
    names = [m["name"] for m in cells.metrics(bench, CELL, True)]
    assert "solve.refine_passes" in names
    assert cells.traffic("one_to_all_maps")["scenario"] == "one-to-all"
