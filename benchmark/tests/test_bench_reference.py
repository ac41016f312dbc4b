"""The plain reference against an exact dense solve of the same graph,
and against circuitscape_tpu_torch.compute(..., "cpu") on the same files
(the program's answers are judged, never used)."""

import json
import math
import os

import numpy as np
import pytest

from benchmark import check, inputs
from benchmark.reference import grid_pairwise as gp
from helpers import ROOT

BENCH_DIR = os.path.join(ROOT, "benchmark")
with open(os.path.join(BENCH_DIR, "configs", "testarea1_1M.json")) as f:
    BASE = json.load(f)
MAP = inputs.base_map(BASE, BENCH_DIR)


def _exact(g, cells, avg_res):
    """Resistances and cumulative / max node-current maps from dense
    pseudo-inverses of each component's Laplacian; g holds conductances,
    edges average them (or, with avg_res, their resistances)."""
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
    P = np.linalg.pinv(L)
    k = len(cells)
    R = -np.ones((k, k))
    cum = np.zeros(n)
    mx = np.zeros(n)
    for p in range(k):
        for q in range(k):
            if lab[cells[p]] != lab[cells[q]]:
                continue
            a, b = idx[cells[p]], idx[cells[q]]
            R[p, q] = P[a, a] + P[b, b] - 2 * P[a, b]
            if q <= p:
                continue
            v = P[:, a] - P[:, b]
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
    np.fill_diagonal(R, 0)
    grid = np.zeros((H, W))
    grid[act] = cum
    mgrid = np.zeros((H, W))
    mgrid[act] = mx
    return R, grid, mgrid


@pytest.mark.parametrize("rules", [(True, True), (False, False),
                                   (True, False)],
                         ids=["res-avgres", "cond-avgcond", "res-avgcond"])
@pytest.mark.parametrize("coarsest", [64, 10**6])
def test_reference_against_exact(tmp_path, monkeypatch, coarsest, rules):
    resistances, avg_res = rules
    monkeypatch.setattr(gp, "COARSEST_CELLS", coarsest)
    cfg = dict(BASE, nrows=29, ncols=37)
    g, active = inputs.landscape(cfg, MAP, 4, 0)
    g[:, 17:19] = inputs.NODATA          # two components
    active[:, 17:19] = False
    cells = inputs.focal_cells(active, 6, 4, 0)
    inputs.write_asc(str(tmp_path / "g.asc"), g, cfg)
    inputs.write_points(str(tmp_path / "p.txt"), cells, cfg)
    ref = gp.pairwise(str(tmp_path / "g.asc"), str(tmp_path / "p.txt"),
                      maps=True, resistances=resistances, avg_res=avg_res)
    cond = np.where(active, 1.0 / g if resistances else g, 0.0)
    R, cum, mx = _exact(cond, cells, avg_res)
    got = ref["resistances"]
    assert list(got[0, 1:]) == list(range(1, 7))
    conn = R > 0
    assert np.array_equal(got[1:, 1:] < 0, R < 0) and (R < 0).any()
    assert np.max(np.abs(got[1:, 1:][conn] - R[conn]) / R[conn]) < 1e-9
    assert np.max(np.abs(ref["cum"] - cum)) < 1e-9 * cum.max()
    assert np.max(np.abs(ref["max"] - mx)) < 1e-9 * mx.max()


@pytest.mark.parametrize("traffic", ["resistances", "cum_max_maps"])
def test_program_on_cpu_within_limits(tmp_path, traffic):
    import circuitscape_tpu_torch as cst
    from benchmark import cells
    tr = cells.traffic(traffic)
    cfg = dict(BASE, nrows=200, ncols=200, focal_points=5)
    files = inputs.JobInputs(str(tmp_path), cfg, tr, 31, BENCH_DIR)
    job, habitat, points = files.job(0)
    cst.compute(job, device="cpu")
    ref = gp.pairwise(habitat, points, maps="cum_curmap" in tr["compare"],
                      **check.graph_options(cfg))
    got = check.read_outputs(gp, files.output_dir(0), tr["compare"])
    ok, rows = check.judge(check.compare(got, ref, tr["compare"]),
                           tr["limits"])
    assert ok, rows
