"""circuitscape_tpu_torch one-to-all and all-to-one against the JAX
package on the CPU: the point-map polygon merge, whole jobs on both
packages' stencil device paths (tests/test_onetoall_device.py's 80 x 80
recipes, with variable strengths, polygons, byte-budgeted chunks and the
max_parallel cap), and the one-to-all and all-to-one goldens of
tests/data.

The device paths take grids of at least CS_ONETOALL_DEVICE_MIN cells;
the jobs here lower it to 1.  Where the JAX package's device path
declines (merged or repeated points, included pairs), both packages
run the per-point loop on the general sparse-graph tier.  Every job
writes under tmp_path."""

import os

import numpy as np
import pytest
import torch

import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from circuitscape_tpu.drivers import onetoall as jo
from circuitscape_tpu.graph import build as jb
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu.solve.dispatch import SolverFailedError as JaxFailed
from circuitscape_tpu_torch import stats
from circuitscape_tpu_torch.drivers import onetoall as to
from circuitscape_tpu_torch.graph import build as tb
from circuitscape_tpu_torch.solve import stencil as tst
from circuitscape_tpu_torch.solve.dispatch import SolverFailedError
from golden_utils import DATA_DIR, check_resistances, read_aagrid, readdlm
from test_onetoall_device import _job, _poly_file
from test_torch_advanced import (both_passes, replay_passes,
                                 replay_port_passes)

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

VERIFY = os.path.join(DATA_DIR, "output_verify")


@pytest.mark.parametrize("case", ["no_polygons", "polygons",
                                  "repeated_ids"])
def test_point_map_polymap_matches_jax(case):
    """create_new_polymap's point-map form: focal cells outside polygons
    become polygons of their own; with repeated ids a region takes over
    the polygons it overlaps."""
    rng = np.random.default_rng(3)
    g = rng.uniform(0.5, 2.0, (12, 10))
    poly = np.zeros((0, 0), np.int64)
    if case != "no_polygons":
        poly = np.zeros((12, 10), np.int64)
        poly[1:4, 1:4] = 1
        poly[6:9, 5:9] = 2
        poly[10, 0:3] = 3
    rows = np.array([2, 5, 8, 11, 11, 7])
    cols = np.array([2, 5, 7, 1, 9, 6])
    pts = (np.array([1, 2, 3, 4, 5, 6]) if case != "repeated_ids"
           else np.array([1, 2, 3, 3, 4, 1]))
    point_map = np.zeros(g.shape, np.int64)
    for r, c, p in zip(rows, cols, pts):
        point_map[r - 1, c - 1] = p
    got = tb.create_new_polymap(g, poly, (rows, cols, pts), 0, 0, point_map)
    ref = jb.create_new_polymap(g, poly, (rows, cols, pts), 0, 0, point_map)
    np.testing.assert_array_equal(got, ref)


def test_prune_strengths_matches_jax():
    s = np.array([[1, 0.5], [2, 1.5], [3, 2.5], [7, 3.0]])
    ids = np.array([2, 7])
    np.testing.assert_array_equal(to.prune_strengths(s, ids),
                                  jo.prune_strengths(s, ids))


def _run_both(tmp_path, cfg):
    """The job through both packages: the same results (1e-5 relative),
    every CG pass at the JAX package's iteration count on its inputs
    (test_torch_advanced.replay_passes), the first passes of the two
    jobs equal where both solve the same systems, the same files, and
    every map within 1e-5 of its max.  One-to-all without polygons
    solves each column for the harmonic on the hierarchy's own operator
    (ROADMAP section 3), which the JAX package's job does not: there
    every pass of the port's runs on the JAX package's stencil_cg at the
    port's count on the port's inputs (replay_port_passes).  Returns
    the port's result."""
    with both_passes() as (t, j):
        rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                         device="cpu")
        rj = np.asarray(cs.compute(dict(cfg,
                                        output_file=str(tmp_path / "j.out"))))
    assert rt.dtype == rj.dtype and rt.shape == rj.shape
    np.testing.assert_array_equal(rt[:, 0], rj[:, 0])
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= 1e-5
    harmonic = (cfg["scenario"] == "one-to-all" and
                cfg.get("use_polygons") != "True")
    replay_passes(t, j, first_passes=not harmonic)
    if harmonic:
        replay_port_passes(t)
    files = sorted(f[1:] for f in os.listdir(tmp_path) if f[:2] == "t_")
    assert files == sorted(f[1:] for f in os.listdir(tmp_path)
                           if f[:2] == "j_")
    for suffix in files:
        a = read_aagrid(tmp_path / f"t{suffix}")
        b = read_aagrid(tmp_path / f"j{suffix}")
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), suffix
    return rt


def _strengths(tmp_path, cfg):
    """Non-uniform strengths, one per focal point id (1..6)."""
    (tmp_path / "strengths.txt").write_text(
        "\n".join(f"{i}\t{0.5 + 0.75 * i}" for i in range(1, 7)) + "\n")
    cfg.update(use_variable_source_strengths="True",
               variable_source_file=str(tmp_path / "strengths.txt"))


def _polygons(tmp_path, cfg, keep_points_out):
    """tests/test_onetoall_device.py's two polygons (point 1 lies in
    polygon 2); keep_points_out drops the polygons that hold a focal
    point."""
    path = _poly_file(tmp_path)
    if keep_points_out:
        poly = read_aagrid(path)
        pts = read_aagrid(tmp_path / "pts.asc")
        for pid in np.unique(poly[(pts > 0) & (poly > 0)]):
            poly[poly == pid] = 0
        assert poly.any()
        H, W = poly.shape
        (tmp_path / "poly.asc").write_text(
            f"ncols {W}\nnrows {H}\nxllcorner 0\nyllcorner 0\n"
            f"cellsize 1\nNODATA_value -9999\n" +
            "\n".join(" ".join(str(int(v)) for v in row) for row in poly))
    cfg.update(use_polygons="True", polygon_file=path)


@pytest.mark.parametrize("scenario", ["one-to-all", "all-to-one"])
@pytest.mark.parametrize("variant", ["maps", "strengths", "polygons"])
def test_job_matches_jax(tmp_path, monkeypatch, scenario, variant):
    """6 points on an 80 x 80 grid with per-point and cumulative current
    maps: plain, with variable strengths, and with short-circuit
    polygons (for one-to-all, only those without a focal point: see
    test_onetoall_point_in_polygon_fails_as_jax).  One-to-all results
    are positive resistances; all-to-one results are 0."""
    monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", "1")
    cfg = _job(tmp_path, scenario, write_maps=True)
    cfg["suppress_messages"] = "True"
    if variant == "strengths":
        _strengths(tmp_path, cfg)
    elif variant == "polygons":
        _polygons(tmp_path, cfg, keep_points_out=scenario == "one-to-all")
    r = _run_both(tmp_path, cfg)
    if scenario == "one-to-all":
        assert np.all(r[:, 1] > 0)
    else:
        assert np.all(r[:, 1] == 0)


def test_onetoall_point_in_polygon_fails_as_jax(tmp_path, monkeypatch):
    """A focal point inside a short-circuit polygon: the JAX package's
    one-to-all device path grounds the polygon at that one cell, its CG
    diverges and the job stops at the residual gate (ROADMAP section 3);
    the port stops there too."""
    monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", "1")
    cfg = _job(tmp_path, "one-to-all")
    cfg["suppress_messages"] = "True"
    _polygons(tmp_path, cfg, keep_points_out=False)
    with pytest.raises(SolverFailedError, match="one-to-all device"):
        cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                    device="cpu")
    with pytest.raises(JaxFailed, match="one-to-all device"):
        cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))


def _record_chunks(monkeypatch):
    """Batch widths of every batched solve, per package."""
    widths = {"t": [], "j": []}
    for key, st in (("t", tst), ("j", jst)):
        real = st.stencil_solve_advanced_batch

        def rec(S, src_cells, *a, _real=real, _key=key, **k):
            widths[_key].append(np.asarray(src_cells).shape[0])
            return _real(S, src_cells, *a, **k)
        monkeypatch.setattr(st, "stencil_solve_advanced_batch", rec)
    return widths


@pytest.mark.parametrize("scenario,knob", [("one-to-all", "chunk_bytes"),
                                          ("all-to-one", "max_parallel")])
def test_chunks_match_jax(tmp_path, monkeypatch, scenario, knob):
    """A byte budget of 2 of the port's columns (CS_ONETOALL_CHUNK_BYTES;
    COLUMN_BYTES_PER_CELL a cell, which the JAX package's 64-B model
    floors to 2 as well) cuts the 6 points into chunks of 2, 2, 2 in
    both packages; max_parallel = 5 floors to chunks of 4, 2 (the
    power-of-two floor after the cap)."""
    from circuitscape_tpu_torch.solve.dispatch import COLUMN_BYTES_PER_CELL
    monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", "1")
    cfg = _job(tmp_path, scenario)
    cfg["suppress_messages"] = "True"
    if knob == "chunk_bytes":
        monkeypatch.setenv("CS_ONETOALL_CHUNK_BYTES",
                           str(128 * 128 * COLUMN_BYTES_PER_CELL * 2))
    else:
        cfg["max_parallel"] = "5"
    widths = _record_chunks(monkeypatch)
    _run_both(tmp_path, cfg)
    assert widths["t"] == widths["j"] == ([2, 2, 2] if knob == "chunk_bytes"
                                          else [4, 2])


# the goldens whose jobs the JAX package solves on its device path with
# CS_ONETOALL_DEVICE_MIN = 1; it runs every other one on its per-point
# general path (a focal point on a NODATA cell leaves two points without
# a node, which counts as merged; repeated ids; included pairs)
_DEVICE = {("all_to_one", 7)}
# oneToAllVerify7 (point 2 inside polygon 3): the JAX package's device
# path stops with a residual above the gate (ROADMAP section 3, and
# test_onetoall_point_in_polygon_fails_as_jax); the port does the same
_FAILS = {("one_to_all", 7)}


def _golden(tmp_path, kind, n):
    stem = {"one_to_all": "oneToAllVerify",
            "all_to_one": "allToOneVerify"}[kind] + str(n)
    cfg = cst.parse_config(f"input/raster/{kind}/{n}/{stem}.ini").to_dict()
    cfg.update(solver="cg+amg", suppress_messages="True",
               output_file=str(tmp_path / f"{stem}.out"))
    return stem, cfg


@pytest.mark.parametrize("kind,n", [("one_to_all", n) for n in range(1, 14)] +
                         [("all_to_one", n) for n in range(1, 13)])
def test_golden(tmp_path, monkeypatch, kind, n):
    """With CS_ONETOALL_DEVICE_MIN = 1 and solver = cg+amg: the goldens
    the JAX package solves on its device path, and the others (included
    pairs, repeated ids, merged points), which take the per-point loop
    on the general sparse-graph tier, pass at the reference's tolerance
    (results within sqrt(1e-6), written grids within a sum-of-squares
    difference of 1e-6); the one its device path fails fails here too."""
    monkeypatch.chdir(DATA_DIR)
    monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", "1")
    stem, cfg = _golden(tmp_path, kind, n)
    if (kind, n) in _FAILS:
        with pytest.raises(SolverFailedError, match="one-to-all device"):
            cst.compute(cfg, device="cpu")
        return
    r = cst.compute(cfg, device="cpu")
    check_resistances(readdlm(os.path.join(VERIFY, f"{stem}_resistances.out")),
                      r, 1e-6, label=stem)
    grids = sorted(f for f in os.listdir(tmp_path) if f.endswith(".asc"))
    assert grids or (kind, n) not in _DEVICE
    for f in grids:
        d2 = float(((read_aagrid(tmp_path / f) -
                     read_aagrid(os.path.join(VERIFY, f))) ** 2).sum())
        assert d2 < 1e-6, f"{f}: grid sum-sq diff {d2}"


@pytest.mark.parametrize("scenario", ["one-to-all", "all-to-one"])
def test_cum_only_matches_point_loop(tmp_path, monkeypatch, scenario):
    """write_cum_cur_map_only (with write_cur_maps and write_max_cur_maps,
    as mgVerify7.ini sets them) on the device fast path: no map per
    point, as the pairwise paths write none (out.write_cur_maps), and the
    cumulative and max maps those of the per-point loop on the same job
    within the bound tests/test_onetoall_device.py holds the JAX
    package's two routes to.  (The per-point loop, advanced_kernel,
    writes a map per point under the option, as the JAX package's
    does.)"""
    cfg = _job(tmp_path, scenario, write_maps=True)
    cfg.update(suppress_messages="True", write_cum_cur_map_only="True",
               write_max_cur_maps="True")
    maps = {}
    for route, cells_min in (("fast", "1"), ("loop", "100000000")):
        monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", cells_min)
        out = tmp_path / route
        out.mkdir()
        cst.compute(dict(cfg, output_file=str(out / "job.out")),
                    device="cpu")
        assert (stats.finalize().get("stencil_solves", 0) > 0) == (
            route == "fast")
        maps[route] = [read_aagrid(out / f"job_{k}_curmap.asc")
                       for k in ("cum", "max")]
    files = os.listdir(tmp_path / "fast")
    assert not [f for f in files if "_curmap_" in f], files
    for fast, loop in zip(maps["fast"], maps["loop"]):
        assert loop.max() > 0
        assert ((fast - loop) ** 2).sum() < 1e-6


def test_edges_at_are_the_operator_columns():
    """stencil_edges_at: the far ends and weights of a cell's edges are
    minus the Laplacian's column at the cell, off its diagonal, at
    corners, borders and inside, NODATA neighbours included."""
    rng = np.random.default_rng(5)
    g = rng.uniform(0.5, 2.0, (9, 7))
    g[rng.random(g.shape) < 0.2] = 0.0
    A = tst.operator_from_numpy(tst.stencil_planes_np(g, False, False),
                                torch.float64)
    H, W = A.shape
    cells = np.array([[0, 0], [4, 3], [H - 1, W - 1], [0, W - 1], [3, 0]])
    far, w = tst.stencil_edges_at(A, cells)
    assert far.shape == (5, 8, 2) and w.shape == (5, 8)
    for n, (r, c) in enumerate(cells):
        e = torch.zeros((1, H, W), dtype=torch.float64)
        e[0, r, c] = 1.0
        col = -tst.stencil_matvec(A, e)[0].numpy()
        col[r, c] = 0.0
        got = np.zeros((H, W))
        np.add.at(got, (far[n, :, 0], far[n, :, 1]), w[n])
        np.testing.assert_allclose(got, col, rtol=0, atol=1e-15)




def test_harmonic_passes_stop_on_the_unit_current_residual(tmp_path,
                                                           monkeypatch):
    """One-to-all's harmonic columns: the residual the passes stop on,
    and the gate reads, is the unit-current answer's, u_i's residual
    over the current u_i + e_i draws out of point i along its edges,
    under HARMONIC_RTOL; the harmonic's own relative residual (over its
    right-hand side) differs from it."""
    monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", "1")
    seen = []
    real = tst.stencil_solve_advanced_batch

    def solve(S64, *a, **k):
        X, rel, it = real(S64, *a, **k)
        seen.append((S64, a, k, X.clone(), rel))
        return X, rel, it
    monkeypatch.setattr(tst, "stencil_solve_advanced_batch", solve)
    cst.compute(_job(tmp_path, "one-to-all"), device="cpu")
    (S64, (sc, sv, gc, gv), k, X, rel), = seen
    assert k["rel_to"] is not None and k["rtol"] == to.HARMONIC_RTOL
    assert k["max_refine"] == to.HARMONIC_PASSES
    H, W = S64.shape

    def field(cells, vals):
        return tst._scatter_field(torch.as_tensor(cells),
                                  torch.as_tensor(vals), H, W)
    R = field(sc, sv) - tst._apply_op(S64, X, field(gc, gv))
    rn = torch.sqrt(tst._colsum(R * R)).numpy()
    # column n's point: the one whose edges are its sources
    far, w = tst.stencil_edges_at(S64, gc[0])
    own = [next(i for i in range(len(far)) if np.array_equal(far[i], c))
           for c in sc]
    drawn = np.array([np.sum(w[i] * (1.0 - X[n].numpy()[far[i, :, 0],
                                                        far[i, :, 1]]))
                      for n, i in enumerate(own)])
    assert len(own) == len(rel) > 1 and np.all(drawn > 0)
    np.testing.assert_allclose(rel, rn / drawn, rtol=1e-12)
    assert np.all(rel <= to.HARMONIC_RTOL)
    bn = np.linalg.norm(np.asarray(sv), axis=1)
    assert np.all(np.abs(rn / bn - rel) > 0.01 * rel)
