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
from circuitscape_tpu_torch.drivers import onetoall as to
from circuitscape_tpu_torch.graph import build as tb
from circuitscape_tpu_torch.solve import stencil as tst
from circuitscape_tpu_torch.solve.dispatch import SolverFailedError
from golden_utils import DATA_DIR, check_resistances, read_aagrid, readdlm
from test_onetoall_device import _job, _poly_file
from test_torch_advanced import both_passes, replay_passes

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
    (test_torch_advanced.replay_passes), the same files, and every map
    within 1e-5 of its max.  Returns the port's result."""
    with both_passes() as (t, j):
        rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                         device="cpu")
        rj = np.asarray(cs.compute(dict(cfg,
                                        output_file=str(tmp_path / "j.out"))))
    assert rt.dtype == rj.dtype and rt.shape == rj.shape
    np.testing.assert_array_equal(rt[:, 0], rj[:, 0])
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= 1e-5
    replay_passes(t, j)
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
