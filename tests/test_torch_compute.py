"""circuitscape_tpu_torch.compute end to end on the CPU: a small job of
the bench recipe against circuitscape_tpu.compute, the sgVerify4 golden
with maps off, and the scenarios this package does not carry yet."""

import os

import numpy as np
import pytest
import torch

import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from golden_utils import DATA_DIR, check_resistances, readdlm

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)


def _bench_job(d, H, W, npoints, seed=42):
    """bench.py's recipe at a small size: conductance raster with ~10%
    NODATA and npoints focal points, as NPY files in d."""
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
    return {
        "data_type": "raster", "scenario": "pairwise",
        "habitat_file": os.path.join(d, "cellmap.npy"),
        "habitat_map_is_resistances": "False",
        "point_file": os.path.join(d, "points.npy"),
        "solver": "cg+amg", "suppress_messages": "True",
    }


@pytest.mark.parametrize("precision,four,avg", [
    ("single", "False", "False"),     # the bench job's flags
    ("double", "True", "True"),
])
def test_compute_matches_jax(tmp_path, precision, four, avg):
    """(e) resistances to 1e-5 relative, and the same files written."""
    cfg = _bench_job(str(tmp_path), 150, 130, 6)
    cfg.update(precision=precision, connect_four_neighbors_only=four,
               connect_using_avg_resistances=avg)
    rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                     device="cpu")
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    assert rt.dtype == rj.dtype
    assert rt.shape == rj.shape == (7, 7)
    np.testing.assert_array_equal(rt[0], rj[0])
    np.testing.assert_array_equal(rt[:, 0], rj[:, 0])
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= 1e-5
    for suffix in ("_resistances.out", "_resistances_3columns.out"):
        a = readdlm(str(tmp_path / f"t{suffix}"))
        b = readdlm(str(tmp_path / f"j{suffix}"))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


def test_golden_sgverify4_maps_off(tmp_path, monkeypatch):
    """(f) sgVerify4 (no polygons; 4 neighbors, average resistances,
    disconnected points) with maps forced off, which makes it a
    shortcut-mode job, at the reference's tolerance (sqrt(1e-6))."""
    monkeypatch.chdir(DATA_DIR)
    cfg = cst.parse_config("input/raster/pairwise/4/sgVerify4.ini").to_dict()
    cfg.update(write_volt_maps="False", write_cur_maps="False",
               output_file=str(tmp_path / "sgVerify4.out"),
               suppress_messages="True")
    r = cst.compute(cfg, device="cpu")
    x = readdlm(f"{DATA_DIR}/output_verify/sgVerify4_resistances.out")
    check_resistances(x, r, 1e-6, label="sgVerify4")
    written = readdlm(str(tmp_path / "sgVerify4_resistances.out"))
    check_resistances(x, written, 1e-6, label="sgVerify4 (written)")
    three = readdlm(
        f"{DATA_DIR}/output_verify/sgVerify4_resistances_3columns.out")
    check_resistances(three, readdlm(
        str(tmp_path / "sgVerify4_resistances_3columns.out")), 1e-6,
        label="sgVerify4 3columns")


def _same_outputs(tmp_path, rt, rj):
    """The two packages' results (to 1e-5 of max) and every file they
    wrote (t_* against j_*: the same names, numbers to 1e-5 of max)."""
    rt, rj = np.asarray(rt), np.asarray(rj)
    assert rt.shape == rj.shape
    assert np.abs(rt - rj).max() <= 1e-5 * max(np.abs(rj).max(), 1e-30)
    names = sorted(f[2:] for f in os.listdir(tmp_path) if f.startswith("t_"))
    assert names == sorted(f[2:] for f in os.listdir(tmp_path)
                           if f.startswith("j_"))
    for f in names:
        if f.endswith(".out") and "resistances" not in f:
            continue   # the INI echo
        skip = 6 if f.endswith(".asc") else 0
        a = np.loadtxt(tmp_path / f"t_{f}", skiprows=skip, ndmin=2)
        b = np.loadtxt(tmp_path / f"j_{f}", skiprows=skip, ndmin=2)
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30), f
    return names


def _run_both(tmp_path, cfg):
    rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t_.out")),
                     device="cpu")
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j_.out")))
    return _same_outputs(tmp_path, rt, rj)


@pytest.mark.parametrize("override,item", [
    # below CS_ADVANCED_DEVICE_MIN / CS_ONETOALL_DEVICE_MIN (40000 cells)
    # both packages solve these on the general sparse-graph tier
    ({"scenario": "advanced"}, "item 9"),
    ({"scenario": "one-to-all"}, "item 9"),
    ({"scenario": "all-to-one"}, "item 9"),
    ({"data_type": "network"}, "item 9"),
    ({"solver": "cholmod"}, "item 9"),
    # maps on: a 20x20 grid is below CS_PAIRWISE_DEVICE_MIN, so both
    # packages take the general sparse-graph path
    ({"write_cur_maps": "True"}, "item 9"),
    ({"write_volt_maps": "True"}, "item 9"),
])
def test_uncarried_scenarios_raise(tmp_path, override, item):
    """Jobs that ROADMAP queue 1 item 9 (the general sparse-graph tier)
    carried: each runs and matches the JAX package, its result and every
    file it writes (a network job: a 400-node lattice network, 3 focal
    nodes, in place of the raster)."""
    cfg = _bench_job(str(tmp_path), 20, 20, 3)
    cfg.update(override)
    if override.get("scenario") == "advanced":
        # the focal points as sources, point 3 as a direct ground
        pts = np.load(tmp_path / "points.npy")
        np.save(tmp_path / "src.npy", np.where(pts < 3, pts, 0))
        np.save(tmp_path / "gnd.npy", np.where(pts == 3, 0.0, -9999.0))
        cfg.update(source_file=str(tmp_path / "src.npy"),
                   ground_file=str(tmp_path / "gnd.npy"),
                   write_volt_maps="True", write_cur_maps="True")
    if override.get("data_type") == "network":
        from chip_smoke import make_network_job
        cfg = dict(make_network_job(str(tmp_path), n=400, nfocal=3),
                   precision="double")
    _run_both(tmp_path, cfg)


@pytest.mark.parametrize("case", ["regions_below_threshold",
                                  "polygons_cholmod"])
def test_uncarried_polygon_jobs_raise(tmp_path, case):
    """Jobs the general sparse-graph tier carries: a focal-region job
    below CS_PAIRWISE_DEVICE_MIN cells (the per-pair loop), and a polygon
    job with the direct solver; each matches the JAX package."""
    cfg = _bench_job(str(tmp_path), 20, 20, 3)
    if case == "regions_below_threshold":
        pts = np.load(tmp_path / "points.npy")
        r, c = np.argwhere(pts == 1)[0]
        pts[max(r - 1, 0):r + 2, max(c - 1, 0):c + 2] = 1
        np.save(tmp_path / "points.npy", pts)
        cfg.update(write_cur_maps="True")
    else:
        poly = np.zeros((20, 20))
        poly[2:6, 3:8] = 1
        np.save(tmp_path / "poly.npy", poly)
        cfg.update(use_polygons="True", polygon_file=str(tmp_path /
                                                         "poly.npy"),
                   solver="cholmod")
    _run_both(tmp_path, cfg)


@pytest.mark.parametrize("ini,item", [
    ("input/raster/pairwise/6/sgVerify6.ini", "item 9"),    # focal regions
    ("input/raster/pairwise/10/sgVerify10.ini", "item 9"),
])
def test_uncarried_corpus_jobs_raise(tmp_path, monkeypatch, ini, item):
    """Focal-region goldens below CS_PAIRWISE_DEVICE_MIN, maps off: both
    packages run them pair by pair on the general tier, and the port
    matches the golden resistances at the reference's tolerance."""
    monkeypatch.chdir(DATA_DIR)
    cfg = cst.parse_config(ini).to_dict()
    cfg.update(write_volt_maps="False", write_cur_maps="False",
               output_file=str(tmp_path / "x.out"))
    r = cst.compute(cfg, device="cpu")
    stem = os.path.basename(ini)[:-4]
    check_resistances(readdlm(f"{DATA_DIR}/output_verify/"
                              f"{stem}_resistances.out"), r, 1e-6,
                      label=stem)


def _exclude_job(tmp_path):
    cfg = _bench_job(str(tmp_path), 24, 24, 3)
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("mode exclude\n1 2\n")
    cfg.update(use_included_pairs="True", included_pairs_file=str(pairs))
    return cfg


def test_exclude_pairs_raise(tmp_path):
    """Exclude pairs turn the shortcut off; below CS_PAIRWISE_DEVICE_MIN
    cells both packages take the general sparse-graph path: every pair
    but the excluded one solves, as in the JAX package."""
    cfg = _exclude_job(tmp_path)
    rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                     device="cpu")
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    assert rt[1, 2] == rt[2, 1] == -1
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= 1e-5


def test_exclude_pairs_match_jax(tmp_path, monkeypatch):
    """The same job on the stencil device path (CS_PAIRWISE_DEVICE_MIN=1)
    solves every pair but the excluded one, as the JAX package does."""
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    cfg = _exclude_job(tmp_path)
    rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                     device="cpu")
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    assert rt[1, 2] == rt[2, 1] == -1
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= 1e-5


def test_chunked_resume_matches_jax(tmp_path, monkeypatch):
    """A checkpointed shortcut job in 1-pair device chunks, killed after
    its first chunk, resumes without re-solving that chunk and agrees
    with the JAX package's clean run (tests/test_checkpoint.py's
    shortcut case, on this package)."""
    from circuitscape_tpu_torch.drivers import core
    from circuitscape_tpu_torch.solve import stencil
    hdr = ("ncols 6\nnrows 6\nxllcorner 0\nyllcorner 0\ncellsize 1\n"
           "NODATA_value -9999\n")
    (tmp_path / "cell.asc").write_text(
        hdr + "\n".join(["1 1 2 1 1 1"] * 6) + "\n")
    (tmp_path / "pts.asc").write_text(
        hdr + "1 0 0 0 0 2\n0 0 0 0 0 0\n0 0 0 0 0 0\n"
        "0 0 0 0 0 0\n0 0 0 0 0 0\n3 0 0 4 0 0\n")
    cfg = {"data_type": "raster", "scenario": "pairwise",
           "habitat_file": str(tmp_path / "cell.asc"),
           "point_file": str(tmp_path / "pts.asc"),
           "output_file": str(tmp_path / "j.out"), "solver": "cg+amg",
           "suppress_messages": "True"}
    rj = cs.compute(cfg)
    cfg.update(output_file=str(tmp_path / "t.out"),
               checkpoint_file=str(tmp_path / "t.ckpt.npz"))

    solve = stencil.stencil_solve_pairs
    calls = []

    def killed_after_one(*a, **k):
        calls.append(len(a[1]))
        if len(calls) > 1:
            raise KeyboardInterrupt("simulated kill")
        return solve(*a, **k)

    monkeypatch.setattr(core, "_shortcut_chunk_cap", 1)
    monkeypatch.setattr(stencil, "stencil_solve_pairs", killed_after_one)
    with pytest.raises(KeyboardInterrupt):
        cst.compute(cfg, device="cpu")
    assert os.path.exists(cfg["checkpoint_file"])

    calls.clear()
    monkeypatch.setattr(stencil, "stencil_solve_pairs",
                        lambda *a, **k: calls.append(len(a[1])) or
                        solve(*a, **k))
    rt = cst.compute(cfg, device="cpu")
    assert calls == [1, 1]          # 3 anchor pairs, the first restored
    assert not os.path.exists(cfg["checkpoint_file"])
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= 1e-5


def test_compute_reads_ini_and_asc(tmp_path):
    """An INI job with AAGrid inputs (the verify-skill recipe) agrees
    with the JAX package."""
    asc = ("ncols 5\nnrows 5\nxllcorner 0\nyllcorner 0\ncellsize 1\n"
           "NODATA_value -9999\n")
    (tmp_path / "cell.asc").write_text(
        asc + "1 1 1 2 2\n1 1 1 2 2\n1 -9999 1 1 1\n1 1 1 1 1\n2 2 1 1 1\n")
    (tmp_path / "pts.asc").write_text(
        asc + "1 0 0 0 2\n0 0 0 0 0\n0 0 0 0 0\n0 0 0 0 0\n3 0 0 0 0\n")
    for name in ("t", "j"):
        (tmp_path / f"{name}.ini").write_text(
            "[Circuitscape mode]\ndata_type = raster\nscenario = pairwise\n"
            f"[Habitat raster or graph]\nhabitat_file = {tmp_path}/cell.asc"
            "\n[Options for pairwise and one-to-all and all-to-one modes]\n"
            f"point_file = {tmp_path}/pts.asc\n[Output options]\n"
            f"output_file = {tmp_path}/{name}.out\n"
            "[Calculation options]\nsolver = cg+amg\n")
    rt = cst.compute(str(tmp_path / "t.ini"), device="cpu")
    rj = cs.compute(str(tmp_path / "j.ini"))
    np.testing.assert_allclose(rt, rj, rtol=1e-6)


def _info_lines(pkg, cfg):
    """The INFO messages a job logs through pkg.cslog's UI callback,
    without their timestamps."""
    lines = []
    pkg.cslog.ui_interface[0] = (lambda msg, level: lines.append(
        msg.split(" : ", 1)[1]) if level == "info" else None)
    try:
        if pkg is cst:
            pkg.compute(cfg, device="cpu")
        else:
            pkg.compute(cfg)
    finally:
        pkg.cslog.ui_interface[0] = lambda msg, level: None
    return lines


def test_parallelize_log_matches_jax(tmp_path):
    """An INI with parallelize = True logs the same INFO lines in both
    packages, the JAX package's note that the flag is accepted for
    compatibility among them."""
    cfg = _bench_job(str(tmp_path), 20, 20, 3)
    cfg.update(parallelize="True", max_parallel="2")
    lt = _info_lines(cst, dict(cfg, output_file=str(tmp_path / "j.out")))
    lj = _info_lines(cs, dict(cfg, output_file=str(tmp_path / "j.out")))
    assert lt == lj
    assert any("parallelize flag accepted" in m for m in lt)


@pytest.mark.parametrize("per_cell,widths", [
    (64, [4, 4]), (96, [2, 2, 2, 2]), (300, [1] * 8)])
def test_chunk_width_follows_column_bytes(tmp_path, monkeypatch, per_cell,
                                          widths):
    """Under CS_SHORTCUT_CHUNK_BYTES the shortcut path's batch width is
    the budget over dispatch.COLUMN_BYTES_PER_CELL bytes a cell, floored
    to a power of two, whatever value the constant holds: a budget of
    4 x 64 B a cell cuts 9 points' 8 anchor columns into 4 + 4 at 64 B,
    2 + 2 + 2 + 2 at 96 B and singles at 300 B."""
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import dispatch, stencil
    cfg = _bench_job(str(tmp_path), 40, 36, 9)
    cfg["output_file"] = str(tmp_path / "t.out")
    cells = []
    budget = dispatch.solve_chunk_budget
    monkeypatch.setattr(dispatch, "solve_chunk_budget", lambda c, *a, **k:
                        cells.append(c) or budget(c, *a, **k))
    cst.compute(cfg, device="cpu")
    monkeypatch.setenv("CS_SHORTCUT_CHUNK_BYTES", str(4 * cells[0] * 64))
    monkeypatch.setattr(dispatch, "COLUMN_BYTES_PER_CELL", per_cell)
    seen = []
    solve = stencil.stencil_solve_pairs
    monkeypatch.setattr(stencil, "stencil_solve_pairs", lambda *a, **k:
                        seen.append(len(a[1])) or solve(*a, **k))
    r = cst.compute(cfg, device="cpu")
    assert seen == widths
    assert stats.finalize()["batch_width"] == widths[0]
    assert np.all(np.isfinite(r[1:, 1:]))


@pytest.mark.parametrize("per_cell", [64, 88, 128])
def test_oom_message_quotes_column_bytes(monkeypatch, per_cell):
    """The out-of-memory error names the chunk model's bytes per column
    (dispatch.COLUMN_BYTES_PER_CELL a cell) and the knob that cuts the
    batch."""
    from circuitscape_tpu_torch.solve import dispatch
    monkeypatch.setattr(dispatch, "COLUMN_BYTES_PER_CELL", per_cell)
    cells = 49_561_600
    with pytest.raises(dispatch.SolverFailedError) as e:
        dispatch.reraise_if_device_oom(
            torch.cuda.OutOfMemoryError("out of memory"), cells, 16)
    m = str(e.value)
    assert f"~{cells * per_cell / 2**30:.2f} GB per concurrent" in m
    assert "batch=16" in m and "CS_SHORTCUT_CHUNK_BYTES" in m
