"""circuitscape_tpu_torch jobs with short-circuit polygons and focal
regions against the JAX package on the CPU, and the polygon and
focal-region goldens of tests/data at the reference's tolerances.

The job differentials run both packages on the stencil device path:
shortcut mode at any size, maps on and focal regions with
CS_PAIRWISE_DEVICE_MIN lowered.  The goldens are held to the golden
files; where the JAX package's device path departs from a golden (its
in_comp mask on sgVerify5/8's voltage maps, a focal region whose
first-listed cell is NODATA on sgVerify10/11), the port is held to the
JAX package's device path there.  Every job writes under tmp_path."""

import os

import numpy as np
import pytest
import torch

import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from golden_utils import DATA_DIR, check_resistances, read_aagrid, readdlm

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

NODATA = -9999.0
VERIFY = os.path.join(DATA_DIR, "output_verify")


def _polygon_job(d, H, W, npoints=8, seed=42):
    """bench.py's recipe (conductance with ~10% NODATA, npoints focal
    points) plus 20 square polygons scaled to the grid: 1-6 centred on
    points 1-6, 7 two small squares around points 7 and 8 (merging the
    two), 8-20 placed with default_rng(7); polygon cells keep their
    conductance, NODATA included.  NPY files in d."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.10] = NODATA
    pts = np.zeros((H, W))
    placed = 0
    while placed < npoints:
        r, c = rng.integers(0, H), rng.integers(0, W)
        if g[r, c] > 0 and pts[r, c] == 0:
            placed += 1
            pts[r, c] = placed
    big = max(1, round(10 * H / 1000))
    small = max(1, round(2 * H / 1000))
    poly = np.zeros((H, W))

    def square(r, c, h, pid):
        poly[max(r - h, 0):r + h + 1, max(c - h, 0):c + h + 1] = pid

    prng = np.random.default_rng(7)
    for pid in range(8, 21):
        square(prng.integers(0, H), prng.integers(0, W), big, pid)
    for pid in range(1, 7):
        square(*np.argwhere(pts == pid)[0], big, pid)
    for p in (7, 8):
        square(*np.argwhere(pts == p)[0], small, 7)
    for name, a in (("cellmap", g), ("points", pts), ("polygons", poly)):
        np.save(os.path.join(d, f"{name}.npy"), a)
    return {
        "data_type": "raster", "scenario": "pairwise",
        "habitat_file": os.path.join(d, "cellmap.npy"),
        "habitat_map_is_resistances": "False",
        "point_file": os.path.join(d, "points.npy"),
        "use_polygons": "True",
        "polygon_file": os.path.join(d, "polygons.npy"),
        "solver": "cg+amg", "suppress_messages": "True",
    }


def _written(d, stem):
    return sorted(f[len(stem):] for f in os.listdir(d)
                  if f.startswith(stem + "_"))


def _grids_agree(a, b, label, tol=1e-5):
    """Same NODATA cells, and max |a - b| <= tol * max |b| elsewhere."""
    assert a.shape == b.shape, label
    na, nb = a == NODATA, b == NODATA
    assert np.array_equal(na, nb), f"{label}: NODATA cells differ"
    if (~nb).any():
        err = np.abs(a[~na] - b[~nb]).max()
        assert err <= tol * np.abs(b[~nb]).max(), f"{label}: {err}"


def _run_both(tmp_path, cfg):
    """The job through both packages; asserts resistances to 1e-5
    relative (and -1 where the JAX package has -1), the same files, and
    every map to 1e-5 of its max.  Returns (port, JAX) matrices."""
    rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                     device="cpu")
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    assert rt.dtype == rj.dtype and rt.shape == rj.shape
    np.testing.assert_array_equal(rt == -1, rj == -1)
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= 1e-5
    files = _written(tmp_path, "t")
    assert files == _written(tmp_path, "j")
    for suffix in files:
        if suffix.endswith(".asc"):
            _grids_agree(read_aagrid(tmp_path / f"t{suffix}"),
                         read_aagrid(tmp_path / f"j{suffix}"), suffix)
    return rt, rj


@pytest.mark.parametrize("maps", [False, True])
def test_polygon_job_matches_jax(tmp_path, monkeypatch, maps):
    """The polygon recipe with 8 points, in shortcut mode at 150 x 130
    and with per-pair current and voltage maps and the max map on the
    stencil device path at 100 x 90 (the JAX package's maps path takes
    ~4x the port's time on the CPU): the port agrees with the JAX
    package; points 7 and 8 share a merged node (resistance 0), and no
    pair is farther apart than without the polygons (Rayleigh's
    monotonicity law)."""
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    cfg = _polygon_job(str(tmp_path), *((100, 90) if maps else (150, 130)))
    if maps:
        cfg.update(write_cur_maps="True", write_volt_maps="True",
                   write_max_cur_maps="True")
    rt, _ = _run_both(tmp_path, cfg)
    m = rt[1:, 1:]
    assert m[6, 7] == m[7, 6] == 0
    off = ~np.eye(8, dtype=bool)
    assert np.all(m[off][(m[off] != 0)] > 0)
    if maps:
        assert len([f for f in _written(tmp_path, "t")
                    if f.endswith(".asc")]) == 2 * 27 + 2
    else:
        plain = cst.compute(dict(cfg, use_polygons="False",
                                 output_file=str(tmp_path / "p.out")),
                            device="cpu")[1:, 1:]
        assert np.all(m <= plain * (1 + 1e-6))
        assert np.any(m[off] < plain[off] * (1 - 1e-3))


def _regions_job(d, side=60, split=False):
    """Focal regions: 3x3 (or 2x2) blocks of cells made active with
    |g| + 0.5, as tests/test_regions_device.py builds them; split cuts
    the grid in two with a NODATA column."""
    rng = np.random.default_rng(7)
    g = rng.uniform(0.5, 3.0, (side, side))
    g[rng.random((side, side)) < 0.15] = NODATA
    pts = np.zeros((side, side))
    if split:
        g[:, side // 2] = NODATA
        locs = [(4, 4, 2), (side - 10, side - 10, 2), (20, 4, 2)]
    else:
        locs = [(5, 5, 3), (side - 10, 8, 3), (15, side - 14, 3)]
    for k, (r, c, n) in enumerate(locs, start=1):
        g[r:r + n, c:c + n] = np.abs(g[r:r + n, c:c + n]) + 0.5
        pts[r:r + n, c:c + n] = k
    np.save(os.path.join(d, "cell.npy"), g)
    np.save(os.path.join(d, "pts.npy"), pts)
    return {
        "data_type": "raster", "scenario": "pairwise",
        "habitat_file": os.path.join(d, "cell.npy"),
        "habitat_map_is_resistances": "False",
        "point_file": os.path.join(d, "pts.npy"),
        "solver": "cg+amg", "suppress_messages": "True",
    }


@pytest.mark.parametrize("case", ["maps", "disconnected"])
def test_regions_job_matches_jax(tmp_path, monkeypatch, case):
    """Focal-region jobs on both packages' device paths: three 3x3
    regions with per-pair current and voltage maps and the max map
    (every map to 1e-5 of max), and three 2x2 regions split over two
    islands, whose cut pair stays -1."""
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "100")
    cfg = _regions_job(str(tmp_path), split=case == "disconnected")
    if case == "maps":
        cfg.update(write_cur_maps="True", write_volt_maps="True",
                   write_max_cur_maps="True")
    rt, _ = _run_both(tmp_path, cfg)
    if case == "maps":
        assert np.all(rt[1:, 1:][~np.eye(3, dtype=bool)] > 0)
        assert len([f for f in _written(tmp_path, "t")
                    if f.endswith(".asc")]) == 2 * 3 + 2
    else:
        assert rt[1, 2] == rt[2, 1] == -1 and rt[1, 3] > 0


def _golden(tmp_path, n, device_min, **override):
    """sgVerify<n> through this package from DATA_DIR, with outputs in
    tmp_path/t; returns (resistances, written .asc suffixes)."""
    if device_min is not None:
        os.environ["CS_PAIRWISE_DEVICE_MIN"] = str(device_min)
    ini = f"input/raster/pairwise/{n}/sgVerify{n}.ini"
    cfg = cst.parse_config(ini).to_dict()
    (tmp_path / "t").mkdir()
    cfg.update(output_file=str(tmp_path / "t" / f"sgVerify{n}.out"),
               suppress_messages="True", **override)
    r = cst.compute(cfg, device="cpu")
    return cfg, r, [f for f in _written(tmp_path / "t", f"sgVerify{n}")
                    if f.endswith(".asc")]


def _check_grid(path, ref, label):
    """compare_all_output's grid rule: sum of squared differences < 1e-6."""
    d2 = float(((read_aagrid(path) - ref) ** 2).sum())
    assert d2 < 1e-6, f"{label}: grid sum-sq diff {d2}"


# sgVerify1's INI asks for cholmod: it runs with solver = cg+amg, on its
# own GeoTIFF polygon file
_SG1 = {"solver": "cg+amg"}


@pytest.mark.parametrize("n,device_min,override", [
    (12, None, {}), (15, None, {}),              # shortcut, default path
    (1, 1, _SG1), (2, 1, {}), (3, 1, {}), (6, 1, {}), (7, 1, {}),
    (9, 1, {}), (14, 1, {}), (16, 1, {}),
])
def test_golden_polygons(tmp_path, monkeypatch, n, device_min, override):
    """Polygon and focal-region goldens on the stencil device path:
    resistances within sqrt(1e-6) of the golden, written too, and every
    written grid within a sum-of-squares difference of 1e-6."""
    monkeypatch.chdir(DATA_DIR)
    monkeypatch.delenv("CS_PAIRWISE_DEVICE_MIN", raising=False)
    try:
        _, r, grids = _golden(tmp_path, n, device_min, **override)
    finally:
        os.environ.pop("CS_PAIRWISE_DEVICE_MIN", None)
    gold = readdlm(os.path.join(VERIFY, f"sgVerify{n}_resistances.out"))
    check_resistances(gold, r, 1e-6, label=f"sgVerify{n}")
    check_resistances(gold, readdlm(str(tmp_path / "t" /
                                        f"sgVerify{n}_resistances.out")),
                      1e-6, label=f"sgVerify{n} (written)")
    assert bool(grids) == (n not in (12, 15))
    for suffix in grids:
        _check_grid(tmp_path / "t" / f"sgVerify{n}{suffix}",
                    read_aagrid(os.path.join(VERIFY, f"sgVerify{n}{suffix}")),
                    f"sgVerify{n}{suffix}")


@pytest.mark.parametrize("n", [5, 8, 10, 11])
def test_golden_regions_follow_jax(tmp_path, monkeypatch, n):
    """Polygons plus focal regions on the device path, where the JAX
    package's device path departs from the golden.  sgVerify5 and 8:
    resistances and current maps held to the golden, voltage maps to
    the JAX package's (its in_comp mask zeroes region cells that carry
    no grid label).  sgVerify10 and 11: a region's first-listed cell is
    NODATA, so the JAX package leaves its pairs at -1; resistances and
    every grid are held to the JAX package's, -1 where it has -1."""
    monkeypatch.chdir(DATA_DIR)
    try:
        cfg, r, grids = _golden(tmp_path, n, 1)
        (tmp_path / "j").mkdir()
        rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j" /
                                                   f"sgVerify{n}.out")))
    finally:
        os.environ.pop("CS_PAIRWISE_DEVICE_MIN", None)
    assert grids == [f for f in _written(tmp_path / "j", f"sgVerify{n}")
                     if f.endswith(".asc")]
    if n in (10, 11):
        np.testing.assert_array_equal(r == -1, rj == -1)
        assert (r[1:, 1:] == -1).any()
        check_resistances(rj, r, 1e-6, label=f"sgVerify{n} (JAX)")
    else:
        gold = readdlm(os.path.join(VERIFY, f"sgVerify{n}_resistances.out"))
        check_resistances(gold, r, 1e-6, label=f"sgVerify{n}")
    for suffix in grids:
        ref_dir = (tmp_path / "j" if n in (10, 11) or "voltmap" in suffix
                   else VERIFY)
        _check_grid(tmp_path / "t" / f"sgVerify{n}{suffix}",
                    read_aagrid(os.path.join(ref_dir, f"sgVerify{n}{suffix}")),
                    f"sgVerify{n}{suffix}")
