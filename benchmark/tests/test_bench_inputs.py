"""The generator: the same seed gives the same files, the landscapes are
mosaics of the public source map, the ASC writer and the point lists read
back through circuitscape_tpu_torch's readers to the values and cells
generated, and no two jobs share their inputs."""

import json
import os

import numpy as np
import pytest

from benchmark import inputs
from circuitscape_tpu_torch.io import loaders, raster
from helpers import ROOT

BENCH_DIR = os.path.join(ROOT, "benchmark")
with open(os.path.join(BENCH_DIR, "configs", "testarea1_1M.json")) as f:
    CFG = dict(json.load(f), nrows=57, ncols=43, cellsize=2.5,
               xllcorner=100.0, yllcorner=-40.0, focal_points=7,
               landscapes=2)
BASE = inputs.base_map(CFG, BENCH_DIR)
TRAFFIC = {"scenario": "pairwise", "options": {}}


def test_base_map_is_the_public_file():
    """The copy of upstream's map is byte for byte the test corpus's, and
    its NODATA frame is what the crop takes off."""
    with open(os.path.join(BENCH_DIR, CFG["base_map"]), "rb") as f:
        copy = f.read()
    with open(os.path.join(ROOT, "tests", "data", "input", "raster",
                           "advanced", "7", "resistance_TestArea1.asc"),
              "rb") as f:
        assert f.read() == copy
    assert BASE.shape == (351, 478)
    assert BASE.min() == 1 and BASE.max() == 100


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -5, 2**70 + 3])
def test_asc_round_trip(tmp_path, seed):
    g, active = inputs.landscape(CFG, BASE, seed, 1)
    path = str(tmp_path / "g.asc")
    inputs.write_asc(path, g, CFG)
    arr, meta = raster.grid_reader(path)
    np.testing.assert_array_equal(arr, g)
    assert (meta.nrows, meta.ncols, meta.cellsize, meta.xllcorner,
            meta.yllcorner) == (57, 43, 2.5, 100.0, -40.0)
    assert active.all()


@pytest.mark.parametrize("seed", [3, 2**40 + 1])
def test_mosaic_mirrors_the_source(seed):
    """Every landscape is a window of the source map (or its transpose)
    mirrored at its edges: neighbours in the mosaic are neighbours, or
    the same cell, in the source."""
    cfg = dict(CFG, nrows=900, ncols=1100)
    g, _ = inputs.landscape(cfg, BASE, seed, 0)
    assert set(np.unique(g)) <= set(np.unique(BASE))
    for b in (BASE, BASE.T):
        ext = np.concatenate([b, b[::-1]], axis=0)
        ext = np.concatenate([ext, ext[:, ::-1]], axis=1)
        tiled = np.tile(ext, (5, 5))
        win = np.lib.stride_tricks.sliding_window_view(tiled, (12, 12))
        hit = np.argwhere((win[:ext.shape[0], :ext.shape[1]] ==
                           g[:12, :12]).all(axis=(2, 3)))
        for r, c in hit:
            if np.array_equal(tiled[r:r + 900, c:c + 1100], g):
                return
    raise AssertionError("the landscape is no mirrored window of the map")


def test_landscapes_differ():
    a = [inputs.landscape(CFG, BASE, 5, p)[0] for p in range(3)]
    b = inputs.landscape(CFG, BASE, 6, 0)[0]
    assert not any(np.array_equal(x, y) for x, y in
                   [(a[0], a[1]), (a[0], a[2]), (a[1], a[2]), (a[0], b)])


def test_asc_fields_wide_values(tmp_path):
    g = np.array([[0.5, 123.25, -9999.0], [7.0, 0.0, 99999.999]])
    path = str(tmp_path / "w.asc")
    inputs.write_asc(path, g, dict(CFG, decimals=3))
    np.testing.assert_array_equal(raster.grid_reader(path)[0], g)


def test_points_read_back(tmp_path):
    _, active = inputs.landscape(CFG, BASE, 9, 0)
    cells = inputs.focal_cells(active, 7, 9, 3)
    assert len(set(cells)) == 7 and all(active[r, c] for r, c in cells)
    gpath = str(tmp_path / "g.asc")
    inputs.write_asc(gpath, inputs.landscape(CFG, BASE, 9, 0)[0], CFG)
    ppath = str(tmp_path / "p.txt")
    inputs.write_points(ppath, cells, CFG)
    _, meta = raster.grid_reader(gpath)
    i, j, v = loaders.read_point_map(ppath, meta)
    assert list(v) == list(range(1, 8))
    assert [(r - 1, c - 1) for r, c in zip(i, j)] == cells


def test_same_seed_same_files(tmp_path):
    runs = []
    for d in ("a", "b"):
        files = inputs.JobInputs(str(tmp_path / d), CFG, TRAFFIC, 77,
                                 BENCH_DIR)
        pts = [files.job(k)[2] for k in (inputs.WARM, 0, 1, 2, 3, 4)]
        runs.append([open(files.habitat(p), "rb").read()
                     for p in range(2)] +
                    [open(p, "rb").read() for p in pts])
    assert runs[0] == runs[1]
    pts = runs[0][2:]
    assert len(set(pts)) == len(pts)
    other = inputs.JobInputs(str(tmp_path / "c"), CFG, TRAFFIC, 78,
                             BENCH_DIR)
    # another seed: the same landscapes (the pool's own seed), other points
    assert [open(other.habitat(p), "rb").read() for p in range(2)] == \
        runs[0][:2]
    assert open(other.job(0)[2], "rb").read() != runs[0][3]


def test_any_job_number_has_inputs(tmp_path):
    """Point lists are written as jobs ask for them: no speed of the
    program can run a window past its inputs."""
    files = inputs.JobInputs(str(tmp_path), CFG, TRAFFIC, 1, BENCH_DIR)
    for k in (0, 7, 10**6):
        cfg, habitat, points = files.job(k)
        assert habitat == files.habitat(k % 2) and os.path.isfile(points)
        assert cfg["point_file"] == points
