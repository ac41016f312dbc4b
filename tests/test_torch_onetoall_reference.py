"""circuitscape_tpu_torch's one-to-all device path on the CPU against the
benchmark's plain reference (benchmark/reference/grid_onetoall.py: the
same semantics in float64, grounding all points at once and scaling
each harmonic by the current it draws), at 200 x 200 cells of the
TestArea1 mosaic with 6 points: the cumulative and max current maps as
written, and the (id, R) table compute() returns.

Limits, and the readings they rest on (this CPU, seeds 1 to 8 and two
island cases; the reference's TF32 control on the same jobs):

  number        program at most   control at least   limit
  cum_map_rel   8.1e-8            7.17e-5            2e-5
  max_map_rel   2.4e-7            1.60e-4            2e-5
  r_rel         7.0e-8            2.16e-4            5e-5

Each limit lies above the geometric mean of its two readings, with room
on both sides."""

import json
import os

import numpy as np
import pytest
import torch

import circuitscape_tpu_torch as cst
from benchmark import cells, check, inputs
from benchmark.reference import grid_onetoall as go
from circuitscape_tpu_torch import stats

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
with open(os.path.join(BENCH_DIR, "configs",
                       "testarea1_1M_onetoall.json")) as f:
    BASE = json.load(f)
CFG = dict(BASE, nrows=200, ncols=200, focal_points=6, landscapes=1)
TRAFFIC = cells.traffic("one_to_all_maps")
LIMITS = {"cum_map_rel": 2e-5, "max_map_rel": 2e-5, "r_rel": 5e-5}
# the island: a 5 x 5 patch of habitat inside a ring of NODATA, its own
# component, with the sixth point at its centre
ISLAND = (150, 150)


def _r_rel(got, want):
    """max |R - R_ref| / R_ref over the points with a resistance; inf
    where the ids, or which points have none (-1), differ."""
    if (got.shape != want.shape or
            not np.array_equal(got[:, 0], want[:, 0]) or
            not np.array_equal(got[:, 1] == -1, want[:, 1] == -1)):
        return float("inf")
    on = want[:, 1] > 0
    return float(np.max(np.abs(got[on, 1] - want[on, 1]) / want[on, 1]))


def _inputs(tmp_path, seed, island):
    """(job config, habitat file, point file) of one job."""
    files = inputs.JobInputs(str(tmp_path), CFG, TRAFFIC, seed, BENCH_DIR)
    job, habitat, points = files.job(0)
    if island:
        g, active = inputs.landscape(CFG, inputs.base_map(CFG, BENCH_DIR),
                                     CFG["pool_seed"], 0)
        r, c = ISLAND
        g[r - 3:r + 4, c - 3:c + 4] = inputs.NODATA
        g[r - 2:r + 3, c - 2:c + 3] = 7.0
        active = (g != inputs.NODATA) & (g > 0)
        active[r - 3:r + 4, c - 3:c + 4] = False
        pts = inputs.focal_cells(active, CFG["focal_points"] - 1, seed, 0)
        inputs.write_asc(habitat, g, CFG)
        inputs.write_points(points, pts + [ISLAND], CFG)
    return job, habitat, points


def _numbers(result, out_dir, ref):
    got = check.read_outputs(go, out_dir, TRAFFIC["compare"])
    numbers = check.compare(got, ref, TRAFFIC["compare"])
    numbers["r_rel"] = _r_rel(np.asarray(result, np.float64),
                              ref["resistances"])
    return numbers


@pytest.mark.parametrize("seed,island", [(1, False), (2, False),
                                         (5, True)],
                         ids=["seed1", "seed2", "island"])
def test_device_path_against_reference(tmp_path, monkeypatch, seed,
                                       island):
    monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", "1")
    job, habitat, points = _inputs(tmp_path, seed, island)
    result = cst.compute(job, device="cpu")
    st = stats.finalize()
    # the device fast path ran, every CG iteration on the hierarchy's own
    # operator (the harmonic columns: no per-column penalty body)
    assert st["stencil_solves"] == 1 and st["cg_iters"] > 0
    assert "pen_iters" not in st
    opts = check.graph_options(CFG)
    ref = go.pairwise(habitat, points, maps=True, **opts)
    numbers = _numbers(result, os.path.dirname(job["output_file"]), ref)
    ok, rows = check.judge(numbers, LIMITS)
    assert ok, rows
    assert (np.asarray(result)[:, 1] == -1).sum() == int(island)

    # the reference in TF32 in the program's place fails the same limits
    ctl = go.pairwise(habitat, points, maps=True, control=True, **opts)
    got = {"cum_curmap": ctl["cum"], "max_curmap": ctl["max"]}
    numbers = check.compare(got, ref, TRAFFIC["compare"])
    numbers["r_rel"] = _r_rel(ctl["resistances"], ref["resistances"])
    assert all(v > LIMITS[k] for k, v in numbers.items()), numbers
