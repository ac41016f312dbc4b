"""The one-to-all and all-to-one goldens through circuitscape_tpu_torch
on the CPU, on both solver tiers, at the default thresholds and the
tolerances of tests/test_golden.py (results within sqrt(1e-6), every
written grid within a sum-of-squares difference of 1e-6).  Below
CS_ONETOALL_DEVICE_MIN cells, and with included pairs or merged points
at any size, these jobs take the per-point loop (drivers/onetoall.py
onetoall_kernel) on the general sparse-graph tier.  Outputs go to
tmp_path."""

import os

import pytest
import torch

from golden_utils import check_resistances, readdlm
from test_torch_golden import SOLVERS, TOL, VERIFY, compare_outputs, run_golden

torch.set_num_threads(1)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("kind,n", [("one_to_all", n) for n in range(1, 14)] +
                         [("all_to_one", n) for n in range(1, 13)])
def test_raster_one_to_all(tmp_path, monkeypatch, solver, kind, n):
    stem = {"one_to_all": "oneToAllVerify",
            "all_to_one": "allToOneVerify"}[kind] + str(n)
    _, r = run_golden(tmp_path, monkeypatch,
                      f"input/raster/{kind}/{n}/{stem}.ini", solver)
    x = readdlm(os.path.join(VERIFY, f"{stem}_resistances.out"))
    check_resistances(x, r, TOL, label=stem)
    compare_outputs(tmp_path, stem)
