"""The golden corpus through circuitscape_tpu_torch on the CPU: raster
pairwise and advanced, on both solver tiers, at the default thresholds,
at the tolerances of tests/test_golden.py (resistances elementwise within
sqrt(1e-6), every written grid within a sum-of-squares difference of
1e-6, network current files by sorted rows).

Outputs go to tmp_path (output_file rewritten), never to tests/data/
output, which tests/test_golden.py and tests/test_golden_mesh.py wipe.
Two INIs name GeoTIFF inputs (sgVerify1's polygon file, mgVerify3's
habitat, source, ground and polygon files): both run on them.
One-to-all, all-to-one and network goldens:
tests/test_torch_golden_o2a.py, test_torch_network.py.
"""

import os

import numpy as np
import pytest
import torch

import circuitscape_tpu_torch as cst
from golden_utils import DATA_DIR, check_resistances, readdlm
# golden_utils.compare_all_output's rules on a directory of our own
from torch_golden import compare_outputs

torch.set_num_threads(1)

VERIFY = os.path.join(DATA_DIR, "output_verify")
SOLVERS = ["cg+amg", "cholmod"]
TOL = 1e-6

def run_golden(tmp_path, monkeypatch, ini, solver):
    """Run a corpus INI (cwd tests/data) through the port on the CPU with
    the solver overridden and outputs in tmp_path; returns (stem,
    result)."""
    monkeypatch.chdir(DATA_DIR)
    stem = os.path.basename(ini)[:-4]
    cfg = cst.parse_config(ini).to_dict()
    cfg.update(solver=solver, suppress_messages="True",
               output_file=str(tmp_path / f"{stem}.out"))
    return stem, cst.compute(cfg, device="cpu")


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("i", list(range(1, 18)))
def test_raster_pairwise(tmp_path, monkeypatch, solver, i):
    stem, r = run_golden(tmp_path, monkeypatch,
                         f"input/raster/pairwise/{i}/sgVerify{i}.ini", solver)
    x = readdlm(os.path.join(VERIFY, f"{stem}_resistances.out"))
    written = readdlm(str(tmp_path / f"{stem}_resistances.out"))
    check_resistances(written, r, TOL, label=f"{stem} (written)")
    check_resistances(x, r, TOL, label=f"{stem} (verify)")
    compare_outputs(tmp_path, stem)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("i", list(range(1, 7)))
def test_raster_advanced(tmp_path, monkeypatch, solver, i):
    stem, v = run_golden(tmp_path, monkeypatch,
                         f"input/raster/advanced/{i}/mgVerify{i}.ini", solver)
    assert np.all(np.isfinite(v))
    assert compare_outputs(tmp_path, stem) > 0
