"""Network pairwise and advanced through circuitscape_tpu_torch on the
CPU: the six network goldens on both solver tiers (at the default
routing, cg+amg networks of at most CS_NETWORK_DIRECT_MAX nodes run the
native Cholesky; with CS_NETWORK_DIRECT_MAX=0 the iterative tier), and a
lattice network pairwise job on the iterative tier in both packages.
Outputs go to tmp_path."""

import os

import numpy as np
import pytest
import torch

import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from chip_smoke import make_network_job, record_passes
from circuitscape_tpu.solve import dispatch as jdispatch
from circuitscape_tpu_torch.solve import dispatch as tdispatch
from golden_utils import check_resistances, readdlm
from test_torch_golden import TOL, VERIFY, compare_outputs, run_golden

torch.set_num_threads(1)

TIERS = [("cg+amg", None), ("cg+amg", "0"), ("cholmod", None)]


@pytest.mark.parametrize("solver,direct_max", TIERS)
@pytest.mark.parametrize("i", [1, 2, 3])
def test_network_pairwise(tmp_path, monkeypatch, solver, direct_max, i):
    if direct_max is not None:
        monkeypatch.setenv("CS_NETWORK_DIRECT_MAX", direct_max)
    stem, r = run_golden(tmp_path, monkeypatch,
                         f"input/network/sgNetworkVerify{i}.ini", solver)
    x = readdlm(os.path.join(VERIFY, f"{stem}_resistances.out"))
    check_resistances(x[1:, 1:], r[1:, 1:], TOL, label=stem)
    assert np.array_equal(x[1:, 0] + 1, r[1:, 0])
    assert compare_outputs(tmp_path, stem) > 0


@pytest.mark.parametrize("solver,direct_max", TIERS)
@pytest.mark.parametrize("i", [1, 2, 3])
def test_network_advanced(tmp_path, monkeypatch, solver, direct_max, i):
    if direct_max is not None:
        monkeypatch.setenv("CS_NETWORK_DIRECT_MAX", direct_max)
    stem, r = run_golden(tmp_path, monkeypatch,
                         f"input/network/mgNetworkVerify{i}.ini", solver)
    x = readdlm(os.path.join(VERIFY, f"{stem}_voltages.txt")).copy()
    x[:, 0] += 1
    check_resistances(x, r, TOL, label=stem)
    assert compare_outputs(tmp_path, stem) > 0


def test_lattice_network_matches_jax(tmp_path, monkeypatch):
    """A 1024-node lattice network (side 32, 6 focal nodes, cg+amg,
    single precision) on the iterative tier (CS_NETWORK_DIRECT_MAX=0) in
    both packages: the same CG iteration count on each pass, resistances
    to 1e-5 relative, every per-pair and cumulative current file to 1e-5
    of its max."""
    monkeypatch.setenv("CS_NETWORK_DIRECT_MAX", "0")
    cfg = make_network_job(str(tmp_path), n=1024, nfocal=6)
    with record_passes(mod=tdispatch, fn="cg_batched") as rt:
        t = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                        device="cpu")
    with record_passes(mod=jdispatch, fn="cg_batched") as rj:
        j = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    assert rt.iters == rj.iters and len(rt.iters) == 1
    off = ~np.eye(6, dtype=bool)
    rel = np.abs(t[1:, 1:] - j[1:, 1:])[off] / np.abs(j[1:, 1:])[off]
    assert rel.max() <= 1e-5
    names = sorted(f[2:] for f in os.listdir(tmp_path)
                   if f.startswith("t_") and f.endswith(".txt"))
    assert len(names) == 2 * 15 + 2
    for f in names:
        a = readdlm(str(tmp_path / f"t_{f}"))
        b = readdlm(str(tmp_path / f"j_{f}"))
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), f
