"""tests/test_golden_mesh.py's corpus subset through circuitscape_tpu_torch
on its virtual mesh: eight shards of the CPU, shaped (2, 4) like the JAX
package's eight virtual CPU devices, with the mesh forced on
(CS_FORCE_MESH=1) and the stencil device paths forced on
(CS_*_DEVICE_MIN=1), so the tiny corpus grids run the row-sharded
operator, the halo-exchange stencil and the batch-split right-hand
sides.  Resistances and every written grid at the reference's
tolerances; outputs in tmp_path."""

import os

import pytest
import torch

from circuitscape_tpu_torch import stats
from circuitscape_tpu_torch.parallel import mesh as tm
from golden_utils import check_resistances, readdlm
from test_torch_golden import VERIFY, compare_outputs, run_golden

torch.set_num_threads(1)

TOL = 1e-6


@pytest.fixture(autouse=True)
def _mesh_env(monkeypatch):
    monkeypatch.setattr(tm, "visible_devices",
                        lambda: [torch.device("cpu")] * 8)
    monkeypatch.setenv("CS_FORCE_MESH", "1")
    monkeypatch.delenv("CS_DISABLE_MESH", raising=False)
    monkeypatch.delenv("CS_MESH_SHAPE", raising=False)
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    monkeypatch.setenv("CS_ONETOALL_DEVICE_MIN", "1")


def _run(tmp_path, monkeypatch, ini, on_mesh=True):
    """on_mesh: the job takes the stencil device path, and so the mesh
    (oneToAllVerify6 takes the general tier in both packages)."""
    stem, r = run_golden(tmp_path, monkeypatch, ini, "cg+amg")
    kernels = stats.JOB.get("mg_kernels", [])
    assert any(k.endswith("/shard") for k in kernels) == on_mesh, kernels
    x = readdlm(os.path.join(VERIFY, f"{stem}_resistances.out"))
    check_resistances(x, r, TOL, label=f"{stem} (mesh)")
    compare_outputs(tmp_path, stem)


@pytest.mark.parametrize("i", [1, 2, 7, 14])
def test_raster_pairwise_mesh(tmp_path, monkeypatch, i):
    _run(tmp_path, monkeypatch,
         f"input/raster/pairwise/{i}/sgVerify{i}.ini")


@pytest.mark.parametrize("i", [1, 6])
def test_raster_one_to_all_mesh(tmp_path, monkeypatch, i):
    _run(tmp_path, monkeypatch,
         f"input/raster/one_to_all/{i}/oneToAllVerify{i}.ini", i != 6)


@pytest.mark.parametrize("i", [1])
def test_raster_all_to_one_mesh(tmp_path, monkeypatch, i):
    _run(tmp_path, monkeypatch,
         f"input/raster/all_to_one/{i}/allToOneVerify{i}.ini")
