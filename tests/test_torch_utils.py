"""circuitscape_tpu_torch.utils against the JAX package on the CPU: the
offline cum/max map tools write the JAX package's files byte for byte,
and the Omniscape entry compute_omniscape_current gives the JAX
package's current map on the general tier (the 3x3 window of
tests/test_internal.py) and on the stencil device path (a 220 x 220
window, above CS_ADVANCED_DEVICE_MIN), in single and double precision,
without writing a file.  Also the rest of the public surface:
register_solver reaches compute() by name, and the TF32 switch of the
coarse solve leaves an embedding program's setting alone."""

import os

import numpy as np
import pytest
import torch

import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst

torch.set_num_threads(1)

MAP_TOL = 1e-5   # of the map's max

HDR = ("ncols         {w}\nnrows         {h}\nxllcorner     0\n"
       "yllcorner     0\ncellsize      1\nNODATA_value  -9999\n")


def _write_pair_maps(d, rng, h=7, w=9, n=4):
    for k in range(n):
        m = rng.uniform(0, 3, (h, w))
        m[rng.random((h, w)) < 0.2] = -9999
        with open(os.path.join(d, f"job_curmap_1_{k + 2}.asc"), "w") as f:
            f.write(HDR.format(w=w, h=h))
            for row in m:
                f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
    # not a per-pair current map: both tools skip it
    with open(os.path.join(d, "job_voltmap_1_2.asc"), "w") as f:
        f.write(HDR.format(w=w, h=h) + "1\n")


@pytest.mark.parametrize("tool", ["calculate_cum_current_map",
                                  "calculate_max_current_map"])
def test_map_tools_write_jax_bytes(tmp_path, tool):
    files = {}
    for name, mod in (("torch", cst), ("jax", cs)):
        d = tmp_path / name
        d.mkdir()
        _write_pair_maps(str(d), np.random.default_rng(4))
        getattr(mod, tool)(str(d / "job.out"))
        op = "cum" if "cum" in tool else "max"
        files[name] = (d / f"{op}_{op}_curmap.asc").read_bytes()
    assert files["torch"] == files["jax"]
    assert len(files["torch"]) > 100


def test_map_tools_without_maps_write_nothing(tmp_path):
    cst.calculate_cum_current_map(str(tmp_path / "job.out"))
    assert os.listdir(tmp_path) == []


def _cfg(solver):
    return {
        "ground_file_is_resistances": "True",
        "use_direct_grounds": "False",
        "output_file": "temp",
        "write_cum_cur_map_only": "False",
        "scenario": "Advanced",
        "suppress_messages": "True",
        "connect_four_neighbors_only": "False",
        "solver": solver,
        "cholmod_batch_size": "1000",
        "data_type": "raster",
    }


@pytest.mark.parametrize("solver", ["cholmod", "cg+amg"])
def test_omniscape_small_window_matches_jax(tmp_path, monkeypatch, solver):
    """tests/test_internal.py's 3x3 window: the general tier in both
    packages (below CS_ADVANCED_DEVICE_MIN)."""
    monkeypatch.chdir(tmp_path)
    conductance = np.array([[1., 5, 1], [2, 1, 1], [9, 1, 6]])
    source = np.array([[1., 0, 0], [0, 0, 0], [0, 1, 0]])
    ground = np.array([[0., 0, 1], [0, 0, 0], [0, 0, 0]])
    got = cst.compute_omniscape_current(conductance, source, ground,
                                        _cfg(solver), device="cpu")
    ref = cs.compute_omniscape_current(conductance, source, ground,
                                       _cfg(solver))
    assert isinstance(got, np.ndarray) and got.shape == (3, 3)
    assert got.max() > 0
    assert np.abs(got - ref).max() <= MAP_TOL * np.abs(ref).max()
    assert os.listdir(tmp_path) == []


def _window(dtype, side=220, seed=6):
    """A moving window as Omniscape cuts it: resistance-derived
    conductance with nodata holes, a source of 1 on every habitat cell
    and one ground of value 1 at the centre."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (side, side))
    g[rng.random((side, side)) < 0.05] = 0.0
    c = side // 2
    g[c, c] = 1.0
    source = (g > 0).astype(np.float64)
    ground = np.zeros((side, side))
    ground[c, c] = 1.0
    return g.astype(dtype), source.astype(dtype), ground.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["single", "double"])
def test_omniscape_device_window_matches_jax(tmp_path, monkeypatch, dtype):
    """220 x 220 = 48,400 cells: the advanced stencil device path in both
    packages, its current map computed though no map output is asked
    for, within 1e-5 of max of the JAX package's; no file is written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CS_DISABLE_MESH", "1")   # one device in both
    from circuitscape_tpu_torch import stats
    g, s, gr = _window(dtype)
    stats.reset()
    got = cst.compute_omniscape_current(g, s, gr, _cfg("cg+amg"),
                                        device="cpu")
    assert stats.JOB.get("cg_iters"), "the window took the general tier"
    ref = cs.compute_omniscape_current(g, s, gr, _cfg("cg+amg"))
    assert got.dtype == dtype and got.shape == g.shape
    assert np.all(np.isfinite(got)) and got.max() > 0
    assert np.abs(got - ref).max() <= MAP_TOL * np.abs(ref).max()
    assert os.listdir(tmp_path) == []


class _FlagProbe:
    """Right operand of a matmul that reports the TF32 switches at the
    moment of the product."""

    def __rmatmul__(self, other):
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)


def test_tf32_switch_is_scoped_to_the_coarse_solve(tmp_path, monkeypatch):
    """full_precision_matmul turns TF32 off for its product only: a
    program that embeds the package keeps its own setting through a
    job (here the Omniscape entry, whose V-cycles run the coarse
    solve)."""
    from circuitscape_tpu_torch.solve.geomg import full_precision_matmul
    monkeypatch.chdir(tmp_path)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert full_precision_matmul(torch.ones(2, 2), _FlagProbe()) == \
            (False, False)
        g, s, gr = _window(np.float64, side=210)
        cst.compute_omniscape_current(g, s, gr, _cfg("cg+amg"),
                                      device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_solver_registry_extension(tmp_path):
    """register_solver is the plugin surface (tests/test_native.py's
    case): a registered tier is reachable from compute() by name and
    gives the JAX package's resistances."""
    import circuitscape_tpu as cs
    from circuitscape_tpu_torch.solve.dispatch import DirectSolver

    calls = {"n": 0}

    class TracingSolver(DirectSolver):
        name = "traced"

        def build(self, matrix, dtype, device=None):
            calls["n"] += 1
            return super().build(matrix, dtype, device)

    cst.register_solver("my_torch_ext_solver", TracingSolver,
                        "Solver used: traced")
    hdr = ("ncols 5\nnrows 5\nxllcorner 0\nyllcorner 0\ncellsize 1\n"
           "NODATA_value -9999\n")
    (tmp_path / "cell.asc").write_text(hdr + "\n".join(["1 1 1 1 1"] * 5))
    pts = ["1 0 0 0 2"] + ["0 0 0 0 0"] * 3 + ["3 0 0 0 0"]
    (tmp_path / "pts.asc").write_text(hdr + "\n".join(pts))
    d = {"data_type": "raster", "scenario": "pairwise",
         "habitat_file": str(tmp_path / "cell.asc"),
         "point_file": str(tmp_path / "pts.asc"),
         "output_file": str(tmp_path / "job.out"),
         "solver": "my_torch_ext_solver"}
    r = cst.compute(d, device="cpu")
    assert calls["n"] > 0, "custom solver was not used"
    ref = cs.compute(dict(d, solver="cholmod",
                          output_file=str(tmp_path / "jax.out")))
    assert np.all(np.abs(r - ref) <= 1e-9 * np.abs(ref).max())
