"""circuitscape_tpu_torch stands alone: importing it loads no JAX, no
module of it (or chip_smoke.py, profile_torch.py, torch_golden.py,
bench_torch.py, bench_suite_torch.py, bench_capacity_torch.py,
compare_residual_init.py) imports JAX, circuitscape_tpu, bench_suite.py,
bench_capacity.py or tests/golden_utils.py (which imports
circuitscape_tpu), and
its entry points run on CUDA unless the caller asks for the CPU.  Also
the host-side modules copied from the JAX package, against it."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from child_env import one_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "circuitscape_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, n) for n in (
        "chip_smoke.py", "profile_torch.py", "torch_golden.py",
        "bench_torch.py", "bench_suite_torch.py",
        "bench_capacity_torch.py", "compare_residual_init.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_import_leaves_jax_out():
    """(g) a fresh interpreter imports the package and every module of
    it without pulling in jax or circuitscape_tpu."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import circuitscape_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'circuitscape_tpu' or "
        "m.startswith('circuitscape_tpu.')]\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=one_thread(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_golden_replay_leaves_jax_out():
    """torch_golden.py's whole replay (on the CPU here, on the card on a
    machine without JAX) loads neither jax nor circuitscape_tpu."""
    code = (
        "import sys, torch_golden\n"
        "rc = torch_golden.main(['--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'circuitscape_tpu' or "
        "m.startswith('circuitscape_tpu.') or m == 'golden_utils']\n"
        "print('LOADED', bad, rc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=one_thread(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED [] 0" in out.stdout, out.stdout


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    """(g) no port file imports jax, circuitscape_tpu (other than
    circuitscape_tpu_torch), bench_suite or golden_utils, at any depth of
    the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "circuitscape_tpu",
                               "bench_suite", "bench_capacity",
                               "golden_utils"), \
                f"{path}:{node.lineno} imports {n}"


@pytest.mark.parametrize("rel", ["utils.py", "warmup.py", "tui.py",
                                 "parallel/__init__.py", "parallel/mesh.py"])
def test_source_scan_covers_the_whole_surface(rel):
    """The JAX-import scan above reaches every module of the port's
    surface, the mesh package included."""
    assert os.path.join(PKG, rel) in _port_files()


def test_compute_defaults_to_cuda():
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch.run import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cst.compute({"data_type": "raster"})
    assert resolve_device("cpu") == torch.device("cpu")


def test_new_entry_points_default_to_cuda(tmp_path):
    """compute_omniscape_current and warmup run on CUDA unless given
    device="cpu", and raise without a card; the mesh spans CUDA devices
    only."""
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu_torch.parallel import mesh
    from circuitscape_tpu_torch.warmup import warmup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    g = np.ones((3, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cst.compute_omniscape_current(g, g, g, {"data_type": "raster"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warmup({"data_type": "raster", "habitat_file": "x"})
    assert mesh.visible_devices() == []
    assert mesh.active_mesh(10 ** 8) is None
    for name in ("compute", "start", "compute_omniscape_current",
                 "calculate_cum_current_map", "calculate_max_current_map",
                 "register_solver"):
        assert name in cst.__all__ and callable(getattr(cst, name))


def test_config_round_trip_matches_jax(tmp_path):
    import circuitscape_tpu as cs
    import circuitscape_tpu_torch as cst
    ini = os.path.join(ROOT, "tests", "data", "input", "raster",
                       "pairwise", "4", "sgVerify4.ini")
    a, b = cst.parse_config(ini), cs.parse_config(ini)
    assert a.to_dict() == b.to_dict()
    a.output_file = str(tmp_path / "t.out")
    b.output_file = str(tmp_path / "j.out")
    cst.write_config(a)
    cs.write_config(b)
    ta = (tmp_path / "t.out").read_text().replace("t.out", "X")
    tb = (tmp_path / "j.out").read_text().replace("j.out", "X")
    assert ta == tb


def test_loaders_match_jax():
    """load_raster_data and the node map / components of the corpus
    raster the golden test runs."""
    import circuitscape_tpu as cs
    import circuitscape_tpu_torch as cst
    from circuitscape_tpu.drivers import raster as jr
    from circuitscape_tpu.graph import build as jb
    from circuitscape_tpu.io import loaders as jl
    from circuitscape_tpu_torch.drivers import raster as tr
    from circuitscape_tpu_torch.graph import build as tb
    from circuitscape_tpu_torch.io import loaders as tl
    data = os.path.join(ROOT, "tests", "data")
    cwd = os.getcwd()
    os.chdir(data)
    try:
        ini = "input/raster/pairwise/4/sgVerify4.ini"
        dt = tl.load_raster_data(cst.parse_config(ini), np.float64)
        dj = jl.load_raster_data(cs.parse_config(ini), np.float64)
    finally:
        os.chdir(cwd)
    np.testing.assert_array_equal(dt.cellmap, dj.cellmap)
    for a, b in zip(dt.points_rc, dj.points_rc):
        np.testing.assert_array_equal(a, b)
    nt = tb.construct_node_map(dt.cellmap, dt.polymap)
    np.testing.assert_array_equal(nt, jb.construct_node_map(dj.cellmap,
                                                            dj.polymap))
    ct = tr._grid_components(dt.cellmap, nt, True)
    cj = jr._grid_components(dj.cellmap, nt, True)
    assert len(ct) == len(cj)
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a, b)
    lt = tr.LazyStencilGraph(dt.cellmap, nt, True, True, np.float64)
    lj = jr.LazyStencilGraph(dj.cellmap, nt, True, True, np.float64)
    assert abs(lt.tocsr() - lj.tocsr()).max() == 0


def test_three_column_writer_matches_jax():
    from circuitscape_tpu import out as jo
    from circuitscape_tpu_torch import out as to
    rng = np.random.default_rng(1)
    r = rng.uniform(0, 5, (6, 6))
    r[0, 1:] = r[1:, 0] = [3, 4, 8, 9, 11]
    np.testing.assert_array_equal(to.compute_3col(r), jo.compute_3col(r))


def test_shortcut_reconstruction_matches_jax():
    """update_shortcut_resistances on a synthetic anchor solve."""
    from circuitscape_tpu.drivers import core as jc
    from circuitscape_tpu_torch.drivers import core as tc
    rng = np.random.default_rng(2)
    n = 5
    points = np.arange(1, n + 1)
    res = -np.ones((n, n))
    res[0, 1:] = res[1:, 0] = rng.uniform(1, 3, n - 1)
    volt = rng.uniform(0, 1, (n, n))
    out = []
    for mod in (tc, jc):
        sc = -np.ones((n, n))
        mod.update_shortcut_resistances(
            0, mod._Shortcut(True, volt.copy(), sc), res.copy(), points,
            points)
        out.append(sc)
    np.testing.assert_array_equal(out[0], out[1])


def test_update_voltmatrix_matches_jax():
    from circuitscape_tpu.drivers import core as jc
    from circuitscape_tpu_torch.drivers import core as tc
    rng = np.random.default_rng(3)
    points = np.array([4, 9, 2, 7])
    comp = np.array([2, 4, 7, 9, 11])
    volts = rng.uniform(0, 1, comp.size)
    out = []
    for mod in (tc, jc):
        vm = np.zeros((4, 4))
        o = mod._Output(points, volts, (1, 2), (0, 1), 1.7, 2)
        mod.update_voltmatrix(mod._Shortcut(True, vm, vm.copy()), o,
                              mod.ComponentData(comp, None, None, None,
                                                None))
        out.append(vm)
    np.testing.assert_array_equal(out[0], out[1])
    assert np.count_nonzero(out[0]) == 3
