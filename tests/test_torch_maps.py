"""Maps-on and exclude-pair pairwise jobs of circuitscape_tpu_torch against
the JAX package on the CPU: node currents, the ASC writer, whole jobs of
the bench recipe through both packages on the stencil device path
(CS_PAIRWISE_DEVICE_MIN=1), checkpoint resume, and the sgVerify4 and
sgVerify13 goldens.  Every job writes under tmp_path."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from circuitscape_tpu.graph import build as jbuild
from circuitscape_tpu.io import raster as jraster
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch.io import raster as traster
from circuitscape_tpu_torch.solve import stencil as tst
from golden_utils import DATA_DIR, check_resistances, read_aagrid, readdlm

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

NODATA = -9999.0


def _bench_job(d, H, W, npoints, seed=42):
    """bench.py's recipe at a small size: conductance raster with ~10%
    NODATA and npoints focal points, as NPY files in d."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.10] = NODATA
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


def _written(d, stem):
    """Suffixes of the files a job with output_file <d>/<stem>.out
    wrote."""
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


def test_node_currents_match_jax():
    rng = np.random.default_rng(31)
    g = rng.uniform(0.5, 3.0, (37, 53))
    g[rng.random(g.shape) < 0.15] = 0.0
    V = rng.standard_normal((3, 37, 53))
    S = jst.stencil_from_gmap_device(jnp.asarray(g), False, False)
    T = tst.stencil_from_gmap_device(torch.as_tensor(g), False, False)
    ref = np.asarray(jst.stencil_node_currents(S, jnp.asarray(V)))
    got = tst.stencil_node_currents(T, torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    ref = np.asarray(jst.stencil_node_currents(S, jnp.asarray(V),
                                               out_dtype=jnp.float32))
    got = tst.stencil_node_currents(T, torch.as_tensor(V),
                                    out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # a polygon map: merged-node currents (tests/test_torch_poly.py holds
    # the per-column case)
    poly = np.zeros(g.shape, np.int64)
    poly[3:9, 4:12] = 1
    poly[20:30, 40:45] = 2
    nm = jbuild.construct_node_map(g, poly)
    ref = np.asarray(jst.stencil_node_currents(
        S, jnp.asarray(V), proj=jst.build_poly_projector(nm)))
    got = tst.stencil_node_currents(T, torch.as_tensor(V),
                                    proj=tst.build_poly_projector(nm))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_write_aagrid_matches_jax(tmp_path):
    rng = np.random.default_rng(32)
    a = rng.standard_normal((7, 5)).astype(np.float32) * 1e3
    a[0, 0] = NODATA
    transform = (10.0, 2.5, 0.0, 40.0, 0.0, -2.5)
    traster.write_raster(str(tmp_path / "t"), a, "", transform, "asc")
    jraster.write_raster(str(tmp_path / "j"), a, "", transform, "asc")
    t, j = (tmp_path / "t.asc").read_text(), (tmp_path / "j.asc").read_text()
    assert t.splitlines()[:6] == j.splitlines()[:6]
    # the JAX package's native formatter writes float32 with 9 digits,
    # this one with 12: both read back to the same float32 values
    np.testing.assert_array_equal(
        read_aagrid(tmp_path / "t.asc").astype(np.float32),
        read_aagrid(tmp_path / "j.asc").astype(np.float32))
    np.testing.assert_array_equal(
        read_aagrid(tmp_path / "t.asc").astype(np.float32), a)
    # write_as_tif: both packages write the same GeoTIFF bytes
    traster.write_raster(str(tmp_path / "t"), a, "", transform, "tif")
    jraster.write_raster(str(tmp_path / "j"), a, "", transform, "tif")
    assert (tmp_path / "t.tif").read_bytes() == \
        (tmp_path / "j.tif").read_bytes()
    np.testing.assert_array_equal(
        traster.read_raster(str(tmp_path / "t.tif"))[0], a)


def _run_both(tmp_path, cfg):
    rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                     device="cpu")
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    return rt, rj


def _assert_jobs_agree(tmp_path, rt, rj, map_tol=1e-5):
    assert rt.dtype == rj.dtype and rt.shape == rj.shape
    np.testing.assert_array_equal(rt[0], rj[0])
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= 1e-5
    files = _written(tmp_path, "t")
    assert files == _written(tmp_path, "j")
    for suffix in files:
        if suffix.endswith(".asc"):
            _grids_agree(read_aagrid(tmp_path / f"t{suffix}"),
                         read_aagrid(tmp_path / f"j{suffix}"), suffix,
                         map_tol)
        elif suffix.endswith(".tif"):
            _grids_agree(jraster.read_raster(str(tmp_path / f"t{suffix}"))[0],
                         jraster.read_raster(str(tmp_path / f"j{suffix}"))[0],
                         suffix, map_tol)
    return files


@pytest.mark.parametrize("case", ["pair_maps_null", "cum_only_log",
                                  "exclude_no_maps", "pair_maps_tif"])
def test_maps_job_matches_jax(tmp_path, monkeypatch, case):
    """A 150x130, 6-point bench-recipe job through both packages on the
    stencil device path: resistances to 1e-5 relative, the same files,
    every map (ASC, or GeoTIFF with write_as_tif) to 1e-5 of its max."""
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    cfg = _bench_job(str(tmp_path), 150, 130, 6)
    if case == "pair_maps_null":
        cfg.update(write_cur_maps="True", write_volt_maps="True",
                   write_max_cur_maps="True",
                   set_null_currents_to_nodata="True",
                   set_null_voltages_to_nodata="True")
    elif case == "cum_only_log":
        cfg.update(write_cum_cur_map_only="True", log_transform_maps="True")
    elif case == "pair_maps_tif":
        cfg.update(write_cur_maps="True", write_volt_maps="True",
                   write_as_tif="True")
    else:
        pairs = tmp_path / "pairs.txt"
        pairs.write_text("mode exclude\n1 2\n3 5\n")
        cfg.update(use_included_pairs="True",
                   included_pairs_file=str(pairs))
    rt, rj = _run_both(tmp_path, cfg)
    # linear maps: both solves reach rtol 1e-6, and the currents agree to
    # ~3e-7 of their max.  log10 turns that absolute error into a
    # relative one: at cells carrying 1e-5 of the max current the two
    # packages' currents differ by ~1e-3 relative, ~4e-4 in log10 per
    # pair, summed over the pairs of the cumulative map (measured
    # 2.6e-3 against a max |map| of 70), so log maps get 1e-4 of max
    files = _assert_jobs_agree(tmp_path, rt, rj,
                               1e-4 if case == "cum_only_log" else 1e-5)
    maps = [f for f in files if f.endswith(".asc")]
    if case == "pair_maps_null":
        assert len(maps) == 2 * 15 + 2           # per pair, cum, max
    elif case == "cum_only_log":
        assert maps == ["_cum_curmap.asc"]
    elif case == "pair_maps_tif":
        assert maps == []
        assert len([f for f in files if f.endswith(".tif")]) == 2 * 15 + 1
    else:
        assert maps == []
        assert rt[1, 2] == rt[2, 1] == -1        # excluded: never solved


def test_maps_resume_matches_jax(tmp_path, monkeypatch):
    """A checkpointed maps job in 1-pair chunks, killed at its third
    solve (after the first chunk's maps and pairs were saved), resumes
    without re-solving and agrees with the JAX package's clean run,
    cumulative map included."""
    from circuitscape_tpu_torch.solve import stencil
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    cfg = _bench_job(str(tmp_path), 40, 36, 4)
    cfg.update(write_cum_cur_map_only="True", write_max_cur_maps="True",
               max_parallel="1")
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    cfg.update(output_file=str(tmp_path / "t.out"),
               checkpoint_file=str(tmp_path / "t.ckpt.npz"))

    solve = stencil.stencil_solve_pairs
    calls = []

    def killed_at_third(*a, **k):
        calls.append(len(a[1]))
        if len(calls) > 2:
            raise KeyboardInterrupt("simulated kill")
        return solve(*a, **k)

    monkeypatch.setattr(stencil, "stencil_solve_pairs", killed_at_third)
    with pytest.raises(KeyboardInterrupt):
        cst.compute(cfg, device="cpu")
    assert os.path.exists(cfg["checkpoint_file"])

    calls.clear()
    monkeypatch.setattr(stencil, "stencil_solve_pairs",
                        lambda *a, **k: calls.append(len(a[1])) or
                        solve(*a, **k))
    rt = cst.compute(cfg, device="cpu")
    assert calls == [1] * 5                  # 6 pairs, the first restored
    assert not os.path.exists(cfg["checkpoint_file"])
    _assert_jobs_agree(tmp_path, rt, rj)


def test_maps_chunk_bytes_sets_batch_width(tmp_path, monkeypatch):
    """CS_MAPS_CHUNK_BYTES sets the maps path's chunk budget, as in the
    JAX package: two of the port's columns' worth of bytes
    (COLUMN_BYTES_PER_CELL + 8 a cell each; the JAX package's 72-B
    model floors the same budget to 2 as well) gives chunks of 2 pairs
    in both packages, and the same answers."""
    from circuitscape_tpu.solve import stencil as jstencil
    from circuitscape_tpu_torch.solve import stencil
    from circuitscape_tpu_torch.solve.dispatch import COLUMN_BYTES_PER_CELL
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    monkeypatch.setenv("CS_MAPS_CHUNK_BYTES",
                       str(2 * 40 * 36 * (COLUMN_BYTES_PER_CELL + 8)))
    cfg = _bench_job(str(tmp_path), 40, 36, 4)
    cfg.update(write_cum_cur_map_only="True")
    widths = {"t": [], "j": []}
    for mod, key in ((stencil, "t"), (jstencil, "j")):
        solve = mod.stencil_solve_pairs
        monkeypatch.setattr(mod, "stencil_solve_pairs",
                            lambda *a, _s=solve, _k=key, **k:
                            widths[_k].append(len(a[1])) or _s(*a, **k))
    rt, rj = _run_both(tmp_path, cfg)
    assert widths == {"t": [2, 2, 2], "j": [2, 2, 2]}
    _assert_jobs_agree(tmp_path, rt, rj)


@pytest.mark.parametrize("ini,stem", [
    ("input/raster/pairwise/4/sgVerify4.ini", "sgVerify4"),
    ("input/raster/pairwise/13/sgVerify13.ini", "sgVerify13"),
])
def test_golden_maps(tmp_path, monkeypatch, ini, stem):
    """sgVerify4 (maps on, 4 neighbours, several components) and
    sgVerify13 (included pairs, mask, maps on) on the device path at the
    reference's tolerances: resistances within sqrt(1e-6), every written
    grid within a sum-of-squares difference of 1e-6 of its golden
    (compare_all_output's grid rule), and the same grids written as the
    JAX package writes."""
    monkeypatch.setenv("CS_PAIRWISE_DEVICE_MIN", "1")
    monkeypatch.chdir(DATA_DIR)
    cfg = cst.parse_config(ini).to_dict()
    cfg.update(output_file=str(tmp_path / f"{stem}.out"),
               suppress_messages="True")
    r = cst.compute(cfg, device="cpu")
    (tmp_path / "jax").mkdir()
    cs.compute(dict(cfg, output_file=str(tmp_path / "jax" / f"{stem}.out")))
    verdir = os.path.join(DATA_DIR, "output_verify")
    gold = readdlm(os.path.join(verdir, f"{stem}_resistances.out"))
    check_resistances(gold, r, 1e-6, label=stem)
    check_resistances(gold, readdlm(str(tmp_path / f"{stem}_resistances.out")),
                      1e-6, label=f"{stem} (written)")
    grids = [f for f in _written(tmp_path, stem) if f.endswith(".asc")]
    assert grids and grids == [f for f in _written(tmp_path / "jax", stem)
                               if f.endswith(".asc")]
    for suffix in grids:
        mine = read_aagrid(tmp_path / f"{stem}{suffix}")
        ref = read_aagrid(os.path.join(verdir, f"{stem}{suffix}"))
        d2 = float(((mine - ref) ** 2).sum())
        assert d2 < 1e-6, f"{stem}{suffix}: grid sum-sq diff {d2}"
