"""circuitscape_tpu_torch's large-grid route against the JAX package on
the CPU.  Grids above CS_DEVICE_MG_MAX cells build their multigrid
hierarchy on the host in float64 (geomg.build_geo_mg) under a fine level
cast from the device-built operator (prepare._prepare_large_single, and
the pen-aware branch of prepare_stencil_solver_from_gmap_pen).  Both
packages read the threshold at call time, so a low setting sends small
grids down the route in both: the host build array for array (float32
planes, diagonals and inverse diagonals equal, lams equal, the coarse
pseudo-inverse to 1e-12), the solves and whole jobs at F32_TOL with the
JAX package's CG iteration counts.  Last, a shortcut job whose fine level
is wider than 4094 cells (the width where the fused smoother gives way
to cheb_step and matvec)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from chip_smoke import make_job
from circuitscape_tpu import stats as jstats
from circuitscape_tpu.solve import geomg as jmg
from circuitscape_tpu.solve import prepare as jpr
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch import stats as tstats
from circuitscape_tpu_torch.solve import geomg as tmg
from circuitscape_tpu_torch.solve import prepare as tpr
from circuitscape_tpu_torch.solve import stencil as tst

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

F32_TOL = 1e-5   # float32, sum order differs between XLA and torch
PINV_TOL = 1e-12


def _grid(H, W, seed, nodata=0.1):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < nodata] = 0.0
    return g, rng


def _pen_field(g, rng, n=7):
    """Finite ground conductances on active cells, one of them nearly
    direct (a penalty-sized value)."""
    pen = np.zeros(g.shape)
    act = np.argwhere(g > 0)
    for k, (r, c) in enumerate(act[rng.choice(len(act), n,
                                              replace=False)]):
        pen[r, c] = 1e8 if k == 0 else rng.uniform(0.2, 5.0)
    return pen


def assert_same_hierarchy(got, ref):
    """Every level's five float32 planes and inv_diag equal to the JAX
    package's, lams equal, the coarse shape equal and the float32 coarse
    pseudo-inverse within PINV_TOL of max |pinv|."""
    assert len(got.levels) == len(ref.levels)
    for k, (Lt, Lr) in enumerate(zip(got.levels, ref.levels)):
        for name in ("we", "ws", "wse", "wne", "diag"):
            t = getattr(Lt.A, name)
            assert t.dtype == torch.float32, (k, name)
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(getattr(Lr.A, name)),
                err_msg=f"level {k} {name}")
        np.testing.assert_array_equal(Lt.inv_diag.numpy(),
                                      np.asarray(Lr.inv_diag),
                                      err_msg=f"level {k} inv_diag")
        assert Lt.lam_max == Lr.lam_max, k
        assert Lt.fused == tmg.fused_smoother_supported(Lt.A.shape)
    assert got.coarse_shape == tuple(ref.coarse_shape)
    pr = np.asarray(ref.coarse_pinv)
    assert got.coarse_pinv.dtype == torch.float32
    assert np.abs(got.coarse_pinv.numpy() - pr).max() <= \
        PINV_TOL * np.abs(pr).max()


@pytest.mark.parametrize("four,avg", [(False, False), (True, True),
                                      (False, True)])
def test_host_planes_match_jax(four, avg):
    """stencil_planes_np and stencil_matvec_np, the host build's input
    and its power iteration's product: equal to the bit."""
    g, rng = _grid(37, 53, 1)
    got = tst.stencil_planes_np(g, avg, four)
    ref = jst.stencil_planes_np(g, avg, four)
    for t, r in zip(got, ref):
        np.testing.assert_array_equal(t, r)
    x = rng.standard_normal((2, 37, 53))
    np.testing.assert_array_equal(
        tst.stencil_matvec_np(tst.StencilOperator(*got), x),
        jst.stencil_matvec_np(jst.StencilOperator(*ref), x))


# (100, 70): odd sides on the way down (50x35 -> 25x18 -> 13x9: the
# coarsest level has odd sides); (128, 128): a bucketed shape; (9, 300):
# levels of fewer than 64 rows (the generic smoother) and odd sides
# (9 x 300 -> 5 x 150 -> a 3 x 75 coarsest level)
@pytest.mark.parametrize("shape", [(100, 70), (128, 128), (9, 300)])
@pytest.mark.parametrize("pen", [False, True])
def test_host_build_matches_jax(shape, pen):
    """build_geo_mg from the same host planes, with and without a ground
    field baked into every level."""
    g, rng = _grid(*shape, seed=3)
    planes = tst.stencil_planes_np(g, False, False)
    pen_np = _pen_field(g, rng) if pen else None
    ref = jmg.build_geo_mg(planes_np=planes, pen_np=pen_np)
    got = tmg.build_geo_mg(planes, pen_np=pen_np)
    assert_same_hierarchy(got, ref)
    assert got.coarse_shape == {(100, 70): (13, 9), (128, 128): (16, 16),
                                (9, 300): (3, 75)}[shape]


@pytest.mark.parametrize("pen", [False, True])
def test_host_build_with_fine_device_ops_matches_jax(pen):
    """Level 0 taken from the float32 cast of the device-built float64
    operator (with the penalty added in float32, as the pen-aware setup
    does), its inv_diag computed on the device; the coarser levels from
    the host planes."""
    g, rng = _grid(128, 128, seed=5)
    pen_np = _pen_field(g, rng) if pen else np.zeros(g.shape)
    S32 = jst._to_dtype(jst.stencil_from_gmap_device(jnp.asarray(g), False,
                                                     False), jnp.float32)
    pen32 = jnp.asarray(pen_np, jnp.float32)
    jops = (S32.we, S32.ws, S32.wse, S32.wne, S32.diag + pen32)
    tops = tuple(torch.as_tensor(np.array(p)) for p in jops)
    planes = jst.stencil_planes_np(g, False, False)
    ref = jmg.build_geo_mg(planes_np=planes, fine_device_ops=jops,
                           pen_np=pen_np if pen else None)
    got = tmg.build_geo_mg(planes, fine_device_ops=tops,
                           pen_np=pen_np if pen else None)
    assert_same_hierarchy(got, ref)


@pytest.mark.parametrize("B", [1, 3])
def test_vcycle_on_host_hierarchy_matches_jax(B):
    """Each package's V-cycle on its own host-built hierarchy of the
    odd-sided (100, 70) grid, whose coarsest level is 13 x 9."""
    g, _ = _grid(100, 70, seed=6)
    planes = tst.stencil_planes_np(g, False, False)
    R = np.random.default_rng(7).standard_normal(
        (B, 100, 70)).astype(np.float32)
    ref = np.asarray(jmg.geomg_apply(jmg.build_geo_mg(planes_np=planes),
                                     jnp.asarray(R)))
    got = tmg.geomg_apply(tmg.build_geo_mg(planes),
                          torch.as_tensor(R)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()


def test_prepare_large_single_matches_jax(monkeypatch):
    """The whole large-grid setup with CS_DEVICE_MG_MAX = 0 in both
    packages: the same float64 operator (1e-13), the same hierarchy,
    recorded as host-built; then a pair solve through both setups to
    F32_TOL of max |V| with the same CG iteration count."""
    monkeypatch.setenv("CS_DEVICE_MG_MAX", "0")
    g, _ = _grid(130, 140, seed=5)
    tstats.reset()
    S_t, prec_t, apply_t, shp_t = tpr.prepare_stencil_solver_from_gmap(
        g, False, False, "cpu")
    S_j, prec_j, apply_j, shp_j = jpr.prepare_stencil_solver_from_gmap(
        g, False, False)
    assert shp_t == tuple(shp_j) == (130, 140)
    assert tstats.finalize()["mg_build"] == "host"
    for name in ("we", "ws", "wse", "wne", "diag"):
        r = np.asarray(getattr(S_j, name))
        assert np.abs(getattr(S_t, name).numpy() - r).max() <= \
            1e-13 * np.abs(r).max()
    assert_same_hierarchy(prec_t, prec_j)

    from scipy.ndimage import label
    lab, _ = label(g > 0, structure=np.ones((3, 3), int))
    act = np.argwhere(lab == np.argmax(np.bincount(lab[lab > 0])))
    pts = act[[10, len(act) // 2, -10]]
    sc, dc = pts[[0, 0]], pts[[1, 2]]
    Xt, relt, itt = tst.stencil_solve_pairs(S_t, sc, dc, prec=prec_t,
                                            prec_apply=apply_t)
    Xj, relj, itj = jst.stencil_solve_pairs(S_j, sc, dc, prec=prec_j,
                                            prec_apply=apply_j)
    assert relt.max() <= 1e-6 and relj.max() <= 1e-6
    Vj = np.asarray(Xj)[:2]
    assert np.abs(Xt[:2].numpy() - Vj).max() <= F32_TOL * np.abs(Vj).max()
    assert int(itt) == int(itj)


def test_prepare_pen_large_matches_jax(monkeypatch):
    """The pen-aware setup on the host-built route: the ground field
    resolved as in the JAX package (direct grounds at the penalty), and
    the penalty-baked hierarchy equal to the JAX package's."""
    monkeypatch.setenv("CS_DEVICE_MG_MAX", "0")
    g, rng = _grid(100, 120, seed=8)
    spec = _pen_field(g, rng)
    spec[spec == 1e8] = np.inf
    tstats.reset()
    S_t, prec_t, _, shp, pen_t = tpr.prepare_stencil_solver_from_gmap_pen(
        g, False, False, spec, "cpu")
    S_j, prec_j, _, _, pen_j = jpr.prepare_stencil_solver_from_gmap_pen(
        g, False, False, spec)
    assert shp == (100, 120) and tstats.finalize()["mg_build"] == "host"
    np.testing.assert_allclose(pen_t, pen_j, rtol=1e-13, atol=0)
    assert_same_hierarchy(prec_t, prec_j)


def test_pairwise_job_large_route_matches_jax(tmp_path, monkeypatch):
    """A 150 x 130, 6-point bench-recipe shortcut job through both
    packages' compute with CS_DEVICE_MG_MAX = 1: resistances to F32_TOL
    relative and the same total CG iterations (the JAX package runs its
    refinement passes inside one device loop, so only the total is
    visible there)."""
    monkeypatch.setenv("CS_DEVICE_MG_MAX", "1")
    cfg, _ = make_job(str(tmp_path), 150, 130, npoints=6)
    cfg["suppress_messages"] = "True"
    rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                     device="cpu")
    st = tstats.finalize()
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    sj = jstats.finalize()
    assert st["mg_build"] == "host"
    assert rt.shape == rj.shape == (7, 7)
    np.testing.assert_array_equal(rt[0], rj[0])
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= \
        F32_TOL
    assert st["cg_iters"] == sj["cg_iters"] == sum(st["pass_iters"])


def test_advanced_job_large_route_matches_jax(tmp_path, monkeypatch):
    """tests/test_torch_advanced.py's 80 x 80 advanced job on both
    packages' device paths with CS_DEVICE_MG_MAX = 1 (the penalty-baked
    hierarchy built on the host): voltages and both maps to F32_TOL of
    max, every CG pass at the JAX package's count on its own inputs."""
    from golden_utils import read_aagrid
    from test_torch_advanced import _advanced_job, both_passes, \
        replay_passes
    monkeypatch.setenv("CS_ADVANCED_DEVICE_MIN", "1")
    monkeypatch.setenv("CS_DEVICE_MG_MAX", "1")
    cfg = _advanced_job(tmp_path)
    with both_passes() as (t, j):
        vt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                         device="cpu")
        assert tstats.finalize()["mg_build"] == "host"
        vj = np.asarray(cs.compute(dict(cfg,
                                        output_file=str(tmp_path / "j.out"))))
    assert vt.shape == vj.shape == (80, 80)
    assert np.abs(vt - vj).max() <= F32_TOL * np.abs(vj).max()
    replay_passes(t, j)
    for f in ("curmap.asc", "voltmap.asc"):
        a = read_aagrid(tmp_path / f"t_{f}")
        b = read_aagrid(tmp_path / f"j_{f}")
        assert np.abs(a - b).max() <= F32_TOL * np.abs(b).max(), f


def test_wide_fine_level_job_matches_jax(tmp_path, monkeypatch):
    """A 128 x 4200 shortcut job (padded to 128 x 4224): its fine level
    is wider than 4094 cells, so the V-cycle smooths it with cheb_step
    and matvec (fused_smoother_supported), the coarser levels with the
    fused kernels.  Resistances to F32_TOL relative, the same CG
    iterations as the JAX package."""
    monkeypatch.delenv("CS_DEVICE_MG_MAX", raising=False)
    cfg, _ = make_job(str(tmp_path), 128, 4200, npoints=4, seed=3)
    cfg["suppress_messages"] = "True"
    rt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                     device="cpu")
    st = tstats.finalize()
    rj = cs.compute(dict(cfg, output_file=str(tmp_path / "j.out")))
    sj = jstats.finalize()
    assert st["cells"] == 128 * 4224 and st["mg_build"] == "device"
    assert np.all(np.isfinite(rt[1:, 1:]))
    assert np.max(np.abs(rt - rj) / np.maximum(np.abs(rj), 1e-30)) <= \
        F32_TOL
    assert st["cg_iters"] == sj["cg_iters"]
