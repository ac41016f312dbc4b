"""circuitscape_tpu_torch pair solve against the JAX package on the CPU:
the whole mixed-precision solve (f32 MG-CG inner passes inside the f64
refinement loop) on a random gmap with NODATA holes, and the chunked CG
driver that backs it up."""

import numpy as np
import pytest
import torch
from scipy.ndimage import label

import jax.numpy as jnp

from circuitscape_tpu.solve import prepare as jpr
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch.solve import prepare as tpr
from circuitscape_tpu_torch.solve import stencil as tst

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)


def _problem(H, W, seed, npairs):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.10] = 0.0
    lab, _ = label(g > 0, structure=np.ones((3, 3), int))
    main = np.argmax(np.bincount(lab[lab > 0]))
    act = np.argwhere(lab == main)
    pick = act[rng.choice(len(act), npairs + 1, replace=False)]
    src = np.repeat(pick[:1], npairs, axis=0)
    return g, src, pick[1:]


@pytest.mark.parametrize("npairs", [1, 3])
def test_pair_solve_matches_jax(npairs):
    """(d) voltages to 1e-5 of max|V| (both sides stop at a true relative
    residual of 1e-6, with different f32 rounding); iteration counts
    within 2."""
    g, src, dst = _problem(200, 200, 21, npairs)
    S_j, prec_j, apply_j, _ = jpr.prepare_stencil_solver_from_gmap(
        g, False, False)
    Xj, relj, itj = jst.stencil_solve_pairs(S_j, src, dst, prec=prec_j,
                                            prec_apply=apply_j)
    S_t, prec_t, apply_t, _ = tpr.prepare_stencil_solver_from_gmap(
        g, False, False, "cpu")
    Xt, relt, itt = tst.stencil_solve_pairs(S_t, src, dst, prec=prec_t,
                                            prec_apply=apply_t)
    assert Xt.dtype == torch.float64
    assert relt.max() <= 1e-6 and relj.max() <= 1e-6
    Vj = np.asarray(Xj)[:npairs]
    Vt = Xt[:npairs].numpy()
    assert np.abs(Vt - Vj).max() <= 1e-5 * np.abs(Vj).max()
    assert abs(int(itt) - int(itj)) <= 2, (itt, itj)


def test_stencil_cg_matches_jax():
    """The chunked driver (the fused solve's fallback) with the V-cycle
    and a per-column tolerance array."""
    g, src, dst = _problem(96, 120, 22, 2)
    S_j, prec_j, apply_j, _ = jpr.prepare_stencil_solver_from_gmap(
        g, False, False)
    S_t, prec_t, apply_t, _ = tpr.prepare_stencil_solver_from_gmap(
        g, False, False, "cpu")
    H, W = S_t.shape
    sc, dc = np.zeros((2, 2), np.int64), np.zeros((2, 2), np.int64)
    sc[:], dc[:] = src, dst
    B = np.asarray(jst._pairs_rhs(jnp.asarray(sc), jnp.asarray(dc), H, W,
                                  2), np.float32)
    rtol = np.array([1e-4, 1e-3])
    Xj, relj, itj = jst.stencil_cg(prec_j.levels[0].A, jnp.asarray(B), rtol,
                                   chunk=3, prec=prec_j, prec_apply=apply_j)
    Xt, relt, itt = tst.stencil_cg(prec_t.levels[0].A, torch.as_tensor(B),
                                   rtol, chunk=3, prec=prec_t,
                                   prec_apply=apply_t)
    assert np.all(relt.numpy() <= rtol) and np.all(np.asarray(relj) <= rtol)
    assert abs(int(itt) - int(itj)) <= 2
    Xj = np.asarray(Xj)
    assert np.abs(Xt.numpy() - Xj).max() <= 1e-3 * np.abs(Xj).max()


def test_jacobi_cg_without_hierarchy():
    """No hierarchy given: Jacobi-preconditioned inner passes still
    reach the target (stencil_solve_pairs' default, as in JAX)."""
    g, src, dst = _problem(64, 64, 23, 2)
    S_t, _, _, _ = tpr.prepare_stencil_solver_from_gmap(g, False, False,
                                                        "cpu")
    X, rel, it = tst.stencil_solve_pairs(S_t, src, dst)
    assert rel.max() <= 1e-6 and it > 0
    R = (tst._pairs_rhs(torch.as_tensor(src), torch.as_tensor(dst),
                        *S_t.shape, 2) - tst.stencil_matvec(S_t, X))
    assert float(R.abs().max()) < 1e-5


def test_prepare_buckets_and_records_stats():
    from circuitscape_tpu_torch import stats
    g, _, _ = _problem(150, 90, 24, 1)
    stats.reset()
    S, prec, _, shape0 = tpr.prepare_stencil_solver_from_gmap(
        g, False, True, "cpu")
    assert shape0 == (150, 90) and S.shape == (256, 128)
    assert S.diag.dtype == torch.float64
    assert prec.levels[0].A.diag.dtype == torch.float32
    st = stats.finalize()
    assert st["cells"] == 256 * 128
    assert st["mg_kernels"] == ["torch"] * len(prec.levels)
    assert st["fine_nnz"] == jst.stencil_activity_stats(
        np.pad(np.where(g > 0, g, 0.0), ((0, 106), (0, 38))), True)


def test_prepare_refuses_grids_above_the_device_build():
    with pytest.raises(NotImplementedError, match="item 11"):
        tpr.prepare_stencil_solver_from_gmap(
            np.ones((1100, 1100)), False, False, "cpu")
