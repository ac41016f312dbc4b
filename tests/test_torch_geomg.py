"""circuitscape_tpu_torch geometric multigrid against the JAX package on
the CPU: the device hierarchy build level by level, and the V-cycle run
on exactly the JAX hierarchy (carried across with from_jax_numpy)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circuitscape_tpu.solve import geomg as jmg
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch.solve import geomg as tmg
from circuitscape_tpu_torch.solve import stencil as tst

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

F32_TOL = 1e-5   # float32, sum order differs between XLA and torch


def _operators(H, W, seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.12] = 0.0
    S32 = jst._to_dtype(jst.stencil_from_gmap_device(jnp.asarray(g), False,
                                                     False), jnp.float32)
    T32 = tst.operator_from_numpy([np.asarray(p) for p in
                                   (S32.we, S32.ws, S32.wse, S32.wne,
                                    S32.diag)])
    return S32, T32


def _carry(hier):
    """The JAX hierarchy as the numpy arrays from_jax_numpy takes."""
    levels = [dict(we=np.asarray(L.A.we), ws=np.asarray(L.A.ws),
                   wse=np.asarray(L.A.wse), wne=np.asarray(L.A.wne),
                   diag=np.asarray(L.A.diag),
                   inv_diag=np.asarray(L.inv_diag), lam_max=L.lam_max)
              for L in hier.levels]
    return tmg.from_jax_numpy(levels, np.asarray(hier.coarse_pinv),
                              hier.coarse_shape, hier.overcorrect)


# (100, 70): odd sides on the way down (50x35 -> 25x18 -> 13x9), the
# odd-size padding and edge-parity routing; (128, 128): the bucketed
# shape of a small job
@pytest.mark.parametrize("shape", [(100, 70), (128, 128)])
def test_device_build_matches_jax(shape):
    """(c) per-level planes, inv_diag and lam_max, coarse shape and
    pseudo-inverse."""
    S32, T32 = _operators(*shape, seed=3)
    ref = jmg.build_geo_mg_device(S32)
    got = tmg.build_geo_mg_device(T32)
    assert len(got.levels) == len(ref.levels)
    assert got.coarse_shape == tuple(ref.coarse_shape)
    for k, (Lr, Lt) in enumerate(zip(ref.levels, got.levels)):
        for name in ("we", "ws", "wse", "wne", "diag"):
            r = np.asarray(getattr(Lr.A, name))
            t = getattr(Lt.A, name).numpy()
            assert t.shape == r.shape, (k, name)
            assert np.abs(t - r).max() <= F32_TOL * np.abs(r).max(), \
                (k, name)
        r = np.asarray(Lr.inv_diag)
        assert np.abs(Lt.inv_diag.numpy() - r).max() <= \
            F32_TOL * np.abs(r).max()
        assert abs(Lt.lam_max - Lr.lam_max) <= F32_TOL * Lr.lam_max, k
    pr = np.asarray(ref.coarse_pinv)
    assert np.abs(got.coarse_pinv.numpy() - pr).max() <= \
        F32_TOL * np.abs(pr).max()


@pytest.mark.parametrize("B", [1, 3])
def test_vcycle_on_carried_hierarchy_matches_jax(B):
    """geomg_apply of this package on the JAX hierarchy itself."""
    S32, _ = _operators(100, 70, seed=4)
    hier = jmg.build_geo_mg_device(S32)
    rng = np.random.default_rng(5)
    R = rng.standard_normal((B, 100, 70)).astype(np.float32)
    ref = np.asarray(jmg.geomg_apply(hier, jnp.asarray(R)))
    got = tmg.geomg_apply(_carry(hier), torch.as_tensor(R)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()


def test_vcycle_on_own_hierarchy_matches_jax():
    S32, T32 = _operators(128, 128, seed=6)
    rng = np.random.default_rng(7)
    R = rng.standard_normal((2, 128, 128)).astype(np.float32)
    ref = np.asarray(jmg.geomg_apply(jmg.build_geo_mg_device(S32),
                                     jnp.asarray(R)))
    got = tmg.geomg_apply(tmg.build_geo_mg_device(T32),
                          torch.as_tensor(R)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(6, 8), (7, 9)])
def test_restrict_prolong_match_jax(shape):
    rng = np.random.default_rng(8)
    r = rng.standard_normal((2,) + shape)
    np.testing.assert_allclose(
        tmg._restrict(torch.as_tensor(r)).numpy(),
        np.asarray(jmg._restrict(jnp.asarray(r))), rtol=1e-12, atol=1e-12)
    xc = rng.standard_normal((2, -(-shape[0] // 2), -(-shape[1] // 2)))
    np.testing.assert_array_equal(
        tmg._prolong(torch.as_tensor(xc), *shape).numpy(),
        np.asarray(jmg._prolong(jnp.asarray(xc), *shape)))


def test_dense_coarse_solve_helpers_match_jax():
    rng = np.random.default_rng(9)
    planes = [rng.uniform(0, 1, (5, 6)) for _ in range(4)]
    A = tmg._dense_laplacian(*planes)
    np.testing.assert_array_equal(A, jmg._dense_laplacian(*planes))
    np.testing.assert_allclose(tmg._sym_pinv(A), jmg._sym_pinv(A),
                               rtol=1e-10, atol=1e-10)
