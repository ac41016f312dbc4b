"""The premultiplied-Dinv Chebyshev smoother of circuitscape_tpu_torch
against the JAX package on the CPU: the plain version of each of its
three CUDA kernels against the Pallas kernel it replaces (interpret
mode, on the recipe of tests/test_stencil.py's round-5 differentials),
the plane expansion, and the V-cycle in the fused configuration.

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circuitscape_tpu.solve import geomg as jmg
from circuitscape_tpu.solve import pallas_stencil as jps
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch.solve import cuda_stencil as cs
from circuitscape_tpu_torch.solve import geomg as tmg
from circuitscape_tpu_torch.solve import stencil as tst

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

F32_TOL = 1e-5   # float32, sum order differs between XLA and torch


def _coefficients(lmax=2.0):
    """c, ca, cb of the degree-2 smoother (geomg._cheb_smooth) at
    lam_max = 2.0, the production default of the fine levels."""
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    rho_new = 1.0 / (2.0 * sigma - rho)
    return (float(1.0 / theta), float(rho_new * rho),
            float(2.0 * rho_new / delta))


def _inputs(B, H=128, W=256, seed=11):
    """tests/test_stencil.py:590-599's recipe: a float32 operator for
    both packages (the JAX one with its init planes), Dinv, x and b."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 2.0, (H, W))
    g[rng.random((H, W)) < 0.1] = 0.0
    S = jst.stencil_from_gmap(g, False, False, jnp.float32)
    P = jps.PallasStencil.from_operator(S, with_init=True)
    T = tst.operator_from_numpy([np.asarray(p) for p in
                                 (S.we, S.ws, S.wse, S.wne, S.diag)])
    diag = np.asarray(S.diag)
    dinv = np.where(diag > 0, 1.0 / np.where(diag == 0, 1, diag),
                    0.0).astype(np.float32)
    x = rng.standard_normal((B, H, W)).astype(np.float32)
    b = rng.standard_normal((B, H, W)).astype(np.float32)
    return S, P, T, dinv, x, b


def _close(got, ref, label):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, label
    err = np.abs(got - ref).max()
    assert err <= F32_TOL * np.abs(ref).max(), f"{label}: {err}"


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_cheb_init_plain_matches_pallas(B):
    _, P, T, dinv, _, b = _inputs(B)
    c, ca, cb = _coefficients()
    ref = jps.pallas_cheb_init(P.init_planes, jnp.asarray(dinv),
                               jnp.asarray(b), c=c, ca=ca, cb=cb,
                               interpret=True)
    got = cs.cheb_init(T, torch.as_tensor(dinv), torch.as_tensor(b), c, ca,
                       cb)
    _close(got, ref, "cheb_init")


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_residual_init_plain_matches_pallas(B):
    _, P, T, dinv, x, b = _inputs(B)
    c, _, _ = _coefficients()
    r_ref, x1_ref = jps.pallas_residual_init(P, jnp.asarray(dinv),
                                             jnp.asarray(b), jnp.asarray(x),
                                             c=c, interpret=True)
    r0, x1 = cs.residual_init(T, torch.as_tensor(dinv), torch.as_tensor(b),
                              torch.as_tensor(x), c)
    _close(r0, r_ref, "residual_init r0")
    _close(x1, x1_ref, "residual_init x1")


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_cheb_finish_plain_matches_pallas(B):
    _, P, T, dinv, x, b = _inputs(B)
    c, ca, cb = _coefficients()
    # r0 and x1 as the V-cycle hands them over: pass 1 of the same step
    r0, x1 = cs.residual_init_plain(T, torch.as_tensor(dinv),
                                    torch.as_tensor(b), torch.as_tensor(x), c)
    ref = jps.pallas_cheb_finish(P.init_planes, jnp.asarray(dinv),
                                 jnp.asarray(r0.numpy()),
                                 jnp.asarray(x1.numpy()), c=c, ca=ca, cb=cb,
                                 interpret=True)
    got = cs.cheb_finish(T, torch.as_tensor(dinv), r0, x1, c, ca, cb)
    _close(got, ref, "cheb_finish")


@pytest.mark.parametrize("shape", [(128, 256), (37, 53)])
def test_expand_planes_match_jax(shape):
    """The nine planes against the JAX expansions, cropped from their
    row padding to (H, W): with Dinv = 1 against the plain planes (each
    product by 1 is exact), and premultiplied by Dinv."""
    H, W = shape
    S, _, T, dinv, _, _ = _inputs(1, H, W, seed=12)
    ref = np.asarray(jps._expand_planes(S.we, S.ws, S.wse, S.wne,
                                        S.diag))[:, :H, :W]
    np.testing.assert_array_equal(
        cs.expand_planes(T, torch.ones((H, W))).numpy(), ref)
    ref = np.asarray(jps._expand_planes_dinv(
        S.we, S.ws, S.wse, S.wne, S.diag, jnp.asarray(dinv)))[:, :H, :W]
    # one float32 product per entry on both sides: equal to the bit
    np.testing.assert_array_equal(
        cs.expand_planes(T, torch.as_tensor(dinv)).numpy(), ref)


def test_launch_counters_of_smoother_ignore_plain_calls():
    _, _, T, dinv, x, b = _inputs(2, 64, 96)
    cs.reset_launch_counts()
    d, xt, bt = torch.as_tensor(dinv), torch.as_tensor(x), torch.as_tensor(b)
    r0, x1 = cs.residual_init(T, d, bt, xt, 0.8)
    cs.cheb_finish(T, d, r0, x1, 0.8, 0.3, 1.1)
    cs.cheb_init(T, d, bt, 0.8, 0.3, 1.1)
    assert all(cs.LAUNCHES[k] == 0 for k in ("cheb_init", "residual_init",
                                              "cheb_finish"))


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


@pytest.mark.parametrize("shape", [(100, 70), (128, 128)])
def test_fused_vcycle_matches_jax(shape):
    """geomg_apply with the fused smoother on its fine levels against
    the JAX V-cycle, which runs its generic configuration on the CPU."""
    S32, T32 = _operators(*shape, seed=21)
    ref_h = jmg.build_geo_mg_device(S32)
    got_h = tmg.build_geo_mg_device(T32)
    fused = [L.fused for L in got_h.levels]
    assert fused == [L.A.shape[0] >= 64 for L in got_h.levels]
    assert fused[0]
    rng = np.random.default_rng(22)
    R = rng.standard_normal((3,) + shape).astype(np.float32)
    ref = np.asarray(jmg.geomg_apply(ref_h, jnp.asarray(R)))
    got = tmg.geomg_apply(got_h, torch.as_tensor(R)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()


@pytest.mark.parametrize("B", [1, 4])
def test_fused_matches_generic_configuration(B):
    """The two smoother configurations of this package on one hierarchy
    differ only in rounding."""
    _, T32 = _operators(150, 130, seed=23)
    fused = tmg.build_geo_mg_device(T32)
    generic = tmg.build_geo_mg_device(T32, fused_smoother=False)
    assert any(L.fused for L in fused.levels)
    assert not any(L.fused for L in generic.levels)
    R = torch.as_tensor(np.random.default_rng(24).standard_normal(
        (B, 150, 130)).astype(np.float32))
    a = tmg.geomg_apply(fused, R).numpy()
    b = tmg.geomg_apply(generic, R).numpy()
    assert np.abs(a - b).max() <= F32_TOL * np.abs(b).max()


def test_fused_gates_follow_jax():
    """Rows >= 64 (the JAX init-plane gate) and columns <= 4094 (its
    kernel gate); the carried hierarchy takes the same flags."""
    assert tmg.fused_smoother_supported((64, 4094))
    assert not tmg.fused_smoother_supported((63, 100))
    assert not tmg.fused_smoother_supported((64, 4095))
    S32, _ = _operators(128, 128, seed=25)
    h = jmg.build_geo_mg_device(S32)
    levels = [dict(we=np.asarray(L.A.we), ws=np.asarray(L.A.ws),
                   wse=np.asarray(L.A.wse), wne=np.asarray(L.A.wne),
                   diag=np.asarray(L.A.diag),
                   inv_diag=np.asarray(L.inv_diag), lam_max=L.lam_max)
              for L in h.levels]
    on = tmg.from_jax_numpy(levels, np.asarray(h.coarse_pinv),
                            h.coarse_shape)
    off = tmg.from_jax_numpy(levels, np.asarray(h.coarse_pinv),
                             h.coarse_shape, fused_smoother=False)
    assert [L.fused for L in on.levels] == [True, True, False]
    assert not any(L.fused for L in off.levels)
