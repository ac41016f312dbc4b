"""circuitscape_tpu_torch stencil layer against the JAX package on the CPU:
the device plane build, and the plain version of each CUDA kernel
against the Pallas kernel it replaces (run in interpret mode, as
tests/test_stencil.py runs them).

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circuitscape_tpu.solve import pallas_stencil as jps
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch.solve import cuda_stencil as cs
from circuitscape_tpu_torch.solve import stencil as tst

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

F32_TOL = 1e-5   # float32, sum order differs between XLA and torch


def _gmap(H, W, seed, holes=0.15):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < holes] = 0.0
    return g


@pytest.mark.parametrize("avg_res", [False, True])
@pytest.mark.parametrize("four", [False, True])
def test_plane_build_matches_jax(avg_res, four):
    """(a) stencil_from_gmap_device, float64, on a grid with odd sides."""
    g = _gmap(37, 53, 1)
    ref = jst.stencil_from_gmap_device(jnp.asarray(g), avg_res, four)
    got = tst.stencil_from_gmap_device(torch.as_tensor(g), avg_res, four)
    assert got.diag.dtype == torch.float64
    for name in ("we", "ws", "wse", "wne", "diag"):
        r = np.asarray(getattr(ref, name))
        t = getattr(got, name).numpy()
        np.testing.assert_allclose(t, r, rtol=1e-12, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_matvec_matches_jax(dtype):
    """Plain matvec in both precisions (the f64 one is the refinement
    residual's operator)."""
    g = _gmap(40, 29, 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 40, 29))
    S = jst.stencil_from_gmap_device(jnp.asarray(g), False, False)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ref = np.asarray(jst.stencil_matvec(jst._to_dtype(S, jdt),
                                        jnp.asarray(x, jdt)))
    T = tst._to_dtype(tst.stencil_from_gmap_device(torch.as_tensor(g),
                                                   False, False), dtype)
    got = tst.stencil_matvec(T, torch.as_tensor(x, dtype=dtype)).numpy()
    tol = F32_TOL if dtype == torch.float32 else 1e-12
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _kernel_inputs(B, H=128, W=256, seed=11):
    """A float32 operator for both packages, its Dinv, and blocks."""
    g = _gmap(H, W, seed, holes=0.1)
    S = jst.stencil_from_gmap(g, False, False, jnp.float32)
    T = tst.operator_from_numpy([np.asarray(p) for p in
                                 (S.we, S.ws, S.wse, S.wne, S.diag)])
    diag = np.asarray(S.diag)
    dinv = np.where(diag > 0, 1.0 / np.where(diag == 0, 1, diag),
                    0.0).astype(np.float32)
    rng = np.random.default_rng(seed + B)
    blocks = [rng.standard_normal((B, H, W)).astype(np.float32)
              for _ in range(3)]
    return S, T, dinv, blocks


def _close(got, ref, label):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, label
    err = np.abs(got - ref).max()
    assert err <= F32_TOL * np.abs(ref).max(), f"{label}: {err}"


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_matvec_plain_matches_pallas(B):
    S, T, _, (x, _, _) = _kernel_inputs(B)
    ref = jps.pallas_matvec(jps.PallasStencil.from_operator(S),
                            jnp.asarray(x), interpret=True)
    _close(cs.matvec_plain(T, torch.as_tensor(x)), ref, "matvec")
    # on CPU tensors the wrapper is its plain version
    _close(cs.matvec(T, torch.as_tensor(x)), ref, "matvec wrapper")


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_matvec_pap_plain_matches_pallas(B):
    S, T, _, (x, _, _) = _kernel_inputs(B)
    y_ref, pap_ref = jps.pallas_matvec_pap(
        jps.PallasStencil.from_operator(S), jnp.asarray(x), interpret=True)
    y, pap = cs.matvec_pap(T, torch.as_tensor(x))
    _close(y, y_ref, "matvec_pap y")
    _close(pap, pap_ref, "matvec_pap pAp")
    assert pap.shape == (B,)


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_cheb_step_plain_matches_pallas(B):
    S, T, dinv, (r, d, x) = _kernel_inputs(B)
    ca, cb = 0.37, 1.21
    ref = jps.pallas_cheb_step(jps.PallasStencil.from_operator(S),
                               jnp.asarray(dinv), jnp.asarray(r),
                               jnp.asarray(d), jnp.asarray(x), ca=ca, cb=cb,
                               interpret=True)
    got = cs.cheb_step(T, torch.as_tensor(dinv), torch.as_tensor(r),
                       torch.as_tensor(d), torch.as_tensor(x), ca, cb)
    for g_, r_, name in zip(got, ref, ("r", "d", "x")):
        _close(g_, r_, f"cheb_step {name}")


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_residual_restrict_plain_matches_pallas(B):
    S, T, _, (b, x, _) = _kernel_inputs(B)
    ref = jps.pallas_residual_restrict(jps.PallasStencil.from_operator(S),
                                       jnp.asarray(b), jnp.asarray(x),
                                       interpret=True)
    got = cs.residual_restrict(T, torch.as_tensor(b), torch.as_tensor(x))
    _close(got, ref, "residual_restrict")


@pytest.mark.parametrize("shape", [(37, 53), (36, 53), (37, 52)])
def test_residual_restrict_odd_sides_match_restrict(shape):
    """The TPU gates its fused kernel to even H and W % 256 == 0; the
    port's serves every level, restricting odd sides as the XLA
    _restrict (zero-padded, output ceil(H/2) x ceil(W/2))."""
    from circuitscape_tpu.solve.geomg import _restrict
    H, W = shape
    g = _gmap(H, W, 5)
    S = jst.stencil_from_gmap(g, False, False, jnp.float32)
    T = tst.operator_from_numpy([np.asarray(p) for p in
                                 (S.we, S.ws, S.wse, S.wne, S.diag)])
    rng = np.random.default_rng(6)
    b, x = (rng.standard_normal((2, H, W)).astype(np.float32)
            for _ in range(2))
    ref = _restrict(jnp.asarray(b) - jst.stencil_matvec(S, jnp.asarray(x)))
    got = cs.residual_restrict(T, torch.as_tensor(b), torch.as_tensor(x))
    assert tuple(got.shape) == (2, -(-H // 2), -(-W // 2))
    _close(got, ref, "residual_restrict odd")


def test_launch_counters_ignore_plain_calls():
    """Counters move only where a kernel launches: CPU tensors take the
    plain versions and leave every count at zero."""
    S, T, dinv, (r, d, x) = _kernel_inputs(2, 64, 96)
    cs.reset_launch_counts()
    xt = torch.as_tensor(x)
    cs.matvec(T, xt)
    cs.matvec_pap(T, xt)
    cs.cheb_step(T, torch.as_tensor(dinv), xt, xt, xt, 0.5, 0.5)
    cs.residual_restrict(T, xt, xt)
    assert set(cs.LAUNCHES) == {"matvec", "matvec_pap", "cheb_step",
                                "residual_restrict", "cheb_init",
                                "residual_init", "cheb_finish"}
    assert all(v == 0 for v in cs.LAUNCHES.values())


def test_pairs_rhs_and_point_voltages_match_jax():
    H, W, b_pad = 20, 30, 4
    sc = np.array([[1, 2], [3, 4], [5, 6], [0, 0]])
    dc = np.array([[7, 8], [9, 10], [5, 6], [0, 0]])
    ref = np.asarray(jst._pairs_rhs(jnp.asarray(sc), jnp.asarray(dc),
                                    H, W, b_pad))
    got = tst._pairs_rhs(torch.as_tensor(sc), torch.as_tensor(dc), H, W,
                         b_pad)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((b_pad, H, W))
    pc = np.array([[1, 2], [7, 8], [11, 12]])
    Vr, vr = jst._extract_point_voltages(jnp.asarray(X), jnp.asarray(sc),
                                         jnp.asarray(pc))
    Vt, vt = tst._extract_point_voltages(torch.as_tensor(X),
                                         torch.as_tensor(sc),
                                         torch.as_tensor(pc))
    np.testing.assert_array_equal(Vt.numpy(), np.asarray(Vr))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))


def test_activity_stats_match_jax():
    g = _gmap(31, 45, 8)
    for four in (False, True):
        assert (tst.stencil_activity_stats(g, four) ==
                jst.stencil_activity_stats(g, four))
