"""circuitscape_tpu_torch pair solve against the JAX package on the CPU:
the whole mixed-precision solve (f32 MG-CG inner passes inside the f64
refinement loop) on a random gmap with NODATA holes, and the chunked CG
driver that backs it up."""

import numpy as np
import pytest
import torch
from scipy.ndimage import label

import jax
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


F32 = np.float32
F32_MAX = np.finfo(F32).max


def _rounds_down_best():
    """A float32 best whose float32 product best * 0.999 lies below the
    float64 product of the same numbers: at worst equal to the float32
    product, float32 says "not improved" where float64 says "improved"."""
    for i in range(1, 1 << 16):
        best = F32(1.0) + F32(i) * np.finfo(F32).eps
        if float(best * F32(0.999)) < float(best) * 0.999:
            return best
    raise AssertionError("no float32 best rounds down")


_B = _rounds_down_best()
_T = _B * F32(0.999)              # the float32 stall threshold of _B
GUARD_CASES = [
    # (worst, best): the first best of the loop, and a first worst of inf
    (F32(np.inf), F32_MAX),
    (F32(3.0), F32_MAX),
    # worst at the float32 threshold of a best that rounds down, and one
    # float32 step either side of it
    (_T, _B),
    (np.nextafter(_T, F32(0)), _B),
    (np.nextafter(_T, F32(np.inf)), _B),
    # worst at best * 8 (exact in float32) and one step above it
    (F32(8e-3) * F32(8), F32(8e-3)),
    (np.nextafter(F32(8e-3) * F32(8), F32(np.inf)), F32(8e-3)),
    # ordinary values
    (F32(5e-4), F32(1e-3)),
    (F32(1e-3), F32(1e-3)),
    (F32(2e-2), F32(1e-3)),
    (F32(np.nan), F32(1e-3)),
]


@jax.jit
def _jax_guards(worst, best):
    """The JAX loop's divergence guard (in not_done) and stall test (in
    body), as circuitscape_tpu/solve/stencil.py writes them, on float32
    scalars."""
    return worst <= best * 8, worst < best * 0.999


@pytest.mark.parametrize("worst,best", GUARD_CASES)
def test_cg_guards_decide_as_jax(worst, best):
    """The port's CG guards compare in float32 as the JAX loop does: the
    same (worst, best) give the same decisions to continue and to count
    an improvement, and the same next best."""
    assert worst.dtype == best.dtype == F32
    bounded, improved = _jax_guards(jnp.asarray(worst, jnp.float32),
                                    jnp.asarray(best, jnp.float32))
    assert tst._cg_bounded(worst, best) == bool(bounded)
    assert tst._cg_improved(worst, best) == bool(improved)
    nxt = np.minimum(best, worst)
    jnxt = np.asarray(jnp.minimum(jnp.asarray(best, jnp.float32),
                                  jnp.asarray(worst, jnp.float32)))
    assert nxt.dtype == jnxt.dtype == F32
    np.testing.assert_array_equal(nxt, jnxt)


def test_cg_state_carries_best_in_float32():
    A = tst.stencil_from_gmap_device(torch.ones((4, 5)), False, False)
    A = tst._to_dtype(A, torch.float32)
    st = _port_state_init(A, torch.ones((2, 4, 5)))
    assert type(st.best) is F32 and st.best == F32_MAX


def _port_state_init(A, B):
    """The port's initial loop state: _cg_loop from none, to k = 0
    (Jacobi, tol 0, safe_bnorm 1)."""
    one = torch.ones(B.shape[0])
    return tst._cg_loop(A, B, None, torch.zeros_like(one), one, 0, 1000)


_LOOP_G = np.random.default_rng(5).uniform(0.5, 3.0, (6, 7))
_LOOP_B = np.random.default_rng(6).standard_normal((1, 6, 7)).astype(F32)


def _run_cg_loop(pkg, k_stop, rn2_scale=F32(1.0), best=None, s=F32(1.0)):
    """One package's initial state and _cg_loop on the same float32
    operator and one-column B, Jacobi-preconditioned, tol 0 (never
    converged): the state's rn2 times rn2_scale, its best replaced by
    best if given, safe_bnorm s.  Returns (k, best, since, rn2)."""
    if pkg == "jax":
        A = jst.stencil_from_gmap(_LOOP_G, False, False)
        B = jnp.asarray(_LOOP_B)
        st = list(jst._cg_state_init(A, B))
        assert st[6].dtype == jnp.float32 and F32(st[6]) == F32_MAX
        st[8] = st[8] * rn2_scale
        if best is not None:
            st[6] = jnp.asarray(best, jnp.float32)
        out = jst._cg_loop(A, B, tuple(st), jnp.asarray(0, jnp.float32),
                           jnp.asarray([s]), k_stop, 1000)
        return int(out[5]), F32(out[6]), int(out[7]), np.asarray(out[8])
    A = tst._to_dtype(tst.stencil_from_gmap_device(
        torch.as_tensor(_LOOP_G), False, False), torch.float32)
    B = torch.as_tensor(_LOOP_B)
    st = _port_state_init(A, B)
    assert st.k == 0 and type(st.best) is F32 and st.best == F32_MAX
    st = st._replace(rn2=st.rn2 * float(rn2_scale),
                     best=st.best if best is None else best)
    out = tst._cg_loop(A, B, st, 0.0, torch.tensor([s]), k_stop, 1000)
    return out.k, out.best, out.since, out.rn2.numpy()


def _stall_edge(pkg):
    """(best, safe_bnorm, worst) for which the package's first CG
    iteration gives a worst equal to the float32 product best * 0.999
    while the float64 product is larger: JAX's loop counts no
    improvement there, a float64 comparison would count one.  The worst
    is the float32 quotient the loop forms, sqrt(rn2) / safe_bnorm."""
    rn = np.sqrt(_run_cg_loop(pkg, 1)[3][0])
    s = F32(1.0)
    for _ in range(256):
        w = rn / s
        b0 = F32(float(w) / 0.999)
        for b in (b0, np.nextafter(b0, F32(0)), np.nextafter(b0, F32(np.inf))):
            if b * F32(0.999) == w and float(b) * 0.999 > float(w):
                return b, s, w
        s = np.nextafter(s, F32(np.inf))
    raise AssertionError("no stall edge within 256 steps of safe_bnorm")


@pytest.mark.parametrize("case", ["inf_first_worst", "at_stall_threshold",
                                  "above_stall_threshold"])
def test_cg_loop_decides_as_jax(case):
    """Both packages' initial states and _cg_loop, driven on the guards'
    edge values, stop at the same k with the same since and best: a
    first worst of inf (float32 best * 8 overflows, so JAX goes on), a
    worst at the float32 stall threshold of best (not improved), and
    the next best whose threshold lies above that worst (improved)."""
    got = {}
    for pkg in ("jax", "torch"):
        if case == "inf_first_worst":
            got[pkg] = _run_cg_loop(pkg, 2, rn2_scale=F32(np.inf))
            continue
        b, s, w = _stall_edge(pkg)
        while case == "above_stall_threshold" and not w < b * F32(0.999):
            b = np.nextafter(b, F32(np.inf))
        got[pkg] = _run_cg_loop(pkg, 1, best=b, s=s)
        assert got[pkg][1] == w
    (kj, bj, sj, _), (kt, bt, st, _) = got["jax"], got["torch"]
    assert (kt, st) == (kj, sj)
    assert kj == {"inf_first_worst": 2}.get(case, 1)
    assert sj == {"at_stall_threshold": 1}.get(case, 0)
    assert type(bt) is F32
    np.testing.assert_allclose(bt, bj, rtol=1e-5)


def _jax_tol(rtol, bnorm):
    """The JAX stencil_cg's target from its column norms, as
    circuitscape_tpu/solve/stencil.py stencil_cg forms it."""
    eps_floor = 32 * jnp.finfo(bnorm.dtype).eps
    return jnp.maximum(rtol, eps_floor) * bnorm


@pytest.mark.parametrize("rtol", [1e-4, np.float64(1e-4),
                                  np.array([1e-4, 1e-7])],
                         ids=["float", "np.float64", "array"])
def test_cg_tol_matches_jax(rtol):
    """stencil_cg's absolute target has JAX's dtype and value, from the
    same float32 column norms: float32 for a Python float, float64 for a
    numpy float64 scalar or array (whose second entry sits under the
    32 eps floor)."""
    bnorm = np.random.default_rng(7).uniform(0.5, 9.0, 2).astype(F32)
    ref = np.asarray(_jax_tol(rtol, jnp.asarray(bnorm)))
    got = tst._cg_tol(rtol, torch.as_tensor(bnorm)).numpy()
    assert got.dtype == ref.dtype == (F32 if type(rtol) is float
                                      else np.float64)
    np.testing.assert_array_equal(got, ref)


def _cg_stop(pkg, rtol):
    """The iteration at which the package's stencil_cg stops on the
    one-column Jacobi problem of _run_cg_loop."""
    if pkg == "jax":
        A = jst.stencil_from_gmap(_LOOP_G, False, False)
        return int(jst.stencil_cg(A, jnp.asarray(_LOOP_B), rtol,
                                  itmax=100)[2])
    A = tst._to_dtype(tst.stencil_from_gmap_device(
        torch.as_tensor(_LOOP_G), False, False), torch.float32)
    return tst.stencil_cg(A, torch.as_tensor(_LOOP_B), rtol, itmax=100)[2]


def _tol_edge(pkg):
    """A one-entry float64 rtol array whose float64 target rtol * bnorm
    lies just under the package's float32 residual norm after one CG
    iteration, while a target formed in float32 (rtol rounded to
    float32, times bnorm in float32) rounds up to it: JAX goes on there,
    a float32 target would stop."""
    if pkg == "jax":
        B = jnp.asarray(_LOOP_B)
        bnorm = np.asarray(jnp.sqrt(jnp.sum(B * B, axis=(-2, -1))))[0]
    else:
        B = torch.as_tensor(_LOOP_B)
        bnorm = torch.sqrt(tst._colsum(B * B)).numpy()[0]
    rn = np.sqrt(_run_cg_loop(pkg, 1)[3][0])
    ulp = float(np.spacing(rn))
    for frac in np.linspace(0.02, 0.48, 47):
        rtol = (float(rn) - frac * ulp) / float(bnorm)
        if (rtol * float(bnorm) < float(rn) and
                F32(F32(rtol) * bnorm) >= rn):
            return np.array([rtol])
    raise AssertionError("no float32-rounding edge under the residual")


def test_stencil_cg_stops_as_jax_at_tol_edge():
    """With an array rtol whose float64 target lies just under the first
    iteration's residual (and rounds up to it in float32), both
    packages' stencil_cg go on past that iteration and stop at the same
    k; a target rounded to float32 stopped the port at k = 1."""
    got = {pkg: _cg_stop(pkg, _tol_edge(pkg)) for pkg in ("jax", "torch")}
    assert got["jax"] > 1
    assert got["torch"] == got["jax"]


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


class _Built(Exception):
    pass


@pytest.mark.parametrize("shape,pen,build", [
    ((1100, 1100), False, "host"),      # 1.21M cells
    ((1000, 1200), False, "device"),    # exactly CS_DEVICE_MG_MAX
    ((1050, 1100), False, "device"),    # 1.155M cells, 1.327M padded
    ((1050, 1100), True, "host"),       # the pen setup counts the padded
])
def test_prepare_refuses_grids_above_the_device_build(monkeypatch, shape,
                                                      pen, build):
    """Grids above CS_DEVICE_MG_MAX (default 1200000 cells, read at call
    time) are refused by the device hierarchy build and take the JAX
    package's host-built route (tests/test_torch_large.py holds that
    route against the JAX package).  As there, the plain setup counts
    the unpadded cells and the pen-aware one the padded cells."""
    monkeypatch.delenv("CS_DEVICE_MG_MAX", raising=False)

    def stop_at(kind):
        def build_fn(*a, **k):
            raise _Built(kind)
        return build_fn
    monkeypatch.setattr(tpr, "build_geo_mg_device", stop_at("device"))
    monkeypatch.setattr(tpr, "build_geo_mg", stop_at("host"))
    monkeypatch.setattr(tpr, "stencil_planes_np", lambda *a: None)
    g = np.ones(shape)
    with pytest.raises(_Built, match=build):
        if pen:
            tpr.prepare_stencil_solver_from_gmap_pen(
                g, False, False, np.zeros(shape), "cpu")
        else:
            tpr.prepare_stencil_solver_from_gmap(g, False, False, "cpu")
