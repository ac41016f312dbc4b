"""The general sparse-graph tier of circuitscape_tpu_torch against the JAX
package on the CPU: the padded-ELL operator and its products, the SA-AMG
host setup (the same arrays) and V-cycle, the batched ELL CG (the same
iteration counts; zero padding columns; the float32 guards), the CG and
direct solve contexts, and the native libraries built from source."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circuitscape_tpu.solve import amg as jamg
from circuitscape_tpu.solve import cg as jcg
from circuitscape_tpu.solve import dispatch as jdis
from circuitscape_tpu.solve import operators as jops
from circuitscape_tpu_torch import native_build
from circuitscape_tpu_torch.graph import build as tb
from circuitscape_tpu_torch.solve import amg as tamg
from circuitscape_tpu_torch.solve import cg as tcg
from circuitscape_tpu_torch.solve import dispatch as tdis
from circuitscape_tpu_torch.solve import operators as tops

torch.set_num_threads(1)

F32 = np.float32
DTYPES = [(np.float32, 1e-6), (np.float64, 1e-12)]


def _lattice_laplacian(side=24, seed=0, holes=True):
    """The Laplacian of a side x side 8-neighbour conductance raster
    (some cells NODATA), regularized as the general tier regularizes a
    component's matrix (src/core.jl:161)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (side, side))
    if holes:
        g[rng.random((side, side)) < 0.08] = -9999.0
    nm = tb.construct_node_map(g, np.zeros((0, 0), np.int64))
    L = tb.laplacian(tb.construct_graph(g, nm, False, False)).tocsr()
    comp = max(tb.components(L), key=len)
    L = L[comp - 1][:, comp - 1].tocsr()
    L.data = L.data + np.finfo(np.float64).eps * np.linalg.norm(L.data)
    return L


@pytest.fixture(scope="module")
def lap():
    return _lattice_laplacian()


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_ell_matches_jax(lap, dtype, tol):
    """ell_from_csr's arrays equal JAX's; ell_matvec and ell_matvec_rect
    agree with JAX's on the same (n_pad, B) block."""
    T = tops.ell_from_csr(lap, dtype)
    J = jops.ell_from_csr(lap, dtype)
    np.testing.assert_array_equal(_np(T.idx), _np(J.idx))
    np.testing.assert_array_equal(_np(T.w), _np(J.w))
    np.testing.assert_array_equal(_np(T.diag), _np(J.diag))
    assert (T.n, T.n_pad, T.nnz) == (J.n, J.n_pad, J.nnz)
    x = np.random.default_rng(1).standard_normal((T.n_pad, 5)).astype(dtype)
    for t_fn, j_fn in ((tops.ell_matvec, jops.ell_matvec),
                       (tops.ell_matvec_rect, jops.ell_matvec_rect)):
        got = _np(t_fn(T, torch.as_tensor(x)))
        ref = np.asarray(j_fn(J, jnp.asarray(x)))
        assert got.dtype == ref.dtype == dtype
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    # against the CSR product, on the true rows
    y = _np(tops.ell_matvec(T, torch.as_tensor(x)))[:T.n]
    ref = lap @ x[:T.n].astype(np.float64)
    assert np.abs(y - ref).max() <= 10 * tol * np.abs(ref).max()


def test_build_amg_matches_jax(lap):
    """The host setup builds the JAX package's hierarchy, array for
    array: every level's operator, smoother weights, prolongator and
    restriction, and the coarse pseudo-inverse."""
    Aj = jops.ell_from_csr(lap, np.float32)
    hj = jamg.build_amg(lap, Aj, np.float32)
    At = tops.ell_from_csr(lap, np.float32)
    ht = tamg.build_amg(lap, At, np.float32)
    assert len(ht.levels) == len(hj.levels) >= 2
    for lt, lj in zip(ht.levels, hj.levels):
        assert lt.omega == lj.omega
        np.testing.assert_array_equal(_np(lt.inv_diag), _np(lj.inv_diag))
        for et, ej in ((lt.A, lj.A), (lt.P, lj.P), (lt.R, lj.R)):
            assert et.n == ej.n
            for f in ("idx", "w", "diag"):
                np.testing.assert_array_equal(_np(getattr(et, f)),
                                              _np(getattr(ej, f)))
    np.testing.assert_array_equal(_np(ht.coarse_pinv), _np(hj.coarse_pinv))


def test_amg_apply_matches_jax(lap):
    At = tops.ell_from_csr(lap, np.float32)
    Aj = jops.ell_from_csr(lap, np.float32)
    ht = tamg.build_amg(lap, At, np.float32)
    hj = jamg.build_amg(lap, Aj, np.float32)
    r = np.random.default_rng(2).standard_normal((At.n_pad, 4)).astype(F32)
    got = _np(tamg.amg_apply(ht, torch.as_tensor(r)))
    ref = np.asarray(jamg.amg_apply(hj, jnp.asarray(r)))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _pair_rhs(n_pad, n, ncols, zero_cols=0, seed=3):
    """Pair right-hand sides (-1 at one node, +1 at another) and
    zero_cols all-zero padding columns, float32."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n_pad, ncols + zero_cols), F32)
    for c in range(ncols):
        i, j = rng.choice(n, 2, replace=False)
        b[i, c], b[j, c] = -1, 1
    return b


@pytest.mark.parametrize("amg", [True, False], ids=["amg", "jacobi"])
def test_cg_batched_matches_jax(lap, amg):
    """The batched ELL CG on a lattice of >= 512 nodes with three pair
    columns and a zero padding column: the same iteration count as the
    JAX package's, X (each column normalized to its source node, as the
    driver normalizes it: the floating Laplacian fixes X only up to a
    constant) within 1e-5 of max |X|, the zero column untouched."""
    At = tops.ell_from_csr(lap, np.float32)
    Aj = jops.ell_from_csr(lap, np.float32)
    assert At.n >= 512
    b = _pair_rhs(At.n_pad, At.n, 3, zero_cols=1)
    if amg:
        pt, pat = tamg.build_amg(lap, At, np.float32), tamg.amg_apply
        pj, paj = jamg.build_amg(lap, Aj, np.float32), jamg.amg_apply
    else:
        pt, pat = tcg.jacobi_prec(At), tcg.jacobi_apply
        pj, paj = jcg.jacobi_prec(Aj), jcg.jacobi_apply
    Xt, rt, kt = tcg.cg_batched(At, torch.as_tensor(b), pt, prec_apply=pat)
    Xj, rj, kj = jcg.cg_batched(Aj, jnp.asarray(b), pj, prec_apply=paj)
    assert kt == int(kj) > 0
    Xt, Xj = _np(Xt), np.asarray(Xj)
    assert np.all(np.isfinite(Xt)) and np.all(Xt[:, -1] == 0)
    src = np.argmin(b, axis=0)
    cols = np.arange(b.shape[1])
    Xt, Xj = (Xt - Xt[src, cols])[:At.n], (Xj - Xj[src, cols])[:At.n]
    assert np.abs(Xt - Xj).max() <= 1e-5 * np.abs(Xj).max()
    assert np.all(_np(rt)[:3] < 1e-4) and _np(rt)[3] == 0


def _loop_inputs(lap):
    At = tops.ell_from_csr(lap, np.float32)
    Aj = jops.ell_from_csr(lap, np.float32)
    b = _pair_rhs(At.n_pad, At.n, 2, zero_cols=1, seed=4)
    return At, Aj, b


# (since, best, k_stop) of the starting state: a stall counter one short
# of the limit with a best no worst can improve on (the loop ends after
# one iteration) or any worst improves on (it runs to k_stop); the first
# best, float32's largest value; and a best one float32 step under it
LOOP_CASES = [
    (199, F32(0.0), 5),
    (199, np.finfo(F32).max, 5),
    (0, np.finfo(F32).max, 7),
    (198, np.nextafter(np.finfo(F32).max, F32(0)), 4),
    (150, F32(np.inf), 60),
]


@pytest.mark.parametrize("since,best,k_stop", LOOP_CASES)
def test_ell_cg_loop_decides_as_jax(lap, since, best, k_stop):
    """Both packages' ELL CG loops, driven from the same float32 state
    (Jacobi, target 0: never converged), stop at the same k with the
    same stall counter, and carry best as float32 (equal up to the
    float32 rounding of the residual norms' sums)."""
    At, Aj, b = _loop_inputs(lap)
    Bt, Bj = torch.as_tensor(b), jnp.asarray(b)
    st = list(tcg._ell_cg_init(At, Bt, None, None))
    sj = list(jcg._ell_cg_init(Aj, Bj, None, None))
    assert type(st[6]) is F32 and F32(sj[6]) == st[6] == np.finfo(F32).max
    st[6], st[7] = best, since
    sj[6], sj[7] = jnp.asarray(best, jnp.float32), jnp.asarray(since)
    zero = np.zeros(b.shape[1], F32)
    ot = tcg._ell_cg_loop(At, Bt, tuple(st), torch.as_tensor(zero),
                          torch.ones(b.shape[1]), k_stop, 1000, None, None)
    oj = jcg._ell_cg_loop(Aj, Bj, tuple(sj), jnp.asarray(zero),
                          jnp.ones(b.shape[1], jnp.float32), k_stop, 1000, None, None)
    assert (ot[5], ot[7]) == (int(oj[5]), int(oj[7]))
    assert type(ot[6]) is F32
    np.testing.assert_allclose(ot[6], F32(oj[6]), rtol=1e-5)


def test_cg_target_is_float32_for_single_precision():
    """A Python-float rtol gives the float32 target of float32 columns,
    as JAX's weakly typed max(rtol, 32 eps) * ||b|| does."""
    b = torch.ones((8, 2), dtype=torch.float32)
    tol = tcg._cg_tol(1e-6, tcg._colnorm(b))
    ref = jnp.maximum(1e-6, 32 * jnp.finfo(jnp.float32).eps) * \
        jnp.linalg.norm(jnp.ones((8, 2), jnp.float32), axis=0)
    assert tol.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_array_equal(tol.numpy(), np.asarray(ref))


def test_cg_context_matches_jax(lap):
    """CGContext.solve (float64) on pair right-hand sides: the JAX
    package's answer to 1e-10 of max |x| and the same CG iterations."""
    from circuitscape_tpu import stats as jstats
    from circuitscape_tpu_torch import stats as tstats
    b = _pair_rhs(lap.shape[0], lap.shape[0], 5)[:lap.shape[0]].astype(
        np.float64)
    tstats.reset()
    jstats.reset()
    xt = tdis.CGContext(lap, np.float64, "cpu").solve(b)
    xj = jdis.CGContext(lap, np.float64).solve(b)
    assert tstats.JOB["cg_iters"] == jstats.JOB["cg_iters"] > 0
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()


def test_direct_context_matches_jax(lap):
    """DirectContext.solve (float64, the native Cholesky built from
    source) against the JAX package's to 1e-10 of max |x|."""
    b = _pair_rhs(lap.shape[0], lap.shape[0], 5)[:lap.shape[0]].astype(
        np.float64)
    b[:, 2] = 0
    xt = tdis.DirectContext(lap, np.float64).solve(b)
    xj = jdis.DirectContext(lap, np.float64).solve(b)
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()
    assert np.all(xt[:, 2] == 0)


def test_cg_context_pads_batch_to_power_of_two(lap, monkeypatch):
    """Five columns solve as one block of eight, as in the JAX package."""
    widths = []
    real = tdis.cg_batched

    def rec(A, B, *a, **k):
        widths.append(B.shape[1])
        return real(A, B, *a, **k)
    monkeypatch.setattr(tdis, "cg_batched", rec)
    ctx = tdis.CGContext(lap, np.float32, "cpu")
    ctx.solve(_pair_rhs(lap.shape[0], lap.shape[0], 5)[:lap.shape[0]])
    assert widths == [8]
    assert ctx.max_batch() == min(4096, (1 << 30) // (ctx.A.n_pad * 4 * 6))


def test_native_libraries_build_from_source(tmp_path, monkeypatch):
    """Both native libraries are built from native/*.cpp into
    build/native/ under a name keyed on source, flags and host CPU; a
    failed build raises with the compiler's output."""
    from circuitscape_tpu_torch.io import fastio
    from circuitscape_tpu_torch.solve import native_chol
    for lib in (native_chol._load(), fastio.load()):
        # never the prebuilt native/*.so
        assert os.path.dirname(lib._name) == str(native_build.BUILD_DIR)
    built = sorted(p.name.split("-")[0] for p in
                   native_build.BUILD_DIR.glob("*.so"))
    assert "libcschol" in built and "libcsio" in built
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "NATIVE_SRC", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="bad.cpp failed"):
        native_build.build("bad.cpp", "libbad")


def test_amg_setup_failure_falls_back_to_jacobi(lap, monkeypatch):
    """A failing AMG host setup leaves the context on Jacobi CG, as in
    the JAX package, and it still solves."""
    def boom(*a, **k):
        raise ValueError("setup")
    monkeypatch.setattr(tamg, "build_amg", boom)
    ctx = tdis.CGContext(lap, np.float64, "cpu")
    assert ctx.prec_apply is tcg.jacobi_apply
    b = _pair_rhs(lap.shape[0], lap.shape[0], 2)[:lap.shape[0]]
    x = ctx.solve(b.astype(np.float64))
    assert np.linalg.norm(lap @ x - b) <= 1e-5 * np.linalg.norm(b)


def test_solver_registry_matches_jax():
    """cholmod and its aliases route to the direct tier, cg+amg to the
    iterative one, as the JAX registry does."""
    class Cfg:
        cholmod_batch_size = 7

    for name in ("cg+amg", "cholmod", "mklpardiso", "accelerate"):
        c = Cfg()
        c.solver = name
        t, j = tdis.get_solver(c), jdis.get_solver(c)
        assert (t.name, t.is_direct, t.batch_size) == \
            (j.name, j.is_direct, j.batch_size)
    c = Cfg()
    c.solver = "nonesuch"
    with pytest.raises(ValueError, match="Unknown solver"):
        tdis.get_solver(c)


def _test_map(shape, seed):
    """A float64 map with NODATA, integral values, signed zeros and
    values across the exponent range."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * 10.0 ** rng.integers(-8, 8, shape)
    a.flat[::7] = -9999.0
    a.flat[1::11] = np.round(a.flat[1::11])
    a.flat[2::13] = 0.0
    a.flat[3::17] = -0.0
    a.flat[4] = 1e-300
    a.flat[5] = 3.0
    return a


def test_asc_body_is_the_python_text(tmp_path):
    """The ASC writer's native body is byte for byte the Python "%.12g"
    row formatter's text, for a float64 and a float32 map."""
    from circuitscape_tpu_torch.io.raster import write_aagrid
    for k, a in enumerate((_test_map((37, 29), 5),
                           _test_map((8, 300), 6).astype(np.float32))):
        path = tmp_path / f"m{k}.asc"
        write_aagrid(str(path), a, (0.0, 1.0, 0.0, 37.0, 0.0, -1.0))
        row_fmt = " ".join(["%.12g"] * a.shape[1])
        body = "".join(row_fmt % tuple(row) + "\n"
                       for row in np.asarray(a, np.float64))
        text = path.read_text()
        assert text.split("\n", 6)[6] == body


def test_writedlm_native_route_matches_jax(tmp_path):
    """Above 20000 entries _writedlm takes the native formatter, as the
    JAX package's does: the same bytes as the JAX package's file, and the
    values of the Python path to within one unit of the last printed
    digit (the table-driven formatter's rounding: relative 1e-16 at 17
    digits, 1e-8 at 9), "3" where Python prints "3.0"."""
    from circuitscape_tpu import out as jout
    from circuitscape_tpu_torch import out as tout
    a = _test_map((12000, 2), 7)
    for digits, dt, rtol in ((17, np.float64, 1e-15),
                             (9, np.float32, 1e-8)):
        v = a.astype(dt)
        tout._writedlm(str(tmp_path / "t.txt"), v, "\t", digits=digits)
        jout._writedlm(str(tmp_path / "j.txt"), v, "\t", digits=digits)
        t = (tmp_path / "t.txt").read_bytes()
        assert t == (tmp_path / "j.txt").read_bytes()
        back = np.loadtxt(tmp_path / "t.txt", delimiter="\t")
        np.testing.assert_allclose(back, v.astype(np.float64), rtol=rtol,
                                   atol=0)
        assert b"\n3\t" in t or b"\t3\n" in t
    # at or below 20000 entries: the Python path's text
    small = a[:100]
    tout._writedlm(str(tmp_path / "s.txt"), small, "\t")
    assert (tmp_path / "s.txt").read_text() == "".join(
        "\t".join(tout._fmt(x) for x in row) + "\n" for row in small)


def test_native_build_without_openmp(tmp_path, monkeypatch):
    """A compiler without an OpenMP runtime (no libgomp) builds the
    library serial, as "*-serial.so", which loads and writes the same
    text; a later call finds it instead of rebuilding."""
    import ctypes
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
                   "{ echo \"cannot read spec file 'libgomp.spec'\" >&2; "
                   "exit 1; }; done\nexec g++ \"$@\"\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "out")
    path = native_build.build("fastio.cpp", "libcsio")
    assert path.name.endswith("-serial.so")
    assert native_build.build("fastio.cpp", "libcsio") == path
    lib = ctypes.CDLL(str(path))
    lib.csio_write_asc_body.restype = ctypes.c_longlong
    a = np.ascontiguousarray(_test_map((5, 7), 8))
    out = tmp_path / "b.txt"
    lib.csio_write_asc_body(str(out).encode(), a.ctypes.data_as(
        ctypes.c_void_p), ctypes.c_int64(5), ctypes.c_int64(7))
    row_fmt = " ".join(["%.12g"] * 7)
    assert out.read_text() == "".join(row_fmt % tuple(r) + "\n" for r in a)
