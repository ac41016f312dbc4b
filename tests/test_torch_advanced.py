"""circuitscape_tpu_torch advanced mode against the JAX package on the
CPU: the penalty-baked hierarchy, the batched grounded solve and its
preconditioner, node currents with finite grounds, sources and grounds
with their conflict policies, the advanced map readers, whole jobs on
both packages' stencil device paths (tests/test_onetoall_device.py's
80 x 80 recipes), and the advanced goldens of tests/data.

CG iteration counts.  A float32 pass stops at a true relative residual
of ~1e-5, which is dominated by the pass's float32 rounding; the next
pass solves for that residual, so its right-hand side, and hence its
iteration count, follows the rounding of the previous pass.  XLA fuses
multiply-adds and orders its sums differently from torch, so totals
over several passes may differ between the packages (the port's
CUDA-versus-CPU counts, chip_smoke.py, likewise).  The tests therefore
hold every pass to the JAX package's count on the JAX package's own
inputs for that pass (replay_passes), and the first pass, whose inputs
the packages share, to the JAX count directly."""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import circuitscape_tpu as cs
import circuitscape_tpu_torch as cst
from circuitscape_tpu.drivers import advanced as ja
from circuitscape_tpu.drivers.flags import get_raster_flags as jflags
from circuitscape_tpu.io import loaders as jl
from circuitscape_tpu.solve import geomg as jmg
from circuitscape_tpu.solve import prepare as jpr
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch.drivers import advanced as ta
from circuitscape_tpu_torch.drivers.flags import get_raster_flags as tflags
from circuitscape_tpu_torch.io import loaders as tl
from circuitscape_tpu_torch.solve import geomg as tmg
from circuitscape_tpu_torch.solve import prepare as tpr
from circuitscape_tpu_torch.solve import stencil as tst
from chip_smoke import record_passes
from golden_utils import DATA_DIR, read_aagrid

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

F32_TOL = 1e-5   # float32, sum order differs between XLA and torch
VERIFY = os.path.join(DATA_DIR, "output_verify")


def _grid(H, W, seed, nodata=0.08):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < nodata] = 0.0
    return g, rng


def _pen_spec(g, rng, n_inf=3, n_fin=4):
    """Direct grounds (inf) and finite ground conductances on active
    cells."""
    spec = np.zeros(g.shape)
    act = np.argwhere(g > 0)
    pick = act[rng.choice(len(act), n_inf + n_fin, replace=False)]
    for k, (r, c) in enumerate(pick):
        spec[r, c] = np.inf if k < n_inf else rng.uniform(0.2, 5.0)
    return spec


def carry_hierarchy(hier):
    """The JAX hierarchy as this package's (from_jax_numpy), smoothed as
    the JAX package smooths it: the fused configuration only where the
    JAX package expanded its levels for the Pallas kernels (on the TPU),
    else the generic one on every level, as the JAX package runs on the
    CPU.  Carried with this package's CPU default (fused), the V-cycle
    rounds differently from the JAX one, and a CG pass whose last
    residual lies within that rounding of its target stops an iteration
    earlier or later, depending on the host CPU's float32 kernels."""
    levels = [dict(we=np.asarray(L.A.we), ws=np.asarray(L.A.ws),
                   wse=np.asarray(L.A.wse), wne=np.asarray(L.A.wne),
                   diag=np.asarray(L.A.diag),
                   inv_diag=np.asarray(L.inv_diag), lam_max=L.lam_max)
              for L in hier.levels]
    expanded = any(getattr(getattr(L.A, "pallas", None), "init_planes",
                           None) is not None for L in hier.levels)
    return tmg.from_jax_numpy(levels, np.asarray(hier.coarse_pinv),
                              hier.coarse_shape, hier.overcorrect,
                              fused_smoother=expanded)


def carry_operator(A, dtype=torch.float32):
    return tst.operator_from_numpy(
        [np.asarray(p) for p in (A.we, A.ws, A.wse, A.wne, A.diag)], dtype)


def carry_projector(proj):
    return None if proj is None else tst.projector_from_numpy(
        np.asarray(proj.seg), np.asarray(proj.inv_counts), proj.nseg)


@contextlib.contextmanager
def both_passes():
    """Every inner CG pass (stencil_cg call) of this package and of the
    JAX package while active, with its arguments (chip_smoke's
    recorder)."""
    with record_passes(keep=True, mod=tst) as t, \
            record_passes(keep=True, mod=jst) as j:
        yield t, j


def replay_passes(t, j, first_passes=True):
    """Each JAX pass (j) rerun on this package from the JAX pass's own
    operator, right-hand side, tolerance, hierarchy, penalty and
    projector: the same iteration count, pass by pass.  With
    first_passes, where both packages solve the same systems, the first
    pass of each solve also matches the port's own (t) first pass."""
    for ((A, B, rtol), k), n in zip(j.calls, j.iters):
        pen = k.get("pen")
        _, _, it = t.real(
            carry_operator(A), torch.as_tensor(np.array(B)), rtol,
            itmax=k["itmax"], prec=carry_hierarchy(k["prec"]),
            prec_apply=tmg.geomg_apply,
            pen=None if pen is None else torch.as_tensor(np.array(pen)),
            proj=carry_projector(k.get("proj")))
        assert int(it) == n

    def first(rec):
        return [n for (a, _), n in zip(rec.calls, rec.iters)
                if isinstance(a[2], float)]
    if first_passes:
        assert first(t) == first(j)


def jax_operator(A):
    """This package's operator as the JAX package's (same dtype)."""
    return jst.StencilOperator(*(jnp.asarray(getattr(A, k).cpu().numpy())
                                 for k in ("we", "ws", "wse", "wne",
                                           "diag")))


def jax_hierarchy(hier):
    """This package's hierarchy as the JAX package's: the same levels,
    inverse diagonals, eigenvalue bounds and coarse inverse."""
    levels = tuple(jmg.GeoMgLevel(jax_operator(L.A),
                                  jnp.asarray(L.inv_diag.cpu().numpy()),
                                  L.lam_max) for L in hier.levels)
    return jmg.GeoMgHierarchy(levels,
                              jnp.asarray(hier.coarse_pinv.cpu().numpy()),
                              tuple(hier.coarse_shape), hier.overcorrect)


def replay_port_passes(t):
    """The reverse of replay_passes, for passes the JAX package's jobs
    do not run: each of this package's passes (t) rerun on the JAX
    package's stencil_cg from this package's own operator, right-hand
    side, tolerance and hierarchy (carried across), with no penalty
    field and no projector: the same iteration count, pass by pass."""
    assert t.calls
    for ((A, B, rtol), k), n in zip(t.calls, t.iters):
        assert k.get("pen") is None and k.get("proj") is None
        _, _, it = jst.stencil_cg(
            jax_operator(A), jnp.asarray(B.cpu().numpy()),
            np.asarray(rtol) if np.ndim(rtol) else rtol, itmax=k["itmax"],
            prec=jax_hierarchy(k["prec"]), prec_apply=jmg.geomg_apply)
        assert int(it) == n


# --- the penalty-baked hierarchy -----------------------------------------

@pytest.mark.parametrize("shape", [(8, 6), (7, 9), (33, 20)])
def test_coarsen_pen_matches_jax(shape):
    """2x2 patch sums of a ground field with direct-ground penalties
    beside small finite conductances: the same float32 bits."""
    rng = np.random.default_rng(1)
    p = rng.uniform(0.0, 3.0, shape).astype(np.float32)
    p[rng.random(shape) < 0.3] = 0.0
    p[rng.random(shape) < 0.2] = 3.7e8
    np.testing.assert_array_equal(
        tmg._coarsen_pen_torch(torch.as_tensor(p)).numpy(),
        np.asarray(jmg._coarsen_pen_jnp(jnp.asarray(p))))


@pytest.mark.parametrize("shape", [(100, 70), (128, 128)])
def test_pen_build_matches_jax(shape):
    """build_geo_mg_device(pen=...): every level's planes, diagonal and
    inv_diag per cell (penalty cells carry diagonals ~1e8 times the
    others), lam_max, and the coarse pseudo-inverse."""
    g, rng = _grid(*shape, seed=3)
    spec = _pen_spec(g, rng)
    S32 = jst._to_dtype(jst.stencil_from_gmap_device(jnp.asarray(g), False,
                                                     False), jnp.float32)
    pen = np.where(np.isinf(spec), 1e8 * float(np.max(np.asarray(S32.diag))),
                   spec).astype(np.float32)
    ref = jmg.build_geo_mg_device(S32, pen=jnp.asarray(pen))
    got = tmg.build_geo_mg_device(carry_operator(S32),
                                  pen=torch.as_tensor(pen))
    assert len(got.levels) == len(ref.levels)
    assert got.coarse_shape == tuple(ref.coarse_shape)
    for k, (Lr, Lt) in enumerate(zip(ref.levels, got.levels)):
        for name in ("we", "ws", "wse", "wne", "diag"):
            r = np.asarray(getattr(Lr.A, name))
            t = getattr(Lt.A, name).numpy()
            assert np.all(np.abs(t - r) <= F32_TOL * np.abs(r)), (k, name)
        r = np.asarray(Lr.inv_diag)
        assert np.all(np.abs(Lt.inv_diag.numpy() - r) <= F32_TOL * np.abs(r))
        assert abs(Lt.lam_max - Lr.lam_max) <= F32_TOL * Lr.lam_max, k
        d = np.asarray(Lr.A.diag)
        assert d.max() > 1e7 * np.median(d[d > 0])   # the penalty is baked
    pr = np.asarray(ref.coarse_pinv)
    assert np.abs(got.coarse_pinv.numpy() - pr).max() <= \
        F32_TOL * np.abs(pr).max()


def _pen_solver_pair(g, spec):
    """Both packages' pen-aware setup for g; the JAX hierarchy also
    carried across (from_jax_numpy)."""
    S_j, prec_j, apply_j, _, pen_j = jpr.prepare_stencil_solver_from_gmap_pen(
        g, False, False, spec)
    S_t, prec_t, apply_t, _, pen_t = tpr.prepare_stencil_solver_from_gmap_pen(
        g, False, False, spec, "cpu")
    return (S_j, prec_j, apply_j, pen_j), (S_t, prec_t, apply_t, pen_t)


def test_prepare_pen_matches_jax():
    """pen_host exactly (direct grounds resolved to 1e8 max diag), the
    float64 operator to 1e-12, and the fine level's diagonal holding the
    float32 penalty, per cell."""
    g, rng = _grid(90, 100, seed=5)
    spec = _pen_spec(g, rng)
    (S_j, prec_j, _, pen_j), (S_t, prec_t, _, pen_t) = _pen_solver_pair(
        g, spec)
    np.testing.assert_array_equal(pen_t, pen_j)
    assert np.isinf(spec).sum() == (pen_j == pen_j.max()).sum()
    for name in ("we", "ws", "wse", "wne", "diag"):
        np.testing.assert_allclose(getattr(S_t, name).numpy(),
                                   np.asarray(getattr(S_j, name)),
                                   rtol=1e-12, atol=0)
    d = np.asarray(prec_j.levels[0].A.diag)
    assert np.all(np.abs(prec_t.levels[0].A.diag.numpy() - d) <=
                  F32_TOL * d)
    assert np.all(d[np.isinf(np.pad(spec, ((0, 38), (0, 28))))] >=
                  np.float32(pen_j.max()))


@pytest.mark.parametrize("B", [1, 3])
def test_vcycle_on_pen_hierarchy_matches_jax(B):
    """This package's V-cycle on the JAX package's pen-baked hierarchy."""
    g, rng = _grid(100, 70, seed=4)
    S32 = jst._to_dtype(jst.stencil_from_gmap_device(jnp.asarray(g), False,
                                                     False), jnp.float32)
    pen = np.where(np.isinf(_pen_spec(g, rng)),
                   1e8 * float(np.max(np.asarray(S32.diag))), 0.0)
    hier = jmg.build_geo_mg_device(S32, pen=jnp.asarray(pen, jnp.float32))
    R = rng.standard_normal((B, 100, 70)).astype(np.float32)
    ref = np.asarray(jmg.geomg_apply(hier, jnp.asarray(R)))
    got = tmg.geomg_apply(carry_hierarchy(hier), torch.as_tensor(R)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()


def test_prec_apply_with_column_pen_matches_jax():
    """The masked preconditioner P M0^-1 P + D_pen with a different
    penalty field per column: exact inversion on each column's
    penalized cells, the V-cycle elsewhere."""
    g, rng = _grid(96, 80, seed=6)
    spec = np.where(np.isinf(_pen_spec(g, rng)), np.inf, 0.0)
    (S_j, prec_j, apply_j, pen_j), _ = _pen_solver_pair(g, spec)
    A_j = jst._to_dtype(S_j, jnp.float32)
    pen = np.zeros((2, 128, 128), np.float32)
    cells = np.argwhere(np.isinf(spec))
    pen[0, cells[0, 0], cells[0, 1]] = pen_j.max()
    pen[1, cells[1, 0], cells[1, 1]] = pen_j.max()
    pen[1, cells[2, 0], cells[2, 1]] = 0.25
    R = rng.standard_normal((2, 128, 128)).astype(np.float32)
    ref = np.asarray(jst._make_prec_apply(A_j, prec_j, apply_j,
                                          jnp.asarray(pen))(jnp.asarray(R)))
    got = tst._make_prec_apply(carry_operator(A_j), carry_hierarchy(prec_j),
                               tmg.geomg_apply, torch.as_tensor(pen))(
        torch.as_tensor(R)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
    for b in range(2):
        on = pen[b] > 0
        np.testing.assert_array_equal(got[b][on], ref[b][on])


# --- the batched grounded solve --------------------------------------------

def _solve_case(mode, proj):
    """Inputs of stencil_solve_advanced_batch in one of its three modes
    on a 96 x 110 grid: "baked" (one column, finite and direct grounds
    baked into the hierarchy, pen_in_prec), "per_column" (one-to-all:
    the shared penalty baked, each column its own penalty field on the
    bare operator) and "zero" (all-to-one: a floating hierarchy, zero
    penalty fields, balanced sources)."""
    g, rng = _grid(96, 110, seed=8)
    act = np.argwhere(g > 0)
    pts = act[rng.choice(len(act), 4, replace=False)]
    if mode == "baked":
        spec = _pen_spec(g, rng)
    else:
        spec = np.zeros(g.shape)
        if mode == "per_column":
            spec[pts[:, 0], pts[:, 1]] = np.inf
    if mode == "zero":
        S_j, prec_j, apply_j, _ = jpr.prepare_stencil_solver_from_gmap(
            g, False, False)
    else:
        S_j, prec_j, apply_j, _, pen_j = \
            jpr.prepare_stencil_solver_from_gmap_pen(g, False, False, spec)
    kw = {}
    if mode == "baked":
        rr, cc = np.nonzero(g > 0)
        src = np.zeros(g.shape)
        src[pts[0, 0], pts[0, 1]], src[pts[1, 0], pts[1, 1]] = 1.0, 2.5
        sc = np.column_stack([rr, cc])[None]
        args = (sc, src[rr, cc][None], sc, pen_j[rr, cc][None])
        kw["pen_in_prec"] = True
    else:
        n = len(pts)
        src_cells = np.zeros((n, n, 2), np.int64)
        src_vals = np.zeros((n, n))
        gnd_vals = np.zeros((n, n))
        for i in range(n):
            if mode == "per_column":
                src_cells[i, 0], src_vals[i, 0] = pts[i], 1.0 + i
                gnd_vals[i] = np.where(np.arange(n) != i, pen_j.max(), 0.0)
            else:
                src_cells[i] = pts
                src_vals[i] = 1.0
                src_vals[i, i] = -(n - 1.0)
        args = (src_cells, src_vals, np.tile(pts[None], (n, 1, 1)), gnd_vals)
    proj_j = None
    if proj:
        nm = np.zeros(g.shape, np.int64)
        nm[g > 0] = np.arange(1, int((g > 0).sum()) + 1)
        blk = np.s_[30:36, 40:52]
        nm[blk] = np.where(g[blk] > 0, nm[30, 40] or 1, 0)
        proj_j = jst.build_poly_projector(nm, S_j.shape)
    return S_j, prec_j, apply_j, args, kw, proj_j


@pytest.mark.parametrize("proj", [False, True])
@pytest.mark.parametrize("mode", ["baked", "per_column", "zero"])
def test_advanced_batch_matches_jax(mode, proj):
    """stencil_solve_advanced_batch on both packages with the same
    operator, hierarchy (carried across) and projector: every CG pass
    at the JAX package's count on its inputs and the first passes equal
    (replay_passes; a later pass's right-hand side is the rounding of
    the pass before, so the totals follow the host CPU's float32
    kernels), X within F32_TOL of max |X| and per-column residuals
    under the target."""
    S_j, prec_j, apply_j, args, kw, proj_j = _solve_case(mode, proj)
    lo_j, lo_t = {}, {}
    if mode == "per_column":
        lo_j = {"A_lo": jst._to_dtype(S_j, jnp.float32)}
        lo_t = {"A_lo": carry_operator(S_j)}
    with both_passes() as (t, j):
        Xj, relj, itj = jst.stencil_solve_advanced_batch(
            S_j, *args, rtol=1e-6, prec=prec_j, prec_apply=apply_j,
            proj=proj_j, **kw, **lo_j)
        Xt, relt, itt = tst.stencil_solve_advanced_batch(
            carry_operator(S_j, torch.float64), *args, rtol=1e-6,
            prec=carry_hierarchy(prec_j), prec_apply=tmg.geomg_apply,
            proj=carry_projector(proj_j), **kw, **lo_t)
    assert itt == sum(t.iters) and int(itj) == sum(j.iters)
    replay_passes(t, j)
    assert np.all(relt <= 1e-6) and np.all(np.asarray(relj) <= 1e-6)
    Xj = np.asarray(Xj)
    assert np.abs(Xt.numpy() - Xj).max() <= F32_TOL * np.abs(Xj).max()


def test_scatter_field_accumulates_at_origin():
    """Padding entries (0, 0) with value 0 do not overwrite a real entry
    at (0, 0)."""
    cells = np.array([[[0, 0], [2, 1], [0, 0]], [[1, 1], [0, 0], [0, 0]]])
    vals = np.array([[1.5, 2.0, 0.0], [3.0, 0.0, 0.0]])
    got = tst._scatter_field(torch.as_tensor(cells), torch.as_tensor(vals),
                             3, 4).numpy()
    ref = np.asarray(jst._scatter_field(jnp.asarray(cells), jnp.asarray(vals),
                                        3, 4))
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0, 0] == 1.5


@pytest.mark.parametrize("proj", [False, True])
def test_node_currents_with_fg_match_jax(proj):
    """Node currents with finite-ground terms, with and without a
    projector, on a voltage block with one grounded column."""
    g, rng = _grid(40, 50, seed=9)
    S_j = jst.stencil_from_gmap_device(jnp.asarray(g), False, False)
    V = rng.standard_normal((2, 40, 50)) * (g > 0)
    fg = np.zeros(g.shape)
    fg[rng.random(g.shape) < 0.05] = 0.7
    proj_j = None
    if proj:
        nm = np.zeros(g.shape, np.int64)
        nm[g > 0] = np.arange(1, int((g > 0).sum()) + 1)
        nm[5:9, 5:12] = np.where(g[5:9, 5:12] > 0, 1, 0)
        proj_j = jst.build_poly_projector(nm)
        V = np.array(jst.poly_project(proj_j, jnp.asarray(V)))
    ref = np.asarray(ja._node_currents_with_fg(S_j, jnp.asarray(V),
                                               jnp.asarray(fg), proj=proj_j))
    got = ta._node_currents_with_fg(
        carry_operator(S_j, torch.float64), torch.as_tensor(V),
        torch.as_tensor(fg), proj=carry_projector(proj_j)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


# --- sources, grounds and their readers -----------------------------------

class _Flags:
    is_raster = True
    grnd_file_is_res = True

    def __init__(self, policy):
        self.policy = policy


@pytest.mark.parametrize("policy", ["keepall", "rmvsrc", "rmvgnd",
                                    "rmvall"])
def test_sources_and_grounds_match_jax(policy):
    """Per-node sums over a node map with a merged node, conflicts
    (a node both source and ground, a direct ground under a source)
    resolved by each policy."""
    nm = np.array([[1, 2, 3, 0], [4, 5, 5, 6], [7, 0, 8, 9]])
    src = np.zeros(nm.shape)
    gnd = np.zeros(nm.shape)
    src[0, 0], src[1, 1], src[1, 2], src[2, 3] = 1.0, 2.0, 0.5, 3.0
    gnd[0, 0], gnd[2, 3], gnd[0, 2], gnd[1, 3] = 0.4, np.inf, 0.8, np.inf
    G = type("G", (), {"shape": (9, 9), "dtype": np.dtype(np.float64)})()
    got = ta._get_sources_and_grounds(src, gnd, _Flags(policy), G, nm)
    ref = ja._get_sources_and_grounds(src, gnd, _Flags(policy), G, nm)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _write_asc(path, a, nodata=-9999):
    H, W = a.shape
    path.write_text(f"ncols {W}\nnrows {H}\nxllcorner 0\nyllcorner 0\n"
                    f"cellsize 1\nNODATA_value {nodata}\n" +
                    "\n".join(" ".join(repr(float(v)) for v in row)
                              for row in a))


@pytest.mark.parametrize("form,is_res,unit,direct", [
    ("raster", True, False, False), ("raster", False, True, True),
    ("txtlist", True, False, False)])
def test_source_ground_readers_match_jax(tmp_path, form, is_res, unit,
                                         direct):
    """read_source_and_ground_maps on AAGrid rasters and on (value, x, y)
    text lists, with resistance grounds (0 -> a direct ground), unit
    currents and direct grounds."""
    g = np.ones((6, 7))
    _write_asc(tmp_path / "cell.asc", g)
    src = np.zeros((6, 7))
    gnd = np.full((6, 7), -9999.0)
    src[1, 2], src[4, 5] = 2.0, 0.5
    gnd[0, 6], gnd[5, 0], gnd[3, 3] = 2.0, 0.0, 4.0
    if form == "raster":
        _write_asc(tmp_path / "src.asc", src)
        _write_asc(tmp_path / "gnd.asc", gnd)
    else:
        for name, a in (("src.asc", src), ("gnd.asc", gnd)):
            rows = [(a[r, c], c + 0.5, 6 - r - 0.5)
                    for r, c in np.argwhere((a != 0) & (a != -9999))]
            if name == "gnd.asc":
                rows.append((0.0, 0.5, 0.5))
            (tmp_path / name).write_text(
                "\n".join(f"{v} {x} {y}" for v, x, y in rows) + "\n")
    cfg = {"data_type": "raster", "scenario": "advanced",
           "habitat_file": str(tmp_path / "cell.asc"),
           "source_file": str(tmp_path / "src.asc"),
           "ground_file": str(tmp_path / "gnd.asc"),
           "ground_file_is_resistances": str(is_res),
           "use_unit_currents": str(unit), "use_direct_grounds": str(direct),
           "output_file": str(tmp_path / "x.out")}
    ct = cst.CSConfig.from_dict(dict(cst.init_config(), **cfg))
    cj = cs.CSConfig.from_dict(dict(cs.init_config(), **cfg))
    dt, dj = tl.load_raster_data(ct), jl.load_raster_data(cj)
    np.testing.assert_array_equal(dt.source_map, dj.source_map)
    np.testing.assert_array_equal(dt.ground_map, dj.ground_map)
    ft, fj = tflags(ct), jflags(cj)
    assert (ft.policy, ft.grnd_file_is_res) == (fj.policy, fj.grnd_file_is_res)


# --- whole jobs and goldens -------------------------------------------------

def _advanced_job(tmp_path, seed=11, polygons=False):
    """tests/test_onetoall_device.py's advanced recipes at 80 x 80: three
    sources, two finite grounds (resistance 2) and a nearly direct one
    (resistance 1e-4); with polygons, its polygon recipe (a source inside
    one polygon, a finite ground inside another, a direct ground)."""
    H = W = 80
    rng = np.random.default_rng(21 if polygons else seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.05] = -9999
    _write_asc(tmp_path / "cell.asc", g)
    src = np.zeros((H, W))
    gnd = np.full((H, W), -9999.0)
    cfg = {"data_type": "raster", "scenario": "advanced",
           "habitat_file": str(tmp_path / "cell.asc"),
           "source_file": str(tmp_path / "src.asc"),
           "ground_file": str(tmp_path / "gnd.asc"),
           "ground_file_is_resistances": "True", "solver": "cg+amg",
           "write_cur_maps": "True", "write_volt_maps": "True",
           "suppress_messages": "True"}
    if polygons:
        poly = np.zeros((H, W), int)
        poly[20:26, 20:28] = 1
        poly[50:60, 60:63] = 2
        poly[g <= 0] = 0
        _write_asc(tmp_path / "poly.asc", poly)
        src[22, 23] = 2.5
        src[5, 5] = 1.0 if g[5, 5] > 0 else 0.0
        gnd[55, 61] = 1.5
        gnd[70, 40] = 0.0
        cfg.update(use_polygons="True",
                   polygon_file=str(tmp_path / "poly.asc"))
    else:
        placed = 0
        while placed < 6:
            r, c = rng.integers(0, H, 2)
            if g[r, c] > 0 and src[r, c] == 0 and gnd[r, c] == -9999:
                placed += 1
                if placed <= 3:
                    src[r, c] = placed
                elif placed <= 5:
                    gnd[r, c] = 2.0
                else:
                    gnd[r, c] = 0.0001
    _write_asc(tmp_path / "src.asc", src)
    _write_asc(tmp_path / "gnd.asc", gnd)
    return cfg


@pytest.mark.parametrize("polygons", [False, True])
def test_advanced_job_matches_jax(tmp_path, monkeypatch, polygons):
    """Advanced jobs on both packages' device paths: voltages to 1e-5 of
    max, the same voltage and current maps (1e-5 of max), every CG pass
    at the JAX package's iteration count on its inputs."""
    monkeypatch.setenv("CS_ADVANCED_DEVICE_MIN", "1")
    cfg = _advanced_job(tmp_path, polygons=polygons)
    with both_passes() as (t, j):
        vt = cst.compute(dict(cfg, output_file=str(tmp_path / "t.out")),
                         device="cpu")
        vj = np.asarray(cs.compute(dict(cfg,
                                        output_file=str(tmp_path / "j.out"))))
    assert vt.shape == vj.shape == (80, 80)
    assert np.abs(vt - vj).max() <= 1e-5 * np.abs(vj).max()
    replay_passes(t, j)
    for f in ("curmap.asc", "voltmap.asc"):
        a = read_aagrid(tmp_path / f"t_{f}")
        b = read_aagrid(tmp_path / f"j_{f}")
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), f


@pytest.mark.parametrize("n", range(1, 7))
def test_golden_advanced(tmp_path, monkeypatch, n):
    """The advanced goldens at the default threshold (the per-component
    loop on the general sparse-graph tier) and on the stencil device
    path (CS_ADVANCED_DEVICE_MIN = 1, solver = cg+amg), which the JAX
    package takes for all six: every written grid within a sum-of-squares
    difference of 1e-6 of the golden, on both paths."""
    monkeypatch.chdir(DATA_DIR)
    for path, env in (("general", None), ("device", "1")):
        if env:
            monkeypatch.setenv("CS_ADVANCED_DEVICE_MIN", env)
        od = tmp_path / path
        od.mkdir()
        cfg = cst.parse_config(
            f"input/raster/advanced/{n}/mgVerify{n}.ini").to_dict()
        cfg.update(solver="cg+amg", suppress_messages="True",
                   output_file=str(od / f"mgVerify{n}.out"))
        v = cst.compute(cfg, device="cpu")
        assert np.all(np.isfinite(v))
        grids = sorted(f for f in os.listdir(od) if f.endswith(".asc"))
        assert grids
        for f in grids:
            d2 = float(((read_aagrid(od / f) -
                         read_aagrid(os.path.join(VERIFY, f))) ** 2).sum())
            assert d2 < 1e-6, f"{path} {f}: grid sum-sq diff {d2}"
