"""circuitscape_tpu_torch short-circuit regions against the JAX package on
the CPU: the graph helpers (create_new_polymap, components), the polygon
projector (its build, poly_project and poly_sum, shared and per column),
and the solves and node currents that carry it, fed the JAX package's
operator, hierarchy and projector through the *_from_numpy functions.

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circuitscape_tpu.graph import build as jb
from circuitscape_tpu.solve import prepare as jpr
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch.graph import build as tb
from circuitscape_tpu_torch.solve import geomg as tmg
from circuitscape_tpu_torch.solve import stencil as tst

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

REL = {np.float32: 1e-6, np.float64: 1e-12}


def _raster(H, W, seed, holes=0.12):
    """A conductance map with NODATA holes, a polygon map of four
    rectangles and two single-row strips (one polygon cell on NODATA
    forced), and focal regions: ids 1-3 as 2x2 blocks, 4 and 5 single
    cells, 6 a region straddling polygon 1."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < holes] = 0.0
    poly = np.zeros((H, W), np.int64)
    poly[2:6, 3:8] = 1
    poly[H - 7:H - 3, W - 9:W - 4] = 2
    poly[H // 2, 1:W // 3] = 3
    poly[1, W // 2:W - 2] = 5
    g[3, 4] = 0.0                    # a polygon cell on NODATA
    pts = np.zeros((H, W), np.int64)
    for k, (r, c) in enumerate([(9, 2), (H - 3, 2), (4, W - 4)], start=1):
        pts[r:r + 2, c:c + 2] = k
    pts[H // 3, W // 3] = 4
    pts[H - 2, W - 2] = 5
    pts[5, 7] = pts[6, 8] = 6        # one cell in polygon 1, one outside
    rows, cols = np.nonzero(pts.T)   # column-major, as read_point_map
    points_rc = (cols + 1, rows + 1, pts.T[rows, cols])
    return g, poly, points_rc


@pytest.mark.parametrize("with_poly", [False, True])
@pytest.mark.parametrize("pair", [(1, 2), (1, 6), (4, 5), (3, 6)])
def test_create_new_polymap_matches_jax(with_poly, pair):
    g, poly, points_rc = _raster(23, 29, 1)
    poly = poly if with_poly else np.zeros((0, 0), np.int64)
    got = tb.create_new_polymap(g, poly, points_rc, *pair)
    ref = jb.create_new_polymap(g, poly, points_rc, *pair)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_components_matches_jax(seed):
    """Components of a collapsed graph with several islands, exactly."""
    g, poly, _ = _raster(31, 27, seed, holes=0.45)
    nm = jb.construct_node_map(g, poly)
    G = jb.laplacian(jb.construct_graph(g, nm, False, seed % 2 == 0))
    got, ref = tb.components(G), jb.components(G)
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _nodemaps(H, W, seed):
    """Node maps of the polygon map and of three focal-region pairs, one
    of them with no polygon at all."""
    g, poly, points_rc = _raster(H, W, seed)
    shared = jb.construct_node_map(g, poly)
    rows = [jb.construct_node_map(g, jb.create_new_polymap(
        g, poly, points_rc, *pair)) for pair in [(1, 2), (3, 6)]]
    rows.append(jb.construct_node_map(g, jb.create_new_polymap(
        g, np.zeros((0, 0), np.int64), points_rc, 4, 5)))
    return g, shared, rows


def _assert_same_projector(got, ref):
    assert got.nseg == ref.nseg
    assert got.seg.dtype == torch.int32
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(ref.seg))
    assert got.inv_counts.dtype == torch.float64
    np.testing.assert_array_equal(got.inv_counts.numpy(),
                                  np.asarray(ref.inv_counts))


@pytest.mark.parametrize("shape", [None, (32, 40)])
def test_build_poly_projector_matches_jax(shape):
    """seg, inv_counts and nseg equal the JAX package's, on the
    nodemap's own shape and on a padded one, with a polygon cell on
    NODATA (it takes the merged id, so it lies in its polygon)."""
    g, nm, _ = _nodemaps(23, 29, 5)
    got = tst.build_poly_projector(nm, shape)
    _assert_same_projector(got, jst.build_poly_projector(nm, shape))
    assert got.seg.reshape(-1, 29 if shape is None else 40)[3, 4] < \
        got.nseg - 1
    one_to_one = jb.construct_node_map(g, np.zeros((0, 0), np.int64))
    assert tst.build_poly_projector(one_to_one, shape) is None


def test_build_poly_projector_rows_matches_jax():
    """The per-column projector, padded, with a row whose pair merges
    nothing but single cells (fewer polygons than the widest row)."""
    _, _, rows = _nodemaps(23, 29, 6)
    got = tst.build_poly_projector_rows(rows, (32, 40))
    _assert_same_projector(got, jst.build_poly_projector_rows(rows,
                                                             (32, 40)))
    assert got.lengths.numel() == 3 * (got.nseg - 1)
    assert int(got.lengths.sum()) == int((got.seg < got.nseg - 1).sum())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("per_column", [False, True])
@pytest.mark.parametrize("fn", ["poly_project", "poly_sum"])
def test_poly_ops_match_jax(fn, per_column, dtype):
    """poly_project and poly_sum on (3, 32, 40) blocks, in float32 to
    1e-6 and in float64 to 1e-12 of max |JAX|, from the JAX package's
    own projector carried across with projector_from_numpy."""
    _, nm, rows = _nodemaps(23, 29, 7)
    ref_p = (jst.build_poly_projector_rows(rows, (32, 40)) if per_column
             else jst.build_poly_projector(nm, (32, 40)))
    got_p = tst.projector_from_numpy(np.asarray(ref_p.seg),
                                     np.asarray(ref_p.inv_counts),
                                     ref_p.nseg)
    y = np.random.default_rng(8).standard_normal((3, 32, 40)).astype(dtype)
    ref = np.asarray(getattr(jst, fn)(ref_p, jnp.asarray(y)))
    got = getattr(tst, fn)(got_p, torch.as_tensor(y))
    assert got.dtype == torch.as_tensor(y).dtype
    err = np.abs(got.numpy() - ref).max()
    assert err <= REL[dtype] * np.abs(ref).max(), err


def test_pad_projector_rows_matches_jax():
    """_fused_pair_solve's padding of a per-column projector: all-trash
    rows with inv_counts 0, as the JAX package pads; padded columns pass
    through poly_project unchanged."""
    _, _, rows = _nodemaps(23, 29, 9)
    ref = jst.build_poly_projector_rows(rows, (32, 40))
    got = tst._pad_projector_rows(tst.build_poly_projector_rows(rows,
                                                                (32, 40)), 4)
    assert got.seg.shape == (4, 32 * 40)
    np.testing.assert_array_equal(got.seg[:3].numpy(), np.asarray(ref.seg))
    assert bool((got.seg[3] == ref.nseg - 1).all())
    assert not bool(got.inv_counts[3].any())
    y = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (4, 32, 40)))
    out = tst.poly_project(got, y)
    assert torch.equal(out[3], y[3])
    np.testing.assert_allclose(out[:3].numpy(), np.asarray(jst.poly_project(
        ref, jnp.asarray(y[:3].numpy()))), rtol=0, atol=1e-12)


def _solver_pair(g):
    """The JAX package's stencil solver for g, and the same operator,
    hierarchy (from_jax_numpy) and V-cycle for this package."""
    S_j, prec_j, apply_j, _ = jpr.prepare_stencil_solver_from_gmap(
        g, False, False)
    S_t = tst.operator_from_numpy(
        [np.asarray(p) for p in (S_j.we, S_j.ws, S_j.wse, S_j.wne,
                                 S_j.diag)], torch.float64)
    levels = [dict(we=np.asarray(L.A.we), ws=np.asarray(L.A.ws),
                   wse=np.asarray(L.A.wse), wne=np.asarray(L.A.wne),
                   diag=np.asarray(L.A.diag),
                   inv_diag=np.asarray(L.inv_diag), lam_max=L.lam_max)
              for L in prec_j.levels]
    prec_t = tmg.from_jax_numpy(levels, np.asarray(prec_j.coarse_pinv),
                                prec_j.coarse_shape, prec_j.overcorrect)
    return (S_j, prec_j, apply_j), (S_t, prec_t, tmg.geomg_apply)


def _carry(proj):
    return tst.projector_from_numpy(np.asarray(proj.seg),
                                    np.asarray(proj.inv_counts), proj.nseg)


def _pairs(nm, points_rc, pairs):
    """(src, dst) cells of the first-listed cells of each pair's ids."""
    first = {}
    for r, c, p in zip(*points_rc):
        first.setdefault(int(p), (int(r) - 1, int(c) - 1))
    return (np.asarray([first[a] for a, _ in pairs], np.int64),
            np.asarray([first[b] for _, b in pairs], np.int64))


@pytest.mark.parametrize("per_column", [False, True])
def test_solve_pairs_with_projector_matches_jax(per_column):
    """stencil_solve_pairs under the shared polygon projector (3 pairs,
    padded to 4 columns) and under a per-column one (3 pairs, padded
    with an all-trash row): resistances X[dst] - X[src] to 1e-6
    relative, and the same CG iteration count to within 2 (float32
    sums in another order)."""
    g, poly, points_rc = _raster(60, 50, 11)
    (S_j, prec_j, apply_j), (S_t, prec_t, apply_t) = _solver_pair(g)
    pairs = [(1, 2), (3, 6), (4, 5)]
    if per_column:
        nms = [jb.construct_node_map(g, jb.create_new_polymap(
            g, poly, points_rc, a, b)) for a, b in pairs]
        proj_j = jst.build_poly_projector_rows(nms, S_j.shape)
    else:
        nms = [jb.construct_node_map(g, poly)]
        proj_j = jst.build_poly_projector(nms[0], S_j.shape)
    src, dst = _pairs(nms[0], points_rc, pairs)
    Xj, relj, itj = jst.stencil_solve_pairs(S_j, src, dst, prec=prec_j,
                                            prec_apply=apply_j, proj=proj_j)
    Xt, relt, itt = tst.stencil_solve_pairs(S_t, src, dst, prec=prec_t,
                                            prec_apply=apply_t,
                                            proj=_carry(proj_j))
    assert relt.max() <= 1e-6 and relj.max() <= 1e-6
    cols = np.arange(3)
    Xj = np.asarray(Xj)
    rj = Xj[cols, dst[:, 0], dst[:, 1]] - Xj[cols, src[:, 0], src[:, 1]]
    Xt = Xt.numpy()
    rt = Xt[cols, dst[:, 0], dst[:, 1]] - Xt[cols, src[:, 0], src[:, 1]]
    assert np.all(rj > 0)
    assert np.abs(rt - rj).max() <= 1e-6 * np.abs(rj).max()
    assert abs(int(itt) - int(itj)) <= 2, (itt, itj)


def test_stencil_cg_with_projector_matches_jax():
    """stencil_cg (chunked) under the shared projector, with the V-cycle
    and a per-column tolerance array: both packages stop at their
    targets; the solutions agree to 1e-3 of max |X| (each stops at its
    own float32 residual) and take the same iterations to within 2."""
    g, poly, _ = _raster(60, 50, 12)
    (S_j, prec_j, apply_j), (S_t, prec_t, apply_t) = _solver_pair(g)
    proj_j = jst.build_poly_projector(jb.construct_node_map(g, poly),
                                      S_j.shape)
    H, W = S_j.shape
    B = np.zeros((2, H, W), np.float32)
    B[0, 10, 3], B[0, 40, 30] = -1.0, 1.0
    B[1, 4, 5], B[1, 50, 40] = -1.0, 1.0        # source in polygon 1
    assert g[10, 3] > 0 and g[40, 30] > 0 and g[50, 40] > 0
    B = np.array(jst.poly_project(proj_j, jnp.asarray(B)))
    rtol = np.array([1e-4, 1e-3])
    Xj, relj, itj = jst.stencil_cg(prec_j.levels[0].A, jnp.asarray(B), rtol,
                                   chunk=3, prec=prec_j, prec_apply=apply_j,
                                   proj=proj_j)
    Xt, relt, itt = tst.stencil_cg(prec_t.levels[0].A, torch.as_tensor(B),
                                   rtol, chunk=3, prec=prec_t,
                                   prec_apply=apply_t, proj=_carry(proj_j))
    assert np.all(relt.numpy() <= rtol) and np.all(np.asarray(relj) <= rtol)
    assert abs(int(itt) - int(itj)) <= 2, (itt, itj)
    Xj = np.asarray(Xj)
    assert np.abs(Xt.numpy() - Xj).max() <= 1e-3 * np.abs(Xj).max()


@pytest.mark.parametrize("per_column", [False, True])
def test_node_currents_with_projector_match_jax(per_column):
    """Merged-node currents (poly_sum of in/outflow) on random voltage
    blocks, float64 to 1e-12 and float32 to 1e-5 of max."""
    g, nm, rows = _nodemaps(23, 29, 13)
    S = jst.stencil_from_gmap_device(jnp.asarray(g), False, False)
    T = tst.stencil_from_gmap_device(torch.as_tensor(g), False, False)
    proj_j = (jst.build_poly_projector_rows(rows, g.shape) if per_column
              else jst.build_poly_projector(nm))
    proj_t = _carry(proj_j)
    V = np.random.default_rng(14).standard_normal((3,) + g.shape)
    ref = np.asarray(jst.stencil_node_currents(S, jnp.asarray(V),
                                               proj=proj_j))
    got = tst.stencil_node_currents(T, torch.as_tensor(V), proj=proj_t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    ref = np.asarray(jst.stencil_node_currents(
        S, jnp.asarray(V), proj=proj_j, out_dtype=jnp.float32))
    got = tst.stencil_node_currents(T, torch.as_tensor(V), proj=proj_t,
                                    out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
