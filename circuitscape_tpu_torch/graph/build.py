"""Graph construction: node maps, polygon collapse, stencil graph assembly,
Laplacian.

Parity reference: src/raster/pairwise.jl:271-362 (construct_node_map,
relabel!, construct_graph), src/core.jl:608-634 (laplacian!).

Counterpart of circuitscape_tpu/graph/build.py, with create_new_polymap
(the per-pair focal-region map and the one-to-all point map,
src/raster/pairwise.jl:369-442) and components (src/core.jl connected
components).

Design notes: the raster-to-graph step is a stencil, so edge assembly is
done with whole-array shifted-plane operations (4 directed neighbor
planes), not per-cell pushes.  The resulting COO triples feed a scipy
CSR on the host.  A job without polygons never needs it (the stencil
planes build on the device, solve/stencil.py), so LazyStencilGraph only
materializes it on demand; with a polygon map its components come from
this CSR, since a polygon can join two grid islands.

Conventions: node maps use 0 = "no node" and 1-based node ids numbered in
column-major order, exactly like the reference, so unit tests and output
orderings line up.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components as _cc


# Edge-weight rules (src/raster/pairwise.jl:364-367)
def res_avg(x, y):
    return 1.0 / ((1.0 / x + 1.0 / y) / 2.0)


def cond_avg(x, y):
    return (x + y) / 2.0


def weird_avg(x, y):
    return (x + y) / (2.0 * np.sqrt(2.0))


def weirder_avg(x, y):
    return 1.0 / (np.sqrt(2.0) * (1.0 / x + 1.0 / y) / 2.0)


def construct_node_map(gmap: np.ndarray, polymap: np.ndarray) -> np.ndarray:
    """Number occupied cells 1..n (column-major), collapsing polygons
    (src/raster/pairwise.jl:271-301)."""
    nodemap = np.zeros(gmap.shape, np.int64)
    ind = gmap > 0
    # column-major sequential numbering
    nm_t = nodemap.T
    nm_t[ind.T] = np.arange(1, int(ind.sum()) + 1)

    if polymap.size == 0:
        return nodemap

    polymap_pruned = np.zeros(gmap.shape, np.int64)
    polymap_pruned[ind] = polymap[ind]

    # unique polygon ids in column-major first-appearance order
    seen = {}
    for v in polymap.T.ravel():
        if v != 0 and v not in seen:
            seen[v] = True
    for polynum in seen:
        idx1 = polymap_pruned.T == polynum
        idx2 = polymap.T == polynum
        if idx1.any():
            first = nodemap.T[idx1].flat[0]
            nodemap.T[idx2] = first
    relabel(nodemap, 1)
    return nodemap


def relabel(nodemap: np.ndarray, offset: int = 0) -> None:
    """Densely renumber nonzero labels by rank, in place
    (src/raster/pairwise.jl:303-314)."""
    mask = nodemap != 0
    vals = nodemap[mask]
    uniq, inv = np.unique(vals, return_inverse=True)
    nodemap[mask] = inv + offset


def construct_graph(gmap: np.ndarray, nodemap: np.ndarray, avg_res: bool,
                    four_neighbors: bool) -> sp.csr_matrix:
    """Assemble the neighbor-stencil conductance graph
    (src/raster/pairwise.jl:316-362).

    Vectorized: each of the 4 directed neighbor offsets (E, S, SE, NE)
    contributes one shifted-plane batch of edges.  Duplicate (i, j)
    entries (collapsed polygon nodes) are summed, as in sparse().
    """
    f1 = res_avg if avg_res else cond_avg
    f2 = weirder_avg if avg_res else weird_avg

    rows_i = []
    rows_j = []
    vals = []

    def add_edges(src_sl, dst_sl, fn):
        nm_src = nodemap[src_sl]
        nm_dst = nodemap[dst_sl]
        mask = (nm_src != 0) & (nm_dst != 0)
        if not mask.any():
            return
        rows_i.append(nm_src[mask])
        rows_j.append(nm_dst[mask])
        # gmap can be 0 under a polygon-collapsed node; inf-conductance
        # averages resolve exactly like the reference's 1/0 arithmetic
        with np.errstate(divide="ignore"):
            vals.append(fn(gmap[src_sl][mask], gmap[dst_sl][mask]))

    # Horizontal neighbor: (i, j) -- (i, j+1)
    add_edges(np.s_[:, :-1], np.s_[:, 1:], f1)
    # Vertical neighbor: (i, j) -- (i+1, j)
    add_edges(np.s_[:-1, :], np.s_[1:, :], f1)
    if not four_neighbors:
        # Diagonal: (i, j) -- (i+1, j+1)
        add_edges(np.s_[:-1, :-1], np.s_[1:, 1:], f2)
        # Anti-diagonal: (i, j) -- (i-1, j+1)
        add_edges(np.s_[1:, :-1], np.s_[:-1, 1:], f2)

    m = int(nodemap.max())
    if rows_i:
        I = np.concatenate(rows_i) - 1
        J = np.concatenate(rows_j) - 1
        V = np.concatenate(vals)
    else:
        I = J = np.zeros(0, np.int64)
        V = np.zeros(0, gmap.dtype)
    a = sp.coo_matrix((V.astype(gmap.dtype), (I, J)), shape=(m, m)).tocsr()
    a = (a + a.T).tocsr()
    a.sum_duplicates()
    return a


def laplacian(a: sp.spmatrix) -> sp.csr_matrix:
    """Graph Laplacian from (possibly self-looped) adjacency
    (src/core.jl:608-634): diagonal entries dropped, off-diagonals negated,
    diagonal = off-diagonal column sums."""
    a = a.tocsr()
    d = a.diagonal()
    offdiag = a - sp.diags(d)
    s = np.asarray(offdiag.sum(axis=0)).ravel()
    L = sp.diags(s) - offdiag
    return L.tocsr()


def components(a: sp.spmatrix):
    """Connected components as sorted 1-based node-id arrays, ordered by
    smallest member (matches Graphs.jl connected_components), grouped
    with one argsort over the labels."""
    n = a.shape[0]
    ncomp, labels = _cc(a, directed=False)
    if ncomp == 0:
        return []
    first = np.full(ncomp, n, np.int64)
    np.minimum.at(first, labels, np.arange(n, dtype=np.int64))
    rank = np.empty(ncomp, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(ncomp)
    r = rank[labels]
    order = np.argsort(r, kind="stable").astype(np.int64) + 1
    counts = np.bincount(r, minlength=ncomp)
    return np.split(order, np.cumsum(counts)[:-1])


def construct_local_node_map(nodemap: np.ndarray, component: np.ndarray,
                             polymap: np.ndarray) -> np.ndarray:
    """Component-local node map: rank of node id within the sorted
    component, 1-based (src/utils.jl:8-30)."""
    local = np.zeros_like(nodemap)
    comp_sorted = np.sort(np.asarray(component))
    mask = np.isin(nodemap, comp_sorted)
    local[mask] = np.searchsorted(comp_sorted, nodemap[mask]) + 1
    return local


def create_new_polymap(gmap: np.ndarray, polymap: np.ndarray, points_rc,
                       pt1=0, pt2=0, point_map=None) -> np.ndarray:
    """Merge focal points or regions into the polygon map
    (src/raster/pairwise.jl:369-442).  The pairwise form merges the focal
    regions pt1 and pt2: a region of several cells becomes one polygon,
    joined with any polygon it overlaps.  Given a point_map (one-to-all
    and all-to-one), every focal cell outside a polygon becomes a polygon
    of its own (id point + max polygon id), and a focal region that
    overlaps polygons takes them over."""
    rows, cols, pts = points_rc

    def cell(x):
        return (int(rows[x]) - 1, int(cols[x]) - 1)

    if point_map is not None and point_map.size:
        if polymap.size == 0:
            return point_map.copy()
        newpoly = polymap.copy()
        if len(pts) == len(np.unique(pts)):
            k = polymap.max()
            for c, r in zip(*np.nonzero(point_map.T)):   # column-major
                if polymap[r, c] == 0:
                    newpoly[r, c] = point_map[r, c] + k
        else:
            k = max(polymap.max(), point_map.max())
            for c, r in zip(*np.nonzero(point_map.T)):
                v1 = point_map[r, c]
                v2 = newpoly[r, c]
                if v2 == 0:
                    newpoly[r, c] = k + v1
                elif v1 != v2:
                    newpoly[newpoly == v2] = v1
        return newpoly

    if polymap.size == 0:
        newpoly = np.zeros(gmap.shape, np.int64)
        for x in np.nonzero(pts == pt1)[0]:
            newpoly[cell(x)] = pt1
        for x in np.nonzero(pts == pt2)[0]:
            newpoly[cell(x)] = pt2
        return newpoly

    newpoly = polymap.copy()
    k = polymap.max()
    for p in (pt1, pt2):
        idx = np.nonzero(pts == p)[0]
        if len(idx) == 1:
            continue
        poly_at = [polymap[cell(x)] for x in idx]
        if all(v == 0 for v in poly_at):
            for x in idx:
                newpoly[cell(x)] = k + 1
            k += 1
        else:
            nz = [x for x in idx if polymap[cell(x)] != 0]
            if len(nz) == 1:
                # reference intent (src/raster/pairwise.jl:428-430): collapse
                # all cells of this point onto the one existing polygon id
                target = polymap[cell(nz[0])]
                for x in idx:
                    newpoly[cell(x)] = target
            else:
                vals = {polymap[cell(x)] for x in nz}
                overlap = np.isin(polymap, list(vals))
                newpoly[overlap] = k + 1
                k += 1
    return newpoly
