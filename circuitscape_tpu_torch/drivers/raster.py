"""Raster pairwise scenario driver.

Counterpart of circuitscape_tpu/drivers/raster.py.  Parity reference:
src/raster/pairwise.jl:14-269 (raster_pairwise, the no-polygons and
focal-region paths, exclude-pair generation).  Short-circuit polygons
run on the stencil path as a projector; focal regions (a point file
with repeated ids) solve all pairs as one batched stencil solve with a
per-pair projector above CS_PAIRWISE_DEVICE_MIN cells with cg+amg, and
otherwise pair by pair, each pair's graph rebuilt with its two regions
merged (the reference's loop, kept by the JAX package).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from scipy import ndimage

from .. import consts, cslog, out, stats
from ..graph import build
from ..io.loaders import load_raster_data
from ..solve.dispatch import get_solver
from ..timer import CSTIMER
from .core import GraphProblem, _save_padded, single_ground_all_pairs
from .flags import get_raster_flags


def raster_pairwise(cfg, dtype, device):
    """src/raster/pairwise.jl:14-30."""
    with CSTIMER("load raster data"):
        rasterdata = load_raster_data(cfg, dtype)
    flags = get_raster_flags(cfg)

    pts = rasterdata.points_rc[2]
    if len(pts) != len(np.unique(pts)):
        return _pt_file_polygons_path(rasterdata, flags, cfg, dtype, device)
    return _pt_file_no_polygons_path(rasterdata, flags, cfg, dtype, device)


def _pt_file_no_polygons_path(rasterdata, flags, cfg, dtype, device):
    """src/raster/pairwise.jl:55-69."""
    with CSTIMER("construct graph"):
        graphdata = compute_graph_data_no_polygons(rasterdata, flags, cfg,
                                                   dtype)
    with CSTIMER("solve pairwise resistances"):
        r = single_ground_all_pairs(graphdata, flags, cfg, device)

    of = flags.outputflags
    if of.write_cur_maps or of.write_cum_cur_map_only:
        with CSTIMER("write cumulative current maps"):
            out.write_cum_maps(graphdata.cum, rasterdata.cellmap, cfg,
                               rasterdata.hbmeta, of.write_max_cur_maps,
                               of.write_cum_cur_map_only)
    return r


def _pt_file_polygons_path(rasterdata, flags, cfg, dtype, device):
    """The point file holds focal regions (src/raster/pairwise.jl:72-135):
    every pair solves with its own merge of the two regions, in one
    batched device solve (_regions_device_path) or, where that declines,
    pair by pair on a rebuilt graph (compute_graph_data_polygons)."""
    gmap = rasterdata.cellmap
    points_rc = rasterdata.points_rc
    included_pairs = rasterdata.included_pairs
    if included_pairs.isempty():
        exclude_pairs = []
    else:
        exclude_pairs = generate_exclude_pairs(points_rc, included_pairs)

    cum = out.initialize_cum_maps(gmap, flags.outputflags.write_max_cur_maps)

    pts = list(dict.fromkeys(int(p) for p in points_rc[2]))
    npts = len(pts)
    resistances = -np.ones((npts, npts), dtype)

    n = npts * (npts - 1) // 2
    cslog.info("Total number of pair solves = %s", n)
    exclude_set = set(exclude_pairs)
    with CSTIMER("solve pairwise resistances"):
        done = _regions_device_path(rasterdata, flags, cfg, dtype, pts,
                                    exclude_set, cum, resistances, device)
        k = 1
        for i in range(0 if done else npts):
            for j in range(i + 1, npts):
                pt1, pt2 = pts[i], pts[j]
                cslog.info("Solving pair %s of %s", k, n)
                k += 1
                if (pt1, pt2) in exclude_set or (pt2, pt1) in exclude_set:
                    continue
                graphdata = compute_graph_data_polygons(
                    rasterdata, flags, pt1, pt2, cum, cfg, dtype)
                pairwise_resistance = single_ground_all_pairs(
                    graphdata, flags, cfg, device, log=False)
                resistances[i, j] = resistances[j, i] = \
                    pairwise_resistance[1, 2]

    of = flags.outputflags
    if of.write_cur_maps or of.write_cum_cur_map_only:
        out.write_cum_maps(cum, gmap, cfg, rasterdata.hbmeta,
                           of.write_max_cur_maps, of.write_cum_cur_map_only)
    return _save_padded(resistances, pts, cfg)


def _region_jobs(rasterdata, flags, pts, exclude_set):
    """One job per connected pair of focal regions, each with its own
    node map (the two regions merged on top of the polygons), in pair
    order.  Connectivity of the merged graph is a union-find over the
    grid's components, joined by the polygons; a pair whose first-listed
    cells lie in different merged components, or on no component, keeps
    resistance -1.

    Returns (jobs [(i, j, nodemap, src_cell, dst_cell, root_of_base,
    root_src)], grid component labels)."""
    gmap = rasterdata.cellmap
    polymap = rasterdata.polymap
    points_rc = rasterdata.points_rc
    structure = (np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
                 if flags.four_neighbors else np.ones((3, 3), np.int64))
    labels, nlab = ndimage.label(gmap > 0, structure=structure)

    # first-listed cell of each focal region id
    first_cell = {}
    for r, c, p in zip(points_rc[0], points_rc[1], points_rc[2]):
        first_cell.setdefault(int(p), (int(r) - 1, int(c) - 1))

    npts = len(pts)
    jobs = []
    for i in range(npts):
        for j in range(i + 1, npts):
            pt1, pt2 = pts[i], pts[j]
            if (pt1, pt2) in exclude_set or (pt2, pt1) in exclude_set:
                continue
            newpoly = build.create_new_polymap(gmap, polymap, points_rc,
                                               pt1, pt2)
            nodemap = build.construct_node_map(gmap, newpoly)
            parent = np.arange(nlab + 1, dtype=np.int64)

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            mask = (newpoly > 0) & (gmap > 0)
            pl = newpoly[mask]
            bl = labels[mask]
            order = np.argsort(pl, kind="stable")
            pl_s, bl_s = pl[order], bl[order]
            starts = np.nonzero(np.diff(pl_s, prepend=-1))[0]
            ends = np.append(starts[1:], len(pl_s))
            for s0, s1 in zip(starts, ends):
                ra = find(bl_s[s0])
                for b in np.unique(bl_s[s0:s1]):
                    parent[find(b)] = ra
            sc = first_cell[int(pt1)]
            dc = first_cell[int(pt2)]
            rs = find(labels[sc])
            rd = find(labels[dc])
            if rs != rd or rs == 0:
                continue   # disconnected pair: resistance stays -1
            root_of_base = np.array([find(b) for b in range(nlab + 1)],
                                    np.int64)
            jobs.append((i, j, nodemap, sc, dc, root_of_base, rs))
    return jobs, labels


def _regions_device_path(rasterdata, flags, cfg, dtype, pts, exclude_set,
                         cum, resistances, device):
    """Batched stencil solve for focal-regions pairwise (counterpart of
    the JAX package's _regions_device_path).

    One shared operator and MG hierarchy; each pair is one RHS column
    and one row of a per-column PolyProjector that merges its two focal
    regions (on top of the polygons).  Resistances are X[dst] - X[src];
    current and voltage maps are zero outside the pair's merged
    component.  Returns True when it solved the job, False for grids
    below CS_PAIRWISE_DEVICE_MIN cells and solvers other than cg+amg,
    which take the per-pair loop."""
    from ..solve.dispatch import COLUMN_BYTES_PER_CELL, SolverFailedError
    from ..solve.prepare import prepare_stencil_solver_from_gmap
    from ..solve.stencil import (build_poly_projector_rows,
                                 stencil_node_currents, stencil_solve_pairs)

    gmap = rasterdata.cellmap
    min_cells = int(os.environ.get("CS_PAIRWISE_DEVICE_MIN", "40000"))
    if cfg.solver != "cg+amg" or gmap.size < min_cells:
        return False

    of = flags.outputflags
    H, W = gmap.shape
    cslog.info("focal-regions device path: shared operator, per-pair "
               "projector")
    with CSTIMER("prepare stencil solver (upload + MG setup)"):
        S64, prec, prec_apply, _ = prepare_stencil_solver_from_gmap(
            gmap, flags.avg_res, flags.four_neighbors, device)
    Hp, Wp = S64.shape
    dev = S64.diag.device

    with CSTIMER("construct pair node maps"):
        jobs, labels = _region_jobs(rasterdata, flags, pts, exclude_set)
    if not jobs:
        return True

    need_cur = (of.write_cur_maps or of.write_cum_cur_map_only or
                of.write_max_cur_maps)
    write_pair_files = of.write_cur_maps and not of.write_cum_cur_map_only
    if need_cur or of.write_volt_maps:
        labels_grid = np.zeros((Hp, Wp), np.int64)
        labels_grid[:H, :W] = labels
        labels_dev = torch.as_tensor(labels_grid, device=dev)

    # the JAX package's flat 4 GiB of solve blocks per chunk
    per_col = Hp * Wp * COLUMN_BYTES_PER_CELL
    step = max(1, min(2048, (4 << 30) // max(per_col, 1)))
    for s0 in range(0, len(jobs), step):
        chunk = jobs[s0:s0 + step]
        bsz = len(chunk)
        with CSTIMER("build polygon projector"):
            proj = build_poly_projector_rows([jb[2] for jb in chunk],
                                             (Hp, Wp), dev)
        src_cells = np.asarray([jb[3] for jb in chunk], np.int64)
        dst_cells = np.asarray([jb[4] for jb in chunk], np.int64)
        with CSTIMER("batched pair solve"):
            t0 = time.perf_counter()
            X, rel, iters = stencil_solve_pairs(
                S64, src_cells, dst_cells, rtol=consts.CG_RTOL,
                itmax=consts.CG_ITMAX, prec=prec, prec_apply=prec_apply,
                proj=proj)
            stats.record_solve(tuple(X.shape), iters,
                               time.perf_counter() - t0)
        if np.any(rel >= consts.RESIDUAL_GATE):
            raise SolverFailedError(
                f"CG solver did not converge: relative residual "
                f"{float(rel.max())} exceeds tolerance "
                f"{consts.RESIDUAL_GATE}")
        Xb = X[:bsz]
        cols = torch.arange(bsz, device=dev)
        scj = torch.as_tensor(src_cells, device=dev)
        dcj = torch.as_tensor(dst_cells, device=dev)
        vsrc = Xb[cols, scj[:, 0], scj[:, 1]]
        vals = (Xb[cols, dcj[:, 0], dcj[:, 1]] - vsrc).cpu().numpy()
        for col, jb in enumerate(chunk):
            i, j = jb[0], jb[1]
            resistances[i, j] = resistances[j, i] = float(vals[col])

        if not (need_cur or of.write_volt_maps):
            continue
        with CSTIMER("node currents + reduce"):
            # per-pair component mask from the merged union-find roots
            root_table = torch.as_tensor(np.stack([jb[5] for jb in chunk]),
                                         device=dev)
            root_src = torch.as_tensor([jb[6] for jb in chunk], device=dev)
            in_comp = root_table[:, labels_dev] == root_src[:, None, None]
            Xn = torch.where(in_comp, Xb - vsrc[:, None, None], 0.0)
            if need_cur:
                ncur = stencil_node_currents(S64, Xn, proj=proj)
                cum.cum_curr += torch.sum(ncur, dim=0).cpu().numpy().astype(
                    dtype)[:H, :W]
                if of.write_max_cur_maps:
                    np.maximum(cum.max_curr,
                               torch.amax(ncur, dim=0).cpu().numpy().astype(
                                   dtype)[:H, :W],
                               out=cum.max_curr)
                if write_pair_files:
                    ncur_h = ncur.float().cpu().numpy().astype(dtype)
            if of.write_volt_maps:
                volt_h = Xn.float().cpu().numpy().astype(dtype)
        with CSTIMER("write maps"):
            for col, jb in enumerate(chunk):
                name = f"_{int(pts[jb[0]])}_{int(pts[jb[1]])}"
                if need_cur and write_pair_files:
                    out.write_grid(ncur_h[col][:H, :W].copy(), name, cfg,
                                   rasterdata.hbmeta)
                if of.write_volt_maps:
                    out.write_grid(volt_h[col][:H, :W].copy(), name, cfg,
                                   rasterdata.hbmeta, voltage=True)
    return True


def compute_graph_data_polygons(rasterdata, flags, pt1, pt2, cum, cfg, dtype):
    """One focal-region pair's problem: the two regions merged into the
    polygon map, the graph rebuilt on it (src/raster/pairwise.jl:148-190)."""
    gmap = rasterdata.cellmap
    polymap = rasterdata.polymap
    points_rc = rasterdata.points_rc

    newpoly = build.create_new_polymap(gmap, polymap, points_rc, pt1, pt2)
    nodemap = build.construct_node_map(gmap, newpoly)
    a = build.construct_graph(gmap, nodemap, flags.avg_res,
                              flags.four_neighbors)
    G = build.laplacian(a)
    cc = build.components(a)

    pts = points_rc[2]
    x = int(np.nonzero(pts == pt1)[0][0])
    y = int(np.nonzero(pts == pt2)[0][0])
    c1 = nodemap[points_rc[0][x] - 1, points_rc[1][x] - 1]
    c2 = nodemap[points_rc[0][y] - 1, points_rc[1][y] - 1]
    points = np.asarray([c1, c2], np.int64)

    return GraphProblem(G, cc, points, np.asarray([pt1, pt2], np.int64),
                        [], nodemap, newpoly, rasterdata.hbmeta, gmap, cum,
                        get_solver(cfg))


class LazyStencilGraph:
    """Deferred CSR Laplacian for the raster stencil path.

    The whole job runs on the stencil operator, so the general sparse
    matrix is never needed on the solve path; this stands in for prob.G
    and materializes the real Laplacian only if asked."""

    def __init__(self, cellmap, nodemap, avg_res, four_neighbors, dtype):
        self._cellmap = cellmap
        self._nodemap = nodemap
        self._avg_res = avg_res
        self._four = four_neighbors
        n = int(nodemap.max())
        self.shape = (n, n)
        self.dtype = np.dtype(dtype)
        self._mat = None

    def materialize(self):
        if self._mat is None:
            a = build.construct_graph(self._cellmap, self._nodemap,
                                      self._avg_res, self._four)
            self._mat = build.laplacian(a).astype(self.dtype)
        return self._mat

    def tocsr(self):
        return self.materialize().tocsr()


def _grid_components(cellmap, nodemap, four_neighbors):
    """Connected components of the active-cell grid via ndimage labeling
    (equivalent to components of the stencil graph).  Grouping is one
    argsort over the active cells."""
    structure = (np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
                 if four_neighbors else np.ones((3, 3), np.int64))
    labels, nlab = ndimage.label(cellmap > 0, structure=structure)
    active = nodemap > 0
    lab_flat = labels[active]
    nodes_flat = nodemap[active]
    order = np.argsort(lab_flat, kind="stable")
    sorted_labs = lab_flat[order]
    sorted_nodes = nodes_flat[order]
    bounds = np.searchsorted(sorted_labs, np.arange(1, nlab + 2))
    comps = [np.sort(sorted_nodes[bounds[i]:bounds[i + 1]])
             for i in range(nlab) if bounds[i + 1] > bounds[i]]
    comps.sort(key=lambda c: c[0] if len(c) else 0)
    return comps


def compute_graph_data_no_polygons(data, flags, cfg, dtype):
    """src/raster/pairwise.jl:192-238.  Without a polygon map the sparse
    Laplacian is deferred and components come from the grid; with one,
    a polygon can join two grid islands, so the components are those of
    the collapsed graph's Laplacian."""
    cellmap = data.cellmap
    polymap = data.polymap
    points_rc = data.points_rc

    nodemap = build.construct_node_map(cellmap, polymap)
    if polymap.size == 0:
        G = LazyStencilGraph(cellmap, nodemap, flags.avg_res,
                             flags.four_neighbors, dtype)
        cc = _grid_components(cellmap, nodemap, flags.four_neighbors)
    else:
        G = build.laplacian(build.construct_graph(
            cellmap, nodemap, flags.avg_res, flags.four_neighbors))
        cc = build.components(G)

    if not data.included_pairs.isempty():
        exclude_pairs = generate_exclude_pairs(points_rc, data.included_pairs)
    else:
        exclude_pairs = []

    points = np.asarray(
        [nodemap[r - 1, c - 1]
         for r, c in zip(points_rc[0], points_rc[1])], np.int64)

    cum = out.initialize_cum_maps(cellmap,
                                  flags.outputflags.write_max_cur_maps)
    solver = get_solver(cfg)

    return GraphProblem(G, cc, points, np.asarray(points_rc[2], np.int64),
                        exclude_pairs, nodemap, polymap, data.hbmeta,
                        cellmap, cum, solver)


def generate_exclude_pairs(points_rc, included_pairs):
    """src/raster/pairwise.jl:240-269.  In include mode, also prunes
    points_rc in place to the listed ids."""
    exclude = []
    mat = included_pairs.include_pairs
    point_ids = included_pairs.point_ids

    if included_pairs.mode == "include":
        prune_points(points_rc, point_ids)
        for j in range(mat.shape[1]):
            for i in range(mat.shape[0]):
                if mat[i, j] == 0 and mat[j, i] == 0:
                    exclude.append((int(point_ids[i]), int(point_ids[j])))
    else:
        for j in range(mat.shape[1]):
            for i in range(mat.shape[0]):
                if mat[i, j] == 1 and mat[j, i] == 1:
                    exclude.append((int(point_ids[i]), int(point_ids[j])))
    return exclude


def prune_points(points_rc, point_ids):
    """Keep only focal points listed in point_ids, in place
    (src/raster/onetoall.jl:169-180)."""
    keep = np.isin(points_rc[2], point_ids)
    for k in range(3):
        arr = points_rc[k]
        pruned = arr[keep]
        # in-place resize semantics: caller holds the tuple, so rebuild
        arr.resize(pruned.shape, refcheck=False)
        arr[:] = pruned
