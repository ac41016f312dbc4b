"""Raster pairwise scenario driver.

Counterpart of circuitscape_tpu/drivers/raster.py, no-polygons path.
Parity reference: src/raster/pairwise.jl:14-69,192-269 (raster_pairwise,
the no-polygons path, exclude-pair generation).  Polygons and focal
regions are not carried yet (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from .. import out
from ..graph import build
from ..io.loaders import load_raster_data
from ..solve.dispatch import get_solver
from ..timer import CSTIMER
from .core import GraphProblem, single_ground_all_pairs
from .flags import get_raster_flags

_NO_POLYGONS = ("polygons and focal regions are not carried by "
                "circuitscape_tpu_torch yet (ROADMAP queue 1 item 7)")


def raster_pairwise(cfg, dtype, device):
    """src/raster/pairwise.jl:14-30."""
    if cfg.use_polygons:
        raise NotImplementedError(_NO_POLYGONS)
    with CSTIMER("load raster data"):
        rasterdata = load_raster_data(cfg, dtype)
    flags = get_raster_flags(cfg)

    pts = rasterdata.points_rc[2]
    if len(pts) != len(np.unique(pts)):
        raise NotImplementedError(_NO_POLYGONS)
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
    """src/raster/pairwise.jl:192-238 (stencil-eligible jobs only: the
    sparse Laplacian is deferred, components come from the grid)."""
    cellmap = data.cellmap
    points_rc = data.points_rc

    nodemap = build.construct_node_map(cellmap, data.polymap)
    G = LazyStencilGraph(cellmap, nodemap, flags.avg_res,
                         flags.four_neighbors, dtype)
    cc = _grid_components(cellmap, nodemap, flags.four_neighbors)

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
                        exclude_pairs, nodemap, data.polymap, data.hbmeta,
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
