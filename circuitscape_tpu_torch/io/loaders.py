"""Input data loaders: cell maps, polygons, focal points, sources/grounds,
include/exclude pairs, network edge lists.

Counterpart of circuitscape_tpu/io/loaders.py.
Parity reference: src/io.jl:1-556.  Conventions preserved from the
reference: node maps use 0 for "no node" and 1-based node numbers;
points_rc holds 1-based (row, col, point_id) triples; -9999 is the
universal nodata value after read_raster normalization.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field

import numpy as np

from .. import consts, cslog
from .raster import (RasterMeta, grid_reader, guess_file_type,
                     open_maybe_gzip)


@dataclass
class IncludeExcludePairs:
    """src/io.jl:5-13; mode is 'include', 'exclude', or 'undef'."""

    mode: str = "undef"
    point_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    include_pairs: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int64))

    def isempty(self) -> bool:
        return self.mode == "undef"


@dataclass
class NetworkData:
    """src/io.jl:15-20; coords is (i, j, conductance) with 1-based ids."""

    coords: tuple
    fp: np.ndarray
    source_map: np.ndarray
    ground_map: np.ndarray


@dataclass
class RasterData:
    """src/io.jl:37-46."""

    cellmap: np.ndarray
    polymap: np.ndarray
    source_map: np.ndarray
    ground_map: np.ndarray
    points_rc: tuple
    strengths: np.ndarray
    included_pairs: IncludeExcludePairs
    hbmeta: RasterMeta


def _readdlm(path: str, dtype=np.float64) -> np.ndarray:
    with open_maybe_gzip(path, "rt") as f:
        text = f.read()
    return np.loadtxt(_io.StringIO(text), dtype=dtype, ndmin=2)


def load_graph(path: str, dtype=np.float64):
    """Edge-list loader with 0-based -> 1-based renumbering
    (src/io.jl:48-72)."""
    g = _readdlm(path, np.float64)
    i = g[:, 0].astype(np.int64)
    j = g[:, 1].astype(np.int64)
    v = g[:, 2].astype(dtype)
    min_node = min(i.min(), j.min())
    if min_node > 1:
        raise ValueError(
            f"Your resistance file starts counting nodes from {min_node}. "
            "Node numbering must start from 0 or 1."
        )
    starts_from_zero = min_node == 0
    if starts_from_zero:
        cslog.info("Node numbering starts from 1, not 0. "
                   "This will be reflected in the outputs.")
        i = i + 1
        j = j + 1
    return i, j, v, starts_from_zero


def read_focal_points(path: str) -> np.ndarray:
    """src/io.jl:74-82: 1-column node list; 0-based shifted up."""
    ret = _readdlm(path).ravel().astype(np.int64)
    if ret.min() == 0:
        ret = ret + 1
    return ret


def read_point_strengths(path: str, starts_from_zero: bool, dtype=np.float64):
    """src/io.jl:84-89: (node, strength) rows; renumber if 0-based."""
    s = _readdlm(path, dtype)
    if s[:, 0].min() == 0 or starts_from_zero:
        s = s.copy()
        s[:, 0] = s[:, 0] + 1
    return s


def read_cellmap(habitat_file: str, is_res: bool, dtype=np.float64):
    """Habitat map -> conductance map (src/io.jl:91-111)."""
    cell_map, rastermeta = grid_reader(habitat_file, np.float64)
    nodata_mask = cell_map == consts.NODATA
    if is_res:
        if np.any(cell_map == 0):
            raise ValueError(
                "Error: zero resistance values are not currently supported "
                "for habitat maps. Use a short-circuit region file instead.")
        with np.errstate(divide="ignore"):
            gmap = 1.0 / cell_map
        gmap[nodata_mask] = 0
    else:
        gmap = cell_map.copy()
        gmap[nodata_mask] = 0
    return gmap.astype(dtype), rastermeta


def read_polymap(path: str, habitatmeta: RasterMeta, nodata_as=0,
                 dtype=np.int64) -> np.ndarray:
    """Polygon/region map reader with meta-consistency warnings
    (src/io.jl:159-194)."""
    polymap, rastermeta = grid_reader(path, np.float64)

    if nodata_as != -1:
        polymap = polymap.copy()
        polymap[polymap == rastermeta.nodata] = nodata_as

    if rastermeta.cellsize != habitatmeta.cellsize:
        cslog.warn("cellsize is not the same")
    elif rastermeta.ncols != habitatmeta.ncols:
        cslog.warn("ncols is not the same")
    elif rastermeta.nrows != habitatmeta.nrows:
        cslog.warn("nrows is not the same")
    elif rastermeta.yllcorner != habitatmeta.yllcorner:
        cslog.warn("yllcorner is not the same")
    elif rastermeta.xllcorner != habitatmeta.xllcorner:
        cslog.warn("xllcorner is not the same")

    if dtype is not None and np.issubdtype(np.dtype(dtype), np.integer):
        if not np.all(np.equal(np.mod(polymap, 1), 0)):
            cslog.logger.error(
                "Your node file (point_file in the .ini) contains "
                "non-integer values. See the docs on specifying nodes "
                "for more information.")
        polymap = polymap.astype(dtype)
    return polymap


def read_point_map(path: str, habitatmeta: RasterMeta):
    """Focal point reader: grid or txt list (src/io.jl:196-249).

    Returns 1-based (rows, cols, point_ids), sorted by point id.
    """
    if path == "none":
        return (np.zeros(0, np.int64),) * 3

    filetype = guess_file_type(path)
    if filetype == consts.FILE_TYPE_TXTLIST:
        pts = _readdlm(path)
        v = pts[:, 0]
        x = pts[:, 1]
        y = pts[:, 2]
        i = np.ceil(habitatmeta.nrows -
                    (y - habitatmeta.yllcorner) / habitatmeta.cellsize
                    ).astype(np.int64)
        j = np.ceil((x - habitatmeta.xllcorner) / habitatmeta.cellsize
                    ).astype(np.int64)
    else:
        grid = read_polymap(path, habitatmeta, dtype=np.int64)
        # column-major order to match Julia findall on matrices
        jj, ii = np.nonzero(grid.T)
        i = (ii + 1).astype(np.int64)
        j = (jj + 1).astype(np.int64)
        v = grid[ii, jj]

    v = np.asarray(v, np.float64)
    keep = v >= 0
    i, j, v = i[keep], j[keep], v[keep]

    idx = np.argsort(v, kind="stable")
    i, j, v = i[idx], j[idx], v[idx]

    if (i.size and (i.min() < 0 or j.min() < 0 or
                    i.max() > habitatmeta.nrows or
                    j.max() > habitatmeta.ncols)):
        raise ValueError("At least one focal node location falls outside "
                         "of habitat map")
    if np.unique(v).size < 2:
        raise ValueError("Less than two valid focal nodes found. Please "
                         "check focal node location file.")
    return i, j, v.astype(np.int64)


def _txt_list_reader(path: str, habitatmeta: RasterMeta, dtype=np.float64):
    """(value, x, y) list -> (value, row, col), 1-based (src/io.jl:315-326)."""
    points = _readdlm(path, dtype)
    out = np.zeros_like(points)
    try:
        out[:, 0] = points[:, 0]
        out[:, 1] = np.ceil(habitatmeta.nrows -
                            (points[:, 2] - habitatmeta.yllcorner)
                            / habitatmeta.cellsize)
        out[:, 2] = np.ceil((points[:, 1] - habitatmeta.xllcorner)
                            / habitatmeta.cellsize)
    except Exception as e:
        raise ValueError(
            "Error extracting locations from text list file") from e
    return out


def read_source_and_ground_maps(source_file: str, ground_file: str,
                                habitatmeta: RasterMeta, is_res: bool, cfg,
                                dtype=np.float64):
    """Advanced-mode source/ground maps (src/io.jl:252-313): grids or
    (value, x, y) lists; resistance grounds invert to conductances, with
    1/0 = inf marking a direct ground."""
    ftype = guess_file_type(ground_file)
    if ftype in (consts.FILE_TYPE_AAGRID, consts.FILE_TYPE_GEOTIFF,
                 consts.FILE_TYPE_NPY):
        ground_map = read_polymap(ground_file, habitatmeta, nodata_as=-1,
                                  dtype=None).astype(dtype)
    elif ftype == consts.FILE_TYPE_TXTLIST:
        rc = _txt_list_reader(ground_file, habitatmeta, dtype)
        ground_map = np.full((habitatmeta.nrows, habitatmeta.ncols),
                             consts.NODATA, dtype)
        for v, x, y in rc:
            ground_map[int(x) - 1, int(y) - 1] = v
    else:
        raise ValueError("Cannot recognise file type.")

    ftype = guess_file_type(source_file)
    if ftype in (consts.FILE_TYPE_AAGRID, consts.FILE_TYPE_GEOTIFF,
                 consts.FILE_TYPE_NPY):
        source_map = read_polymap(source_file, habitatmeta,
                                  dtype=None).astype(dtype)
        source_map[source_map == consts.NODATA] = 0
    elif ftype == consts.FILE_TYPE_TXTLIST:
        rc = _txt_list_reader(source_file, habitatmeta, dtype)
        source_map = np.zeros((habitatmeta.nrows, habitatmeta.ncols), dtype)
        for v, x, y in rc:
            source_map[int(x) - 1, int(y) - 1] = v
    else:
        raise ValueError("Cannot recognize file type.")

    if is_res:
        nodata_mask = ground_map == consts.NODATA
        with np.errstate(divide="ignore"):
            ground_map = 1.0 / ground_map
        ground_map[nodata_mask] = 0
    else:
        ground_map[ground_map == consts.NODATA] = 0

    if cfg.use_unit_currents:
        source_map[source_map != 0] = 1
    if cfg.use_direct_grounds:
        ground_map[ground_map != 0] = np.inf

    return source_map, ground_map


def read_included_pairs(path: str) -> IncludeExcludePairs:
    """Include/exclude pairs reader, both formats (src/io.jl:328-385)."""
    filetype = guess_file_type(path)

    if filetype == consts.FILE_TYPE_INCL_PAIRS_AAGRID:
        with open_maybe_gzip(path, "rt") as f:
            minval = float(f.readline().split()[1])
            maxval = float(f.readline().split()[1])
            body = np.loadtxt(f, ndmin=2)
        point_ids = body[1:, 0].astype(np.int64)
        mat = body[1:, 1:]
        mat = np.where(mat > maxval, 0, mat)
        binmat = (mat >= minval).astype(np.int64)
        return IncludeExcludePairs("include", point_ids, binmat)

    if filetype == consts.FILE_TYPE_INCL_PAIRS:
        with open_maybe_gzip(path, "rt") as f:
            mode = f.readline().split()[1]
            pairs = np.loadtxt(f, ndmin=2).astype(np.int64)
        point_ids = np.unique(pairs)
        if np.any(point_ids == 0):
            point_ids = point_ids[point_ids != 0]
            cslog.warn("Code to include pairs is activated, some entries "
                       "did not match with focal node file. Some focal "
                       "nodes may have been dropped")
        npts = point_ids.size
        mat = np.zeros((npts, npts), np.int64)
        id_to_idx = {p: k for k, p in enumerate(point_ids)}
        for a, b in pairs:
            ia, ib = id_to_idx.get(a), id_to_idx.get(b)
            if ia is not None and ib is not None:
                mat[ia, ib] = 1
                mat[ib, ia] = 1
        return IncludeExcludePairs(mode, point_ids, mat)

    raise ValueError("Error reading focal node include/exclude pairs file. "
                     "Please check file format.")


def apply_mask(cellmap: np.ndarray, mask_file: str, hbmeta: RasterMeta):
    """Zero out cells where the mask is <= 0 (src/io.jl:510-514)."""
    mask = read_polymap(mask_file, hbmeta, dtype=None)
    mask = (mask > 0).astype(cellmap.dtype)
    cellmap *= mask


def get_network_data(cfg, dtype=np.float64) -> NetworkData:
    """src/io.jl:387-418."""
    is_pairwise = cfg.scenario == "pairwise"
    i, j, v, starts_from_zero = load_graph(cfg.habitat_file, dtype)
    if cfg.habitat_map_is_resistances:
        v = 1.0 / v

    if is_pairwise:
        fp = read_focal_points(cfg.point_file)
        source_list = np.zeros((0, 0), dtype)
        ground_list = np.zeros((0, 0), dtype)
    else:
        fp = np.zeros(0, np.int64)
        source_list = read_point_strengths(cfg.source_file,
                                           starts_from_zero, dtype)
        ground_list = read_point_strengths(cfg.ground_file,
                                           starts_from_zero, dtype)
    return NetworkData((i, j, v), fp, source_list, ground_list)


def load_raster_data(cfg, dtype=np.float64) -> RasterData:
    """src/io.jl:420-508."""
    is_advanced = cfg.scenario == "advanced"

    cslog.info("Reading maps")
    cellmap, hbmeta = read_cellmap(cfg.habitat_file,
                                   cfg.habitat_map_is_resistances, dtype)
    c = int(np.count_nonzero(cellmap > 0))
    ncells = cellmap.size
    if ncells > 5_000_000 and cfg.solver == "cholmod":
        cslog.warn(
            "The landscape has %s cells and the CHOLMOD solver is selected. "
            "CHOLMOD is a sparse direct solver that consumes a lot of memory "
            "on large grids. Consider using solver = cg+amg instead.", ncells)
    cslog.info("Resistance/Conductance map has %s nodes", c)

    if cfg.use_polygons:
        polymap = read_polymap(cfg.polygon_file, hbmeta)
    else:
        polymap = np.zeros((0, 0), np.int64)

    if cfg.use_mask:
        apply_mask(cellmap, cfg.mask_file, hbmeta)
        if cellmap.sum() == 0:
            raise ValueError("Mask file deleted everything!")

    if not is_advanced:
        points_rc = read_point_map(cfg.point_file, hbmeta)
    else:
        points_rc = (np.zeros(0, np.int64),) * 3

    if is_advanced:
        source_map, ground_map = read_source_and_ground_maps(
            cfg.source_file, cfg.ground_file, hbmeta,
            cfg.ground_file_is_resistances, cfg, dtype)
    else:
        source_map = np.zeros((0, 0), dtype)
        ground_map = np.zeros((0, 0), dtype)

    if cfg.use_included_pairs:
        included_pairs = read_included_pairs(cfg.included_pairs_file)
    else:
        included_pairs = IncludeExcludePairs()

    if cfg.use_variable_source_strengths:
        strengths = read_point_strengths(cfg.variable_source_file, False, dtype)
    else:
        strengths = np.zeros((0, 0), dtype)

    return RasterData(cellmap, polymap, source_map, ground_map, points_rc,
                      strengths, included_pairs, hbmeta)
