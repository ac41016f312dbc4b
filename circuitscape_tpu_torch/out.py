"""Output system: resistance files, current/voltage maps, accumulators.

Counterpart of circuitscape_tpu/out.py.  Parity reference:
src/out.jl:1-531.  The stencil device path makes its grids on the
device (solve/stencil.py stencil_node_currents); the general
sparse-graph tier's per-pair maps and the network node and branch
currents are computed here on the host in numpy, as in the JAX package:
cumulative vectors accumulate as batched reductions over the pair axis
(no locks), branch and node currents vectorized over edge arrays.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from . import consts
from .io.raster import write_raster


@dataclass
class OutputFlags:
    """src/out.jl:1-10."""

    write_volt_maps: bool = False
    write_cur_maps: bool = False
    write_cum_cur_map_only: bool = False
    write_max_cur_maps: bool = False
    set_null_currents_to_nodata: bool = False
    set_null_voltages_to_nodata: bool = False
    compress_grids: bool = False
    log_transform_maps: bool = False

    @property
    def any_maps(self) -> bool:
        return (self.write_volt_maps or self.write_cur_maps or
                self.write_cum_cur_map_only or self.write_max_cur_maps)


def get_output_flags(cfg) -> OutputFlags:
    return OutputFlags(cfg.write_volt_maps, cfg.write_cur_maps,
                       cfg.write_cum_cur_map_only, cfg.write_max_cur_maps,
                       cfg.set_null_currents_to_nodata,
                       cfg.set_null_voltages_to_nodata,
                       cfg.compress_grids, cfg.log_transform_maps)


@dataclass
class Cumulative:
    """src/core.jl:1-8 minus the lock (accumulation is single-owner)."""

    cum_curr: np.ndarray
    max_curr: np.ndarray
    cum_branch_curr: np.ndarray
    cum_node_curr: np.ndarray
    coords: list


def initialize_cum_maps(cellmap: np.ndarray, want_max=False) -> Cumulative:
    """src/utils.jl:124-133."""
    dtype = cellmap.dtype
    cum_curr = np.zeros(cellmap.shape, dtype)
    max_curr = (np.full(cellmap.shape, consts.NODATA, dtype)
                if want_max else np.zeros((0, 0), dtype))
    return Cumulative(cum_curr, max_curr, np.zeros(0, dtype),
                      np.zeros(0, dtype), [])


def initialize_cum_vectors(coords, num_nodes: int) -> Cumulative:
    """src/utils.jl:135-146."""
    i, j, v = coords
    dtype = v.dtype
    return Cumulative(np.zeros((0, 0), dtype), np.zeros((0, 0), dtype),
                      np.zeros(len(v), dtype), np.zeros(num_nodes, dtype),
                      [(int(a), int(b)) for a, b in zip(i, j)])


def _fmt(v) -> str:
    fv = float(v)
    if fv == int(fv) and abs(fv) < 1e15:
        return f"{fv:.1f}"
    return repr(fv)


def _writedlm(path: str, arr: np.ndarray, delim: str, digits: int = 17):
    """Julia-writedlm-style text matrix writer.

    Arrays above 20000 entries go through the native formatter
    (io/fastio.py; `digits` significant digits, 17 = exact float64
    round trip, 9 = exact float32 round trip for values computed in
    single precision; an integral value prints "3" where the Python
    path prints "3.0", the same number), as in the JAX package: the
    network pairwise job writes hundreds of node and branch current
    files of 10^5-2*10^5 rows, which the per-value Python formatter
    turns into minutes.  Smaller arrays take the shortest round-trip
    repr per value."""
    arr2 = np.atleast_2d(np.asarray(arr, np.float64))
    if arr2.size > 20000:
        from .io import fastio
        fastio.write_dlm_body(path, arr2, delim, digits=digits)
        return
    with open(path, "w") as f:
        for row in arr2:
            f.write(delim.join(_fmt(v) for v in row))
            f.write("\n")


def output_prefix(cfg) -> str:
    return cfg.output_file.split(".out")[0]


def compute_3col(resistances: np.ndarray) -> np.ndarray:
    """Pairwise matrix -> 3-column upper-triangle list (src/out.jl:12-26)."""
    fp = resistances[1:, 0]
    n = len(fp)
    iu, ju = np.triu_indices(n, k=1)
    out = np.zeros((iu.size, 3), resistances.dtype)
    out[:, 0] = fp[iu]
    out[:, 1] = fp[ju]
    out[:, 2] = resistances[ju + 1, iu + 1]
    return out


def save_resistances(r: np.ndarray, cfg) -> None:
    """src/out.jl:454-465."""
    pref = output_prefix(cfg)
    _writedlm(f"{pref}_resistances.out", r, " ")
    _writedlm(f"{pref}_resistances_3columns.out", compute_3col(r), " ")


def write_currents(node_curr_arr, branch_curr_arr, name, cfg) -> None:
    """Network node/branch current text files (src/out.jl:117-124).
    Branch currents within 1e-6 of zero are filtered (only 6 digits of
    precision are guaranteed by the solve)."""
    pref = output_prefix(cfg)
    keep = ~np.isclose(branch_curr_arr[:, 2], 0.0, atol=consts.OUTPUT_ATOL)
    _writedlm(f"{pref}_node_currents{name}.txt", node_curr_arr, "\t")
    _writedlm(f"{pref}_branch_currents{name}.txt", branch_curr_arr[keep],
              "\t")


def write_voltages(output_file: str, name: str, voltages: np.ndarray,
                   cc) -> None:
    """src/out.jl:412-419."""
    pref = output_file.split(".out")[0]
    arr = np.column_stack([np.asarray(cc, np.float64), voltages])
    _writedlm(f"{pref}_voltages{name}.txt", arr, "\t")


# ---------------------------------------------------------------------------
# Current computation (host, numpy)
# ---------------------------------------------------------------------------

def _upper_edges(G: sp.spmatrix):
    """Strict upper-triangle entries of symmetric G in CSC order
    (column-major), the reference's nzrange iteration
    (src/out.jl:222-248)."""
    coo = G.tocoo()
    mask = coo.col > coo.row
    r, c, v = coo.row[mask], coo.col[mask], coo.data[mask]
    order = np.lexsort((r, c))
    return r[order], c[order], v[order]


def _edges_cached(G: sp.spmatrix):
    """_upper_edges memoized on the matrix object: a pairwise job asks
    for one component matrix's edges once per pair."""
    cached = getattr(G, "_cs_upper_edges", None)
    if cached is None:
        cached = _upper_edges(G)
        G._cs_upper_edges = cached
    return cached


def _branch_current_values(vals, rows, cols, voltages, pos: bool):
    """src/out.jl:250-290: signed branch currents with the small-value
    cutoff."""
    if pos:
        b = np.abs(vals) * (voltages[rows] - voltages[cols])
    else:
        b = np.abs(vals) * (voltages[cols] - voltages[rows])
    if b.size:
        maxcur = b.max()
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.abs(b / maxcur)
        b = np.where(ratio < consts.BRANCH_CURRENT_CUTOFF, 0.0, b)
    return b


def get_node_currents(G: sp.spmatrix, voltages: np.ndarray, finitegrounds):
    """Node current = max(inflow, outflow) (src/out.jl:178-207).  For an
    upper edge (i, j) with signed branch value b, the clipped
    antisymmetric column sum receives b at j when b > 0 and -b at i when
    b < 0."""
    rows, cols, vals = _edges_cached(G)
    n = G.shape[0]

    def posneg(pos):
        b = _branch_current_values(vals, rows, cols, voltages, pos)
        s = np.zeros(n, np.result_type(voltages, b))
        m = b > 0
        np.add.at(s, cols[m], b[m])
        m = b < 0
        np.subtract.at(s, rows[m], b[m])
        fg = np.asarray(finitegrounds)
        if fg.size and fg[0] != -9999:
            fg_cur = fg * voltages
            if pos:
                fg_cur = np.where(fg_cur < 0, -fg_cur, 0.0)
            else:
                fg_cur = np.where(fg_cur > 0, fg_cur, 0.0)
            s = s + fg_cur
        return s

    return np.maximum(posneg(True), posneg(False))


def get_branch_currents_3col(G: sp.spmatrix, voltages: np.ndarray, cc):
    """Network branch currents as (node_i, node_j, |I|) rows in CSC order
    (src/out.jl:128-158)."""
    rows, cols, vals = _edges_cached(G)
    b = np.abs(_branch_current_values(vals, rows, cols, voltages, True))
    cc = np.asarray(cc, np.float64)
    return np.column_stack([cc[rows], cc[cols], b])


def _incidence_cached(G: sp.spmatrix):
    """(n x E) one-hot incidence matrices of the cached upper edges: Ji
    scatters an edge value to its row endpoint, Jc to its column
    endpoint; they turn the per-pair scatters of get_node_currents into
    one batched SpMM over all pair columns.  Built once per component
    matrix."""
    cached = getattr(G, "_cs_incidence", None)
    if cached is None:
        rows, cols, _ = _edges_cached(G)
        E = rows.size
        n = G.shape[0]
        ar = np.arange(E)
        ones = np.ones(E)
        cached = (sp.csr_matrix((ones, (rows, ar)), shape=(n, E)),
                  sp.csr_matrix((ones, (cols, ar)), shape=(n, E)))
        G._cs_incidence = cached
    return cached


def _coord_index(cum: Cumulative) -> dict:
    """(node_i, node_j) -> index into cum.coords, both orientations,
    built once per job (first occurrence wins)."""
    coord_index = getattr(cum, "_coord_index", None)
    if coord_index is None:
        coord_index = {}
        for k, (a, b) in enumerate(cum.coords):
            coord_index.setdefault((a, b), k)
            coord_index.setdefault((b, a), k)
        cum._coord_index = coord_index
    return coord_index


_NET_COL_STEP = 32   # columns per postprocess task (bounds temporaries)


def network_batch_postprocess(G, lhs, chunk, orig_pts, cc, cum, flags, cfg):
    """Per-pair node/branch current files and the cumulative vectors for
    a whole (n, B) network solve block.

    Per pair as write_cur_maps' network path (src/out.jl:29-115): signed
    branch currents with the per-pair BRANCH_CURRENT_CUTOFF relative
    threshold, node current = max(inflow, outflow), per-combo file names
    and per-combo accumulation.  Branch values for all columns come from
    two gathers and one broadcast multiply, node currents from four SpMMs
    against the cached incidence matrices, the cumulative vectors from
    one weighted sum over the batch axis; tasks of 32 columns run on a
    thread pool (numpy and the native formatter release the GIL).

    chunk: [(ci, cj, combos), ...] aligned with lhs columns."""
    rows, cols, vals = _edges_cached(G)
    Ji, Jc = _incidence_cached(G)
    B = len(chunk)
    # branch arithmetic runs in the solve's dtype (float32 in single
    # precision: ~1e-7 relative, below the 1e-6 output filter)
    dt = lhs.dtype if np.dtype(lhs.dtype) in (np.float32, np.float64) \
        else np.float64
    valsd = np.abs(np.asarray(vals, dt))
    combo_n = np.asarray([len(c[2]) for c in chunk], np.float64)

    cache = getattr(G, "_cs_branch_idx_full", None)
    if cache is None:
        coord_index = _coord_index(cum)
        ccl = np.asarray(cc, np.int64)
        idx = np.asarray([coord_index.get(
            (int(ccl[rows[i]]), int(ccl[cols[i]])), -1)
            for i in range(rows.size)], np.int64)
        cache = (idx[idx >= 0], np.nonzero(idx >= 0)[0])
        G._cs_branch_idx_full = cache
    tgt, src = cache

    ccf = np.asarray(cc, np.float64)
    erows = ccf[rows]
    ecols = ccf[cols]
    pref = output_prefix(cfg)
    # values computed in float32 print at its exact round-trip width
    digits = 9 if np.dtype(dt) == np.float32 else 17

    def task(s):
        """Columns [s, s + step): branch values, node currents, per-pair
        files, and the cumulative partials."""
        cn = combo_n[s:s + _NET_COL_STEP]
        V = np.asarray(lhs[:, s:s + cn.size], dt)
        signed = valsd[:, None] * (V[rows, :] - V[cols, :])  # (E, cols)
        b = np.abs(signed)
        maxcur = b.max(axis=0)
        thr = consts.BRANCH_CURRENT_CUTOFF * \
            np.where(maxcur == 0, 1.0, maxcur)
        live = (b >= thr[None, :]).astype(dt)
        signed *= live
        b *= live
        bpos = np.maximum(signed, 0.0)
        bneg = bpos - signed                    # = max(-signed, 0)
        # s_pos: b > 0 at the column endpoint, b < 0 (as -b) at the row
        # endpoint; s_neg the reverse (src/out.jl:250-290)
        s_pos = Jc @ bpos + Ji @ bneg
        s_neg = Jc @ bneg + Ji @ bpos
        node_curr = np.maximum(s_pos, s_neg)             # (n, cols)
        node_arr = np.empty((ccf.size, 2))
        node_arr[:, 0] = ccf
        for k in range(cn.size):
            col = s + k
            node_arr[:, 1] = node_curr[:, k]
            babs = b[:, k]
            keep = np.nonzero(babs > consts.OUTPUT_ATOL)[0]
            branch_arr = np.empty((keep.size, 3))
            branch_arr[:, 0] = erows[keep]
            branch_arr[:, 1] = ecols[keep]
            branch_arr[:, 2] = babs[keep]
            for (c_i, c_j) in chunk[col][2]:
                name = f"_{int(orig_pts[c_i])}_{int(orig_pts[c_j])}"
                _writedlm(f"{pref}_node_currents{name}.txt", node_arr,
                          "\t", digits=digits)
                _writedlm(f"{pref}_branch_currents{name}.txt",
                          branch_arr, "\t", digits=digits)
        return (np.asarray(b[src] @ cn, np.float64),
                np.asarray(node_curr @ cn, np.float64))

    starts = list(range(0, B, _NET_COL_STEP))
    with ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2)) as pool:
        parts = list(pool.map(task, starts))
    # one accumulation per combo (the reference's postprocess runs once
    # per user pair); partials add in submission order: deterministic
    for bw, nw in parts:
        np.add.at(cum.cum_branch_curr, tgt, bw)
        np.add.at(cum.cum_node_curr, np.asarray(cc, np.int64) - 1, nw)


def create_current_maps(G, voltages, finitegrounds, cfg, nodemap=None,
                        hbmeta=None):
    """src/out.jl:150-176: raster current map or network node currents."""
    node_currents = get_node_currents(G, voltages, finitegrounds)
    if cfg.data_type == "network":
        return node_currents, None
    current_map = np.zeros((hbmeta.nrows, hbmeta.ncols), voltages.dtype)
    mask = nodemap != 0
    current_map[mask] = node_currents[nodemap[mask] - 1]
    return current_map, None


def create_voltage_map(voltages, nodemap, hbmeta):
    """src/out.jl:421-434."""
    voltmap = np.zeros((hbmeta.nrows, hbmeta.ncols), voltages.dtype)
    mask = nodemap != 0
    voltmap[mask] = voltages[nodemap[mask] - 1]
    return voltmap


def alloc_map(hbmeta, dtype=np.float64):
    return np.zeros((hbmeta.nrows, hbmeta.ncols), dtype)


def accum_voltages(base, newvolt, nodemap, hbmeta):
    """src/out.jl:438-443."""
    base += create_voltage_map(newvolt, nodemap, hbmeta)


def accum_currents(base, cfg, G, voltages, finitegrounds, nodemap, hbmeta):
    """src/out.jl:445-452."""
    node_currents, _ = create_current_maps(G, voltages, finitegrounds, cfg,
                                           nodemap=nodemap, hbmeta=hbmeta)
    base += node_currents


# ---------------------------------------------------------------------------
# Grid postprocess and writers
# ---------------------------------------------------------------------------

def process_grid(cmap, cellmap, hbmeta, log_transform=False,
                 set_null_to_nodata=False):
    """src/out.jl:305-319 (in place)."""
    if log_transform:
        with np.errstate(divide="ignore", invalid="ignore"):
            cmap[:] = np.where(cmap > 0, np.log10(cmap), hbmeta.nodata)
    if set_null_to_nodata:
        cmap[cellmap == 0] = hbmeta.nodata


def write_grid(cmap, name, cfg, hbmeta, cellmap=None, voltage=False,
               cum=False, maxmap=False, log_transform=False,
               set_null_to_nodata=False):
    """src/out.jl:321-386: <prefix>_{curmap,cum_curmap,max_curmap,
    voltmap}<name>.asc, post-processed in place first when cellmap is
    given."""
    if cellmap is not None:
        process_grid(cmap, cellmap, hbmeta, log_transform,
                     set_null_to_nodata)
    s = "curmap"
    if cum:
        s = "cum_" + s
    elif maxmap:
        s = "max_" + s
    elif voltage:
        s = "voltmap"
    filename = f"{output_prefix(cfg)}_{s}{name}"
    write_raster(filename, cmap, hbmeta.wkt, hbmeta.transform,
                 "tif" if cfg.write_as_tif else "asc")


def postprocess_cum_curmap(accum):
    """src/utils.jl:116-121."""
    accum[accum < consts.NODATA] = consts.NODATA


def write_cum_maps(cum: Cumulative, cellmap, cfg, hbmeta, write_max,
                   write_cum):
    """src/out.jl:467-481."""
    if write_cum or cfg.write_cur_maps:
        postprocess_cum_curmap(cum.cum_curr)
        write_grid(cum.cum_curr, "", cfg, hbmeta, cum=True)
    if write_max:
        postprocess_cum_curmap(cum.max_curr)
        write_grid(cum.max_curr, "", cfg, hbmeta, maxmap=True)


# ---------------------------------------------------------------------------
# Per-pair postprocess of the general tier (raster and network)
# ---------------------------------------------------------------------------

def write_volt_maps(name, voltages, component_data, flags, cfg):
    """src/out.jl:388-410."""
    if not flags.is_raster:
        write_voltages(cfg.output_file, name, voltages, component_data.cc)
    else:
        vm = create_voltage_map(voltages, component_data.local_nodemap,
                                component_data.hbmeta)
        write_grid(vm, name, cfg, component_data.hbmeta,
                   cellmap=component_data.cellmap, voltage=True,
                   set_null_to_nodata=flags.outputflags.set_null_voltages_to_nodata)


def write_cur_maps(name, voltages, component_data, finitegrounds, flags, cfg,
                   cum: Cumulative):
    """src/out.jl:29-115: compute, accumulate, optionally write."""
    of = flags.outputflags
    G = component_data.matrix
    cc = component_data.cc

    if not flags.is_raster:
        node_currents = get_node_currents(G, voltages, finitegrounds)
        branch_3col = get_branch_currents_3col(G, voltages, cc)
        node_arr = np.column_stack([np.asarray(cc, np.float64),
                                    node_currents])
        if flags.is_advanced:
            write_currents(node_arr, branch_3col, name, cfg)
            return

        # the branch rows of a component are in a fixed order across its
        # pairs, so the branch -> coord index map is cached on the matrix
        cache = getattr(G, "_cs_branch_idx", None)
        if cache is None:
            coord_index = _coord_index(cum)
            idx = np.asarray([coord_index.get(
                (int(branch_3col[i, 0]), int(branch_3col[i, 1])), -1)
                for i in range(branch_3col.shape[0])], np.int64)
            cache = (idx[idx >= 0], np.nonzero(idx >= 0)[0])
            G._cs_branch_idx = cache
        tgt, src = cache
        np.add.at(cum.cum_branch_curr, tgt, branch_3col[src, 2])
        np.add.at(cum.cum_node_curr, np.asarray(cc, np.int64) - 1,
                  node_currents)

        write_currents(node_arr, branch_3col, name, cfg)
        return

    cmap, _ = create_current_maps(G, voltages, finitegrounds, cfg,
                                  nodemap=component_data.local_nodemap,
                                  hbmeta=component_data.hbmeta)
    process_grid(cmap, component_data.cellmap, component_data.hbmeta,
                 log_transform=of.log_transform_maps,
                 set_null_to_nodata=of.set_null_currents_to_nodata)

    cum.cum_curr += cmap
    if of.write_max_cur_maps:
        np.maximum(cum.max_curr, cmap, out=cum.max_curr)

    if not of.write_cum_cur_map_only and of.write_cur_maps:
        write_grid(cmap, name, cfg, component_data.hbmeta)
