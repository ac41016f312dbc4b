"""Output system: resistance files, output flags, cumulative-map holders.

Counterpart of circuitscape_tpu/out.py, reduced to what raster
pairwise writes: the resistance matrix and its 3-column list, and the
current and voltage grids of the maps-on path (per pair, cumulative,
max).  Network outputs are not carried yet (ROADMAP queue 1 item 9).
Parity reference: src/out.jl:1-26, :305-386, :454-481.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


def _fmt(v) -> str:
    fv = float(v)
    if fv == int(fv) and abs(fv) < 1e15:
        return f"{fv:.1f}"
    return repr(fv)


def _writedlm(path: str, arr: np.ndarray, delim: str):
    """Julia-writedlm-style text matrix writer (shortest round-trip
    repr per value; the JAX package routes large arrays through a
    native formatter, which this package does not bind yet)."""
    arr2 = np.atleast_2d(np.asarray(arr, np.float64))
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
