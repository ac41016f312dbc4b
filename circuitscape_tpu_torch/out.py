"""Output system: resistance files, output flags, cumulative-map holders.

Counterpart of circuitscape_tpu/out.py, reduced to what shortcut-mode
raster pairwise writes (the resistance matrix and its 3-column list).
Current and voltage maps are not carried yet (ROADMAP queue 1 item 6).
Parity reference: src/out.jl:1-26, :454-465.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import consts


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
