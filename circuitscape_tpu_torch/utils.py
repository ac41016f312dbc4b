"""Utility API: offline current-map accumulation and the Omniscape
in-memory embedding entry point.

Counterpart of circuitscape_tpu/utils.py.  Parity reference:
src/utils.jl:43-257.
"""

from __future__ import annotations

import os

import numpy as np

from . import cslog
from .config import CSConfig
from .graph.build import construct_local_node_map
from .io.loaders import IncludeExcludePairs, RasterData
from .io.raster import RasterMeta
from .out import OutputFlags, accum_currents, alloc_map


def accumulate_current_maps(path: str, op) -> None:
    """Re-accumulate per-pair current maps from an output directory
    (src/utils.jl:43-105) — the manual-resume path for the
    accumulation stage."""
    dirname = os.path.dirname(path) or "."
    base = os.path.basename(path)
    name = base.split(".out")[0]

    cmap_list = [f for f in os.listdir(dirname)
                 if f.startswith(f"{name}_") and "_curmap_" in f]
    if not cmap_list:
        return

    first = os.path.join(dirname, cmap_list[0])
    headers = []
    with open(first) as f:
        for _ in range(6):
            headers.append(f.readline())
    ncol = int(headers[0].split()[1])
    nrow = int(headers[1].split()[1])

    accum = np.zeros((nrow, ncol))
    for fname in cmap_list:
        cslog.info("Accumulating %s", fname)
        cmap = np.loadtxt(os.path.join(dirname, fname), skiprows=6, ndmin=2)
        accum = op(accum, cmap)
    accum[accum < -9999] = -9999

    opname = "cum" if op is np.add else "max"
    accum_path = os.path.join(dirname, f"{opname}_{opname}_curmap.asc")
    cslog.info("Writing to %s", accum_path)
    with open(accum_path, "w") as f:
        f.writelines(headers)
        for row in np.round(accum, 8):
            f.write(" ".join(repr(float(v)) for v in row) + "\n")


def calculate_cum_current_map(path: str) -> None:
    accumulate_current_maps(path, np.add)


def calculate_max_current_map(path: str) -> None:
    accumulate_current_maps(path, np.maximum)


def compute_omniscape_current(conductance: np.ndarray, source: np.ndarray,
                              ground: np.ndarray, cs_cfg: dict,
                              device=None) -> np.ndarray:
    """In-memory advanced solve for moving-window callers
    (src/utils.jl:145-257) on `device` (default: CUDA; pass
    device="cpu" to run on the CPU).  No file IO: takes conductance,
    source and ground matrices plus a config dict and returns the
    current map as numpy.  Windows of at least CS_ADVANCED_DEVICE_MIN
    cells with cg+amg take the stencil device path; the others solve
    per component on the general tier."""
    from .drivers.advanced import (_advanced_device_fast,
                                   compute_advanced_data, multiple_solver)
    from .drivers.flags import RasterFlags
    from .run import resolve_device

    dev = resolve_device(device)
    dtype = conductance.dtype if conductance.dtype in (np.float32, np.float64) \
        else np.float64
    cellmap = np.asarray(conductance, dtype)
    hbmeta = RasterMeta(ncols=cellmap.shape[1], nrows=cellmap.shape[0],
                        xllcorner=0.0, yllcorner=0.0, cellsize=1.0,
                        nodata=-9999.0,
                        transform=(0.0, 1.0, 0.0, cellmap.shape[0], 0.0, -1.0),
                        wkt="")
    rasterdata = RasterData(
        cellmap=cellmap,
        polymap=np.zeros((0, 0), np.int64),
        source_map=np.asarray(source, dtype),
        ground_map=np.asarray(ground, dtype),
        points_rc=(np.zeros(0, np.int64),) * 3,
        strengths=np.zeros((0, 0), dtype),
        included_pairs=IncludeExcludePairs(),
        hbmeta=hbmeta,
    )

    cfg = CSConfig.from_dict(cs_cfg)
    o = OutputFlags()
    flags = RasterFlags(True, False, True, False, False, False, "rmvsrc",
                        cfg.connect_four_neighbors_only, False, o)

    data = compute_advanced_data(rasterdata, flags, cfg, dtype)

    G = data.G
    nodemap = data.nodemap
    polymap = data.polymap
    sources = data.sources
    grounds = data.grounds
    finitegrounds = data.finitegrounds
    fg_sentinel = finitegrounds.size == 1 and finitegrounds[0] == -9999.0

    outcurr = alloc_map(hbmeta, dtype)

    # large moving windows take the batched device path (one stencil
    # solve for all components, currents computed on the device even
    # though no map is written)
    fast = _advanced_device_fast(data, flags, cfg, dev, force_currents=True)
    if fast is not None:
        return fast[1]

    Gcsr = G.tocsr()
    for c in data.cc:
        c = np.sort(np.asarray(c))
        # row then column slice (np.ix_ on CSR densifies the index mesh)
        a_local = Gcsr[c - 1][:, c - 1].tocsr()
        s_local = sources[c - 1]
        g_local = grounds[c - 1]
        if s_local.sum() == 0 or g_local.sum() == 0:
            continue
        f_local = finitegrounds if fg_sentinel else finitegrounds[c - 1]
        voltages = multiple_solver(cfg, data.solver, a_local, s_local.copy(),
                                   g_local, f_local, dev)
        local_nodemap = construct_local_node_map(nodemap, c, polymap)
        accum_currents(outcurr, cfg, a_local, voltages, f_local,
                       local_nodemap, hbmeta)

    return outcurr
