"""Raster advanced scenario driver: arbitrary source and ground maps.

Counterpart of circuitscape_tpu/drivers/advanced.py.  Parity reference:
src/raster/advanced.jl:1-344 (AdvancedProblem, compute_advanced_data,
get_sources_and_grounds, resolve_conflicts, advanced_kernel,
multiple_solver, multiple_solve).  On a raster above
CS_ADVANCED_DEVICE_MIN cells with cg+amg, every component with sources
and grounds solves in one batched stencil solve whose ground diagonal is
baked into the MG hierarchy.  Every other job (networks, small grids,
direct solvers, the per-point solves of one-to-all) takes the
reference's per-component loop on the general sparse-graph tier.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .. import consts, cslog, out, stats
from ..graph import build
from ..io.loaders import load_raster_data
from ..solve.dispatch import SolverFailedError, get_solver
from ..timer import CSTIMER
from .flags import get_raster_flags
from .raster import LazyStencilGraph, _grid_components


@dataclass
class AdvancedProblem:
    """src/raster/advanced.jl:1-15."""

    G: sp.spmatrix
    cc: list
    nodemap: np.ndarray
    polymap: np.ndarray
    hbmeta: object
    sources: np.ndarray
    grounds: np.ndarray
    source_map: np.ndarray
    finitegrounds: np.ndarray
    check_node: int
    src: int
    cellmap: np.ndarray
    solver: object


def raster_advanced(cfg, dtype, device):
    """src/raster/advanced.jl:17-33; returns the voltage grid."""
    with CSTIMER("load raster data"):
        rasterdata = load_raster_data(cfg, dtype)
    flags = get_raster_flags(cfg)
    with CSTIMER("construct graph and sources"):
        advanced_data = compute_advanced_data(rasterdata, flags, cfg, dtype)
    v, _ = advanced_kernel(advanced_data, flags, cfg, device)
    return v


def compute_advanced_data(data, flags, cfg, dtype=np.float64):
    """src/raster/advanced.jl:36-71.  Without polygons the stencil is the
    graph: the sparse Laplacian is deferred (LazyStencilGraph) and the
    components come from the grid."""
    nodemap = build.construct_node_map(data.cellmap, data.polymap)
    if data.polymap.size:
        A = build.construct_graph(data.cellmap, nodemap, flags.avg_res,
                                  flags.four_neighbors)
        G = build.laplacian(A)
        cc = build.components(G)
    else:
        G = LazyStencilGraph(data.cellmap, nodemap, flags.avg_res,
                             flags.four_neighbors, dtype)
        cc = _grid_components(data.cellmap, nodemap, flags.four_neighbors)

    sources, grounds, finitegrounds = get_sources_and_grounds(
        data, flags, G, nodemap)

    solver = get_solver(cfg)
    return AdvancedProblem(G, cc, nodemap, data.polymap, data.hbmeta,
                           sources, grounds, data.source_map, finitegrounds,
                           -1, 0, data.cellmap, solver)


def get_sources_and_grounds(data, flags, G, nodemap):
    """src/raster/advanced.jl:73-80."""
    return _get_sources_and_grounds(data.source_map, data.ground_map,
                                    flags, G, nodemap)


def _get_sources_and_grounds(source_map, ground_map, flags, G, nodemap,
                             override_policy=None):
    """Per-node source and ground values, conflicts resolved by the
    job's policy or override_policy (src/raster/advanced.jl:82-117).  A
    raster's maps are summed per node (a merged node sums its cells');
    a network's (node, value) lists are assigned, a ground resistance of
    0 becoming a direct ground (inf)."""
    policy = override_policy if override_policy else flags.policy
    n = G.shape[0]
    dtype = G.dtype
    sources = np.zeros(n, dtype)
    grounds = np.zeros(n, dtype)

    if flags.is_raster:
        si, sj = np.nonzero(source_map)
        for r, c in zip(si, sj):
            v = nodemap[r, c]
            if v != 0:
                sources[v - 1] += source_map[r, c]
        gi, gj = np.nonzero(ground_map)
        for r, c in zip(gi, gj):
            v = nodemap[r, c]
            if v != 0:
                grounds[v - 1] += ground_map[r, c]
    else:
        gm = ground_map.copy()
        if flags.grnd_file_is_res:
            with np.errstate(divide="ignore"):
                gm[:, 1] = 1.0 / gm[:, 1]
        sources[source_map[:, 0].astype(np.int64) - 1] = source_map[:, 1]
        grounds[gm[:, 0].astype(np.int64) - 1] = gm[:, 1]
    return resolve_conflicts(sources, grounds, policy)


def resolve_conflicts(sources, grounds, policy):
    """A node that is both source and ground keeps one of them by policy
    (rmvsrc, rmvgnd, rmvall, keepall); a direct ground under a positive
    source is dropped.  Returns (sources, grounds, finitegrounds), the
    last [-9999] when no finite ground is left
    (src/raster/advanced.jl:119-149)."""
    sources = np.asarray(sources).copy()
    grounds = np.asarray(grounds).copy()

    finitegrounds = np.where(grounds < np.inf, grounds, 0.0)
    if np.count_nonzero(finitegrounds) == 0:
        finitegrounds = np.asarray([-9999.0])

    conflicts = (sources != 0) & (grounds != 0)
    if conflicts.any():
        if policy == "rmvsrc":
            sources[conflicts] = 0
        elif policy == "rmvgnd":
            grounds[conflicts] = 0
        elif policy == "rmvall":
            sources[conflicts] = 0

    infgrounds = grounds == np.inf
    infconflicts = infgrounds & (sources > 0)
    grounds[infconflicts] = 0

    return sources, grounds, finitegrounds


def _advanced_device_fast(prob: AdvancedProblem, flags, cfg, device,
                          force_currents=False):
    """The stencil device path of advanced mode (counterpart of the JAX
    package's _advanced_device_fast).

    One batched stencil solve covers every qualifying component: finite
    grounds add their conductance to the diagonal, direct (infinite)
    grounds become penalty entries, and both are baked into the MG
    hierarchy; sources in components without grounds are zeroed (the
    reference skips those components, src/raster/advanced.jl:194).  A
    merged (polygon) node spreads its source and ground totals over its
    cells, and the solve runs under its projector.  Node currents
    include the finite-ground terms (src/out.jl:193-202); they are
    computed when a current map is asked for, or with force_currents
    (the Omniscape entry, which writes no file).

    Returns (volt grid, current grid), or None where the JAX package
    takes its general path: a network, off cg+amg, a check node or a
    one-to-all / all-to-one point, grids below CS_ADVANCED_DEVICE_MIN
    cells, or nothing to solve."""
    from ..solve.prepare import prepare_stencil_solver_from_gmap_pen
    from ..solve.stencil import (advanced_ground_penalty,
                                 build_poly_projector,
                                 stencil_node_currents,
                                 stencil_solve_advanced_batch)

    if (not flags.is_raster or cfg.solver != "cg+amg" or
            prob.check_node != -1 or flags.is_onetoall or
            flags.is_alltoone):
        return None
    min_cells = int(os.environ.get("CS_ADVANCED_DEVICE_MIN", "40000"))
    if prob.cellmap.size < min_cells:
        return None

    nodemap = prob.nodemap
    H, W = nodemap.shape
    of = flags.outputflags
    n = prob.G.shape[0]
    rr, cc_ = np.nonzero(nodemap)
    node_ids = nodemap[rr, cc_]
    # member-cell count per node: per-cell source and ground values are
    # the merged node's total over its size, so polygon sums recover the
    # reference's merged-node totals
    node_count = np.bincount(node_ids, minlength=n + 1).astype(np.float64)
    node_count[node_count == 0] = 1.0

    sources = np.asarray(prob.sources, np.float64)
    grounds = np.asarray(prob.grounds, np.float64)
    fg_sentinel = (prob.finitegrounds.size == 1 and
                   prob.finitegrounds[0] == -9999.0)
    finite = (np.zeros(n) if fg_sentinel
              else np.asarray(prob.finitegrounds, np.float64))

    # qualifying components: nonzero (signed) source and ground sums
    comp_of_node = np.zeros(n + 1, np.int64)
    for ci, comp in enumerate(prob.cc):
        comp_of_node[np.asarray(comp)] = ci
    ncomp = len(prob.cc)
    ssum = np.bincount(comp_of_node[1:], weights=sources, minlength=ncomp)
    with np.errstate(invalid="ignore"):
        gsum = np.bincount(comp_of_node[1:],
                           weights=np.where(np.isinf(grounds), 1.0, grounds),
                           minlength=ncomp)
    ok_comp = (ssum != 0) & (gsum != 0)
    keep = ok_comp[comp_of_node[np.arange(1, n + 1)]]
    src_vec = np.where(keep, sources, 0.0)
    if not np.any(src_vec):
        return None

    cslog.info("advanced device fast path")
    inf_mask = np.isinf(grounds)
    inv_cnt = 1.0 / node_count[node_ids]
    # the ground diagonal per cell, np.inf marking direct grounds
    # (resolved to the penalty inside the setup)
    with np.errstate(invalid="ignore"):
        pen_spec = np.zeros((H, W))
        pen_spec[rr, cc_] = np.where(inf_mask, np.inf,
                                     finite)[node_ids - 1] * inv_cnt

    with CSTIMER("prepare stencil solver (upload + MG setup)"):
        S64, prec, geomg_apply, _, pen_host = \
            prepare_stencil_solver_from_gmap_pen(
                prob.cellmap, flags.avg_res, flags.four_neighbors, pen_spec,
                device)
    with_pen = pen_host is not None
    if not with_pen:
        # a mesh run: the sharded hierarchy carries no penalty, so the
        # grounds go to the masked preconditioner, as in the JAX package
        # (with a single direct ground at megacell scale it converges
        # poorly; multi-ground jobs are unaffected)
        pen_host = np.where(np.isinf(pen_spec),
                            advanced_ground_penalty(S64), pen_spec)
    Hp, Wp = S64.shape
    dev = S64.diag.device
    proj = (build_poly_projector(nodemap, S64.shape, dev)
            if prob.polymap.size else None)

    src_grid = np.zeros((H, W))
    src_grid[rr, cc_] = src_vec[node_ids - 1] * inv_cnt
    sc = np.column_stack([rr, cc_])
    with CSTIMER("batched pair solve"):
        t0 = time.perf_counter()
        X, rel, iters = stencil_solve_advanced_batch(
            S64, sc[None], src_grid[rr, cc_][None], sc[None],
            pen_host[rr, cc_][None], rtol=consts.CG_RTOL,
            itmax=consts.CG_ITMAX, prec=prec, prec_apply=geomg_apply,
            proj=proj, pen_in_prec=with_pen)
        stats.record_solve(tuple(X.shape), iters, time.perf_counter() - t0)
    if np.any(rel >= consts.RESIDUAL_GATE):
        raise SolverFailedError(
            f"advanced device solve residual {float(rel.max())} exceeds "
            f"tolerance {consts.RESIDUAL_GATE}")

    tdt = getattr(torch, np.dtype(prob.G.dtype).name)   # the job's dtype
    with CSTIMER("fetch maps"):
        volt = X[0].to(tdt).cpu().numpy()[:H, :W].copy()
    volt[nodemap == 0] = 0

    outcurr = np.zeros((H, W), volt.dtype)
    if force_currents or of.write_cur_maps or of.write_cum_cur_map_only:
        with CSTIMER("node currents + reduce"):
            if fg_sentinel:
                ncur = stencil_node_currents(S64, X, proj=proj)[0]
            else:
                # finite-ground current terms (penalty cells are the
                # reference's deleted nodes: excluded)
                fin_grid = np.zeros((Hp, Wp))
                fin_grid[rr, cc_] = np.where(inf_mask, 0.0,
                                             finite)[node_ids - 1] * inv_cnt
                ncur = _node_currents_with_fg(
                    S64, X, torch.as_tensor(fin_grid, device=dev),
                    proj=proj)[0]
            outcurr = ncur.to(tdt).cpu().numpy()[:H, :W].copy()
    if of.write_cur_maps or of.write_cum_cur_map_only:
        with CSTIMER("write maps"):
            out.write_grid(outcurr.copy(), "", cfg, prob.hbmeta,
                           cellmap=prob.cellmap)
    if of.write_volt_maps:
        with CSTIMER("write maps"):
            out.write_grid(volt.copy(), "", cfg, prob.hbmeta,
                           cellmap=prob.cellmap, voltage=True)
    return volt, outcurr


def _node_currents_with_fg(S, V, fg_grid, proj=None):
    """Node currents including the finite-ground diagonal terms
    (src/out.jl:193-206): inflow += relu(-fg v), outflow += relu(fg v),
    node current = max of the two; the branch cutoff and projector as in
    stencil_node_currents, which computes them (on a mesh too)."""
    from ..solve.stencil import stencil_node_currents
    return stencil_node_currents(S, V, proj=proj, fg=fg_grid)


def advanced_kernel(prob: AdvancedProblem, flags, cfg, device):
    """src/raster/advanced.jl:151-271: the stencil device path where it
    applies, else one solve per component with sources and grounds on
    the general sparse-graph tier.  Returns (result, current grid)."""
    fast = _advanced_device_fast(prob, flags, cfg, device)
    if fast is not None:
        return fast
    G = prob.G
    nodemap = prob.nodemap
    polymap = prob.polymap
    hbmeta = prob.hbmeta
    sources = prob.sources
    grounds = prob.grounds
    finitegrounds = prob.finitegrounds
    cellmap = prob.cellmap
    dtype = G.dtype

    of = flags.outputflags
    is_raster = flags.is_raster

    volt = np.zeros(nodemap.shape, dtype)
    solver_called = False
    voltages = np.zeros(G.shape[0], dtype)
    outvolt = out.alloc_map(hbmeta, dtype) if is_raster else None
    outcurr = (out.alloc_map(hbmeta, dtype) if is_raster
               else np.zeros((0, 0), dtype))

    fg_sentinel = finitegrounds.size == 1 and finitegrounds[0] == -9999.0
    Gcsr = G.tocsr()

    for c in prob.cc:
        c = np.sort(np.asarray(c))
        if prob.check_node != -1 and prob.check_node not in c:
            continue

        # row then column slice (np.ix_ on CSR densifies the index mesh)
        a_local = Gcsr[c - 1][:, c - 1].tocsr()
        s_local = sources[c - 1]
        g_local = grounds[c - 1]

        if s_local.sum() == 0 or g_local.sum() == 0:
            continue

        f_local = finitegrounds if fg_sentinel else finitegrounds[c - 1]

        v_comp = multiple_solver(cfg, prob.solver, a_local, s_local.copy(),
                                 g_local, f_local, device)
        voltages[c - 1] += v_comp
        solver_called = True

        if is_raster:
            local_nodemap = build.construct_local_node_map(nodemap, c,
                                                           polymap)
            if of.write_volt_maps:
                out.accum_voltages(outvolt, v_comp, local_nodemap, hbmeta)
            if of.write_cur_maps:
                out.accum_currents(outcurr, cfg, a_local, v_comp, f_local,
                                   local_nodemap, hbmeta)
            mask = local_nodemap != 0
            volt[mask] = v_comp[local_nodemap[mask] - 1]

    name = "" if prob.src == 0 else f"_{int(prob.src)}"
    cd = _FullGraphData(Gcsr, cellmap, hbmeta)
    with CSTIMER("write maps"):
        if of.write_volt_maps:
            if not is_raster:
                out.write_volt_maps(name, voltages, cd, flags, cfg)
            else:
                out.write_grid(outvolt, name, cfg, hbmeta, cellmap=cellmap,
                               voltage=True)
        if of.write_cur_maps or of.write_cum_cur_map_only:
            if not is_raster:
                out.write_cur_maps(name, voltages, cd, finitegrounds, flags,
                                   cfg, None)
            else:
                out.write_grid(outcurr, name, cfg, hbmeta, cellmap=cellmap)

    if not is_raster:
        ids = np.arange(1, G.shape[0] + 1, dtype=dtype)
        return np.column_stack([ids, voltages]), outcurr

    if not solver_called:
        return -np.ones((1, 1), dtype), outcurr

    if flags.is_onetoall:
        idx = prob.source_map != 0
        vals = volt[idx] / prob.source_map[idx]
        # Julia's `val[1] ≈ 0` with default atol is exact equality
        if vals[0] == 0:
            return -np.ones((1, 1), dtype), outcurr
        return vals.reshape(-1, 1).astype(dtype), outcurr
    if flags.is_alltoone:
        return np.zeros((1, 1), dtype), outcurr

    return volt, outcurr


class _FullGraphData:
    """src/raster/advanced.jl:335-343 (FullGraph)."""

    def __init__(self, G, cellmap, hbmeta=None):
        self.matrix = G
        self.cc = np.arange(1, G.shape[0] + 1, dtype=np.int64)
        self.local_nodemap = np.zeros((0, 0), np.int64)
        self.hbmeta = hbmeta
        self.cellmap = cellmap


def multiple_solver(cfg, solver, a, sources, grounds, finitegrounds,
                    device):
    """One simultaneous solve with finite and direct (infinite) grounds
    (src/raster/advanced.jl:274-305): finite grounds on the diagonal,
    direct grounds' rows and columns deleted."""
    asolve = a
    if finitegrounds[0] != -9999:
        asolve = a + sp.diags(finitegrounds)

    infgrounds = np.nonzero(grounds == np.inf)[0]
    keep = np.setdiff1d(np.arange(a.shape[0]), infgrounds)
    sources_kept = np.delete(sources, infgrounds)
    asolve = asolve.tocsr()[keep][:, keep]

    volt = multiple_solve(solver, asolve.tocsr(), sources_kept, device)

    voltages = np.zeros(a.shape[0], a.dtype)
    voltages[keep] = volt
    return voltages


def multiple_solve(solver, matrix, sources, device):
    """src/raster/advanced.jl:307-333."""
    with CSTIMER("construct preconditioner/factorization"):
        ctx = solver.build(matrix, matrix.dtype, device)
    with CSTIMER("solve"):
        volt = ctx.solve(sources.reshape(-1, 1))[:, 0]
    snorm = np.linalg.norm(sources)
    if snorm > 0:
        res = np.linalg.norm(matrix @ volt - sources) / snorm
        if res >= consts.RESIDUAL_GATE:
            raise SolverFailedError(
                f"Advanced solve residual {res} exceeds tolerance")
    return volt
