"""Core pairwise driver: all-pairs effective resistance over components.

Counterpart of circuitscape_tpu/drivers/core.py, its stencil branches.
Parity reference: src/core.jl:64-739 (single_ground_all_pairs, shortcut
optimization, get_num_pairs, voltmatrix bookkeeping).

The reference schedules one linear solve per focal pair; here a raster
is a stencil, and its short-circuit polygons a projector on it
(solve/stencil.py PolyProjector).  In shortcut mode the N-1 anchor
pairs of every connected component solve as one batched device solve
(_stencil_shortcut_solve), and the full matrix is rebuilt with the
voltage-ratio shortcut.  Jobs that write maps or exclude pairs turn the
shortcut off and solve every pair in device chunks, with their current
maps made on the device (_stencil_maps_solve), when the grid has at
least CS_PAIRWISE_DEVICE_MIN cells.  Every other job (networks, smaller
grids, direct solvers) takes the general sparse-graph path: per
connected component, all pair right-hand sides form one (n, n_pairs)
block, solved by the component's solve context (solve/dispatch.py:
batched ELL PCG on the device, or the native Cholesky on the host).
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .. import consts, cslog, out, stats
from ..checkpoint import Checkpoint
from ..graph.build import construct_local_node_map
from ..timer import CSTIMER


@dataclass
class ComponentData:
    """src/core.jl:24-30."""

    cc: np.ndarray
    matrix: sp.spmatrix
    local_nodemap: np.ndarray
    hbmeta: object
    cellmap: np.ndarray


@dataclass
class GraphProblem:
    """src/core.jl:10-22."""

    G: object                 # sparse Laplacian or LazyStencilGraph
    cc: list
    points: np.ndarray        # graph node id (1-based) per user point
    user_points: np.ndarray   # user point ids
    exclude_pairs: list       # list of (user_id, user_id) tuples
    nodemap: np.ndarray
    polymap: np.ndarray
    hbmeta: object
    cellmap: np.ndarray
    cum: out.Cumulative
    solver: object


def _focal_in_comp(fp, comp_sorted):
    """Boolean mask: which focal node ids lie in the (sorted) component."""
    fp = np.asarray(fp, np.int64)
    comp_sorted = np.asarray(comp_sorted)
    if comp_sorted.size == 0:
        return np.zeros(fp.shape, bool)
    idx = np.searchsorted(comp_sorted, fp)
    idx_c = np.minimum(idx, comp_sorted.size - 1)
    return (idx < comp_sorted.size) & (comp_sorted[idx_c] == fp)


def _sub_focal(fp, comp_sorted):
    """Unique focal node ids inside the component, in first-occurrence
    order (the reference's `sub_fp` semantics)."""
    mask = _focal_in_comp(fp, comp_sorted)
    return list(dict.fromkeys(int(x) for x in np.asarray(fp)[mask]))


def get_num_pairs(ccs, fp, exclude_pairs, user_points=None):
    """Count pair solves (src/core.jl:537-561)."""
    if user_points is None:
        user_points = fp
    num = 0
    g2u = {int(fp[i]): int(user_points[i]) for i in range(len(fp))}
    for cc in ccs:
        sub_fp = _sub_focal(fp, np.sort(np.asarray(cc)))
        n = len(sub_fp)
        for ii in range(n):
            for jj in range(ii + 1, n):
                if (g2u.get(sub_fp[ii], sub_fp[ii]),
                        g2u.get(sub_fp[jj], sub_fp[jj])) in exclude_pairs:
                    continue
                num += 1
    return num


def get_num_pairs_shortcut(ccs, fp, exclude_pairs, user_points=None):
    """src/core.jl:563-587 — anchor-only pair count."""
    if user_points is None:
        user_points = fp
    num = 0
    g2u = {int(fp[i]): int(user_points[i]) for i in range(len(fp))}
    for cc in ccs:
        sub_fp = _sub_focal(fp, np.sort(np.asarray(cc)))
        if not sub_fp:
            continue
        pt1 = sub_fp[0]
        for jj in range(1, len(sub_fp)):
            if (g2u.get(pt1, pt1),
                    g2u.get(sub_fp[jj], sub_fp[jj])) in exclude_pairs:
                continue
            num += 1
    return num


@dataclass
class _Output:
    """src/core.jl:32-40 (cum carried separately)."""

    points: np.ndarray
    voltages: np.ndarray
    orig_pts: tuple
    comp_idx: tuple  # 0-based local indices
    resistance: float
    col: int         # 0-based index into points of the dst point


@dataclass
class _Shortcut:
    """src/core.jl:42-46."""

    get_shortcut_resistances: bool
    voltmatrix: np.ndarray
    shortcut_res: np.ndarray


def single_ground_all_pairs(prob: GraphProblem, flags, cfg, device,
                            log=True):
    """Solve all focal-point pairs (src/core.jl:70-305, :312-515): the
    stencil shortcut, then the stencil maps path at or above
    CS_PAIRWISE_DEVICE_MIN cells, then the general per-component loop,
    in the JAX package's order."""
    a = prob.G
    dtype = a.dtype
    points = prob.points
    exclude = set(prob.exclude_pairs)
    orig_pts = prob.user_points
    numpoints = len(points)
    of = flags.outputflags
    cum = prob.cum

    cslog.info("Graph has %s nodes, %s focal points and %s connected "
               "components", a.shape[0], numpoints, len(prob.cc))

    with CSTIMER.span("count pairs"):
        num_pairs = get_num_pairs(prob.cc, points, exclude, orig_pts)
    if log:
        cslog.info("Total number of pair solves = %s", num_pairs)

    resistances = -np.ones((numpoints, numpoints), dtype)
    voltmatrix = np.zeros((numpoints, numpoints), dtype)
    shortcut_res = -np.ones((numpoints, numpoints), dtype)

    get_shortcut = (flags.is_raster and not of.any_maps and not exclude)
    stencil_base = (flags.is_raster and not prob.solver.is_direct and
                    prob.cellmap.size > 0 and prob.nodemap.size > 0)
    maps_min = int(os.environ.get("CS_PAIRWISE_DEVICE_MIN", "40000"))
    if stencil_base and not get_shortcut and prob.cellmap.size >= maps_min:
        _stencil_maps_solve(prob, flags, cfg, resistances, cum, exclude,
                            device)
        return _save_padded(resistances, orig_pts, cfg)

    ckpt = Checkpoint(getattr(cfg, "checkpoint_file", ""))
    done_pairs = ckpt.load(resistances, cum, voltmatrix)
    if get_shortcut:
        cslog.info("Triggering resistance calculation shortcut")
        with CSTIMER.span("count pairs"):
            num_pairs = get_num_pairs_shortcut(prob.cc, points, exclude,
                                               orig_pts)
        cslog.info("Total number of pair solves has been reduced to %s",
                   num_pairs)
    if stencil_base and get_shortcut:
        _stencil_shortcut_solve(prob, flags, resistances, voltmatrix,
                                shortcut_res, device, ckpt, done_pairs,
                                max_par=getattr(cfg, "max_parallel", 0))
        ckpt.finish()
        return _save_padded(shortcut_res, orig_pts, cfg)

    sc = _Shortcut(get_shortcut, voltmatrix, shortcut_res)
    for comp in prob.cc:
        comp = np.sort(np.asarray(comp))
        if _sub_focal(points, comp):
            _general_component(prob, flags, cfg, device, comp, sc,
                               resistances, exclude, ckpt, done_pairs)
    ckpt.finish()
    return _save_padded(shortcut_res if get_shortcut else resistances,
                        orig_pts, cfg)


def _general_component(prob, flags, cfg, device, comp, sc, resistances,
                       exclude, ckpt, done_pairs):
    """One connected component on the general sparse-graph tier
    (src/core.jl:386-515): the component's Laplacian, regularized for
    the iterative tier (src/core.jl:161), its solve context, every pair
    (anchor pairs only in shortcut mode) as one right-hand-side column,
    normalized to its source (src/core.jl:466-472), then each pair's
    outputs."""
    a = prob.G
    dtype = a.dtype
    points = prob.points
    orig_pts = prob.user_points
    cum = prob.cum
    csub = _sub_focal(points, comp)

    # row slice, then column slice: np.ix_ would build a dense index mesh
    idx = comp - 1
    matrix = a.tocsr()[idx][:, idx].tocsr().astype(dtype)
    if not prob.solver.is_direct:
        eps = np.finfo(np.dtype(dtype)).eps
        matrix = matrix.copy()
        matrix.data = matrix.data + eps * np.linalg.norm(matrix.data)

    with CSTIMER("construct preconditioner/factorization"):
        ctx = prob.solver.build(matrix, dtype, device)
    with CSTIMER("construct local nodemap"):
        local_nodemap = construct_local_node_map(prob.nodemap, comp,
                                                 prob.polymap)
    component_data = ComponentData(comp, matrix, local_nodemap,
                                   prob.hbmeta, prob.cellmap)

    def comp_index(node):
        k = np.searchsorted(comp, node)
        if k >= len(comp) or comp[k] != node:
            raise ValueError(f"Node {node} not found in component")
        return int(k)

    pair_list = []  # (comp_i, comp_j, [(c_i, c_j), ...])
    point_range = range(1) if sc.get_shortcut_resistances else \
        range(len(csub))
    for point_idx in point_range:
        src_node = csub[point_idx]
        comp_i = comp_index(src_node)
        src_indices = np.nonzero(points == src_node)[0]
        # zero resistance between focal points collapsed to one node
        for ii in range(len(src_indices)):
            for jj in range(ii + 1, len(src_indices)):
                resistances[src_indices[ii], src_indices[jj]] = 0
                resistances[src_indices[jj], src_indices[ii]] = 0
        for pair_idx in range(point_idx + 1, len(csub)):
            dst_node = csub[pair_idx]
            if src_node == dst_node:
                continue
            comp_j = comp_index(dst_node)
            dst_indices = np.nonzero(points == dst_node)[0]
            combos = [(int(ci), int(cj))
                      for ci in src_indices for cj in dst_indices
                      if (int(orig_pts[ci]), int(orig_pts[cj]))
                      not in exclude]
            if not combos:
                continue
            if done_pairs and all(c in done_pairs for c in combos):
                continue  # resumed from a checkpoint
            pair_list.append((comp_i, comp_j, combos))

    # network currents: all columns of a block at once (vectorized
    # branch and node currents, pooled file writes)
    batch_net = not flags.is_raster and not sc.get_shortcut_resistances
    batch = prob.solver.batch_size or len(pair_list) or 1
    for st in range(0, len(pair_list), batch):
        chunk = pair_list[st:st + batch]
        rhs = np.zeros((matrix.shape[0], len(chunk)), dtype)
        for col, (ci, cj, _) in enumerate(chunk):
            rhs[ci, col] = -1
            rhs[cj, col] = 1
        with CSTIMER("solve and accumulate pairs"):
            lhs = ctx.solve(rhs)
            lhs = lhs - lhs[[ci for ci, _, _ in chunk],
                            range(len(chunk))][None, :]
        if batch_net:
            with CSTIMER("postprocess"):
                out.network_batch_postprocess(matrix, lhs, chunk, orig_pts,
                                              comp, cum, flags, cfg)
        for col, (ci, cj, combos) in enumerate(chunk):
            voltages = lhs[:, col]
            resistance = float(voltages[cj] - voltages[ci])
            for (c_i, c_j) in combos:
                resistances[c_i, c_j] = resistance
                resistances[c_j, c_i] = resistance
                output = _Output(points, voltages,
                                 (int(orig_pts[c_i]), int(orig_pts[c_j])),
                                 (ci, cj), resistance, c_j)
                with CSTIMER("postprocess"):
                    if batch_net:
                        if flags.outputflags.write_volt_maps:
                            out.write_volt_maps(
                                f"_{output.orig_pts[0]}_"
                                f"{output.orig_pts[1]}", voltages,
                                component_data, flags, cfg)
                    else:
                        postprocess(output, component_data, flags, sc, cfg,
                                    cum)
            ckpt.mark(combos)
        ckpt.save(resistances, cum, sc.voltmatrix)

    if sc.get_shortcut_resistances:
        anchor = int(np.nonzero(points == csub[0])[0][0])
        update_shortcut_resistances(anchor, sc, resistances, points, comp)


def postprocess(output: _Output, component_data, flags, shortcut, cfg, cum):
    """src/core.jl:655-683."""
    if shortcut.get_shortcut_resistances:
        update_voltmatrix(shortcut, output, component_data)
        return

    name = f"_{output.orig_pts[0]}_{output.orig_pts[1]}"
    of = flags.outputflags
    if of.write_volt_maps:
        out.write_volt_maps(name, output.voltages, component_data, flags,
                            cfg)
    if (of.write_cur_maps or of.write_cum_cur_map_only or
            of.write_max_cur_maps or not flags.is_raster):
        out.write_cur_maps(name, output.voltages, component_data,
                           np.asarray([-9999.0]), flags, cfg, cum)


def _save_padded(resistances, orig_pts, cfg):
    """Zero diagonal, pad with the user point ids (src/core.jl:299),
    write the resistance files; returns the padded matrix."""
    with CSTIMER.span("write resistances"):
        dtype = resistances.dtype
        np.fill_diagonal(resistances, 0)
        op = np.asarray(orig_pts, dtype)
        r = np.vstack([np.concatenate([np.zeros(1, dtype), op])[None, :],
                       np.column_stack([op, resistances])])
        out.save_resistances(r, cfg)
    return r


# device-chunk upper bound for the shortcut path (tests shrink this to
# force multi-chunk runs on tiny grids)
_shortcut_chunk_cap = 4096


def _polygon_projector(prob, S64):
    """The polygon (short-circuit region) collapse of a job with a
    polygon map, as the projector on the padded operator's grid; None
    without one, or when no polygon merges two active cells."""
    from ..solve.stencil import build_poly_projector
    if not prob.polymap.size:
        return None
    with CSTIMER("build polygon projector"):
        return build_poly_projector(prob.nodemap, S64.shape,
                                    S64.diag.device)


def _stencil_shortcut_solve(prob, flags, resistances, voltmatrix,
                            shortcut_res, device, ckpt=None,
                            done_pairs=None, max_par=0):
    """Shortcut-mode pairwise resistances via the grid stencil operator.

    Solves the N-1 anchor pairs of EVERY connected component in one
    batched stencil CG (solve/stencil.py), then reconstructs the full
    pairwise matrix with the voltage-ratio shortcut
    (src/core.jl:137-146,685-739 semantics).
    """
    from ..solve.dispatch import (COLUMN_BYTES_PER_CELL, SolverFailedError,
                                  pow2_floor, reraise_if_device_oom,
                                  solve_chunk_budget)
    from ..solve.prepare import prepare_stencil_solver_from_gmap
    from ..solve.stencil import (_extract_point_voltages,
                                 stencil_solve_pairs)

    points = prob.points
    nodemap = prob.nodemap
    H, W = nodemap.shape
    # the f64 planes build on the device from the uploaded conductance
    # map; work precision is f32 (the hierarchy's fine level), outer
    # refinement residuals run in f64 (stencil_solve_pairs)
    with CSTIMER("prepare stencil solver (upload + MG setup)"):
        S64, prec, prec_apply, _ = prepare_stencil_solver_from_gmap(
            prob.cellmap, flags.avg_res, flags.four_neighbors, device)
    proj = _polygon_projector(prob, S64)

    # invert the nodemap once: node id -> grid cell
    with CSTIMER("invert nodemap"):
        rr, cc_ = np.nonzero(nodemap)
        node_cell = np.zeros((int(nodemap.max()) + 1, 2), np.int64)
        node_cell[nodemap[rr, cc_]] = np.column_stack([rr, cc_])
        point_cells = node_cell[np.asarray(points)]   # (npts, 2)
        point_cells_dev = torch.as_tensor(point_cells, device=S64.diag.device)

    # Assemble anchor pairs per component
    jobs = []       # (comp_sorted, anchor_point_idx)
    pair_cols = []  # flat: (src_cell, dst_cell)
    col_meta = []   # flat: (comp_id, src_node, dst_node, comp, anchor)
    with CSTIMER.span("assemble anchor pairs"):
        for comp_id, comp in enumerate(prob.cc):
            comp = np.sort(np.asarray(comp))
            csub = _sub_focal(points, comp)
            if not csub:
                continue
            src_node = csub[0]
            src_indices = np.nonzero(points == src_node)[0]
            for ii in range(len(src_indices)):
                for jj in range(ii + 1, len(src_indices)):
                    resistances[src_indices[ii], src_indices[jj]] = 0
                    resistances[src_indices[jj], src_indices[ii]] = 0
            anchor = int(src_indices[0])
            jobs.append((comp, anchor))
            for dst_node in csub[1:]:
                if done_pairs:
                    dst_indices = np.nonzero(points == dst_node)[0]
                    combos = [(int(ci), int(cj)) for ci in src_indices
                              for cj in dst_indices]
                    if combos and all(c in done_pairs for c in combos):
                        # resumed: resistances+voltmatrix restored
                        continue
                pair_cols.append((node_cell[src_node],
                                  node_cell[dst_node]))
                col_meta.append((comp_id, src_node, dst_node, comp,
                                 anchor))

    if pair_cols:
        nb = len(pair_cols)
        # memory cap: COLUMN_BYTES_PER_CELL a cell per column under the
        # device's free memory, floored to a power of two because the
        # fused solve pads its batch UP to one
        per_col = H * W * COLUMN_BYTES_PER_CELL
        budget = solve_chunk_budget(H * W, S64.diag.device,
                                    mesh=getattr(S64, "mesh", None))
        step = max(1, min(_shortcut_chunk_cap, budget // max(per_col, 1)))
        if max_par > 0:
            # Circuitscape-4 `max_parallel` semantics: cap the number of
            # concurrent solves (batch width) per device chunk
            step = min(step, max_par)
        step = pow2_floor(step)
        stats.record(batch_width=min(step, nb))
        for s0 in range(0, nb, step):
            chunk = pair_cols[s0:s0 + step]
            bsz = len(chunk)
            src_cells = np.asarray([c[0] for c in chunk], np.int64)
            dst_cells = np.asarray([c[1] for c in chunk], np.int64)
            with CSTIMER("batched pair solve"):
                t0 = time.perf_counter()
                try:
                    X, relres, iters = stencil_solve_pairs(
                        S64, src_cells, dst_cells, rtol=consts.CG_RTOL,
                        itmax=consts.CG_ITMAX, prec=prec,
                        prec_apply=prec_apply, proj=proj)
                except torch.cuda.OutOfMemoryError as e:
                    reraise_if_device_oom(e, S64.shape[0] * S64.shape[1],
                                          bsz)
                stats.record_solve(tuple(X.shape), iters,
                                   time.perf_counter() - t0)
            if np.any(relres >= consts.RESIDUAL_GATE):
                raise SolverFailedError(
                    f"CG solver did not converge: relative residual "
                    f"{float(relres.max())} exceeds tolerance "
                    f"{consts.RESIDUAL_GATE}")
            # fetch only the voltages at focal cells (nb x npts)
            with CSTIMER.span("fetch focal voltages"):
                sc_dev = torch.as_tensor(
                    np.concatenate([src_cells,
                                    np.zeros((X.shape[0] - bsz, 2),
                                             np.int64)]),
                    device=X.device)
                Vp_dev, _ = _extract_point_voltages(X, sc_dev,
                                                    point_cells_dev)
                Vp = Vp_dev[:bsz].cpu().numpy()          # (bsz, npts)

            with CSTIMER.span("fill resistances and voltmatrix"):
                _fill_anchor_columns(Vp, col_meta[s0:s0 + bsz], points,
                                     resistances, voltmatrix, ckpt)
            if ckpt is not None:
                ckpt.save(resistances, None, voltmatrix)

    with CSTIMER.span("update shortcut resistances"):
        for comp, anchor in jobs:
            update_shortcut_resistances(
                anchor, _Shortcut(True, voltmatrix, shortcut_res),
                resistances, points, comp)


def _fill_anchor_columns(Vp, meta, points, resistances, voltmatrix, ckpt):
    """One chunk's anchor solves into resistances and voltmatrix: Vp
    (chunk columns, points) holds each solve's voltages at the focal
    cells, meta its columns' col_meta entries."""
    for col, (_, src_node, dst_node, comp, _) in enumerate(meta):
        dst_indices = np.nonzero(points == dst_node)[0]
        src_indices = np.nonzero(points == src_node)[0]
        # any point index mapping to dst_node reads the same value
        resistance = float(Vp[col, dst_indices[0]])
        in_comp = _focal_in_comp(points, comp)
        with np.errstate(divide="ignore", invalid="ignore"):
            volt_col = 1.0 - Vp[col] / resistance
        for c_i in src_indices:
            for c_j in dst_indices:
                resistances[c_i, c_j] = resistance
                resistances[c_j, c_i] = resistance
                # voltmatrix column fill (update_voltmatrix semantics,
                # vectorized over points)
                sel = in_comp.copy()
                sel[0] = False  # row 0 never filled (reference)
                voltmatrix[sel, c_j] = volt_col[sel]
        if ckpt is not None and ckpt.enabled:
            ckpt.mark([(int(ci), int(cj)) for ci in src_indices
                       for cj in dst_indices])


def _maps_pairs(prob, exclude, done_pairs, resistances):
    """All-pairs assembly across components for the maps path: one solve
    per focal node pair, assigned to every user-point combo mapping to
    it (src/core.jl:386-444); zero resistance between points that share
    a node.  Returns [(src_node, dst_node, combos)]."""
    points = prob.points
    orig_pts = prob.user_points
    pair_list = []
    for comp in prob.cc:
        csub = _sub_focal(points, np.sort(np.asarray(comp)))
        for pi, src_node in enumerate(csub):
            src_indices = np.nonzero(points == src_node)[0]
            for ii in range(len(src_indices)):
                for jj in range(ii + 1, len(src_indices)):
                    resistances[src_indices[ii], src_indices[jj]] = 0
                    resistances[src_indices[jj], src_indices[ii]] = 0
            for dst_node in csub[pi + 1:]:
                if dst_node == src_node:
                    continue
                dst_indices = np.nonzero(points == dst_node)[0]
                combos = [(int(ci), int(cj))
                          for ci in src_indices for cj in dst_indices
                          if (int(orig_pts[ci]), int(orig_pts[cj]))
                          not in exclude]
                if not combos:
                    continue
                if done_pairs and all(c in done_pairs for c in combos):
                    continue    # resumed from checkpoint
                pair_list.append((src_node, dst_node, combos))
    return pair_list


def _host_copy(t: torch.Tensor):
    """Start t's copy to the host on the calling thread: on CUDA into
    pinned memory, asynchronously on the current stream, with an event
    that marks its end; on the CPU a plain contiguous copy.  Returns
    (host tensor, event or None) for _host_wait."""
    if not t.is_cuda:
        return t.contiguous(), None
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return buf, ev


def _host_wait(copy) -> np.ndarray:
    buf, ev = copy
    if ev is not None:
        ev.synchronize()
    return buf.numpy()


def _stencil_maps_solve(prob, flags, cfg, resistances, cum, exclude,
                        device):
    """Maps-on (and exclude-pair) pairwise via the stencil device path
    (counterpart of the JAX package's drivers/core._stencil_maps_solve).

    All pairs of all components solve in batched device chunks of at
    most 32 columns.  Per chunk, on the device: each column is
    normalised to its source cell and zeroed outside the pair's
    component, node currents are computed (float32), log transform and
    null-to-nodata are applied per map, and the cumulative (float64, one
    count per user-point combo) and max maps reduce over the batch.
    Their device->host copies start on the main thread (pinned memory
    and an event) and are waited for one chunk later, while the next
    chunk solves; a thread pool writes the per-pair files.  The host
    accumulates cum/max in chunk order, then marks the chunk's pairs
    done, so a checkpoint never holds a chunk's maps without its pairs.
    """
    from ..solve.dispatch import (COLUMN_BYTES_PER_CELL, SolverFailedError,
                                  pow2_floor, reraise_if_device_oom,
                                  solve_chunk_budget)
    from ..solve.prepare import prepare_stencil_solver_from_gmap
    from ..solve.stencil import stencil_node_currents, stencil_solve_pairs

    orig_pts = prob.user_points
    nodemap = prob.nodemap
    of = flags.outputflags
    dtype = resistances.dtype
    nodata = prob.hbmeta.nodata
    H, W = nodemap.shape

    cslog.info("pairwise device path (maps on)")
    with CSTIMER("prepare stencil solver (upload + MG setup)"):
        S64, prec, prec_apply, _ = prepare_stencil_solver_from_gmap(
            prob.cellmap, flags.avg_res, flags.four_neighbors, device)
    Hp, Wp = S64.shape       # bucketed up from (H, W); maps crop back
    dev = S64.diag.device
    proj = _polygon_projector(prob, S64)

    with CSTIMER.span("label components"):
        rr, cc_ = np.nonzero(nodemap)
        node_cell = np.zeros((int(nodemap.max()) + 1, 2), np.int64)
        node_cell[nodemap[rr, cc_]] = np.column_stack([rr, cc_])
        # component label per cell: a pair's voltages are zero outside
        # its component (create_voltage_map on the local nodemap)
        comp_label_of_node = np.zeros(int(nodemap.max()) + 1, np.int32)
        for ci, comp in enumerate(prob.cc):
            comp_label_of_node[np.asarray(comp)] = ci + 1
        labels_grid = np.zeros((Hp, Wp), np.int32)
        labels_grid[rr, cc_] = comp_label_of_node[nodemap[rr, cc_]]
        labels_dev = torch.as_tensor(labels_grid, device=dev)

    ckpt = Checkpoint(getattr(cfg, "checkpoint_file", ""))
    done_pairs = ckpt.load(resistances, cum)
    with CSTIMER.span("assemble pairs"):
        pair_list = _maps_pairs(prob, exclude, done_pairs, resistances)

    write_pair_files = of.write_cur_maps and not of.write_cum_cur_map_only
    need_cur = (of.write_cur_maps or of.write_cum_cur_map_only or
                of.write_max_cur_maps)
    null_cur = None
    if need_cur and of.set_null_currents_to_nodata:
        m = np.ones((Hp, Wp), bool)
        m[:H, :W] = prob.cellmap == 0
        null_cur = torch.as_tensor(m, device=dev)

    # per column the chunk also holds the normalised voltages and the
    # float32 node currents besides the solve's own blocks; chunks cap
    # at 32 so that one chunk's output overlaps the next one's solve
    per_col = H * W * (COLUMN_BYTES_PER_CELL + 8)
    # CS_MAPS_CHUNK_BYTES overrides the maps path's budget; it falls
    # back to CS_SHORTCUT_CHUNK_BYTES, then to the device's free memory
    budget = solve_chunk_budget(
        H * W, dev, env_var=("CS_MAPS_CHUNK_BYTES"
                             if os.environ.get("CS_MAPS_CHUNK_BYTES")
                             else "CS_SHORTCUT_CHUNK_BYTES"),
        mesh=getattr(S64, "mesh", None))
    step = max(1, min(32, budget // max(per_col, 1)))
    if getattr(cfg, "max_parallel", 0) > 0:
        step = min(step, cfg.max_parallel)
    step = pow2_floor(step)   # after the clamp: the batch pads up to pow2

    writer = ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2))
    pending = []            # file-write futures
    inflight = deque()      # (chunk, resistances, host copies) per chunk

    def drain_one():
        chunk, rvals, copies = inflight.popleft()
        with CSTIMER("fetch maps"):
            host = {k: _host_wait(v) for k, v in copies.items()}
        with CSTIMER("node currents + reduce"):
            if "cum" in host:
                cum.cum_curr += host["cum"].astype(dtype, copy=False)
            if "max" in host:
                np.maximum(cum.max_curr, host["max"].astype(dtype),
                           out=cum.max_curr)
        with CSTIMER("write maps"):
            for col, (_, _, combos) in enumerate(chunk):
                resistance = float(rvals[col])
                for (c_i, c_j) in combos:
                    resistances[c_i, c_j] = resistance
                    resistances[c_j, c_i] = resistance
                    name = f"_{int(orig_pts[c_i])}_{int(orig_pts[c_j])}"
                    if write_pair_files:
                        pending.append(writer.submit(
                            out.write_grid, host["cur"][col], name, cfg,
                            prob.hbmeta))
                    if of.write_volt_maps:
                        vm = host["volt"][col].copy()
                        if of.set_null_voltages_to_nodata:
                            vm[prob.cellmap == 0] = nodata
                        pending.append(writer.submit(
                            out.write_grid, vm, name, cfg, prob.hbmeta,
                            voltage=True))
                ckpt.mark(combos)
        if ckpt.enabled:
            for f in pending:   # a saved chunk's maps must be on disk
                f.result()
            pending.clear()
            ckpt.save(resistances, cum)

    try:
        for s0 in range(0, len(pair_list), step):
            chunk = pair_list[s0:s0 + step]
            bsz = len(chunk)
            src_cells = np.asarray([node_cell[p[0]] for p in chunk],
                                   np.int64)
            dst_cells = np.asarray([node_cell[p[1]] for p in chunk],
                                   np.int64)
            with CSTIMER("batched pair solve"):
                t0 = time.perf_counter()
                try:
                    X, rel, iters = stencil_solve_pairs(
                        S64, src_cells, dst_cells, rtol=consts.CG_RTOL,
                        itmax=consts.CG_ITMAX, prec=prec,
                        prec_apply=prec_apply, proj=proj)
                except torch.cuda.OutOfMemoryError as e:
                    reraise_if_device_oom(e, Hp * Wp, bsz)
                stats.record_solve(tuple(X.shape), iters,
                                   time.perf_counter() - t0)
            if np.any(rel >= consts.RESIDUAL_GATE):
                raise SolverFailedError(
                    f"CG solver did not converge: relative residual "
                    f"{float(rel.max())} exceeds tolerance "
                    f"{consts.RESIDUAL_GATE}")
            # normalise each column to its source cell, zero outside the
            # pair's component
            with CSTIMER.span("normalise columns"):
                cols = torch.arange(bsz, device=dev)
                scj = torch.as_tensor(src_cells, device=dev)
                dcj = torch.as_tensor(dst_cells, device=dev)
                Xb = X[:bsz]
                vsrc = Xb[cols, scj[:, 0], scj[:, 1]]
                pair_label = labels_dev[scj[:, 0], scj[:, 1]]
                in_comp = labels_dev[None] == pair_label[:, None, None]
                Xb = torch.where(in_comp, Xb - vsrc[:, None, None], 0.0)
                rvals = Xb[cols, dcj[:, 0], dcj[:, 1]].cpu().numpy()

            copies = {}
            if need_cur:
                with CSTIMER("node currents + reduce"):
                    ncur = stencil_node_currents(S64, Xb, proj=proj,
                                                 out_dtype=torch.float32)
                    if of.log_transform_maps:
                        ncur = torch.where(ncur > 0, torch.log10(ncur),
                                           nodata)
                    if null_cur is not None:
                        ncur = torch.where(null_cur[None], nodata, ncur)
                    # one accumulation per user-point combo (duplicate
                    # focal ids share a solve), summed in float64
                    combo_n = torch.tensor([len(c[2]) for c in chunk],
                                           dtype=torch.float64, device=dev)
                    copies["cum"] = _host_copy(torch.einsum(
                        "b,bhw->hw", combo_n, ncur.double())[:H, :W])
                    if of.write_max_cur_maps:
                        copies["max"] = _host_copy(
                            torch.amax(ncur, dim=0)[:H, :W])
                    if write_pair_files:
                        copies["cur"] = _host_copy(ncur[:, :H, :W])
            if of.write_volt_maps:
                # maps stay float32 on the host, as in the JAX package
                copies["volt"] = _host_copy(Xb[:, :H, :W].float())
            inflight.append((chunk, rvals, copies))
            if len(inflight) >= 2:
                drain_one()
        while inflight:
            drain_one()
        with CSTIMER("write maps"):
            for f in pending:
                f.result()
            pending.clear()
    finally:
        writer.shutdown(wait=True)
    ckpt.finish()


def update_shortcut_resistances(anchor, sc, resistances, points, comp):
    """Reconstruct all pairwise resistances from the anchor solves
    (src/core.jl:706-739, 0-based indices).

    Uses R2x = 2*R12*Vx + R1x - R12 where Vx is the normalized voltage
    at point x in the anchor->point2 solve."""
    voltmatrix = sc.voltmatrix
    shortcut = sc.shortcut_res
    check = _focal_in_comp(points, comp)  # comp arrives sorted
    n = resistances.shape[0]
    for pointx in range(n):
        if not check[pointx]:
            continue
        R1x = resistances[anchor, pointx]
        if R1x == -1:
            continue
        shortcut[pointx, anchor] = shortcut[anchor, pointx] = R1x
        for point2 in range(pointx, n):
            if not check[point2]:
                continue
            R12 = resistances[anchor, point2]
            if R12 == -1:
                continue
            if R1x != consts.RESISTANCE_INVALID:
                shortcut[anchor, point2] = shortcut[point2, anchor] = R12
                Vx = voltmatrix[pointx, point2]
                R2x = 2 * R12 * Vx + R1x - R12
                if shortcut[point2, pointx] != consts.RESISTANCE_INVALID:
                    shortcut[point2, pointx] = shortcut[pointx, point2] = R2x
            else:
                shortcut[pointx, :] = consts.RESISTANCE_INVALID
                shortcut[:, pointx] = consts.RESISTANCE_INVALID


def update_voltmatrix(shortcut, output, component_data):
    """src/core.jl:685-703 (0-based indices)."""
    voltmatrix = shortcut.voltmatrix
    c = output.points
    cc = component_data.cc
    voltages = output.voltages
    r = output.resistance
    j = output.col
    for i in range(1, len(c)):
        k = np.searchsorted(cc, c[i])
        if k < len(cc) and cc[k] == c[i]:
            v = voltages[k]
            voltmatrix[i, j] = 1 - v / r
