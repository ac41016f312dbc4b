"""Core pairwise driver: all-pairs effective resistance over components.

Counterpart of circuitscape_tpu/drivers/core.py, shortcut branch.
Parity reference: src/core.jl:64-739 (single_ground_all_pairs, shortcut
optimization, get_num_pairs, voltmatrix bookkeeping).

The reference schedules one linear solve per focal pair; here a raster
without polygons is exactly a stencil, so the N-1 anchor pairs of every
connected component solve as one batched device solve
(_stencil_shortcut_solve), and the full matrix is rebuilt with the
voltage-ratio shortcut.  Jobs that need per-pair maps or exclude pairs
(no shortcut) are not carried yet (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .. import consts, cslog, out, stats
from ..checkpoint import Checkpoint
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
    """Solve all focal-point pairs, shortcut mode (src/core.jl:70-305)."""
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

    num_pairs = get_num_pairs(prob.cc, points, exclude, orig_pts)
    if log:
        cslog.info("Total number of pair solves = %s", num_pairs)

    get_shortcut = (flags.is_raster and not of.any_maps and not exclude)
    stencil_base = (flags.is_raster and not prob.solver.is_direct and
                    prob.cellmap.size > 0 and prob.nodemap.size > 0)
    if not (get_shortcut and stencil_base):
        raise NotImplementedError(
            "circuitscape_tpu_torch carries raster pairwise in shortcut "
            "mode only (no maps, no exclude pairs); per-pair solves are "
            "ROADMAP queue 1 item 6")

    resistances = -np.ones((numpoints, numpoints), dtype)
    voltmatrix = np.zeros((numpoints, numpoints), dtype)
    shortcut_res = -np.ones((numpoints, numpoints), dtype)

    ckpt = Checkpoint(getattr(cfg, "checkpoint_file", ""))
    done_pairs = ckpt.load(resistances, cum, voltmatrix)

    cslog.info("Triggering resistance calculation shortcut")
    num_pairs = get_num_pairs_shortcut(prob.cc, points, exclude, orig_pts)
    cslog.info("Total number of pair solves has been reduced to %s",
               num_pairs)

    _stencil_shortcut_solve(prob, flags, resistances, voltmatrix,
                            shortcut_res, device, ckpt, done_pairs,
                            max_par=getattr(cfg, "max_parallel", 0))
    ckpt.finish()
    resistances = shortcut_res
    np.fill_diagonal(resistances, 0)
    # Pad with the user point ids (src/core.jl:299)
    op = np.asarray(orig_pts, dtype)
    r = np.vstack([np.concatenate([np.zeros(1, dtype), op])[None, :],
                   np.column_stack([op, resistances])])
    out.save_resistances(r, cfg)
    return r


# device-chunk upper bound for the shortcut path (tests shrink this to
# force multi-chunk runs on tiny grids)
_shortcut_chunk_cap = 4096


def _stencil_shortcut_solve(prob, flags, resistances, voltmatrix,
                            shortcut_res, device, ckpt=None,
                            done_pairs=None, max_par=0):
    """Shortcut-mode pairwise resistances via the grid stencil operator.

    Solves the N-1 anchor pairs of EVERY connected component in one
    batched stencil CG (solve/stencil.py), then reconstructs the full
    pairwise matrix with the voltage-ratio shortcut
    (src/core.jl:137-146,685-739 semantics).
    """
    from ..solve.dispatch import (SolverFailedError, pow2_floor,
                                  reraise_if_device_oom,
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
                    continue  # resumed: resistances+voltmatrix restored
            pair_cols.append((node_cell[src_node], node_cell[dst_node]))
            col_meta.append((comp_id, src_node, dst_node, comp, anchor))

    if pair_cols:
        nb = len(pair_cols)
        # memory cap: ~8 live f64 (B, H, W) blocks per column under the
        # device's free memory, floored to a power of two because the
        # fused solve pads its batch UP to one
        per_col = H * W * 8 * 8
        budget = solve_chunk_budget(H * W, S64.diag.device)
        step = max(1, min(_shortcut_chunk_cap, budget // max(per_col, 1)))
        if max_par > 0:
            # Circuitscape-4 `max_parallel` semantics: cap the number of
            # concurrent solves (batch width) per device chunk
            step = min(step, max_par)
        step = pow2_floor(step)
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
                        prec_apply=prec_apply)
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
            sc_dev = torch.as_tensor(
                np.concatenate([src_cells,
                                np.zeros((X.shape[0] - bsz, 2), np.int64)]),
                device=X.device)
            Vp_dev, _ = _extract_point_voltages(X, sc_dev, point_cells_dev)
            Vp = Vp_dev[:bsz].cpu().numpy()          # (bsz, npts)

            for col in range(bsz):
                comp_id, src_node, dst_node, comp, anchor = col_meta[s0 + col]
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
                        # voltmatrix column fill (update_voltmatrix
                        # semantics, vectorized over points)
                        sel = in_comp.copy()
                        sel[0] = False  # row 0 never filled (reference)
                        voltmatrix[sel, c_j] = volt_col[sel]
                if ckpt is not None and ckpt.enabled:
                    ckpt.mark([(int(ci), int(cj)) for ci in src_indices
                               for cj in dst_indices])
            if ckpt is not None:
                ckpt.save(resistances, None, voltmatrix)

    for comp, anchor in jobs:
        update_shortcut_resistances(anchor,
                                    _Shortcut(True, voltmatrix, shortcut_res),
                                    resistances, points, comp)


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
