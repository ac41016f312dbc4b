"""Raster one-to-all / all-to-one scenario driver.

Counterpart of circuitscape_tpu/drivers/onetoall.py.  Parity reference:
src/raster/onetoall.jl:1-194.  Each focal node is one advanced solve
(source at the node against grounds at the others, or the inverse); on
the stencil device path every focal node of the job is one column of a
batched stencil solve.  Included pairs, merged points, small grids and
direct solvers take the reference's one-solve-per-point loop
(onetoall_kernel), each point an advanced job on the general
sparse-graph tier, as in the JAX package.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import consts, cslog, out, stats
from ..graph import build
from ..io.loaders import load_raster_data
from ..solve.dispatch import get_solver
from ..timer import CSTIMER
from .advanced import (AdvancedProblem, _get_sources_and_grounds,
                       advanced_kernel)
from .flags import get_raster_flags
from .raster import _grid_components, prune_points

# the harmonic one-to-all columns' stop (_onetoall_device_fast): the
# unit-current answer's residual at a tenth of consts.CG_RTOL, within 6
# float64 passes.  At CG_RTOL itself the 1M-cell TestArea1 jobs' current
# maps missed a float64 reference by up to 5.4e-5 of their max (30-50
# times the residual); at a tenth, reached in 4-5 passes, by 6e-6.
HARMONIC_RTOL = 0.1 * consts.CG_RTOL
HARMONIC_PASSES = 6


def raster_one_to_all(cfg, dtype, device):
    """src/raster/onetoall.jl:1-11."""
    with CSTIMER("load raster data"):
        rasterdata = load_raster_data(cfg, dtype)
    flags = get_raster_flags(cfg)
    return onetoall_kernel(rasterdata, flags, cfg, dtype, device)


def prune_strengths(strengths, point_ids):
    """src/raster/onetoall.jl:182-194."""
    keep = np.isin(strengths[:, 0], point_ids)
    return strengths[keep]


def _onetoall_device_fast(data, flags, cfg, dtype, device):
    """Batched stencil device path of one-to-all and all-to-one
    (counterpart of the JAX package's _onetoall_device_fast).

    One-to-all: column i injects point i's strength and grounds every
    other focal point by a penalty.  The penalty at every focal cell is
    baked into the MG hierarchy, so the hierarchy's operator grounds
    point i too: column i solves it for the harmonic u_i that is 1 at
    point i and 0 at every other point (its right-hand side the weights
    of the edges into point i), and the unit-current solution is
    u_i / I_i, I_i the current u_i draws out of point i.  Every column
    solves the hierarchy's own operator (the CG body the fused
    matvec_pap kernel), and its passes stop where the unit-current
    answer's residual, u_i's over I_i, is HARMONIC_RTOL.  Solving the
    column's own operator, the bare Laplacian plus a penalty at the
    other points, under a hierarchy that grounds point i leaves the
    point's voltage an eigenvalue ~1e-8 of the rest to the float32 CG,
    whose refinement passes then stall at 1M cells (the JAX package's
    device path does that).  With polygons, and on a mesh (no penalty in
    the hierarchy), each column solves its own operator with its own
    penalty field, as the JAX package does.

    All-to-one grounds a single, different cell per column, which no
    shared penalty conditions well: each column solves the balanced
    floating system instead (the other points' strengths injected, their
    sum drawn at the ground cell, no penalty in the hierarchy), then is
    pinned to 0 at its ground within its component, the exact Dirichlet
    limit.  Its zero penalty field is still passed, as the JAX package
    does, so its CG body is the unfused one too.

    Columns go in byte-budgeted chunks.  Under write_cum_cur_map_only
    no map per point is written or copied to the host, as the pairwise
    paths write none (out.write_cur_maps); the JAX package's device path
    and the per-point loop (advanced_kernel) write them.
    Returns the (point, result)
    matrix, or None where the JAX package takes its general path:
    included pairs, repeated point ids or points merged into one node,
    solvers other than cg+amg, grids below CS_ONETOALL_DEVICE_MIN
    cells."""
    from ..solve.dispatch import (COLUMN_BYTES_PER_CELL, SolverFailedError,
                                  pow2_floor, reraise_if_device_oom,
                                  solve_chunk_budget)
    from ..solve.prepare import (prepare_stencil_solver_from_gmap,
                                 prepare_stencil_solver_from_gmap_pen)
    from ..solve.stencil import (_to_dtype, advanced_ground_penalty,
                                 build_poly_projector, stencil_edges_at,
                                 stencil_node_currents,
                                 stencil_solve_advanced_batch)

    strengths = data.strengths
    gmap = data.cellmap
    hbmeta = data.hbmeta
    rows, cols, pts = data.points_rc

    if (not data.included_pairs.isempty() or cfg.solver != "cg+amg" or
            len(pts) != len(np.unique(pts))):
        return None
    min_cells = int(os.environ.get("CS_ONETOALL_DEVICE_MIN", "40000"))
    if gmap.size < min_cells:
        return None

    one_to_all = flags.is_onetoall
    use_var = strengths.size > 0
    of = flags.outputflags
    H, W = gmap.shape
    cslog.info("one-to-all device fast path: %s points in one batch",
               len(pts))

    bake_pen = one_to_all and len(pts) > 1
    with CSTIMER("prepare stencil solver (upload + MG setup)"):
        if bake_pen:
            pen_spec = np.zeros((H, W))
            pen_spec[np.asarray(rows) - 1, np.asarray(cols) - 1] = np.inf
            S64, prec, geomg_apply, _, pen_host = \
                prepare_stencil_solver_from_gmap_pen(
                    gmap, flags.avg_res, flags.four_neighbors, pen_spec,
                    device)
            # on a mesh the hierarchy carries no penalty (pen_host is
            # None): the plain mesh setup it returned runs the columns
            # with the masked preconditioner, as the JAX package's does
            bake_pen = pen_host is not None
        else:
            S64, prec, geomg_apply, _ = prepare_stencil_solver_from_gmap(
                gmap, flags.avg_res, flags.four_neighbors, device)
    dev = S64.diag.device
    Hp, Wp = S64.shape

    with CSTIMER("construct graph"):
        if data.polymap.size:
            # polygons merge with the focal points (src/raster/
            # onetoall.jl:86-90) and can bridge grid islands, so the
            # components are the merged graph's
            point_map = np.zeros(gmap.shape, np.int64)
            for x in range(len(pts)):
                point_map[rows[x] - 1, cols[x] - 1] = pts[x]
            newpoly = build.create_new_polymap(gmap, data.polymap,
                                               data.points_rc, 0, 0,
                                               point_map)
            nodemap = build.construct_node_map(gmap, newpoly)
            proj = build_poly_projector(nodemap, S64.shape, dev)
            comps = build.components(build.construct_graph(
                gmap, nodemap, flags.avg_res, flags.four_neighbors))
        else:
            nodemap = build.construct_node_map(gmap,
                                               np.zeros((0, 0), np.int64))
            proj = None
            comps = _grid_components(gmap, nodemap, flags.four_neighbors)
    node_of = [int(nodemap[rows[i] - 1, cols[i] - 1])
               for i in range(len(pts))]
    if len(set(node_of)) != len(node_of):
        return None   # points merged into one node
    comp_of = np.full(len(pts), -1)
    for ci, comp in enumerate(comps):
        cset = set(int(x) for x in comp)
        for i, node in enumerate(node_of):
            if node in cset:
                comp_of[i] = ci

    npts = len(pts)
    cells = np.column_stack([np.asarray(rows) - 1, np.asarray(cols) - 1])
    strength = np.ones(npts)
    if use_var:
        strength = strengths[:npts, 1].astype(np.float64)
    penalty = advanced_ground_penalty(S64) if one_to_all else 0.0
    # one-to-all columns on the hierarchy's own operator (the harmonic
    # u_i); with polygons, each column's operator is the bare Laplacian
    # plus its own penalty field (prec.levels[0].A holds the shared one)
    harmonic = bake_pen and proj is None
    A_lo = (_to_dtype(S64, torch.float32) if bake_pen and not harmonic
            else None)
    if harmonic:
        far, w_at = stencil_edges_at(S64, cells)
        focal = np.zeros((Hp, Wp), bool)
        focal[cells[:, 0], cells[:, 1]] = True
        # u_i's right-hand side: the edges into point i, at cells that
        # are not focal points (those are grounded)
        rhs_w = np.where(focal[far[..., 0], far[..., 1]], 0.0, w_at)

    active = np.ones(npts, bool)
    for i in range(npts):
        same_comp = (comp_of == comp_of[i]) & (comp_of >= 0)
        same_comp[i] = False
        if not same_comp.any():
            active[i] = False

    res = np.full(npts, -1.0)
    cum = out.initialize_cum_maps(gmap, of.write_max_cur_maps)
    # currents feed the cumulative (and max) maps whenever either map
    # option is on; a map per point only without write_cum_cur_map_only,
    # the rule of out.write_cur_maps
    need_cur = of.write_cur_maps or of.write_cum_cur_map_only
    point_maps = of.write_cur_maps and not of.write_cum_cur_map_only
    idx_active = np.nonzero(active)[0]

    if not one_to_all:
        # component label per cell of the padded grid, for the pin
        lab = np.zeros((Hp, Wp), np.int64)
        rr_, cc2 = np.nonzero(nodemap)
        node_lab = np.zeros(int(nodemap.max()) + 1, np.int64)
        for ci_, comp_ in enumerate(comps):
            node_lab[np.asarray(comp_)] = ci_ + 1
        lab[rr_, cc2] = node_lab[nodemap[rr_, cc2]]
        labels_dev = torch.as_tensor(lab, device=dev)

    # byte-budgeted column chunks, COLUMN_BYTES_PER_CELL a cell a column;
    # the max_parallel cap, then the power-of-two floor, in that order
    per_col = Hp * Wp * COLUMN_BYTES_PER_CELL
    budget = solve_chunk_budget(Hp * Wp, dev,
                                env_var="CS_ONETOALL_CHUNK_BYTES",
                                mesh=getattr(S64, "mesh", None))
    step = max(1, min(4096, budget // max(per_col, 1)))
    if getattr(cfg, "max_parallel", 0) > 0:
        step = min(step, cfg.max_parallel)
    step = pow2_floor(step)
    arange = np.arange(npts)

    for s0 in range(0, idx_active.size, step):
        sel = idx_active[s0:s0 + step]
        bsz = len(sel)
        nsrc = far.shape[1] if harmonic else npts
        src_cells = np.zeros((bsz, nsrc, 2), np.int64)
        src_vals = np.zeros((bsz, nsrc), np.float64)
        gnd_cells = np.tile(cells[None], (bsz, 1, 1))
        gnd_vals = np.zeros((bsz, npts), np.float64)
        for k, i in enumerate(sel):
            if harmonic:
                src_cells[k], src_vals[k] = far[i], rhs_w[i]
                gnd_vals[k] = penalty
            elif one_to_all:
                src_cells[k, 0] = cells[i]
                src_vals[k, 0] = strength[i]
                gnd_vals[k] = np.where(arange != i, penalty, 0.0)
            else:
                others = (comp_of == comp_of[i]) & (comp_of >= 0)
                others[i] = False
                src_cells[k] = cells
                vals = np.where(others, strength, 0.0)
                vals[i] = -vals.sum()      # balanced floating injection
                src_vals[k] = vals

        own = torch.as_tensor(cells[sel], device=dev)
        ks = torch.arange(bsz, device=dev)
        drawn_by = None
        if harmonic:
            far_k = torch.as_tensor(far[sel], device=dev)
            w_k = torch.as_tensor(w_at[sel], device=dev)

            def drawn_by(X, far_k=far_k, w_k=w_k, ks=ks):
                # the current u_i + e_i draws out of point i along its
                # edges: the unit-current answer's residual is u_i's
                # over it
                u = X[ks[:, None], far_k[..., 0], far_k[..., 1]]
                return torch.sum(w_k * (1.0 - u), dim=1).cpu().numpy()

        t0 = time.perf_counter()
        try:
            with CSTIMER("batched pair solve"):
                X, rel, iters = stencil_solve_advanced_batch(
                    S64, src_cells, src_vals, gnd_cells, gnd_vals,
                    rtol=HARMONIC_RTOL if harmonic else consts.CG_RTOL,
                    itmax=consts.CG_ITMAX, prec=prec,
                    prec_apply=geomg_apply,
                    max_refine=HARMONIC_PASSES if harmonic else 4,
                    proj=proj, pen_in_prec=harmonic, A_lo=A_lo,
                    rel_to=drawn_by)
        except Exception as e:
            reraise_if_device_oom(e, Hp * Wp, bsz)
        stats.record_solve(tuple(X.shape), iters, time.perf_counter() - t0)
        if np.any(rel >= consts.RESIDUAL_GATE):
            raise SolverFailedError(
                f"one-to-all device solve residual {float(rel.max())} "
                f"exceeds tolerance {consts.RESIDUAL_GATE}")

        if harmonic:
            # u_i = 1 at its point; the current it draws is its energy
            # u^T L u (second order in the solve's error, where the sum
            # along the point's edges is first order); the point's
            # strength times u_i / I_i
            X[ks, own[:, 0], own[:, 1]] += 1.0
            drawn = torch.sum(X * S64.matvec(X), dim=(1, 2))
            X.mul_((torch.as_tensor(strength[sel], device=dev) /
                    drawn)[:, None, None])
        if not one_to_all:
            # pin each column's ground cell to 0 within its component (a
            # constant shift changes no flow; other components keep the
            # reference's 0)
            shifts = X[ks, own[:, 0], own[:, 1]]
            col_lab = torch.as_tensor([comp_of[i] + 1 for i in sel],
                                      device=dev)
            X = torch.where(labels_dev[None] == col_lab[:, None, None],
                            X - shifts[:, None, None], 0.0)
        vals = X[ks, own[:, 0], own[:, 1]].cpu().numpy()
        for k, i in enumerate(sel):
            if one_to_all:
                v = vals[k] / strength[i]
                res[i] = -1.0 if v == 0 else v
            else:
                res[i] = 0.0

        if need_cur:
            with CSTIMER("node currents + reduce"):
                ncur = stencil_node_currents(S64, X, proj=proj)
                cum.cum_curr += torch.sum(ncur, dim=0).cpu().numpy()[:H, :W]
                if of.write_max_cur_maps:
                    np.maximum(cum.max_curr,
                               torch.amax(ncur, dim=0).cpu().numpy()[:H, :W],
                               out=cum.max_curr)
                if point_maps:
                    ncur_h = ncur.cpu().numpy()
            if point_maps:
                with CSTIMER("write maps"):
                    for k, i in enumerate(sel):
                        out.write_grid(ncur_h[k].astype(dtype)[:H, :W],
                                       f"_{int(pts[i])}", cfg, hbmeta,
                                       cellmap=gmap)
        if of.write_volt_maps:
            X_h = X.cpu().numpy()
            with CSTIMER("write maps"):
                for k, i in enumerate(sel):
                    out.write_grid(X_h[k].astype(dtype)[:H, :W],
                                   f"_{int(pts[i])}", cfg, hbmeta,
                                   cellmap=gmap, voltage=True)

    if need_cur:
        with CSTIMER("write cumulative current maps"):
            out.write_cum_maps(cum, gmap, cfg, hbmeta, of.write_max_cur_maps,
                               of.write_cum_cur_map_only)

    return np.column_stack([np.asarray(pts, dtype), res.astype(dtype)])


def onetoall_kernel(data, flags, cfg, dtype, device):
    """src/raster/onetoall.jl:13-167: the stencil device path where it
    applies, else one advanced solve per focal point.  Reference quirks
    are kept, since the goldens encode them: the nodemap rebuilt from
    the original polymap in the included-pairs branch, strengths indexed
    by loop position."""
    fast = _onetoall_device_fast(data, flags, cfg, dtype, device)
    if fast is not None:
        return fast
    strengths = data.strengths
    included_pairs = data.included_pairs
    points_rc = data.points_rc
    gmap = data.cellmap
    polymap = data.polymap
    hbmeta = data.hbmeta

    use_variable_strengths = strengths.size > 0
    use_included_pairs = not included_pairs.isempty()
    mode = 0 if included_pairs.mode == "include" else 1
    one_to_all = flags.is_onetoall

    if use_included_pairs:
        prune_points(points_rc, included_pairs.point_ids)
        if use_variable_strengths:
            strengths = prune_strengths(strengths, included_pairs.point_ids)

    point_map = np.zeros(gmap.shape, np.int64)
    rows, cols, pts = points_rc
    for x in range(len(pts)):
        point_map[rows[x] - 1, cols[x] - 1] = pts[x]

    points_unique = list(dict.fromkeys(int(p) for p in pts))

    with CSTIMER("construct graph"):
        newpoly = build.create_new_polymap(gmap, polymap, points_rc, 0, 0,
                                           point_map)
        nodemap = build.construct_node_map(gmap, newpoly)
        a = build.construct_graph(gmap, nodemap, flags.avg_res,
                                  flags.four_neighbors)
        cc = build.components(a)
        G = build.laplacian(a)
    cslog.info("There are %s points and %s connected components",
               a.shape[0], len(cc))

    cum = out.initialize_cum_maps(gmap, flags.outputflags.write_max_cur_maps)

    point_ids = included_pairs.point_ids
    num_points_to_solve = len(points_unique)
    res = np.zeros(num_points_to_solve, dtype)
    original_point_map = point_map.copy()
    unique_point_map = np.zeros(gmap.shape, np.int64)
    strength_map_base = (np.zeros(gmap.shape, dtype)
                         if use_variable_strengths
                         else np.zeros((0, 0), dtype))

    for i in points_unique:
        ind = int(np.nonzero(pts == i)[0][0])
        unique_point_map[rows[ind] - 1, cols[ind] - 1] = pts[ind]

    def solve_point(i):
        point_map = original_point_map.copy()
        strength_map = strength_map_base.copy()
        local_newpoly = newpoly
        local_nodemap = nodemap
        stren = strengths[i, 1] if use_variable_strengths else 1
        cslog.info("Solving point %s of %s", i + 1, num_points_to_solve)
        n = points_unique[i]

        if use_included_pairs:
            for j in range(len(point_ids)):
                if i != j and included_pairs.include_pairs[i, j] == mode:
                    point_map[point_map == point_ids[j]] = 0
            local_newpoly = build.create_new_polymap(
                gmap, polymap, points_rc, 0, 0, point_map)
            # reference quirk: nodemap rebuilt from the ORIGINAL polymap
            # (src/raster/onetoall.jl:90)
            local_nodemap = build.construct_node_map(gmap, polymap)

        if use_variable_strengths:
            tmp = np.array([point_map[rows[x] - 1, cols[x] - 1]
                            for x in range(len(rows))])
            _strengths = strengths.copy()
            _strengths[tmp == 0, 1] = 1
            for x in range(len(rows)):
                strength_map[rows[x] - 1, cols[x] - 1] = _strengths[x, 1]

        if point_map.sum() == n:
            return -1, None

        T = dtype
        if one_to_all:
            source_map = np.where(unique_point_map == n, T(stren), T(0))
            ground_map = np.where(point_map == n, 0, point_map).astype(T)
            ground_map = np.where(ground_map > 0, np.inf, ground_map)
        else:
            if use_variable_strengths:
                source_map = np.where(unique_point_map == n, T(0),
                                      strength_map).astype(T)
            else:
                source_map = np.where(unique_point_map != 0, T(1), T(0))
                source_map = np.where(point_map == n, T(0), source_map)
            ground_map = np.where(point_map == n, np.inf, T(0))

        check_node = int(local_nodemap[rows[i] - 1, cols[i] - 1])

        policy = "rmvgnd" if one_to_all else "rmvsrc"
        sources, grounds, finite_grounds = _get_sources_and_grounds(
            source_map, ground_map, flags, G, local_nodemap, policy)

        advanced_data = AdvancedProblem(G, cc, local_nodemap, local_newpoly,
                                        hbmeta, sources, grounds, source_map,
                                        finite_grounds, check_node, n, gmap,
                                        get_solver(cfg))
        v, curr = advanced_kernel(advanced_data, flags, cfg, device)
        return v.flat[0], curr

    results = [solve_point(i) for i in range(num_points_to_solve)]

    # deterministic reduction over the per-point current maps
    for i, (r_i, curr) in enumerate(results):
        res[i] = r_i
        if curr is None:
            continue
        cum.cum_curr += curr
        if flags.outputflags.write_max_cur_maps:
            np.maximum(cum.max_curr, curr, out=cum.max_curr)

    of = flags.outputflags
    if of.write_cur_maps or of.write_cum_cur_map_only:
        with CSTIMER("write cumulative current maps"):
            out.write_cum_maps(cum, gmap, cfg, hbmeta, of.write_max_cur_maps,
                               of.write_cum_cur_map_only)

    return np.column_stack([np.asarray(points_unique, dtype), res])
