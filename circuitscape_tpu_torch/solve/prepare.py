"""Setup for the stencil device path: conductance map -> device operator
+ geometric-MG hierarchy.

Counterpart of circuitscape_tpu/solve/prepare.py: the plain setup and
the pen-aware one of the advanced and one-to-all paths, on one device or
on a device mesh.  Grids of at most CS_DEVICE_MG_MAX cells (read at
call time, default 1200000, as in the JAX package) build their
hierarchy on the device; larger ones take the JAX package's large-grid
route: the float64 operator still builds on the device from the
uploaded map, the fine level is its float32 cast, and the coarser
levels coarsen on the host in float64 (geomg.build_geo_mg).

When a mesh is active (parallel/mesh.active_mesh: more than one device
of the job's type visible) the grid's rows pad to lcm(128, 8 x nodes),
so the fine level and three coarser ones split evenly over 'nodes'; the
operator and the host-built hierarchy are laid out row-sharded
(parallel/mesh.shard_hierarchy).  Above CS_STREAM_BUILD_MIN cells (read
at call time, default 4000000) the mesh build streams: each shard's
planes build from its own rows of the map, so the full fine planes
never exist on the host.  Padding cells carry zero weights, so callers
crop fetched maps back to the returned original shape.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import stats
from ..parallel.mesh import (active_mesh, build_shard_stencil,
                             shard_hierarchy, shard_stencil_from_slabs)
from ..timer import CSTIMER
from .geomg import (GeoMgHierarchy, GeoMgLevel, _coarsen_planes_slab,
                    _np_diag, build_geo_mg, build_geo_mg_device, geomg_apply)
from .stencil import (_to_dtype, advanced_ground_penalty,
                      operator_from_numpy, stencil_activity_stats,
                      stencil_from_gmap_device, stencil_planes_np)


def _device_mg_max() -> int:
    """Largest grid (cells) whose hierarchy builds on the device; above
    it the hierarchy builds on the host.  The JAX package's knob."""
    return int(os.environ.get("CS_DEVICE_MG_MAX", "1200000"))


def _bucket(n: int) -> int:
    """A grid side padded up to a 128-cell multiple (one operator shape
    per size bucket)."""
    return -(-n // 128) * 128


def _upload_operator(gmap, avg_res, four_neighbors, device):
    """The conductance map, padded to its bucket with inactive cells, and
    its five float64 stencil planes built on the device.  Returns
    (padded host map, S64)."""
    H0, W0 = gmap.shape
    g = np.zeros((_bucket(H0), _bucket(W0)), np.float64)
    g[:H0, :W0] = np.where(gmap > 0, gmap, 0.0)
    return g, stencil_from_gmap_device(torch.as_tensor(g, device=device),
                                       bool(avg_res), bool(four_neighbors))


def _record(cells, fine_nnz, prec, device, build):
    """The setup's stats; a level on a mesh is named by its route and
    its layout (shard: rows split over 'nodes', whole: rows whole)."""
    device = torch.device(device)
    route = "cuda" if device.type == "cuda" else "torch"

    def name(L):
        nsh = getattr(L.A, "nsh", None)
        return route if nsh is None else \
            f"{route}/{'shard' if nsh > 1 else 'whole'}"
    stats.record(fine_nnz=fine_nnz, cells=cells,
                 device_name=(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                 mg_kernels=[name(L) for L in getattr(prec, "levels", ())]
                 or ["jacobi"], mg_build=build)


def prepare_stencil_solver_from_gmap(gmap, avg_res, four_neighbors,
                                     device):
    """Upload the (H, W) conductance map and build the five float64
    stencil planes on the device, then the float32 MG hierarchy: on the
    device, or on the host when the unpadded grid has more than
    CS_DEVICE_MG_MAX cells (_prepare_large_single).

    On the active mesh: the streamed build above CS_STREAM_BUILD_MIN
    cells, else prepare_stencil_solver on the host planes.

    Returns (S64, prec, prec_apply, (H0, W0))."""
    device = torch.device(device)
    gmap = np.asarray(gmap)
    H0, W0 = gmap.shape
    mesh = active_mesh(H0 * W0, device)
    if mesh is not None:
        if gmap.size > int(os.environ.get("CS_STREAM_BUILD_MIN",
                                          "4000000")):
            return prepare_stencil_solver_streamed(
                gmap, avg_res, four_neighbors, mesh)
        return prepare_stencil_solver(
            stencil_planes_np(gmap, avg_res, four_neighbors), mesh)
    if gmap.size > _device_mg_max():
        return _prepare_large_single(gmap, avg_res, four_neighbors, device)
    g, S64 = _upload_operator(gmap, avg_res, four_neighbors, device)
    # bucketed grids are >= 128 x 128, so the hierarchy always pays off
    prec = build_geo_mg_device(_to_dtype(S64, torch.float32))
    _record(g.size, stencil_activity_stats(g, four_neighbors), prec,
            device, "device")
    return S64, prec, geomg_apply, (H0, W0)


def _prepare_large_single(gmap, avg_res, four_neighbors, device):
    """Device-built operator, host-coarsened hierarchy and a fine level
    derived on the device from the operator (the JAX package's
    _prepare_large_single), for grids above CS_DEVICE_MG_MAX cells."""
    H0, W0 = gmap.shape
    with CSTIMER("device operator"):
        g, S64 = _upload_operator(gmap, avg_res, four_neighbors, device)
        A32 = _to_dtype(S64, torch.float32)
    with CSTIMER("host planes"):
        planes = stencil_planes_np(g, avg_res, four_neighbors)
    with CSTIMER("host hierarchy"):
        prec = build_geo_mg(planes, device=device,
                            fine_device_ops=A32.planes)
    del planes
    _record(g.size, stencil_activity_stats(g, four_neighbors), prec,
            device, "host")
    return S64, prec, geomg_apply, (H0, W0)


def prepare_stencil_solver_from_gmap_pen(gmap, avg_res, four_neighbors,
                                         pen_spec, device):
    """Setup for the advanced and one-to-all solves: the ground diagonal
    is baked into the MG hierarchy (coarsened per level, see
    geomg._build_levels_device and geomg.build_geo_mg), so the V-cycle
    preconditions the grounded operator.  The hierarchy builds on the
    host when the padded grid has more than CS_DEVICE_MG_MAX cells (the
    JAX package compares the padded size here, the unpadded one in
    prepare_stencil_solver_from_gmap).

    pen_spec: (H0, W0) float64 host field of per-cell ground
    conductances; np.inf marks a direct ground, resolved to
    advanced_ground_penalty(S64).  The penalty is added in float32 to
    the float32 diagonal, so prec.levels[0].A is the f32 L + diag(pen):
    the inner CG applies it with pen=None
    (stencil.stencil_solve_advanced_batch, pen_in_prec=True).

    Returns (S64, prec, prec_apply, (H0, W0), pen_host), pen_host the
    resolved (H0, W0) float64 field for the operator's diagonal term.
    On a mesh the sharded hierarchy does not carry the penalty, as in the
    JAX package: pen_host is None, and the caller falls back to the
    masked preconditioner on the plain mesh setup (which, with a single
    direct ground at megacell scale, converges poorly)."""
    device = torch.device(device)
    gmap = np.asarray(gmap)
    H0, W0 = gmap.shape
    mesh = active_mesh(H0 * W0, device)
    if mesh is not None:
        return prepare_stencil_solver(
            stencil_planes_np(gmap, avg_res, four_neighbors), mesh) + (None,)
    g, S64 = _upload_operator(gmap, avg_res, four_neighbors, device)

    penalty = advanced_ground_penalty(S64)
    pen_host = np.where(np.isinf(pen_spec), penalty,
                        np.asarray(pen_spec, np.float64))
    pen_pad = np.zeros(g.shape, np.float64)
    pen_pad[:H0, :W0] = pen_host
    A32 = _to_dtype(S64, torch.float32)
    pen32 = torch.as_tensor(pen_pad, dtype=torch.float32, device=device)
    if g.size <= _device_mg_max():
        prec = build_geo_mg_device(A32, pen=pen32)
        build = "device"
    else:
        prec = build_geo_mg(
            stencil_planes_np(g, avg_res, four_neighbors), device=device,
            pen_np=pen_pad, fine_device_ops=A32.planes[:4] + (
                A32.diag + pen32,))
        build = "host"
    _record(g.size, stencil_activity_stats(g, four_neighbors), prec,
            device, build)
    return S64, prec, geomg_apply, (H0, W0), pen_host


def prepare_stencil_solver(planes, mesh, use_mg=True):
    """The materialized mesh setup (the JAX package's
    prepare_stencil_solver under a mesh).  planes: 5 host numpy float64
    planes (we, ws, wse, wne, diag).

    Returns (S64, prec, prec_apply, (H0, W0)): S64 the float64 operator
    as a ShardStencil, rows padded to lcm(128, 8 x nodes); prec the
    host-built float32 hierarchy laid out by shard_hierarchy (None for
    grids of at most 4096 cells, which run Jacobi CG)."""
    H0, W0 = planes[0].shape
    # the fine level and the first three coarse levels split evenly over
    # 'nodes' (each level halves the row count)
    qh = math.lcm(128, mesh.shape["nodes"] * 8)
    Hp = -(-H0 // qh) * qh
    Wp = _bucket(W0)
    planes = [np.pad(np.asarray(p, np.float64), ((0, Hp - H0), (0, Wp - W0)))
              for p in planes]
    S64 = build_shard_stencil(
        mesh, operator_from_numpy(planes, torch.float64, "cpu"))
    prec = None
    if use_mg and planes[0].size > 4096:
        prec = shard_hierarchy(mesh, build_geo_mg(planes))
    edges = sum(int(np.count_nonzero(p)) for p in planes[:4])
    _record(Hp * Wp, 2 * edges + int(np.count_nonzero(planes[4])), prec,
            mesh.lead, "host" if prec is not None else "none")
    return S64, prec, (geomg_apply if prec is not None else None), (H0, W0)


def _row_sharded_from_slabs(mesh, shape, slabs_of, specs):
    """Per-shard host slabs to per-shard device tensors, without the full
    arrays ever existing on the host.

    slabs_of(k) -> dict name -> numpy slab for row shard k (rows
    [k*hs, (k+1)*hs)); specs: [(name, dtype), ...].  Each shard's slabs
    are computed once and copied to the devices of its mesh row (one
    copy per distinct device).  Returns dict name -> [slab tensor of
    shard k on the device of mesh position (k, 0)]."""
    nsh = mesh.shape["nodes"]
    assert shape[0] % nsh == 0
    out = {name: [] for name, _ in specs}
    for k in range(nsh):
        slabs = slabs_of(k)
        for name, dtype in specs:
            a = np.ascontiguousarray(slabs[name], dtype)
            out[name].append(torch.from_numpy(a).to(mesh.device(k, 0)))
    return out


def prepare_stencil_solver_streamed(gmap, avg_res, four_neighbors, mesh,
                                    use_mg=True):
    """Mesh setup with a shard-local host build: each 'nodes' shard's row
    slab of the weight planes is computed from its rows of the map (one
    halo row each side) and sent straight to its devices; the full fine
    planes never exist on the host.  Host memory therefore scales with
    cells per shard plus the level-1-and-down pyramid (~1/3 of the fine
    level).

    The fine MG level streams the same way (float32 casts of the slabs);
    level 1 coarsens per slab (geomg._coarsen_planes_slab, with the
    cross-slab NE carry) into full quarter-size planes, from which the
    rest of the hierarchy builds exactly as build_geo_mg.  The operator,
    the hierarchy and every array of it equal the materialized mesh
    build's (prepare_stencil_solver)."""
    gmap = np.asarray(gmap, np.float64)
    H0, W0 = gmap.shape
    nsh = mesh.shape["nodes"]
    qh = math.lcm(128, nsh * 8)
    Hp = -(-H0 // qh) * qh
    Wp = -(-W0 // 128) * 128
    hs = Hp // nsh

    def g_rows(r0, r1):
        """Padded map rows [r0, r1) as a fresh (r1 - r0, Wp) block."""
        out = np.zeros((r1 - r0, Wp))
        lo, hi = max(r0, 0), min(r1, H0)
        if hi > lo:
            out[lo - r0:hi - r0, :W0] = np.where(
                gmap[lo:hi] > 0, gmap[lo:hi], 0.0)
        return out

    names = ("we", "ws", "wse", "wne", "diag")
    build_mg = use_mg and Hp * Wp > 4096
    # level-1 planes accumulate during the same slab sweep
    hc, wc = Hp // 2, Wp // 2
    cplanes = [np.zeros((hc, wc)) for _ in range(4)] if build_mg else None

    def slabs_of(k):
        """All per-shard arrays for rows [k*hs, (k+1)*hs) in one shot."""
        r0, r1 = k * hs, (k + 1) * hs
        g = g_rows(r0 - 1, r1 + 1)     # one halo row each side
        planes = [p[1:-1] for p in
                  stencil_planes_np(g, avg_res, four_neighbors)]
        out = dict(zip(names, planes))
        if build_mg:
            d = planes[4]
            out["inv"] = np.where(d > 0,
                                  1.0 / np.where(d == 0, 1.0, d), 0.0)
            for i, name in enumerate(names):
                out[name + "32"] = planes[i]   # cast by spec dtype
            cE, cS, cSE, cNE, carry = _coarsen_planes_slab(
                planes[0], planes[1], planes[2], planes[3],
                first=(k == 0), last=(k == nsh - 1))
            c0 = k * (hs // 2)
            cplanes[0][c0:c0 + hs // 2] = cE
            cplanes[1][c0:c0 + hs // 2] = cS
            cplanes[2][c0:c0 + hs // 2] = cSE
            cplanes[3][c0:c0 + hs // 2] = cNE
            if k > 0:
                cplanes[1][c0 - 1] += carry
        return out

    specs = [(n, np.float64) for n in names]
    if build_mg:
        specs += [(n + "32", np.float32) for n in names]
        specs += [("inv", np.float32)]
    with CSTIMER("streamed shard build"):
        dev = _row_sharded_from_slabs(mesh, (Hp, Wp), slabs_of, specs)
    S64 = shard_stencil_from_slabs(mesh, [dev[n] for n in names])

    prec = None
    if build_mg:
        # levels 1..coarse build exactly like the materialized path
        rest = shard_hierarchy(mesh, build_geo_mg(
            tuple(cplanes) + (_np_diag(*cplanes),)))
        fine = shard_stencil_from_slabs(
            mesh, [dev[n + "32"] for n in names], dev["inv"])
        prec = GeoMgHierarchy(
            (GeoMgLevel(fine, fine.inv_diag(), 2.0, False),) + rest.levels,
            rest.coarse_pinv, rest.coarse_shape, rest.overcorrect)
    # activity stats straight off the (unpadded) map: padding cells are
    # inactive and add no edges, so the nnz is identical
    _record(Hp * Wp, stencil_activity_stats(gmap, four_neighbors), prec,
            mesh.lead, "host streamed")
    return S64, prec, (geomg_apply if prec is not None else None), (H0, W0)
