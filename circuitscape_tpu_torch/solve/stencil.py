"""Stencil operator: the grid form of a raster graph Laplacian, in torch.

Counterpart of circuitscape_tpu/solve/stencil.py (the single-device
solves: pairs, and the batched grounds of advanced and one-to-all).  A
raster habitat map produces a graph whose every node touches at most 8
fixed neighbors; the Laplacian is held as 4 directed weight planes
(E, S, SE, NE) over the (H, W) grid plus a diagonal plane, and the
matvec is shifted-plane arithmetic over (B, H, W) voltage blocks.

All components of the grid solve simultaneously: the operator is
block-diagonal across components, and CG iterates stay inside the
component their right-hand side lives in.

Short-circuit regions (polygons, and the focal regions a pair merges)
are applied as the projector PolyProjector onto polygon-constant
fields: CG then runs the operator Pi L Pi, which solves the collapsed
system exactly while the matvec stays the grid kernel.

Precision follows the JAX package, which runs with x64 enabled: the
planes, right-hand sides and refinement residuals are float64; the
inner CG passes run in float32 on the hierarchy's fine operator, whose
matvecs go through the hand-written kernels of solve/cuda_stencil.py.
The JAX while_loops are Python loops here: each CG iteration syncs with
the host once for its stop test.

The loops reach the operator only through its methods (matvec,
matvec_pap, project, layout, gather, ...).  On a device mesh
(parallel/mesh.py) the operator is a ShardStencil with the same methods
and the blocks are MeshBlocks: the same loops run on them, and the
solvers hand back full tensors on the mesh's first device.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import stats
from ..timer import CSTIMER


@dataclass
class StencilOperator:
    """Grid Laplacian as directed neighbor weight planes, all (H, W):

    we:   weight to the East  neighbor (i, j)->(i, j+1); 0 in last col
    ws:   weight to the South neighbor (i, j)->(i+1, j); 0 in last row
    wse:  weight to the SE neighbor (i, j)->(i+1, j+1)
    wne:  weight to the NE neighbor (i, j)->(i-1, j+1); 0 in first row
    diag: Laplacian diagonal (sum of incident edge weights)
    """

    we: torch.Tensor
    ws: torch.Tensor
    wse: torch.Tensor
    wne: torch.Tensor
    diag: torch.Tensor

    @property
    def shape(self):
        return tuple(self.diag.shape)

    @property
    def planes(self):
        return (self.we, self.ws, self.wse, self.wne, self.diag)

    # The operations the solvers apply through their operator.  The
    # mesh's ShardStencil (parallel/mesh.py) has the same ones, so the CG
    # loop and the V-cycle run unchanged on either.

    col_groups = 1          # the batch pads to a multiple of this

    def to_dtype(self, dtype) -> "StencilOperator":
        """Cast of all five planes (contiguous, as the kernels need)."""
        return StencilOperator(*(p.to(dtype).contiguous()
                                 for p in self.planes))

    def layout(self, x: torch.Tensor) -> torch.Tensor:
        """A full block laid out for this operator (here: as it is)."""
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """A block of this operator's layout as a full tensor."""
        return x

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """L x: a float32 block through the matvec kernel, a float64 one
        (the refinement residuals) through stencil_matvec."""
        if x.dtype == torch.float32:
            from .cuda_stencil import matvec
            return matvec(self, x)
        return stencil_matvec(self, x)

    def matvec_pap(self, p: torch.Tensor):
        """(L p, per-column p.Lp) in one kernel."""
        from .cuda_stencil import matvec_pap
        return matvec_pap(self, p)

    def cheb_step(self, dinv, r, d, x, ca: float, cb: float):
        """One Chebyshev step of the generic smoother (one kernel)."""
        from .cuda_stencil import cheb_step
        return cheb_step(self, dinv, r, d, x, ca, cb)

    def residual_restrict(self, b, x, coarse=None) -> torch.Tensor:
        """The 2x2 restriction of b - L x (one kernel), laid out for the
        next level's operator `coarse` (None below the last level)."""
        from .cuda_stencil import residual_restrict
        return residual_restrict(self, b, x)

    def prolong_add(self, x: torch.Tensor, xc: torch.Tensor,
                    scale: float) -> torch.Tensor:
        """x + scale * P xc, the piecewise-constant interpolation of a
        coarse block to this operator's grid, written into x (one
        kernel)."""
        from .cuda_stencil import prolong_add
        return prolong_add(x, xc, scale)

    def coarse_solve(self, pinv, b: torch.Tensor) -> torch.Tensor:
        """The dense pseudo-inverse solve of the grid under this level."""
        from .geomg import coarse_solve
        return coarse_solve(pinv, b)

    def project(self, proj, y: torch.Tensor) -> torch.Tensor:
        return poly_project(proj, y)

    def node_flows(self, V: torch.Tensor, cutoff: float):
        """(inflow, outflow) of every cell, branch currents under cutoff
        times the column's largest dropped (stencil_node_currents)."""
        dirs = _branch_dirs(self, V.dtype)
        thr = (cutoff * _max_branch(dirs, V))[:, None, None]
        return _split_flows(dirs, V, thr)


def _to_dtype(A: StencilOperator, dtype) -> StencilOperator:
    """Cast of all five planes (contiguous, as the kernels need)."""
    return A.to_dtype(dtype)


def operator_from_numpy(planes, dtype=torch.float32,
                        device="cpu") -> StencilOperator:
    """StencilOperator from 5 host arrays (we, ws, wse, wne, diag)."""
    return StencilOperator(*(torch.as_tensor(np.array(p),
                                             dtype=dtype, device=device)
                             for p in planes))


@dataclass
class PolyProjector:
    """Polygon (short-circuit region) collapse for the stencil solve.

    The reference merges polygon cells into one graph node before
    building the Laplacian (src/raster/pairwise.jl:283-314); the stencil
    cannot express merged nodes, so the collapse is applied as the
    orthogonal projector Pi = P (P^T P)^-1 P^T onto polygon-constant
    fields (P = cell -> merged-node incidence).  CG with Pi L Pi on
    range(Pi) solves the collapsed system P^T L P v = P^T b exactly.

    seg maps each cell to its polygon (0 .. nseg-2) or to the trash slot
    nseg-1, whose inv_count is 0: shape (H*W,) for one merge pattern
    shared by every column, (B, H*W) for one pattern per column.  The
    sums run over the polygon cells only, never over the trash slot:
    `cells` lists them sorted by polygon (for a per-column seg, as flat
    indices into the (B*H*W,) block), `cell_seg` gives each one's
    polygon (per-column: row * (nseg-1) + polygon), and `lengths` counts
    the cells of every polygon (of every row), zeros included.  A sum is
    then one sorted-segment reduction with no atomics, the same bits on
    every call."""

    seg: torch.Tensor          # (H*W,) or (B, H*W) int32
    inv_counts: torch.Tensor   # (nseg,) or (B, nseg) float64; trash = 0
    nseg: int
    cells: torch.Tensor        # (P,) int64
    cell_seg: torch.Tensor     # (P,) int64
    lengths: torch.Tensor      # (nseg-1,) or (B*(nseg-1),) int64


def projector_from_numpy(seg, inv_counts, nseg: int,
                         device="cpu") -> PolyProjector:
    """PolyProjector from host seg / inv_counts / nseg (the JAX
    package's PolyProjector fields), with the polygon cells sorted by
    polygon for the segment reductions."""
    seg = np.asarray(seg)
    rows = seg.reshape(-1, seg.shape[-1])
    npoly = nseg - 1
    r, c = np.nonzero(rows < npoly)
    gid = r.astype(np.int64) * npoly + rows[r, c]
    order = np.argsort(gid, kind="stable")

    def dev(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device)

    return PolyProjector(
        dev(seg, torch.int32), dev(inv_counts, torch.float64), int(nseg),
        dev((r.astype(np.int64) * rows.shape[1] + c)[order], torch.int64),
        dev(gid[order], torch.int64),
        dev(np.bincount(gid, minlength=rows.shape[0] * npoly), torch.int64))


def _poly_ids(nodemap: np.ndarray, shape):
    """The ids shared by more than one cell of nodemap (its polygons),
    their cell counts, and nodemap zero-padded to shape."""
    active = nodemap > 0
    ids, counts = np.unique(nodemap[active], return_counts=True)
    H, W = nodemap.shape
    full = np.zeros(shape, nodemap.dtype)
    full[:H, :W] = nodemap
    return ids[counts > 1], counts[counts > 1], full.ravel()


def _poly_seg(shared, flat, trash):
    """Polygon index of each cell of flat (position in shared), trash
    elsewhere."""
    npoly = shared.size
    if npoly == 0:
        return np.full(flat.shape, trash, np.int32)
    pos = np.clip(np.searchsorted(shared, flat), 0, npoly - 1)
    is_poly = (shared[pos] == flat) & (flat > 0)
    return np.where(is_poly, pos, trash).astype(np.int32)


def build_poly_projector(nodemap: np.ndarray, shape=None, device="cpu"):
    """PolyProjector from a nodemap whose merged (polygon) nodes cover
    more than one cell; None when it has none.  shape: the padded (H, W)
    of the device operator; padded cells map to the trash slot."""
    shared, counts, flat = _poly_ids(
        nodemap, nodemap.shape if shape is None else shape)
    if shared.size == 0:
        return None
    npoly = shared.size
    inv_counts = np.concatenate([1.0 / counts, np.zeros(1)])
    return projector_from_numpy(_poly_seg(shared, flat, npoly), inv_counts,
                                npoly + 1, device)


def build_poly_projector_rows(nodemaps, shape, device="cpu"):
    """Batched PolyProjector from one nodemap per column (focal-regions
    pairwise: each pair merges its own focal regions).  All rows share
    one segment budget nseg = max polygon count + the trash slot."""
    per = [_poly_ids(nm, shape) for nm in nodemaps]
    nseg = max(s.size for s, _, _ in per) + 1 if per else 1
    segs, invs = [], []
    for shared, counts, flat in per:
        inv = np.zeros(nseg, np.float64)
        inv[:shared.size] = 1.0 / counts
        segs.append(_poly_seg(shared, flat, nseg - 1))
        invs.append(inv)
    return projector_from_numpy(np.stack(segs), np.stack(invs), nseg, device)


def _pad_projector_rows(proj: PolyProjector, b_pad: int) -> PolyProjector:
    """A per-column projector extended with all-trash rows to b_pad
    columns (inv_counts 0), so padded columns pass through unchanged;
    the polygon cells of the first rows keep their flat indices."""
    extra = b_pad - proj.seg.shape[0]
    if proj.seg.dim() == 1 or extra <= 0:
        return proj
    seg = torch.cat([proj.seg, torch.full((extra, proj.seg.shape[1]),
                                          proj.nseg - 1,
                                          dtype=proj.seg.dtype,
                                          device=proj.seg.device)])
    inv = torch.cat([proj.inv_counts,
                     proj.inv_counts.new_zeros((extra, proj.nseg))])
    lengths = torch.cat([proj.lengths,
                         proj.lengths.new_zeros(extra * (proj.nseg - 1))])
    return PolyProjector(seg, inv, proj.nseg, proj.cells, proj.cell_seg,
                         lengths)


def _poly_sums(proj: PolyProjector, flat: torch.Tensor) -> torch.Tensor:
    """Per-column polygon sums (B, nseg-1) of flat (B, H*W), in its
    dtype: one sorted-segment reduction over the polygon cells.  The
    lengths come from projector_from_numpy and sum to the cell count, so
    segment_reduce's checks (a device-to-host sync on CUDA) are
    skipped."""
    B = flat.shape[0]
    if proj.seg.dim() == 1:
        vals = flat[:, proj.cells].t()            # (P, B)
        return torch.segment_reduce(vals, "sum", lengths=proj.lengths,
                                    axis=0, unsafe=True).t()
    vals = flat.reshape(-1)[proj.cells]
    return torch.segment_reduce(vals, "sum", lengths=proj.lengths,
                                unsafe=True).view(B, -1)


def _poly_write(proj: PolyProjector, flat: torch.Tensor,
                per_poly: torch.Tensor) -> torch.Tensor:
    """flat with every polygon cell set to its polygon's per_poly
    value (B, nseg-1); the other cells pass through."""
    out = flat.clone()
    if proj.seg.dim() == 1:
        out[:, proj.cells] = per_poly[:, proj.cell_seg]
    else:
        out.view(-1)[proj.cells] = per_poly.reshape(-1)[proj.cell_seg]
    return out


def poly_project(proj: PolyProjector, y: torch.Tensor) -> torch.Tensor:
    """Apply Pi to a (B, H, W) block: polygon cells take their polygon
    mean, all other cells pass through.  Works in y's dtype; inv_counts
    is cast to it before the multiply, as in the JAX package."""
    if proj.nseg == 1:
        return y
    B, H, W = y.shape
    flat = y.reshape(B, H * W)
    inv = proj.inv_counts[..., :-1].to(y.dtype)
    means = _poly_sums(proj, flat) * inv
    return _poly_write(proj, flat, means).view(B, H, W)


def poly_sum(proj: PolyProjector, y: torch.Tensor) -> torch.Tensor:
    """Polygon cells take their polygon sum (broadcast to members); all
    other cells pass through.  Used for merged-node current maps."""
    if proj.nseg == 1:
        return y
    B, H, W = y.shape
    flat = y.reshape(B, H * W)
    return _poly_write(proj, flat, _poly_sums(proj, flat)).view(B, H, W)


def stencil_activity_stats(gmap: np.ndarray, four_neighbors: bool) -> int:
    """Fine-level nnz of the stencil Laplacian: 2*edges + number of
    active cells with at least one active neighbor (the sustained nnz/s
    metric in stats.py)."""
    act = np.asarray(gmap) > 0
    edges = (int(np.count_nonzero(act[:, :-1] & act[:, 1:])) +
             int(np.count_nonzero(act[:-1, :] & act[1:, :])))
    nbr = np.zeros_like(act)
    nbr[:, :-1] |= act[:, 1:]
    nbr[:, 1:] |= act[:, :-1]
    nbr[:-1, :] |= act[1:, :]
    nbr[1:, :] |= act[:-1, :]
    if not four_neighbors:
        edges += (int(np.count_nonzero(act[:-1, :-1] & act[1:, 1:])) +
                  int(np.count_nonzero(act[1:, :-1] & act[:-1, 1:])))
        nbr[:-1, :-1] |= act[1:, 1:]
        nbr[1:, 1:] |= act[:-1, :-1]
        nbr[1:, :-1] |= act[:-1, 1:]
        nbr[:-1, 1:] |= act[1:, :-1]
    return 2 * edges + int(np.count_nonzero(act & nbr))


def _pad_plane(a: np.ndarray, H: int, W: int) -> np.ndarray:
    out = np.zeros((H, W), a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def stencil_planes_np(gmap: np.ndarray, avg_res: bool, four_neighbors: bool):
    """Host plane construction: 5 numpy float64 arrays (we, ws, wse, wne,
    diag) with the edge-weight rules of graph/build.py, the input of the
    host-built hierarchy (geomg.build_geo_mg).  A copy of the JAX
    package's stencil_planes_np, so its float64 arithmetic (and every
    coarse level built from it) is the same to the bit."""
    from ..graph.build import cond_avg, res_avg, weird_avg, weirder_avg

    g = np.asarray(gmap, np.float64)
    H, W = g.shape
    act = g > 0
    f1 = res_avg if avg_res else cond_avg
    f2 = weirder_avg if avg_res else weird_avg

    def plane(src_sl, dst_sl, fn):
        m = act[src_sl] & act[dst_sl]
        with np.errstate(divide="ignore", invalid="ignore"):
            w = np.where(m, fn(g[src_sl], g[dst_sl]), 0.0)
        w[~m] = 0.0
        return w

    we = _pad_plane(plane(np.s_[:, :-1], np.s_[:, 1:], f1), H, W)
    ws = _pad_plane(plane(np.s_[:-1, :], np.s_[1:, :], f1), H, W)
    if four_neighbors:
        wse = np.zeros((H, W))
        wne = np.zeros((H, W))
    else:
        wse = _pad_plane(plane(np.s_[:-1, :-1], np.s_[1:, 1:], f2), H, W)
        # NE plane indexed at the source cell (i, j), i >= 1
        wne_core = plane(np.s_[1:, :-1], np.s_[:-1, 1:], f2)
        wne = np.zeros((H, W))
        wne[1:, :W - 1] = wne_core

    diag = np.zeros((H, W))
    diag[:, :-1] += we[:, :-1]
    diag[:, 1:] += we[:, :-1]
    diag[:-1, :] += ws[:-1, :]
    diag[1:, :] += ws[:-1, :]
    diag[:-1, :-1] += wse[:-1, :-1]
    diag[1:, 1:] += wse[:-1, :-1]
    diag[1:, :-1] += wne[1:, :-1]
    diag[:-1, 1:] += wne[1:, :-1]

    return we, ws, wse, wne, diag


def stencil_matvec_np(A: StencilOperator, x: np.ndarray) -> np.ndarray:
    """Host (numpy, float64) stencil matvec on (B, H, W) blocks, for an
    operator of numpy planes: the power iteration of the host-built
    hierarchy's lam estimate (geomg._estimate_lam_max), in the JAX
    package's order of operations."""
    we = np.asarray(A.we, np.float64)
    ws = np.asarray(A.ws, np.float64)
    wse = np.asarray(A.wse, np.float64)
    wne = np.asarray(A.wne, np.float64)
    diag = np.asarray(A.diag, np.float64)
    y = diag[None] * x
    y[:, :, :-1] -= we[None, :, :-1] * x[:, :, 1:]
    y[:, :, 1:] -= we[None, :, :-1] * x[:, :, :-1]
    y[:, :-1, :] -= ws[None, :-1, :] * x[:, 1:, :]
    y[:, 1:, :] -= ws[None, :-1, :] * x[:, :-1, :]
    y[:, :-1, :-1] -= wse[None, :-1, :-1] * x[:, 1:, 1:]
    y[:, 1:, 1:] -= wse[None, :-1, :-1] * x[:, :-1, :-1]
    y[:, 1:, :-1] -= wne[None, 1:, :-1] * x[:, :-1, 1:]
    y[:, :-1, 1:] -= wne[None, 1:, :-1] * x[:, 1:, :-1]
    return y


def stencil_from_gmap_device(gmap: torch.Tensor, avg_res: bool,
                             four_neighbors: bool,
                             dtype=torch.float64) -> StencilOperator:
    """Device-side plane construction from an uploaded conductance map,
    with the same four edge-weight rules as graph/build.py
    (src/raster/pairwise.jl:364-367).  Cells with gmap <= 0 take no
    edges.  Runs on gmap's device."""
    g = gmap.to(dtype)
    act = g > 0
    sqrt2 = math.sqrt(2.0)

    if avg_res:
        def f1(a, b):
            return 2.0 / (1.0 / a + 1.0 / b)

        def f2(a, b):
            return 2.0 / (sqrt2 * (1.0 / a + 1.0 / b))
    else:
        def f1(a, b):
            return (a + b) / 2.0

        def f2(a, b):
            return (a + b) / (2.0 * sqrt2)

    def plane(dr, dc, fn):
        """Weight plane at the source cell for offset (dr, dc)."""
        gs = _sh(g[None], -dr, -dc)[0]        # neighbor value at source
        ms = _sh(act[None].to(dtype), -dr, -dc)[0] > 0
        safe_g = torch.where(g == 0, 1.0, g)
        safe_n = torch.where(gs == 0, 1.0, gs)
        w = fn(safe_g, safe_n)
        return torch.where(act & ms, w, 0.0)

    we = plane(0, 1, f1)
    ws = plane(1, 0, f1)
    if four_neighbors:
        wse = torch.zeros_like(we)
        wne = torch.zeros_like(we)
    else:
        wse = plane(1, 1, f2)
        wne = plane(-1, 1, f2)

    # diagonal = sum of incident edge weights (each plane contributes at
    # both endpoints)
    diag = (we + _sh(we[None], 0, 1)[0] +
            ws + _sh(ws[None], 1, 0)[0] +
            wse + _sh(wse[None], 1, 1)[0] +
            wne + _sh(wne[None], -1, 1)[0])
    return StencilOperator(we, ws, wse, wne, diag)


def _sh(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Shift the (B, H, W) block by (dr, dc) on the trailing grid dims
    with zero fill: out[..., i, j] = x[..., i - dr, j - dc]."""
    H, W = x.shape[-2], x.shape[-1]
    core = x[..., max(-dr, 0):H - max(dr, 0), max(-dc, 0):W - max(dc, 0)]
    return F.pad(core, (max(dc, 0), max(-dc, 0), max(dr, 0), max(-dr, 0)))


def stencil_matvec(A: StencilOperator, x: torch.Tensor) -> torch.Tensor:
    """y = L @ x for x of shape (B, H, W): diag*x minus neighbor flows,
    in plain torch ops at x's dtype.  Each directed plane contributes
    twice (edge seen from both ends).

    This is the plain version of the kernels in solve/cuda_stencil.py,
    and the float64 operator of the refinement residuals (which the JAX
    package also computes outside any Pallas kernel)."""
    we, ws, wse, wne, diag = A.planes
    wE = we[None]
    wS = ws[None]
    wSE = wse[None]
    wNE = wne[None]
    y = diag[None] * x
    # East edge (i,j)-(i,j+1): y[i,j] -= we[i,j]*x[i,j+1]; and transpose
    y = y - wE * _sh(x, 0, -1) - _sh(wE * x, 0, 1)
    # South edge (i,j)-(i+1,j)
    y = y - wS * _sh(x, -1, 0) - _sh(wS * x, 1, 0)
    # SE edge (i,j)-(i+1,j+1)
    y = y - wSE * _sh(x, -1, -1) - _sh(wSE * x, 1, 1)
    # NE edge (i,j)-(i-1,j+1)
    y = y - wNE * _sh(x, 1, -1) - _sh(wNE * x, -1, 1)
    return y


def _branch_dirs(A: StencilOperator, dtype):
    """The eight directed branches at each cell of A: (dr, dc, weight
    plane (1, H, W) in dtype) for the neighbour at offset (dr, dc)."""
    dirs = [(0, 1, A.we),                           # E
            (0, -1, _sh(A.we[None], 0, 1)[0]),      # W
            (1, 0, A.ws),                           # S
            (-1, 0, _sh(A.ws[None], 1, 0)[0]),      # N
            (1, 1, A.wse),                          # SE
            (-1, -1, _sh(A.wse[None], 1, 1)[0]),    # NW
            (-1, 1, A.wne),                         # NE
            (1, -1, _sh(A.wne[None], -1, 1)[0])]    # SW
    return [(dr, dc, w.to(dtype)[None]) for dr, dc, w in dirs]


def _max_branch(dirs, V: torch.Tensor, rows=slice(None)) -> torch.Tensor:
    """Per column, max |signed branch current| over the cells of `rows`."""
    maxb = torch.zeros(V.shape[0], dtype=V.dtype, device=V.device)
    for dr, dc, w in dirs:
        f = w * (_sh(V, -dr, -dc) - V)
        maxb = torch.maximum(maxb, torch.amax(torch.abs(f[..., rows, :]),
                                              dim=(-2, -1)))
    return maxb


def _split_flows(dirs, V: torch.Tensor, thr: torch.Tensor):
    """(inflow, outflow) of every cell: its branch currents under thr
    dropped, the rest split by sign and summed.  The flow planes are
    recomputed rather than kept from the threshold pass (fewer live
    blocks)."""
    inflow = torch.zeros_like(V)
    outflow = torch.zeros_like(V)
    for dr, dc, w in dirs:
        f = w * (_sh(V, -dr, -dc) - V)
        f = torch.where(torch.abs(f) < thr, 0.0, f)
        inflow = inflow + torch.clamp_min(f, 0.0)
        outflow = outflow + torch.clamp_min(-f, 0.0)
    return inflow, outflow


def stencil_node_currents(A: StencilOperator, V: torch.Tensor,
                          cutoff=1e-8, proj=None, out_dtype=None,
                          fg=None) -> torch.Tensor:
    """Node current maps from voltage blocks (B, H, W), on V's device.

    Counterpart of circuitscape_tpu/solve/stencil.py
    stencil_node_currents: the reference's node current = max(inflow,
    outflow) with positive/negative branch splitting and the 1e-8*max
    branch cutoff (src/out.jl:178-290), as shifted-plane arithmetic.
    The cutoff max is taken per column over the whole grid (on a mesh,
    over every shard before any shard thresholds).  out_dtype=float32
    casts V first, as the maps-on path does.  fg: an (H, W) field of
    finite-ground conductances, whose diagonal currents add
    relu(-fg v) to the inflow and relu(fg v) to the outflow
    (src/out.jl:193-206).  With a projector, a merged node's current is
    its total in/outflow, broadcast to its cells (poly_sum)."""
    if out_dtype is not None and V.dtype != out_dtype:
        V = V.to(out_dtype)
    inflow, outflow = A.node_flows(V, cutoff)
    if fg is not None:
        fgv = fg[None] * V
        inflow = inflow + torch.clamp_min(-fgv, 0.0)
        outflow = outflow + torch.clamp_min(fgv, 0.0)
    if proj is not None:
        # internal polygon edges carry no flow (equal voltages), so the
        # sum of the member cells' flows is the merged node's
        inflow = poly_sum(proj, inflow)
        outflow = poly_sum(proj, outflow)
    return torch.maximum(inflow, outflow)


def _apply_op(A: StencilOperator, x: torch.Tensor, pen=None, proj=None):
    """L x, plus pen * x with a per-column diagonal penalty field
    (B, H, W) (the batched grounds of the advanced and one-to-all
    solves), projected when a polygon projector is given (x lies in
    range(Pi), so projecting the output keeps the iteration on the
    collapsed system).  A float32 block goes through the matvec kernel,
    a float64 one (the refinement residuals) through stencil_matvec
    (StencilOperator.matvec)."""
    y = A.matvec(x)
    if pen is not None:
        y = y + pen * x
    return y if proj is None else A.project(proj, y)


def _make_prec_apply(A, prec, prec_apply, pen=None, proj=None):
    """Preconditioner application shared by the CG init and loop (they
    must apply the IDENTICAL operator for CG to be valid); Jacobi when
    no hierarchy is given.

    With a penalty field it is the SPD combination P M0^-1 P + D_pen:
    the base preconditioner on the non-penalized cells and exact
    diagonal inversion on the penalized ones (complementary subspaces).
    Under a projector it is Pi M Pi, SPD on range(Pi) (inputs already
    lie there, so only the output is projected)."""
    if pen is not None:
        full_diag = A.diag[None] + pen
        inv_pen = torch.where(full_diag > 0,
                              1.0 / torch.where(full_diag == 0, 1.0,
                                                full_diag), 1.0)
    if prec_apply is None:
        inv_diag = torch.where(A.diag > 0,
                               1.0 / torch.where(A.diag == 0, 1.0, A.diag),
                               1.0)

        def base(r):
            return (inv_diag[None] if pen is None else inv_pen) * r
    elif pen is None:
        def base(r):
            return prec_apply(prec, r)
    else:
        def base(r):
            z = prec_apply(prec, torch.where(pen > 0, 0.0, r))
            return torch.where(pen > 0, r * inv_pen, z)
    if proj is None:
        return base
    return lambda r: A.project(proj, base(r))


def _colsum(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a, dim=(-2, -1))


# the numpy float type of the loop's host-side scalars, by B's dtype
_FTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class CGState(NamedTuple):
    """The JAX loop carry: device blocks and per-column sums, plus the
    host-side iteration count, stall detector and best residual (a numpy
    scalar of B's float type, as JAX carries it)."""

    X: torch.Tensor
    R: torch.Tensor
    Z: torch.Tensor
    P: torch.Tensor
    rz: torch.Tensor
    k: int
    best: np.floating
    since: int
    rn2: torch.Tensor


def _cg_bounded(worst: np.floating, best: np.floating) -> bool:
    """The CG loop's divergence guard, worst <= best * 8, computed in
    best's float type as the JAX loop computes it: in float32 the first
    best (finfo.max) times 8 overflows to inf, so a first worst of inf
    does not stop the loop."""
    with np.errstate(over="ignore"):
        return bool(worst <= best * type(best)(8))


def _cg_improved(worst: np.floating, best: np.floating) -> bool:
    """The stall detector's test, worst < best * 0.999, computed in best's
    float type as the JAX loop computes it (0.999 and the product both
    round to float32)."""
    return bool(worst < best * type(best)(0.999))


def _cg_state_init(A: StencilOperator, B: torch.Tensor, prec=None,
                   prec_apply=None, pen=None, proj=None) -> CGState:
    Z = _make_prec_apply(A, prec, prec_apply, pen, proj)(B)
    R = B
    # rn2 (per-column ||R||^2) rides the state so neither the loop
    # condition nor the stall detector recomputes the reduction
    return CGState(torch.zeros_like(B), R, Z, Z, _colsum(R * Z), 0,
                   np.finfo(_FTYPE[B.dtype]).max, 0, _colsum(R * R))


def _cg_stop(rn2, safe_bnorm, tol, out=None) -> torch.Tensor:
    """The loop's stop quantities [worst relative residual, any column
    above its target], stacked in worst's dtype (into out if given) so
    the host fetches both in one sync."""
    resnorm = torch.sqrt(rn2)
    worst = torch.max(resnorm / safe_bnorm)
    active = torch.any(resnorm > tol)
    return torch.stack([worst, active.to(worst.dtype)], out=out)


def _cg_iterate(step, fetch, k: int, best: np.floating, since: int,
                k_stop: int, itmax: int):
    """The host's side of the CG loop, shared by its two routes:
    step(replace) runs iteration k on the device (replace: the periodic
    true-residual replacement), fetch() returns the stop quantities of
    the last iteration as [worst, active] (one sync).  Runs until
    convergence, stall, divergence, itmax or k_stop, deciding in best's
    float type as the JAX loop does (_cg_bounded, _cg_improved).
    Returns (k, best, since)."""
    ftype = type(best)

    def stop_quantities():
        worst_h, active_h = fetch()
        return ftype(worst_h), active_h > 0

    worst, active = stop_quantities()
    while (k < itmax and k < k_stop and since < 50 and
           _cg_bounded(worst, best) and active):
        # periodic residual replacement: recompute the true residual so
        # the f32 recurrence cannot drift away from it (van der Vorst);
        # costs 1 extra matvec every 64 iterations
        step((k + 1) % 64 == 0)
        k += 1
        worst, active = stop_quantities()
        improved = _cg_improved(worst, best)
        best = np.minimum(best, worst)
        since = 0 if improved else since + 1
    return k, best, since


# the attribute of an operator that holds the graphs its loops keep
GRAPH_SLOT = "_cg_graphs"


def _graph_route(B) -> bool:
    """Whether _cg_loop takes the graph route: B a plain tensor on a CUDA
    device (one card's block).  CPU tensors and a mesh's MeshBlocks take
    the eager loop."""
    return isinstance(B, torch.Tensor) and B.device.type == "cuda"


def _cg_loop(A: StencilOperator, B: torch.Tensor, state, tol,
             safe_bnorm, k_stop: int, itmax: int, prec=None,
             prec_apply=None, pen=None, proj=None, *,
             _eager: bool = False) -> CGState:
    """Preconditioned CG until convergence, stall, itmax, or k_stop (the
    per-call step budget of the chunked driver), from state (a CGState;
    None: _cg_state_init's).

    Every iteration computes its stop quantities on the device and
    fetches them in one host sync.  `since` detects a stall at the f32
    rounding floor; the `worst <= best * 8` guard detects divergence
    past it (once the recurrence hits the floor, beta turns into
    amplified noise).  Both exits leave the outer f64 refinement to
    re-residualize.  Both guards compare in B's float type, as the JAX
    loop does (_cg_iterate).  The matvec + p.Ap of the
    body is one kernel (cuda_stencil.matvec_pap), as is the
    true-residual replacement every 64 iterations (cuda_stencil.matvec).
    Under a penalty field or a projector the body is the composite
    Pi (L + pen) p (the matvec kernel, the penalty term, poly_project)
    and a column dot, as in the JAX loop.  (On a mesh, matvec_pap is
    the sharded matvec and the shard-ordered column sums, as the JAX
    package's mesh loop is.)  On a plain float32 block with neither, the
    rest of the body is the fused glue (_fused_step: cg_update_xr,
    cg_dots, cg_update_p), written in place into the loop's own copies;
    each iteration counts in stats fused_iters.

    A block on one card (_graph_route) takes the graph route: the same
    operations in place on the route's buffers (_cg_step_), each body
    captured once as a CUDA graph and replayed (solve/cg_graph.py); the
    returned state's blocks are then those buffers, which the next loop
    on the same operator writes over, and its Z is None.  CPU blocks, a
    mesh's MeshBlocks and _eager (the tests' comparison) take the eager
    loop below."""
    apply_M = _make_prec_apply(A, prec, prec_apply, pen, proj)
    if not _eager and _graph_route(B):
        from .cg_graph import graphs_for
        return _cg_loop_static(
            A, B, state, tol, safe_bnorm, k_stop, itmax, apply_M,
            graphs_for(A, B, tol, safe_bnorm, prec, prec_apply, pen, proj),
            pen, proj)
    if state is None:
        state = _cg_state_init(A, B, prec, prec_apply, pen, proj)
    X, R, Z, P, rz, k, best, since, rn2 = state
    if _fused_body(B, safe_bnorm, pen, proj):
        # the fused wrappers write in place: the loop's own copies (R and
        # P of _cg_state_init's state are B and Z themselves)
        X, R, P, rz, rn2 = (t.clone() for t in (X, R, P, rz, rn2))
        stop = _cg_stop(rn2, safe_bnorm, tol)
        k0 = k

        def fused_step(replace):
            nonlocal Z
            Z = _fused_step(A, B, X, R, P, rz, rn2, safe_bnorm, tol, stop,
                            replace, apply_M)

        k, best, since = _cg_iterate(fused_step, stop.tolist, k, best,
                                     since, k_stop, itmax)
        stats.record(fused_iters=k - k0)
        return CGState(X, R, Z, P, rz, k, best, since, rn2)

    def step(replace):
        nonlocal X, R, Z, P, rz, rn2
        if pen is None and proj is None:
            AP, pAp = A.matvec_pap(P)
        else:
            AP = _apply_op(A, P, pen, proj)
            pAp = _colsum(P * AP)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, 1.0, pAp),
                            0.0)
        X = X + alpha[:, None, None] * P
        if replace:
            R = B - _apply_op(A, X, pen, proj)
        else:
            R = R - alpha[:, None, None] * AP
        Z = apply_M(R)
        rz_new = _colsum(R * Z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, 1.0, rz),
                           0.0)
        P = Z + beta[:, None, None] * P
        rz = rz_new
        rn2 = _colsum(R * R)

    k, best, since = _cg_iterate(
        step, lambda: _cg_stop(rn2, safe_bnorm, tol).tolist(), k, best,
        since, k_stop, itmax)
    stats.record(fused_iters=0)
    return CGState(X, R, Z, P, rz, k, best, since, rn2)


def _fused_body(B, safe_bnorm, pen=None, proj=None) -> bool:
    """Whether the CG body runs through the fused glue wrappers
    (_fused_step): a plain float32 block, one card's (their kernels) or a
    CPU tensor (their plain versions), with float32 column norms and
    neither a penalty field nor a projector.  A mesh's MeshBlocks, float64
    blocks and the penalty and projector bodies keep the composite
    body."""
    return (pen is None and proj is None and isinstance(B, torch.Tensor) and
            B.dtype == torch.float32 and safe_bnorm.dtype == torch.float32)


def _fused_step(A, B, X, R, P, rz, rn2, safe_bnorm, tol, stop, replace,
                apply_M):
    """One iteration of the plain body (no penalty field, no projector)
    through the fused glue wrappers, in place on X, R, P, rz, rn2 and stop
    (_cg_stop's quantities): matvec_pap, cg_update_xr (the residual
    replacement's R = B - A X by the matvec kernel), the preconditioner,
    cg_dots and cg_update_p.  The same operations as the composite body,
    each product and sum rounded as it rounds them; only the column sums
    add in another order on the card.  Returns Z."""
    from .cuda_stencil import cg_dots, cg_update_p, cg_update_xr
    AP, pAp = A.matvec_pap(P)
    cg_update_xr(X, R, P, AP, rz, pAp, replace)
    del AP
    if replace:
        torch.sub(B, A.matvec(X), out=R)
    Z = apply_M(R)
    cg_update_p(P, Z, cg_dots(R, Z, rz, rn2, safe_bnorm, tol, stop))
    return Z


class _CGBuffers:
    """The graph route's loop state, in storage that every iteration
    writes in place (a replayed graph reads and writes the addresses it
    was captured on): the right-hand side, targets (in float64) and
    column norms the loop reads (B, tol, safe), the iterate, residual
    and search direction (X, R, P), their column sums rz = R.Z and
    rn2 = R.R, and the last iteration's stop quantities (stop,
    _cg_stop).  Z, the preconditioned
    residual, is not carried from one iteration to the next, so it has
    no buffer: an iteration's Z lives in the graph's own memory.  B is
    the right-hand side the buffers were made for: a later loop's is
    copied into it, unless the caller wrote it there."""

    def __init__(self, B: torch.Tensor, tol, safe_bnorm: torch.Tensor):
        tol = torch.as_tensor(tol, device=B.device)
        self.B = B      # the first loop's right-hand side, not a copy
        self.X, self.R, self.P = (torch.empty_like(B) for _ in range(3))
        # in float64: a float32 norm against a float32 target compares
        # as against its float64 value, and cg_dots takes float64 targets
        self.tol = torch.empty_like(tol, dtype=torch.float64)
        self.safe = torch.empty_like(safe_bnorm)
        self.rz = B.new_empty(B.shape[0])
        self.rn2 = B.new_empty(B.shape[0])
        self.stop = B.new_empty(2, dtype=torch.promote_types(
            B.dtype, safe_bnorm.dtype))

    def load(self, B, tol, safe_bnorm, state, apply_M) -> None:
        """Copy a loop's inputs and its state into the buffers, each
        unless it is that buffer already, and set stop.  The state is a
        CGState, or with state None _cg_state_init's (X = 0, R = B,
        P = Z = M^-1 B, rz, rn2)."""
        pairs = [(self.B, B), (self.tol, torch.as_tensor(tol)),
                 (self.safe, safe_bnorm)]
        if state is None:
            self.X.zero_()
            Z = apply_M(B)
            pairs += [(self.R, B), (self.P, Z)]
        else:
            pairs += [(self.X, state.X), (self.R, state.R),
                      (self.P, state.P), (self.rz, state.rz),
                      (self.rn2, state.rn2)]
        for buf, t in pairs:
            if t is not buf:
                buf.copy_(t)
        if state is None:
            torch.sum(self.R * Z, dim=(-2, -1), out=self.rz)
            torch.sum(self.R * self.R, dim=(-2, -1), out=self.rn2)
        _cg_stop(self.rn2, self.safe, self.tol, out=self.stop)


def _cg_step_(A: StencilOperator, s: _CGBuffers, replace: bool, apply_M,
              pen=None, proj=None) -> None:
    """One iteration of _cg_loop's body on s, in place: the same
    operations in the same order, with X, R, P, rz and rn2 written into
    their buffers (the same bits as the eager loop) and the stop
    quantities into s.stop.  replace: the true-residual replacement
    R = B - A X.  Without a penalty field or a projector on a float32
    block, the fused glue (_fused_step)."""
    if _fused_body(s.B, s.safe, pen, proj):
        _fused_step(A, s.B, s.X, s.R, s.P, s.rz, s.rn2, s.safe, s.tol,
                    s.stop, replace, apply_M)
        return
    if pen is None and proj is None:
        AP, pAp = A.matvec_pap(s.P)
    else:
        AP = _apply_op(A, s.P, pen, proj)
        pAp = _colsum(s.P * AP)
    alpha = torch.where(pAp > 0, s.rz / torch.where(pAp == 0, 1.0, pAp),
                        0.0)
    s.X.add_(alpha[:, None, None] * s.P)
    if replace:
        torch.sub(s.B, _apply_op(A, s.X, pen, proj), out=s.R)
    else:
        s.R.sub_(alpha[:, None, None] * AP)
    del AP
    Z = apply_M(s.R)
    rz_new = _colsum(s.R * Z)
    beta = torch.where(s.rz > 0,
                       rz_new / torch.where(s.rz == 0, 1.0, s.rz), 0.0)
    torch.add(Z, beta[:, None, None] * s.P, out=s.P)
    s.rz.copy_(rz_new)
    torch.sum(s.R * s.R, dim=(-2, -1), out=s.rn2)
    _cg_stop(s.rn2, s.safe, s.tol, out=s.stop)


@contextlib.contextmanager
def _graph_scope(A):
    """The graph route's graphs kept on A (cg_graph.graphs_for) last
    until the end of this block, one solve: its refinement passes share
    them, and they go, with their buffers and memory pool, when it
    returns."""
    try:
        yield
    finally:
        A.__dict__.pop(GRAPH_SLOT, None)


def _cg_loop_static(A, B, state, tol, safe_bnorm, k_stop: int, itmax: int,
                    apply_M, graphs, pen=None, proj=None) -> CGState:
    """_cg_loop's graph route: the loop's state in graphs.bufs (a
    _CGBuffers), each iteration graphs.run on _cg_step_ (a replayed
    graph once captured, solve/cg_graph.py), the host's decisions those
    of the eager loop (_cg_iterate).  Records the iterations replayed
    and the graphs captured (stats graph_replays, graph_captures), and
    the iterations whose body ran the fused glue (stats fused_iters).
    The returned state has no Z (_CGBuffers)."""
    s = graphs.bufs
    s.load(B, tol, safe_bnorm, state, apply_M)
    k, best, since = ((0, np.finfo(_FTYPE[B.dtype]).max, 0) if state is None
                      else (state.k, state.best, state.since))
    k0 = k
    replays, captures = graphs.replays, graphs.captures

    def step(replace):
        graphs.run(replace,
                   lambda: _cg_step_(A, s, replace, apply_M, pen, proj))

    k, best, since = _cg_iterate(step, s.stop.tolist, k, best, since,
                                 k_stop, itmax)
    fused = _fused_body(B, safe_bnorm, pen, proj)
    stats.record(graph_replays=graphs.replays - replays,
                 graph_captures=graphs.captures - captures,
                 fused_iters=k - k0 if fused else 0)
    return CGState(s.X, s.R, None, s.P, s.rz, k, best, since, s.rn2)


def _true_relres(A, B, X, safe_bnorm, proj=None):
    """The bare operator's relative residual, without any penalty field,
    as the JAX package computes it."""
    R = B - _apply_op(A, X, None, proj)
    return torch.sqrt(_colsum(R * R)) / safe_bnorm


def _cg_tol(rtol, bnorm: torch.Tensor) -> torch.Tensor:
    """Absolute CG targets max(rtol, 32 eps) * bnorm, in the dtype JAX
    (under x64) gives jnp.maximum(rtol, eps_floor) * bnorm: a Python
    float is weakly typed and takes bnorm's dtype; a numpy scalar or
    array promotes with it (np.float64 or a float64 array: float64).
    The loop's `resnorm > tol` then compares in float64, as JAX's does."""
    ftype = _FTYPE[bnorm.dtype]
    dt = (np.dtype(ftype) if type(rtol) in (float, int) else
          np.promote_types(np.asarray(rtol).dtype, ftype))
    rt = np.maximum(np.asarray(rtol, dt), dt.type(32 * np.finfo(ftype).eps))
    rt = torch.as_tensor(rt, device=bnorm.device)
    return rt * bnorm.to(rt.dtype)


def stencil_cg(A: StencilOperator, B: torch.Tensor, rtol=1e-6,
               itmax=100_000, chunk=512, prec=None, prec_apply=None,
               pen=None, proj=None):
    """Chunked preconditioned-CG driver: the loop runs in bursts of
    `chunk` iterations with a progress check between bursts; a burst
    that makes no progress (stall at the f32 floor or the divergence
    guard) ends the solve, and the caller's outer refinement takes over
    from the true residual.

    B: (nrhs, H, W) right-hand sides; rtol a float or a per-column
    array.  A penalty field's iterations count in stats pen_iters.
    Returns (X, relres (nrhs,), iters)."""
    bnorm = torch.sqrt(_colsum(B * B))
    safe_bnorm = torch.where(bnorm == 0, 1.0, bnorm)
    tol = _cg_tol(rtol, bnorm)

    state, k_prev = None, -1
    while True:
        state = _cg_loop(A, B, state, tol, safe_bnorm,
                         (0 if state is None else state.k) + chunk, itmax,
                         prec, prec_apply, pen, proj)
        k = state.k
        resnorm = torch.sqrt(state.rn2)
        if (k >= itmax or k == k_prev or
                not bool(torch.any(resnorm > tol))):
            break
        k_prev = k
    if pen is not None:
        stats.record(pen_iters=state.k)
    relres = _true_relres(A, B, state.X, safe_bnorm, proj)
    return state.X, relres, state.k


def _pairs_rhs(src_cells: torch.Tensor, dst_cells: torch.Tensor, H: int,
               W: int, b_pad: int) -> torch.Tensor:
    """The +-1 pair RHS block, float64, scattered on the device from
    (b_pad, 2) index tensors."""
    rhs = torch.zeros((b_pad, H, W), dtype=torch.float64,
                      device=src_cells.device)
    cols = torch.arange(src_cells.shape[0], device=src_cells.device)
    one = torch.ones(cols.shape, dtype=torch.float64, device=rhs.device)
    rhs.index_put_((cols, src_cells[:, 0], src_cells[:, 1]), -one,
                   accumulate=True)
    rhs.index_put_((cols, dst_cells[:, 0], dst_cells[:, 1]), one,
                   accumulate=True)
    return rhs


def _extract_point_voltages(X, src_cells, point_cells):
    """Per-column normalized voltages at the focal cells.

    Returns (vsrc-normalized values at point_cells (nb, npts),
    values at src (nb,))."""
    cols = torch.arange(X.shape[0], device=X.device)
    vsrc = X[cols, src_cells[:, 0], src_cells[:, 1]]
    Vp = X[:, point_cells[:, 0], point_cells[:, 1]] - vsrc[:, None]
    return Vp, vsrc


# Per-pass relative tolerance of the f32 inner solves.  The f32 MG-CG
# recurrence has a rounding floor near 4e-6 relative at the 1M-cell
# scale, and pushing into the floor is hazardous: past it, beta becomes
# amplified noise and the iterate can diverge.  Iterative refinement
# removes the hazard: each inner pass stops ~25x above the floor and the
# f64 outer recurrence closes the remaining gap.
INNER_RTOL = 1e-4
MAX_PASSES = 6


def _solve_pairs_fused(S64, A_lo, prec, prec_apply, sc, dc, point_cells,
                       rtol, itmax, proj=None):
    """The mixed-precision pair solve: RHS scatter, iterative refinement
    (f32 MG-CG inner passes at INNER_RTOL, f64 true-residual outer loop,
    additional passes only while a column is above rtol), final f64
    residuals.  On a mesh the RHS block is laid out as S64 (columns over
    'batch', rows over 'nodes') and X comes back as that MeshBlock.

    Returns (X (f64, (b_pad, H, W)), rel (b_pad,), iters)."""
    b_pad = sc.shape[0]
    H, W = S64.shape
    B64 = _pairs_rhs(sc, dc, H, W, b_pad)
    if proj is not None:
        # collapsed-system RHS: Pi b spreads the unit injection over the
        # focal node's polygon
        B64 = poly_project(proj, B64)
    B64 = S64.layout(B64)
    # padded columns (src == dst) scatter to net-zero RHS already
    bnorm = torch.sqrt(_colsum(B64 * B64))
    safe_bnorm = torch.where(bnorm == 0, 1.0, bnorm)
    tol64 = rtol * bnorm                       # absolute target, f64
    safe32 = safe_bnorm.to(torch.float32)

    # bound each inner loop so one pass can't run unboundedly long on a
    # pathological problem (the chunked driver handles the rest)
    kcap = min(itmax, 2000)

    X = torch.zeros_like(B64)
    R = B64
    rel = torch.where(bnorm > 0, math.inf, 0.0)
    iters = npass = 0
    R32 = None
    while npass < MAX_PASSES and bool(torch.any(rel > rtol)):
        with CSTIMER.span("refinement pass"):
            # on one card every pass writes its right-hand side into the
            # first pass's block, the graph route's buffer B
            R32 = (R32.copy_(R) if R32 is not None and _graph_route(R32)
                   else R.to(torch.float32))
            tol32 = torch.maximum(
                tol64, INNER_RTOL * torch.sqrt(_colsum(R32 * R32))
            ).to(torch.float32)
            st = _cg_loop(A_lo, R32, None, tol32, safe32, kcap, kcap, prec,
                          prec_apply, None, proj)
            X = X + st.X.to(torch.float64)
            R = B64 - _apply_op(S64, X, None, proj)
            rel = torch.sqrt(_colsum(R * R)) / safe_bnorm
            iters += st.k
            npass += 1
            stats.record_pass(st.k)
    return X, rel, iters


def stencil_solve_pairs(S64: StencilOperator, src_cells: np.ndarray,
                        dst_cells: np.ndarray, rtol=1e-6, itmax=100_000,
                        prec=None, prec_apply=None, max_refine=4,
                        proj=None):
    """Device-resident mixed-precision pair solve; proj collapses
    polygons (shared, or one merge pattern per pair).

    Returns (X (f64 device tensor, (b_pad, H, W)), rel (np, nb), iters).
    """
    nb = src_cells.shape[0]
    X, _, rel, iters = _fused_pair_solve(
        S64, src_cells, dst_cells, np.zeros((1, 2), np.int64),
        rtol, itmax, prec, prec_apply, max_refine, proj)
    return X, rel[:nb], iters


def _fused_pair_solve(S64, src_cells, dst_cells, point_cells, rtol, itmax,
                      prec, prec_apply, max_refine, proj=None):
    """Fused solve with a chunked-driver fallback for the (rare) case
    the refinement passes don't reach rtol.  A per-column projector is
    padded with all-trash rows to the padded batch, and on a mesh the
    batch to a multiple of its 'batch' axis (zero columns: rel = 0);
    X comes back whole on the mesh's first device."""
    H, W = S64.shape
    dev = S64.diag.device
    nb = src_cells.shape[0]
    b_pad = 1 << max(0, nb - 1).bit_length()
    q = S64.col_groups
    b_pad = -(-b_pad // q) * q          # even shards over a mesh's 'batch'
    sc_np = np.zeros((b_pad, 2), np.int64)
    dc_np = np.zeros((b_pad, 2), np.int64)
    sc_np[:nb] = src_cells
    dc_np[:nb] = dst_cells
    if proj is not None:
        proj = _pad_projector_rows(proj, b_pad)
    # padded columns: src == dst == (0,0) -> the +-1 scatter cancels and
    # the RHS column is exactly zero (rel = 0, never gates convergence)
    sc = torch.as_tensor(sc_np, device=dev)
    dc = torch.as_tensor(dc_np, device=dev)
    pc = torch.as_tensor(np.asarray(point_cells, np.int64), device=dev)
    if prec is not None and getattr(prec, "levels", ()):
        A_lo = prec.levels[0].A   # the hierarchy's fine level IS f32 A
    else:
        A_lo = _to_dtype(S64, torch.float32)

    with _graph_scope(A_lo):
        X, rel_d, total_iters = _solve_pairs_fused(
            S64, A_lo, prec, prec_apply, sc, dc, pc, rtol, itmax, proj)
        rel = rel_d.cpu().numpy()

        if not np.all(rel[:nb] <= rtol) and max_refine > 2:
            B = _pairs_rhs(sc, dc, H, W, b_pad)
            if proj is not None:
                B = poly_project(proj, B)
            B = S64.layout(B)
            bnorm = torch.sqrt(_colsum(B * B))
            safe_bnorm = torch.where(bnorm == 0, 1.0, bnorm).cpu().numpy()
            R = B - _apply_op(S64, X, None, proj)
            for _ in range(max_refine - 2):
                inner = np.clip(rtol / np.where(rel == 0, 1.0, rel),
                                INNER_RTOL, 0.05)
                dX, _, it = stencil_cg(A_lo, R.to(torch.float32), inner,
                                       itmax=itmax, prec=prec,
                                       prec_apply=prec_apply, proj=proj)
                X = X + dX.to(torch.float64)
                R = B - _apply_op(S64, X, None, proj)
                rel = torch.sqrt(_colsum(R * R)).cpu().numpy() / safe_bnorm
                total_iters += int(it)
                if np.all(rel[:nb] <= rtol):
                    break
    X = S64.gather(X)
    Vp = _extract_point_voltages(X, sc, pc)[0].cpu().numpy()
    return X, Vp, rel, total_iters


def _scatter_field(cells, vals, H: int, W: int) -> torch.Tensor:
    """(B, K, 2) cells + (B, K) values -> (B, H, W) field, zero
    elsewhere.  Padding entries sit at (0, 0) with value 0, and a real
    entry may sit there too, so the scatter accumulates."""
    B = cells.shape[0]
    out = torch.zeros((B, H, W), dtype=vals.dtype, device=vals.device)
    cols = torch.arange(B, device=cells.device)[:, None].expand(
        cells.shape[:2])
    out.index_put_((cols, cells[..., 0], cells[..., 1]), vals,
                   accumulate=True)
    return out


def stencil_solve_advanced_batch(S64: StencilOperator, src_cells, src_vals,
                                 gnd_cells, gnd_vals, rtol=1e-6,
                                 itmax=100_000, prec=None, prec_apply=None,
                                 max_refine=4, proj=None,
                                 pen_in_prec=False, A_lo=None,
                                 rel_to=None):
    """Batched advanced-mode solve: (G + diag(g)) v = s per column.

    Each column has its own sources (cells + strengths) and grounds
    (cells + conductances); a direct ground is a penalty conductance
    (advanced_ground_penalty), whose cell then holds a voltage of
    O(1/penalty), as the reference's row/column deletion
    (src/raster/advanced.jl:282-304) holds 0.  Mixed precision as in
    the pair solve: float32 inner CG passes at INNER_RTOL or above, a
    float64 outer residual of S64 + pen.

    src_cells/gnd_cells: (B, K, 2) int arrays (pad with (0, 0) and value
    0); src_vals/gnd_vals: (B, K) float64.

    pen_in_prec: the hierarchy has the ground field baked into every
    level (prepare_stencil_solver_from_gmap_pen), so its fine level is
    the f32 (G + diag(g)) and the inner CG runs it with pen=None (its
    body the fused matvec_pap).  A_lo: an explicit f32 inner operator:
    one-to-all bakes the shared penalty (every focal cell) into the
    hierarchy, but each column's operator is the bare Laplacian plus its
    own penalty field.  rel_to: a function of the float64 iterate (the
    operator's layout) giving the norm (np, B) each column's residual is
    relative to, in place of its right-hand side's, for the passes'
    stop and the returned rel: one-to-all's harmonic columns give the
    current each draws, so that rel is the unit-current answer's.

    On a mesh the batch pads to a multiple of its 'batch' axis (zero
    columns: rel = 0), and X comes back whole on its first device.

    Span log (CSTIMER.span): "penalty fields" around the scatter and
    layout of the source and ground fields, and one "refinement pass"
    per float64 pass, as _solve_pairs_fused logs its passes.

    Returns (X (f64, (B, H, W)), rel (np, B), iters)."""
    H, W = S64.shape
    dev = S64.diag.device
    nb_in = np.asarray(src_cells).shape[0]
    b_pad = -(-nb_in // S64.col_groups) * S64.col_groups
    if b_pad > nb_in:
        def padb(a):
            a = np.asarray(a)
            return np.concatenate(
                [a, np.zeros((b_pad - nb_in,) + a.shape[1:], a.dtype)])
        src_cells, src_vals = padb(src_cells), padb(src_vals)
        gnd_cells, gnd_vals = padb(gnd_cells), padb(gnd_vals)

    def field(cells, vals):
        return _scatter_field(torch.as_tensor(np.asarray(cells, np.int64),
                                              device=dev),
                              torch.as_tensor(np.asarray(vals, np.float64),
                                              device=dev), H, W)
    with CSTIMER.span("penalty fields"):
        B_rhs = field(src_cells, src_vals)
        pen64 = field(gnd_cells, gnd_vals)
        if proj is not None:
            # collapsed-system RHS (per-cell values already sum to each
            # merged node's total; Pi is applied for arbitrary callers)
            B_rhs = poly_project(proj, B_rhs)
        B_rhs, pen64 = S64.layout(B_rhs), S64.layout(pen64)
        # the inner passes' field, unless the hierarchy carries it
        pen32 = None if pen_in_prec else pen64.to(torch.float32)

    if A_lo is None:
        if prec is not None and getattr(prec, "levels", ()):
            A_lo = prec.levels[0].A   # the hierarchy's f32 fine level
        else:
            A_lo = _to_dtype(S64, torch.float32)
    bnorm = torch.sqrt(_colsum(B_rhs * B_rhs))
    safe_bnorm = torch.where(bnorm == 0, 1.0, bnorm).cpu().numpy()

    X = torch.zeros_like(B_rhs)
    R = B_rhs
    R32 = None
    total_iters = 0
    rel = np.full(B_rhs.shape[0], np.inf)
    with _graph_scope(A_lo):
        for pass_i in range(max_refine):
            with CSTIMER.span("refinement pass"):
                # floor-safe inner tolerances: never ask an f32 pass for
                # more than INNER_RTOL relative
                inner = max(rtol, INNER_RTOL) if pass_i == 0 else np.clip(
                    rtol / np.where(rel == 0, 1.0, rel), INNER_RTOL, 0.05)
                # on one card every pass writes its right-hand side into
                # the first pass's block, the buffer B of the graphs the
                # passes share where no penalty field is passed
                R32 = (R32.copy_(R) if R32 is not None and _graph_route(R32)
                       else R.to(torch.float32))
                dX, _, it = stencil_cg(A_lo, R32, inner, itmax=itmax,
                                       prec=prec, prec_apply=prec_apply,
                                       pen=pen32, proj=proj)
                X = X + dX.to(torch.float64)
                R = B_rhs - _apply_op(S64, X, pen64, proj)
                rn = torch.sqrt(_colsum(R * R)).cpu().numpy()
                if rel_to is None:
                    rel = rn / safe_bnorm
                else:
                    ref = rel_to(X)
                    rel = np.where(ref > 0, rn / np.where(ref > 0, ref, 1.0),
                                   np.inf)
                total_iters += int(it)
            if np.all(rel <= rtol):
                break
    return S64.gather(X), rel[:nb_in], total_iters


# a cell's eight edges: (row offset, column offset) of the far end, and
# the plane that weighs the edge with its offset from the cell
_EDGES = ((0, 1, "we", 0, 0), (0, -1, "we", 0, -1),
          (1, 0, "ws", 0, 0), (-1, 0, "ws", -1, 0),
          (1, 1, "wse", 0, 0), (-1, -1, "wse", -1, -1),
          (-1, 1, "wne", 0, 0), (1, -1, "wne", 1, -1))


def stencil_edges_at(A: StencilOperator, cells: np.ndarray):
    """The edges of the cells `cells` ((N, 2) rows and columns): the cell
    at each edge's far end ((N, 8, 2), clamped into the grid) and the
    edge's weight ((N, 8) float64 host array, 0 where the grid has no
    such edge)."""
    H, W = A.shape
    cells = np.asarray(cells, np.int64).reshape(-1, 2)
    far = np.zeros((len(cells), len(_EDGES), 2), np.int64)
    weights = []
    for k, (dr, dc, plane, pr, pc) in enumerate(_EDGES):
        r, c = cells[:, 0] + dr, cells[:, 1] + dc
        inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        far[:, k, 0], far[:, k, 1] = np.clip(r, 0, H - 1), np.clip(c, 0,
                                                                   W - 1)
        at = torch.as_tensor(np.stack([np.clip(cells[:, 0] + pr, 0, H - 1),
                                       np.clip(cells[:, 1] + pc, 0, W - 1)]),
                             device=A.diag.device)
        w = getattr(A, plane)[at[0], at[1]].double().cpu().numpy()
        weights.append(np.where(inside, w, 0.0))
    return far, np.stack(weights, axis=1)


def advanced_ground_penalty(S64: StencilOperator) -> float:
    """Penalty conductance standing in for an infinite (direct) ground:
    large enough that the residual ground voltage is far below the 1e-6
    solve target, small enough to stay well-conditioned in f32 after
    Jacobi scaling."""
    return 1e8 * float(torch.max(S64.diag))
