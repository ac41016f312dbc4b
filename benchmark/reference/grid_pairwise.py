"""Plain reference for raster pairwise jobs: effective resistances between
focal points of a conductance grid, and the cumulative and max node
current maps over all pairs.

It follows Circuitscape's documented semantics, written here from them and
from nothing of the program under test:

- the habitat file is an ESRI ASCII grid of conductances, or of
  resistances (a cell's conductance is then 1 / r); NODATA cells and
  cells <= 0 are not in the graph;
- with 8 neighbours, two active cells that touch are joined by an edge of
  weight (g_a + g_b) / 2 (average conductance) or 2 / (r_a + r_b)
  (average resistance), divided by sqrt 2 across a diagonal;
- focal points come from a text list of "id x y" in map coordinates, each
  in the cell that contains it;
- the resistance between two points is the effective resistance of the
  graph between their cells: -1 across components, 0 on the diagonal; the
  matrix is written with the point ids as its first row and column;
- a pair's node current map is, per cell, max(inflow, outflow) of the
  branch currents of a unit current from one point to the other, where
  branch currents under 1e-8 of the largest are dropped; the cumulative
  map sums pairs, the max map takes their maximum.

The solve is plain torch: per component, its first point is grounded
(held at 0 V), and one column per other point solves L x = e_point by
conjugate gradients preconditioned with a V-cycle of unsmoothed 2x2
aggregation (Galerkin coarse grids, damped Jacobi, coarse corrections
scaled by ALPHA, a dense Cholesky on the coarsest grid), until every
column's relative residual in float64 is under RTOL.  With G the
grounded inverse, R_ij = G_ii + G_jj - G_ij - G_ji and the pair (i, j)'s
voltages are x_i - x_j.

`pairwise(..., control=True)` computes the same in TF32 arithmetic: the
edge weights and leaks rounded to a 10-bit mantissa first and each
cell's diagonal summed from them in float32, so that the operator stays
a Laplacian plus its leaks; each operator product and the coarse solve
then take their operands rounded the same way, with float32 sums and no
refinement.  It is the control, which a sound comparison has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import ndimage

RTOL = 1e-11            # float64 relative residual of every column
CONTROL_RTOL = 1e-6     # the control stops here or where it stalls
MAXITER = 3000
COARSEST_CELLS = 4096   # a dense Cholesky below this many cells
JACOBI_W = 0.6
SWEEPS = 2
ALPHA = 1.8             # coarse correction scale of unsmoothed aggregation
BRANCH_CUTOFF = 1e-8
MAP_COLUMNS = 32        # pair maps computed per block


# ---------------------------------------------------------------- files

def read_asc(path):
    """(values float64 (nrows, ncols), header {lower-case key: float})."""
    with open(path, "rb") as f:
        data = f.read()
    hdr = {}
    pos = 0
    while True:
        end = data.index(b"\n", pos)
        parts = data[pos:end].split()
        if len(parts) != 2 or not parts[0][:1].isalpha():
            break
        hdr[parts[0].decode().lower()] = float(parts[1])
        pos = end + 1
    nrows, ncols = int(hdr["nrows"]), int(hdr["ncols"])
    vals = np.fromstring(data[pos:].decode("ascii"), dtype=np.float64,
                         sep=" ")
    if vals.size != nrows * ncols:
        raise ValueError(f"{path}: {vals.size} values for a "
                         f"{nrows} x {ncols} grid")
    return vals.reshape(nrows, ncols), hdr


def conductance(path, resistances=False):
    """The habitat grid as conductances, 0 off the graph."""
    vals, hdr = read_asc(path)
    nodata = hdr.get("nodata_value")
    g = np.where(vals == nodata, 0.0, vals) if nodata is not None else vals
    g = np.where(g > 0, g, 0.0)
    if resistances:
        g = np.where(g > 0, 1.0 / np.where(g > 0, g, 1.0), 0.0)
    return g, hdr


def read_points(path, hdr):
    """[(id, row, col)] sorted by id, 0-based cells of an "id x y" list."""
    arr = np.loadtxt(path, dtype=np.float64, ndmin=2)
    cs = hdr["cellsize"]
    top = hdr["yllcorner"] + hdr["nrows"] * cs
    rows = np.floor((top - arr[:, 2]) / cs).astype(np.int64)
    cols = np.floor((arr[:, 1] - hdr["xllcorner"]) / cs).astype(np.int64)
    ids = arr[:, 0].astype(np.int64)
    order = np.argsort(ids, kind="stable")
    return [(int(ids[k]), int(rows[k]), int(cols[k])) for k in order]


def read_resistances(path):
    """A resistance matrix as written: ids in the first row and column."""
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


# ------------------------------------------------------------ operator

def tf32(x):
    """x rounded to TF32 (10-bit mantissa, nearest, ties away)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Level:
    """One grid of the hierarchy: the edge planes of a weighted graph on
    (H, W) cells (e: (i, j)-(i, j+1), s: (i, j)-(i+1, j), se: (i, j)-(i+1,
    j+1), sw: (i, j)-(i+1, j-1), zero where there is no edge) and each
    cell's conductance to ground (`leak`); the operator is the graph
    Laplacian plus diag(leak), restricted to the cells where `keep`.
    `rnd` rounds the planes and leaks before the diagonal is summed from
    them, and every operand of the operator's products."""

    def __init__(self, e, s, se, sw, leak, keep, rnd=None):
        self.rnd = rnd if rnd is not None else (lambda t: t)
        e, s, se, sw, leak = (self.rnd(p) for p in (e, s, se, sw, leak))
        self.e, self.s, self.se, self.sw = e, s, se, sw
        self.leak = leak
        self.keep = keep
        d = leak.clone()
        d[:, :-1] += e[:, :-1]
        d[:, 1:] += e[:, :-1]
        d[:-1, :] += s[:-1, :]
        d[1:, :] += s[:-1, :]
        d[:-1, :-1] += se[:-1, :-1]
        d[1:, 1:] += se[:-1, :-1]
        d[:-1, 1:] += sw[:-1, 1:]
        d[1:, :-1] += sw[:-1, 1:]
        self.d = torch.where(keep, d, 0.0)
        self.dinv = torch.where(self.d > 0, 1.0 / torch.where(
            self.d > 0, self.d, 1.0), 0.0)
        self.shape = tuple(d.shape)

    def edges(self):
        """(plane, source slices, destination slices) of each direction:
        plane[source] weighs the edge from each source cell to the cell
        at the same place in the destination slices."""
        H, W = self.shape
        for p, dr, dc in ((self.e, 0, 1), (self.s, 1, 0), (self.se, 1, 1),
                          (self.sw, 1, -1)):
            c0, c1 = max(0, -dc), W - max(0, dc)
            yield (p, (slice(0, H - dr), slice(c0, c1)),
                   (slice(dr, H), slice(c0 + dc, c1 + dc)))

    def matvec(self, x):
        """leak * x plus, along every edge, w (x_i - x_j) at i and its
        negative at j: rows sum to the leak in any precision."""
        r = self.rnd
        y = self.leak * r(x)
        at = (Ellipsis,)
        for p, src, dst in self.edges():
            f = p[src] * r(x[at + src] - x[at + dst])
            y[at + src] += f
            y[at + dst] -= f
        return y

    def coarsen(self):
        """The Galerkin grid of 2x2 aggregates (P piecewise constant)."""
        H, W = self.shape
        Hp, Wp = H + H % 2, W + W % 2

        def pad(p):
            out = torch.zeros((Hp, Wp), dtype=p.dtype, device=p.device)
            out[:H, :W] = p
            return out

        e, s, se, sw, leak = (pad(p) for p in (self.e, self.s, self.se,
                                               self.sw, self.leak))
        keep = pad(self.keep.to(e.dtype)) > 0

        def q(p, a, b):
            return p[a::2, b::2]

        ce = q(e, 0, 1) + q(e, 1, 1) + q(se, 0, 1)
        ce[:, :-1] += q(sw, 0, 0)[:, 1:]
        cs_ = q(s, 1, 0) + q(s, 1, 1) + q(se, 1, 0) + q(sw, 1, 1)
        cse = q(se, 1, 1).clone()
        csw = q(sw, 1, 0).clone()
        cleak = q(leak, 0, 0) + q(leak, 0, 1) + q(leak, 1, 0) + q(leak, 1, 1)
        ckeep = q(keep, 0, 0) | q(keep, 0, 1) | q(keep, 1, 0) | q(keep, 1, 1)
        return Level(ce, cs_, cse, csw, cleak, ckeep, self.rnd)

    def dense(self):
        """The operator as a dense (HW, HW) matrix, identity on cells
        outside `keep`."""
        H, W = self.shape
        n = H * W
        idx = torch.arange(n, device=self.d.device).reshape(H, W)
        A = torch.zeros((n, n), dtype=self.d.dtype, device=self.d.device)
        A[idx.ravel(), idx.ravel()] = torch.where(self.keep, self.d,
                                                  1.0).ravel()
        for w, a, b in ((self.e[:, :-1], idx[:, :-1], idx[:, 1:]),
                        (self.s[:-1, :], idx[:-1, :], idx[1:, :]),
                        (self.se[:-1, :-1], idx[:-1, :-1], idx[1:, 1:]),
                        (self.sw[:-1, 1:], idx[:-1, 1:], idx[1:, :-1])):
            A[a.ravel(), b.ravel()] -= w.ravel()
            A[b.ravel(), a.ravel()] -= w.ravel()
        return A


def _edge_planes(g, avg_res=False):
    """Edge planes of the 8-neighbour graph of the conductances g:
    average conductance, or with avg_res average resistance."""
    act = g > 0
    r = torch.where(act, 1.0 / torch.where(act, g, 1.0), 0.0)

    def weight(a, b, diagonal):
        w = 2.0 / (r[a] + r[b]) if avg_res else (g[a] + g[b]) / 2.0
        w = w / math.sqrt(2.0) if diagonal else w
        return torch.where(act[a] & act[b], w, 0.0)

    planes = [torch.zeros_like(g) for _ in range(4)]
    for p, dr, dc in zip(planes, (0, 1, 1, 1), (1, 0, 1, -1)):
        H, W = g.shape
        c0, c1 = max(0, -dc), W - max(0, dc)
        src = (slice(0, H - dr), slice(c0, c1))
        dst = (slice(dr, H), slice(c0 + dc, c1 + dc))
        p[src] = weight(src, dst, dr != 0 and dc != 0)
    return tuple(planes)


def _grounded_level(g, keep, anchors, rnd, avg_res):
    """The fine grid's operator on the cells `keep` (the components that
    hold points, less their anchors), with every edge to an anchor kept
    as a leak to ground."""
    e, s, se, sw = _edge_planes(g, avg_res)
    grounded = torch.zeros_like(keep)
    grounded[anchors[:, 0], anchors[:, 1]] = True
    leak = torch.zeros_like(g)
    for p, (dr, dc) in ((e, (0, 1)), (s, (1, 0)), (se, (1, 1)),
                        (sw, (1, -1))):
        # p[i, j] joins (i, j) and (i + dr, j + dc)
        H, W = p.shape
        r0, r1 = 0, H - dr
        c0, c1 = max(0, -dc), W - max(0, dc)
        src = (slice(r0, r1), slice(c0, c1))
        dst = (slice(r0 + dr, r1 + dr), slice(c0 + dc, c1 + dc))
        w = p[src]
        leak[src] += torch.where(grounded[dst], w, 0.0)
        leak[dst] += torch.where(grounded[src], w, 0.0)
        cut = ~(keep[src] & keep[dst])
        p[src] = torch.where(cut, 0.0, w)
    leak = torch.where(keep, leak, 0.0)
    return Level(e, s, se, sw, leak, keep, rnd)


class Hierarchy:
    def __init__(self, fine: Level):
        self.levels = [fine]
        while self.levels[-1].shape[0] * self.levels[-1].shape[1] \
                > COARSEST_CELLS:
            self.levels.append(self.levels[-1].coarsen())
        A = self.levels[-1].dense()
        if A.dtype == torch.float64:
            self.chol = torch.linalg.cholesky(A)
            self.coarse_inv = None
        else:
            self.chol = None
            self.coarse_inv = torch.linalg.inv(A.double()).to(A.dtype)

    def vcycle(self, r, k=0):
        L = self.levels[k]
        if k == len(self.levels) - 1:
            H, W = L.shape
            b = r.reshape(r.shape[0], H * W).T
            if self.chol is not None:
                x = torch.cholesky_solve(b, self.chol)
            else:
                x = L.rnd(self.coarse_inv) @ L.rnd(b)
            return (x.T.reshape(r.shape) * L.keep)
        w = JACOBI_W * L.dinv
        x = w * r
        for _ in range(SWEEPS - 1):
            x = x + w * (r - L.matvec(x))
        res = r - L.matvec(x)
        H, W = L.shape
        Hp, Wp = H + H % 2, W + W % 2
        rp = torch.zeros((r.shape[0], Hp, Wp), dtype=r.dtype,
                         device=r.device)
        rp[:, :H, :W] = res
        rc = (rp[:, 0::2, 0::2] + rp[:, 0::2, 1::2] + rp[:, 1::2, 0::2] +
              rp[:, 1::2, 1::2])
        xc = self.vcycle(rc, k + 1)
        up = xc.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        x = x + ALPHA * up[:, :H, :W] * L.keep
        for _ in range(SWEEPS):
            x = x + w * (r - L.matvec(x))
        return x


def pcg(hier: Hierarchy, b, rtol, maxiter=MAXITER):
    """Preconditioned CG on the columns of b (B, H, W); returns (x,
    relative residuals, iterations).  Stops when every column is under
    rtol, or, below float64, where the residual stops falling."""
    A = hier.levels[0]
    dot = (lambda u, v: (u * v).sum(dim=(1, 2)))
    bnorm = torch.sqrt(dot(b, b))
    bsafe = torch.where(bnorm > 0, bnorm, 1.0)
    x = torch.zeros_like(b)
    r = b.clone()
    z = hier.vcycle(r)
    p = z.clone()
    rz = dot(r, z)
    best, stall = math.inf, 0
    rel = torch.sqrt(dot(r, r)) / bsafe
    for it in range(1, maxiter + 1):
        ap = A.matvec(p)
        pap = dot(p, ap)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0),
                            0.0)
        x = x + alpha[:, None, None] * p
        r = r - alpha[:, None, None] * ap
        rel = torch.sqrt(dot(r, r)) / bsafe
        worst = float(rel.max())
        if worst <= rtol:
            break
        if b.dtype != torch.float64:
            if worst < 0.999 * best:
                best, stall = worst, 0
            else:
                stall += 1
                if stall >= 20:
                    break
        z = hier.vcycle(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                           0.0)
        p = z + beta[:, None, None] * p
        rz = rz_new
    true = b - A.matvec(x)
    return x, torch.sqrt(dot(true, true)) / bsafe, it


# ------------------------------------------------------------ the job

def _node_currents(level: Level, v):
    """Per column of v (B, H, W): max(inflow, outflow) of every cell's
    branch currents, those under BRANCH_CUTOFF of the column's largest
    dropped.  level carries the ungrounded edge planes."""
    flows = []
    for p, src, dst in level.edges():
        # current along the edge from src to dst
        f = p[src] * level.rnd(v[(slice(None),) + src] -
                               v[(slice(None),) + dst])
        flows.append((src, dst, f))
    top = torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
    for _, _, f in flows:
        top = torch.maximum(top, f.abs().amax(dim=(1, 2)))
    thr = (BRANCH_CUTOFF * top)[:, None, None]
    inflow = torch.zeros_like(v)
    outflow = torch.zeros_like(v)
    for src, dst, f in flows:
        f = torch.where(f.abs() < thr, 0.0, f)
        pos = torch.clamp_min(f, 0.0)
        neg = torch.clamp_min(-f, 0.0)
        outflow[(slice(None),) + src] += pos
        inflow[(slice(None),) + dst] += pos
        inflow[(slice(None),) + src] += neg
        outflow[(slice(None),) + dst] += neg
    return torch.maximum(inflow, outflow)


def pairwise(habitat_file, point_file, device="cpu", maps=False,
             control=False, col_block=32, resistances=False, avg_res=False):
    """The job's answers: {"resistances": (n+1, n+1) matrix with ids,
    "cum": cumulative map, "max": max map (maps only), "iters",
    "relres"}.  `resistances`: the habitat file holds resistances;
    `avg_res`: edges average resistances.  control=True computes the
    answers in TF32 arithmetic."""
    g_np, hdr = conductance(habitat_file, resistances)
    pts = read_points(point_file, hdr)
    ids = np.array([p[0] for p in pts], np.int64)
    cells = np.array([(p[1], p[2]) for p in pts], np.int64)
    n = len(pts)
    if len({tuple(c) for c in cells}) != n or len(set(ids.tolist())) != n:
        raise ValueError("the reference takes distinct points on "
                         "distinct cells")
    if np.any(g_np[cells[:, 0], cells[:, 1]] <= 0):
        raise ValueError("a focal point lies off the graph")

    labels, _ = ndimage.label(g_np > 0, structure=np.ones((3, 3)))
    comp = labels[cells[:, 0], cells[:, 1]]
    anchor_of = {}
    for k in range(n):
        anchor_of.setdefault(int(comp[k]), k)
    anchors = np.array([cells[k] for k in anchor_of.values()], np.int64)
    holds = np.isin(labels, list(anchor_of))

    dtype = torch.float32 if control else torch.float64
    rnd = tf32 if control else None
    dev = torch.device(device)
    g = torch.as_tensor(g_np, dtype=dtype, device=dev)
    keep = torch.as_tensor(holds, device=dev)
    anc = torch.as_tensor(anchors, device=dev)
    keep[anc[:, 0], anc[:, 1]] = False
    hier = Hierarchy(_grounded_level(g, keep, anc, rnd, avg_res))
    H, W = g.shape

    # columns: every point that is not its component's anchor
    cols = [k for k in range(n) if anchor_of[int(comp[k])] != k]
    X = {}
    iters, relres = 0, 0.0
    for c0 in range(0, len(cols), col_block):
        blk = cols[c0:c0 + col_block]
        b = torch.zeros((len(blk), H, W), dtype=dtype, device=dev)
        for j, k in enumerate(blk):
            b[j, cells[k, 0], cells[k, 1]] = 1.0
        x, rel, it = pcg(hier, b, CONTROL_RTOL if control else RTOL)
        iters += it
        relres = max(relres, float(rel.max()))
        for j, k in enumerate(blk):
            X[k] = x[j]
    # G[i, k] = x_k at point i; anchors' columns and rows are 0
    Gm = np.zeros((n, n))
    for k, x in X.items():
        Gm[:, k] = x[cells[:, 0], cells[:, 1]].double().cpu().numpy()
    R = -np.ones((n, n))
    for i in range(n):
        for j in range(n):
            if comp[i] == comp[j]:
                R[i, j] = Gm[i, i] + Gm[j, j] - Gm[i, j] - Gm[j, i]
    np.fill_diagonal(R, 0.0)
    out = np.zeros((n + 1, n + 1))
    out[0, 1:] = ids
    out[1:, 0] = ids
    out[1:, 1:] = R
    result = {"resistances": out, "iters": iters, "relres": relres}
    if not maps:
        return result

    # ungrounded planes for the branch currents
    e, s, se, sw = _edge_planes(g, avg_res)
    flat = Level(e, s, se, sw, torch.zeros_like(g),
                 torch.ones_like(keep), rnd)
    zero = torch.zeros((H, W), dtype=dtype, device=dev)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
             if comp[i] == comp[j]]
    cum = torch.zeros((H, W), dtype=torch.float64, device=dev)
    mx = torch.zeros((H, W), dtype=dtype, device=dev)
    for p0 in range(0, len(pairs), MAP_COLUMNS):
        blk = pairs[p0:p0 + MAP_COLUMNS]
        v = torch.stack([X.get(i, zero) - X.get(j, zero) for i, j in blk])
        cur = _node_currents(flat, v)
        cum += cur.sum(dim=0).double()
        mx = torch.maximum(mx, cur.amax(dim=0))
    result["cum"] = cum.cpu().numpy()
    result["max"] = mx.double().cpu().numpy()
    return result
