"""Smoothed-aggregation AMG preconditioner: host setup, device V-cycle.

Counterpart of circuitscape_tpu/solve/amg.py.  The reference
preconditions CG with AlgebraicMultigrid.jl's smoothed aggregation
(src/core.jl:164-167); the JAX package replaces its Gauss-Seidel
smoother with weighted Jacobi, and so does this port.

The setup (aggregation, tentative prolongator, prolongator smoothing,
Galerkin RAP) runs once per connected component on the host in
numpy/scipy, a line-for-line copy of the JAX package's with the same
default_rng(0) streams, so both build the same arrays.  The hierarchy
is then held as ELL device tensors; the V-cycle runs in torch on the
job's device, and the coarsest level is a dense pseudo-inverse applied
by a full-float32 matmul (geomg.full_precision_matmul).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .geomg import full_precision_matmul
from .operators import (EllMatrix, _ell, ell_from_csr, ell_matvec,
                        ell_matvec_rect)


@dataclass
class AmgLevel:
    A: EllMatrix           # level operator
    inv_diag: torch.Tensor  # Jacobi smoother weights (n_pad,)
    P: EllMatrix | None    # prolongator (n_pad x nc_pad, rectangular ELL)
    R: EllMatrix | None    # restriction = P^T
    omega: float


@dataclass
class AmgHierarchy:
    levels: tuple
    coarse_pinv: torch.Tensor   # (nc_pad, nc_pad) dense pseudo-inverse


def _rect_ell(M: sp.spmatrix, n_pad_rows: int, dtype,
              device="cpu") -> EllMatrix:
    """A rectangular sparse matrix as gather-ELL with an explicit zero
    diagonal (rows padded to n_pad_rows; the column index space is left
    unpadded: gather sources are padded by the caller)."""
    M = M.tocsr()
    n, m = M.shape
    coo = M.tocoo()
    order = np.lexsort((coo.col, coo.row))
    rows, cols, vals = coo.row[order], coo.col[order], coo.data[order]
    counts = np.bincount(rows, minlength=n)
    K = max(int(counts.max()) if counts.size else 0, 1)
    idx = np.zeros((n_pad_rows, K), np.int32)
    w = np.zeros((n_pad_rows, K), dtype)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(rows.size) - starts[rows]
    idx[rows, pos] = cols.astype(np.int32)
    w[rows, pos] = vals.astype(dtype)
    diag = np.zeros(n_pad_rows, dtype)
    return _ell(idx, w, diag, n, device)


def _standard_aggregation(A: sp.csr_matrix) -> np.ndarray:
    """Aggregation on the strength graph (every off-diagonal coupling of
    a Laplacian is strong): a randomized maximal independent set seeds
    the aggregates (Luby rounds, each one scipy row-max over the
    adjacency), then every other node joins its highest-priority
    neighbouring seed."""
    n = A.shape[0]
    coo = A.tocoo()
    offd = coo.col != coo.row
    rows, cols = coo.row[offd], coo.col[offd]
    adj = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))

    rng = np.random.default_rng(0)
    pri = rng.permutation(n).astype(np.float64) + 1.0
    state = np.zeros(n, np.int8)  # 0 undecided, 1 seed, 2 dominated

    M = adj.copy()
    for _ in range(64):
        und = state == 0
        if not und.any():
            break
        p = np.where(und, pri, 0.0)
        M.data = p[M.indices]
        nbr_max = np.asarray(M.max(axis=1).todense()).ravel()
        new_seeds = und & (p > nbr_max)
        state[new_seeds] = 1
        # dominate undecided neighbours of the new seeds
        touched = adj @ new_seeds.astype(np.float64)
        state[(state == 0) & (touched > 0)] = 2

    seeds = np.nonzero(state == 1)[0]
    agg = -np.ones(n, np.int64)
    agg[seeds] = np.arange(seeds.size)

    # attach each dominated node to its max-priority neighbouring seed
    seed_pri = np.where(state == 1, pri, 0.0)
    M.data = seed_pri[M.indices]
    best = np.asarray(M.argmax(axis=1)).ravel()
    dominated = state == 2
    agg[dominated] = agg[best[dominated]]
    return agg


def _estimate_rho(A: sp.csr_matrix, Dinv: np.ndarray, iters=10) -> float:
    """Power-iteration estimate of rho(D^-1 A)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0])
    x /= np.linalg.norm(x) + 1e-30
    rho = 2.0
    for _ in range(iters):
        y = Dinv * (A @ x)
        nrm = np.linalg.norm(y)
        if nrm == 0:
            return 2.0
        rho = nrm
        x = y / nrm
    return float(rho)


def build_amg(A: sp.spmatrix, A_ell: EllMatrix, dtype, max_levels=12,
              coarse_size=64) -> AmgHierarchy:
    """The SA hierarchy, set up on the host and held on A_ell's device."""
    dev = A_ell.diag.device
    levels = []
    Acur = A.tocsr().astype(np.float64)
    n_pad_cur = A_ell.n_pad
    ell_cur = A_ell

    while len(levels) < max_levels and Acur.shape[0] > coarse_size:
        d = Acur.diagonal()
        dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)

        agg = _standard_aggregation(Acur)
        nc = int(agg.max()) + 1
        if nc >= Acur.shape[0]:
            break  # no coarsening progress

        # tentative prolongator: piecewise constant, column-normalized
        P0 = sp.coo_matrix((np.ones(len(agg)),
                            (np.arange(len(agg)), agg)),
                           shape=(Acur.shape[0], nc)).tocsr()
        colnorm = np.sqrt(np.asarray(P0.multiply(P0).sum(axis=0))).ravel()
        P0 = P0 @ sp.diags(1.0 / np.where(colnorm == 0, 1.0, colnorm))

        # smoothed prolongator: (I - omega D^-1 A) P0
        rho = _estimate_rho(Acur, dinv)
        omega = 4.0 / 3.0 / max(rho, 1e-12)
        P = P0 - sp.diags(omega * dinv) @ (Acur @ P0)
        R = P.T.tocsr()
        Anext = (R @ Acur @ P).tocsr()

        ell_next = ell_from_csr(Anext, dtype, dev)
        # Jacobi smoother weight for this level
        jac_omega = 2.0 / 3.0 / max(_estimate_rho(Acur, dinv), 1e-12)
        inv_diag = np.ones(n_pad_cur, dtype)
        inv_diag[:len(dinv)] = (jac_omega * dinv).astype(dtype)

        levels.append(AmgLevel(
            A=ell_cur,
            inv_diag=torch.as_tensor(inv_diag, device=dev),
            P=_rect_ell(P, n_pad_cur, dtype, dev),
            R=_rect_ell(R, ell_next.n_pad, dtype, dev),
            omega=float(jac_omega),
        ))
        Acur = Anext
        ell_cur = ell_next
        n_pad_cur = ell_next.n_pad

    # coarsest level: dense pseudo-inverse (pinv coarse solve parity)
    dense = np.zeros((n_pad_cur, n_pad_cur), np.float64)
    dense[:Acur.shape[0], :Acur.shape[1]] = Acur.toarray()
    # padding rows get identity so the pinv stays benign
    for k in range(Acur.shape[0], n_pad_cur):
        dense[k, k] = 1.0
    pinv = np.linalg.pinv(dense).astype(dtype)
    return AmgHierarchy(tuple(levels), torch.as_tensor(pinv, device=dev))


def _level_vcycle(hier: AmgHierarchy, lvl: int, b: torch.Tensor):
    """Recursive V(1,1) cycle with weighted-Jacobi smoothing."""
    if lvl == len(hier.levels):
        return full_precision_matmul(hier.coarse_pinv, b)
    L = hier.levels[lvl]
    # pre-smooth: x = omega D^-1 b, one Jacobi sweep from zero
    x = L.inv_diag[:, None] * b
    r = b - ell_matvec(L.A, x)
    rc = ell_matvec_rect(L.R, r)
    xc = _level_vcycle(hier, lvl + 1, rc)
    x = x + ell_matvec_rect(L.P, xc)
    # post-smooth
    r = b - ell_matvec(L.A, x)
    return x + L.inv_diag[:, None] * r


def amg_apply(hier: AmgHierarchy, R: torch.Tensor) -> torch.Tensor:
    """Preconditioner application M^-1 R for the batched CG."""
    return _level_vcycle(hier, 0, R)
