"""Device-resident sparse operators of the general sparse-graph tier.

Counterpart of circuitscape_tpu/solve/operators.py.  A graph Laplacian
from graph/build.py becomes padded ELL: a fixed-width neighbour table
(idx, w) plus a separate diagonal, built on the host (the same arrays
as the JAX package's) and held as device tensors.  The batched product
is a gather and a weighted sum over the K slots, written as an
elementwise multiply and a sum (no matmul, so no TF32 can enter).

Rows are bucketed to powers of two and widths to multiples of 4, as in
the JAX package, so both build the same shapes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch


def _bucket_rows(n: int) -> int:
    return max(8, 1 << math.ceil(math.log2(max(n, 1))))


def _bucket_width(k: int) -> int:
    return max(4, -(-k // 4) * 4)


@dataclass
class EllMatrix:
    """Padded ELL sparse matrix: A = diag + scatter(w at idx).

    idx:  (n_pad, K) int64 gather indices (self-index on padding slots)
    w:    (n_pad, K) values (0 on padding slots)
    diag: (n_pad,)   diagonal (1 on padding rows, keeping A SPD)
    n:    true (unpadded) dimension
    """

    idx: torch.Tensor
    w: torch.Tensor
    diag: torch.Tensor
    n: int

    @property
    def n_pad(self) -> int:
        return self.diag.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.n + torch.count_nonzero(self.w))


def _ell(idx, w, diag, n, device) -> EllMatrix:
    return EllMatrix(torch.as_tensor(idx.astype(np.int64), device=device),
                     torch.as_tensor(w, device=device),
                     torch.as_tensor(diag, device=device), n)


def ell_from_csr(L: sp.spmatrix, dtype=None, device="cpu") -> EllMatrix:
    """A CSR/CSC sparse matrix (diagonal and off-diagonal) as padded ELL
    on device, from the host arrays circuitscape_tpu/solve/operators.
    ell_from_csr builds."""
    L = L.tocsr()
    n = L.shape[0]
    dtype = dtype or L.dtype
    d = L.diagonal().astype(dtype)

    coo = (L - sp.diags(L.diagonal())).tocoo()
    coo.eliminate_zeros()
    order = np.lexsort((coo.col, coo.row))
    rows, cols, vals = coo.row[order], coo.col[order], coo.data[order]
    counts = np.bincount(rows, minlength=n)
    K = int(counts.max()) if counts.size else 0

    n_pad = _bucket_rows(n)
    K_pad = _bucket_width(K)

    idx = np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, K_pad))
    w = np.zeros((n_pad, K_pad), dtype)
    # slot of each entry within its row
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(rows.size) - starts[rows]
    idx[rows, pos] = cols.astype(np.int32)
    w[rows, pos] = vals.astype(dtype)

    diag = np.ones(n_pad, dtype)
    diag[:n] = d
    return _ell(idx, w, diag, n, device)


def ell_matvec(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Batched SpMV/SpMM: x is (n_pad, B); returns A @ x, (n_pad, B)."""
    return A.diag[:, None] * x + ell_matvec_rect(A, x)


def ell_matvec_rect(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Rectangular gather-ELL apply (no diagonal term): x may have any
    row count > max(A.idx); returns (rows_pad, B).  Used for the AMG
    grid-transfer operators (solve/amg.py)."""
    return torch.sum(A.w[:, :, None] * x[A.idx], dim=1)


def pad_rhs(b: np.ndarray, n_pad: int) -> np.ndarray:
    """Zero-pad RHS (n, B) to (n_pad, B)."""
    n, B = b.shape
    if n == n_pad:
        return b
    out = np.zeros((n_pad, B), b.dtype)
    out[:n] = b
    return out
