"""Batched preconditioned conjugate gradients on ELL operators.

Counterpart of circuitscape_tpu/solve/cg.py.  Where the reference
issues one Krylov.cg per focal pair (src/core.jl:224-229), all right-hand
sides of a component solve as one (n, B) block: every product is a
multi-RHS gather-SpMM, every reduction a batched column sum.

The JAX package runs the loop as a device while_loop in chunks; here
the stop is decided after every iteration, as the while_loop decides
it, with one host sync per iteration (as in the stencil CG).  The
target max(rtol, 32 eps) * ||b||, `best` and the stall test
worst < best * 0.999 are formed in B's float type, as JAX forms them
(solve/stencil.py _cg_tol, _cg_improved).

Semantics kept from the reference: rtol 1e-6 against ||b||, itmax
100_000 (src/core.jl:639); the caller checks the 1e-4 residual gate
(src/core.jl:640-642).
"""

from __future__ import annotations

import numpy as np
import torch

from .operators import EllMatrix, ell_matvec
from .stencil import _cg_improved, _cg_tol

STALL_ITERS = 200   # iterations without a 0.1% gain that end the loop


def _colnorm(R: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(R * R, dim=0))


def jacobi_prec(A: EllMatrix) -> torch.Tensor:
    """Diagonal (Jacobi) preconditioner state."""
    return torch.where(A.diag != 0, 1.0 / A.diag, 1.0)


def jacobi_apply(prec, R):
    return prec[:, None] * R


def _make_apply_M(A, prec, prec_apply):
    if prec_apply is None:
        inv = jacobi_prec(A)
        return lambda r: inv[:, None] * r
    return lambda r: prec_apply(prec, r)


def _ell_cg_init(A, B, prec, prec_apply):
    """The CG state (X, R, Z, P, rz, k, best, since) at X = 0; best is a
    numpy scalar of B's float type."""
    Z = _make_apply_M(A, prec, prec_apply)(B)
    ftype = {torch.float32: np.float32, torch.float64: np.float64}[B.dtype]
    return (torch.zeros_like(B), B, Z, Z, torch.sum(B * Z, dim=0), 0,
            np.finfo(ftype).max, 0)


def _ell_cg_loop(A, B, state, tol, safe_bnorm, k_stop, itmax, prec,
                 prec_apply):
    """Preconditioned CG from state until every column's residual norm
    is at most tol, STALL_ITERS iterations pass without the worst
    relative residual improving by 0.1%, or k reaches itmax or k_stop.
    The stop quantities of each iteration are fetched in one host
    sync."""
    apply_M = _make_apply_M(A, prec, prec_apply)
    X, R, Z, P, rz, k, best, since = state
    ftype = type(best)

    def stop_quantities(R):
        resnorm = _colnorm(R)
        worst = torch.max(resnorm / safe_bnorm)
        active = torch.any(resnorm > tol)
        worst_h, active_h = torch.stack(
            [worst, active.to(worst.dtype)]).tolist()
        return ftype(worst_h), active_h > 0

    _, active = stop_quantities(R)
    while k < itmax and k < k_stop and since < STALL_ITERS and active:
        AP = ell_matvec(A, P)
        pAp = torch.sum(P * AP, dim=0)
        # zero (padding) columns have pAp = 0 and rz = 0: both guards
        # keep them at alpha = beta = 0
        alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, 1.0, pAp),
                            0.0)
        X = X + alpha[None, :] * P
        if (k + 1) % 64 == 0:
            # periodic true-residual replacement (van der Vorst)
            R = B - ell_matvec(A, X)
        else:
            R = R - alpha[None, :] * AP
        Z = apply_M(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, 1.0, rz),
                           0.0)
        P = Z + beta[None, :] * P
        rz = rz_new
        k += 1
        worst, active = stop_quantities(R)
        improved = _cg_improved(worst, best)
        best = np.minimum(best, worst)
        since = 0 if improved else since + 1
    return (X, R, Z, P, rz, k, best, since)


def cg_batched(A: EllMatrix, B: torch.Tensor, prec, prec_apply=None,
               rtol=1e-6, itmax=100_000):
    """Solve A X = B for all columns at once.

    A: EllMatrix (n_pad x n_pad), SPD (possibly a near-singular graph
    Laplacian with compatible right-hand sides).
    B: (n_pad, nrhs) right-hand sides, on A's device.
    prec, prec_apply: preconditioner state and its apply (prec, R) -> Z;
    prec_apply None is Jacobi.

    Returns (X, relres (nrhs,), iterations)."""
    bnorm = _colnorm(B)
    safe_bnorm = torch.where(bnorm == 0, 1.0, bnorm)
    # the target is floored at ~32 eps * ||b||: below that a
    # finite-precision CG stalls and would spin to itmax; the 1e-4
    # residual gate still guards correctness (src/core.jl:640-642)
    tol = _cg_tol(rtol, bnorm)
    state = _ell_cg_loop(A, B, _ell_cg_init(A, B, prec, prec_apply), tol,
                         safe_bnorm, itmax, itmax, prec, prec_apply)
    X = state[0]
    relres = _colnorm(B - ell_matvec(A, X)) / safe_bnorm
    return X, relres, state[5]
