"""Solver tiers, per-component solve contexts and device-capacity helpers.

Counterpart of circuitscape_tpu/solve/dispatch.py.  Parity reference:
src/core.jl:48-94 (Solver type hierarchy, get_solver), :636-653
(solve_linear_system with residual gates).

Tiers:
  cg+amg     raster jobs on the stencil device path: batched stencil PCG
             with the geometric-multigrid V-cycle (solve/stencil.py);
             every other job: batched PCG on a padded-ELL operator with
             a smoothed-aggregation AMG V-cycle on the job's device
             (CGContext; hierarchy set up on the host per component)
  cholmod    the native supernodal Cholesky on the host (DirectContext,
             native/cholesky.cpp), batched multi-RHS back-substitution
  mklpardiso, accelerate   the reference's CPU direct-solver extension
             tiers, mapped onto the direct tier

Capacity comes from the device itself (torch.cuda.mem_get_info, or the
host's available memory for CPU tensors), not from a fixed constant.
"""

from __future__ import annotations

import os
import time
from collections import Counter

import numpy as np
import scipy.sparse as sp
import torch

from .. import consts, cslog, stats
from .cg import cg_batched, jacobi_apply, jacobi_prec
from .operators import ell_from_csr, pad_rhs


class SolverFailedError(RuntimeError):
    pass


# Device bytes a column of a batched stencil solve holds per grid cell:
# the chunk model of the shortcut, focal-region and one-to-all chunks
# (the maps path adds one float64 plane) and the out-of-memory
# message's figure.  Set from the card: the 48M-cell pair solve held
# 97.06 B a cell per column above its operator and hierarchy at widths
# 8 and 16 (chip_smoke.phase_chunk_model), 13 float64 planes cover it.
# (The JAX package's model is 8 planes, 64 B.)
COLUMN_BYTES_PER_CELL = 104


def _free_bytes(device: torch.device) -> int:
    """Bytes a solve may still allocate on device: the CUDA driver's
    free memory plus what torch's caching allocator holds unused."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device) -
                  torch.cuda.memory_allocated(device))
        return int(free + cached)
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def solve_chunk_budget(cells: int, device: torch.device,
                       env_var: str = "CS_SHORTCUT_CHUNK_BYTES",
                       mesh=None) -> int:
    """Bytes available for per-RHS-column solve state.  Called once the
    operator and hierarchy are resident, so the free memory already
    excludes them; 10% is held back for allocator fragmentation.  The
    env override wins (tests force multi-chunk paths with tiny
    budgets).

    On a mesh a column's bytes spread over its positions, so the budget
    is set by the device with the least free memory per position it
    holds: on virtual shards of one device every shard's bytes count
    against that device."""
    env = os.environ.get(env_var)
    if env:
        return int(env)
    if mesh is None:
        return max(cells, int(0.9 * _free_bytes(device)))
    held = Counter(d for row in mesh.devices for d in row)
    return max(cells, min(int(0.9 * _free_bytes(d)) * mesh.size // k
                          for d, k in held.items()))


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (chunk widths round UP to a power of
    two inside the fused pair solve, so sizing chunks at a power of two
    keeps allocated bytes equal to budgeted bytes)."""
    return 1 << (max(1, n).bit_length() - 1)


def reraise_if_device_oom(e: Exception, cells: int, batch: int):
    """Turn a device out-of-memory error into an actionable capacity
    error; re-raise anything else unchanged."""
    if not isinstance(e, torch.cuda.OutOfMemoryError):
        raise e
    col_gb = cells * COLUMN_BYTES_PER_CELL / 2**30
    raise SolverFailedError(
        f"device out of memory: the {cells}-cell grid needs "
        f"~{col_gb:.2f} GB per concurrent RHS column (batch={batch}) on "
        f"top of the operator and multigrid hierarchy.  Reduce the "
        f"per-chunk batch with CS_SHORTCUT_CHUNK_BYTES or coarsen the "
        f"grid.") from e


class CGContext:
    """Per-component CG state: the ELL operator and its preconditioner on
    the job's device.  The SA-AMG hierarchy (solve/amg.py) is attached
    from 512 nodes up; below, or when its host setup fails, Jacobi.  The
    answer depends only on the final residual, gated alike either way
    (src/core.jl:640-642)."""

    def __init__(self, matrix: sp.spmatrix, dtype, device, use_amg=True,
                 rtol=consts.CG_RTOL, itmax=consts.CG_ITMAX):
        self.matrix = matrix.tocsr()
        self.dtype = dtype
        self.rtol = rtol
        self.itmax = itmax
        self.A = ell_from_csr(self.matrix, dtype, device)
        self.prec = None
        self.prec_apply = None
        # SA-AMG pays for its setup only past a few hundred nodes; tiny
        # component systems converge in a handful of Jacobi-CG iterations
        if use_amg and self.matrix.shape[0] >= 512:
            try:
                from .amg import amg_apply, build_amg
                self.prec = build_amg(self.matrix, self.A, dtype)
                self.prec_apply = amg_apply
            except Exception:
                cslog.warn("AMG setup failed; falling back to Jacobi CG")
                self.prec = None
        if self.prec is None:
            self.prec = jacobi_prec(self.A)
            self.prec_apply = jacobi_apply

    def max_batch(self) -> int:
        # keep the (n_pad, B) workspace under ~1 GiB
        per_col = self.A.n_pad * np.dtype(self.dtype).itemsize * 6
        return max(1, min(4096, (1 << 30) // max(per_col, 1)))

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """Solve for all columns of rhs (n, B); returns (n, B) on the
        host."""
        t0 = time.perf_counter()
        n, B = rhs.shape
        out = np.empty((n, B), self.dtype)
        step = self.max_batch()
        dev = self.A.diag.device
        for s in range(0, B, step):
            block = np.asarray(rhs[:, s:s + step], np.dtype(self.dtype))
            # the batch axis is padded to a power of two, as in the JAX
            # package, so both run the same columns
            b_pad = 1 << max(0, (block.shape[1] - 1)).bit_length()
            rp = np.zeros((self.A.n_pad, b_pad), block.dtype)
            rp[:, :block.shape[1]] = pad_rhs(block, self.A.n_pad)
            X, relres, iters = cg_batched(
                self.A, torch.as_tensor(rp, device=dev), self.prec,
                prec_apply=self.prec_apply, rtol=self.rtol,
                itmax=self.itmax)
            stats.record(cg_iters=int(iters),
                         col_iters=int(iters) * block.shape[1])
            relres = relres.cpu().numpy()[:block.shape[1]]
            bad = relres >= consts.RESIDUAL_GATE
            # all-zero RHS columns are trivially converged
            nz = np.linalg.norm(block, axis=0) > 0
            if np.any(bad & nz):
                worst = float(relres[bad & nz].max())
                raise SolverFailedError(
                    f"CG solver did not converge: relative residual {worst} "
                    f"exceeds tolerance {consts.RESIDUAL_GATE}")
            out[:, s:s + block.shape[1]] = \
                X[:n, :block.shape[1]].cpu().numpy()
        stats.record(fine_nnz=self.matrix.nnz,
                     solve_s=time.perf_counter() - t0)
        return out


class DirectContext:
    """Direct sparse Cholesky on the host: factors G + 10 eps I once
    (src/core.jl:519-523) and back-substitutes batched multi-RHS blocks
    (src/core.jl:446-493) through the native library.  Without it the
    job raises: there is no SciPy fallback."""

    def __init__(self, matrix: sp.spmatrix, dtype):
        from .native_chol import NativeCholesky
        t0 = time.perf_counter()
        self.dtype = dtype
        self.matrix = matrix.tocsr().astype(dtype)
        eps = np.finfo(np.dtype(dtype)).eps
        shifted = (self.matrix +
                   sp.identity(matrix.shape[0], dtype=dtype) * (10 * eps))
        self._native = NativeCholesky(shifted)
        stats.record(fine_nnz=self.matrix.nnz,
                     factor_nnz_L=int(self._native.nnz_L),
                     factor_s=time.perf_counter() - t0)

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        lhs = self._native.solve(np.asarray(rhs, self.dtype))
        stats.record(solve_s=time.perf_counter() - t0)
        if lhs.ndim == 1:
            lhs = lhs[:, None]
        # per-column residual gate (src/core.jl:646-653), column norms
        # as one einsum pass each
        rhs2 = np.asarray(rhs, self.dtype).reshape(lhs.shape)
        r = self.matrix @ lhs
        r -= rhs2
        rnorm = np.sqrt(np.einsum("ij,ij->j", rhs2, rhs2))
        resid = np.sqrt(np.einsum("ij,ij->j", r, r))
        rel = resid / np.where(rnorm == 0, 1.0, rnorm)
        bad = (rel >= consts.RESIDUAL_GATE) & (rnorm > 0)
        if np.any(bad):
            col = int(np.argmax(bad))
            raise SolverFailedError(
                f"Direct solver residual {rel[col]} exceeds tolerance "
                f"{consts.RESIDUAL_GATE} for column {col}")
        return lhs


class AMGSolver:
    name = "cg+amg"
    is_direct = False

    def __init__(self, cfg=None):
        self.batch_size = 0  # unlimited; CG blocks internally

    def build(self, matrix, dtype, device):
        return CGContext(matrix, dtype, device)


class DirectSolver:
    name = "cholmod"
    is_direct = True

    def __init__(self, cfg):
        self.batch_size = cfg.cholmod_batch_size

    def build(self, matrix, dtype, device=None):
        return DirectContext(matrix, dtype)


# The reference's extension surface maps solver names to factories
# (ext/CircuitscapePardisoExt.jl:6,31-45); config._parse_solver reads
# the names registered here.  A factory takes cfg and returns an object
# with .name, .is_direct, .batch_size and .build(matrix, dtype, device),
# whose context has .solve(rhs (n, B)) -> (n, B).
_SOLVER_REGISTRY: dict = {
    "cg+amg": (AMGSolver, "Solver used: AMG accelerated by CG"),
    "cholmod": (DirectSolver, "Solver used: CHOLMOD"),
    # the reference's extension tiers were both CPU direct-solver
    # variants; their names stay valid and route to the direct tier
    "mklpardiso": (DirectSolver, "Solver used: Pardiso"),
    "accelerate": (DirectSolver, "Solver used: Apple Accelerate"),
}


def register_solver(name: str, factory, message: str = None) -> None:
    """Register (or override) a solver tier under `name`: any INI with
    `solver = <name>` then routes through factory(cfg)."""
    _SOLVER_REGISTRY[name.lower()] = (factory, message)


def get_solver(cfg):
    """src/core.jl:74-94 (registry-backed)."""
    entry = _SOLVER_REGISTRY.get(str(cfg.solver).lower())
    if entry is None:
        raise ValueError(f"Unknown solver: {cfg.solver}")
    factory, message = entry
    if message:
        cslog.info(message)
    return factory(cfg)
