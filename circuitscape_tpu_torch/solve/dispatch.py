"""Solver tiers and device-capacity helpers.

Counterpart of circuitscape_tpu/solve/dispatch.py.  Parity reference:
src/core.jl:48-94 (Solver type hierarchy, get_solver).  This package
carries the iterative tier only: `cg+amg` is the batched stencil PCG
with the geometric-multigrid V-cycle (solve/stencil.py); the direct
tier (`cholmod` and its aliases) is not carried yet (ROADMAP queue 1
item 9) and raises NotImplementedError.

Capacity comes from the device itself (torch.cuda.mem_get_info, or the
host's available memory for CPU tensors), not from a fixed constant.
"""

from __future__ import annotations

import os

import torch

from .. import cslog


class SolverFailedError(RuntimeError):
    pass


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
                       env_var: str = "CS_SHORTCUT_CHUNK_BYTES") -> int:
    """Bytes available for per-RHS-column solve state.  Called once the
    operator and hierarchy are resident, so the free memory already
    excludes them; 10% is held back for allocator fragmentation.  The
    env override wins (tests force multi-chunk paths with tiny
    budgets)."""
    env = os.environ.get(env_var)
    if env:
        return int(env)
    return max(cells, int(0.9 * _free_bytes(device)))


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
    col_gb = cells * 64 / 2**30
    raise SolverFailedError(
        f"device out of memory: the {cells}-cell grid needs "
        f"~{col_gb:.2f} GB per concurrent RHS column (batch={batch}) on "
        f"top of the operator and multigrid hierarchy.  Reduce the "
        f"per-chunk batch with CS_SHORTCUT_CHUNK_BYTES or coarsen the "
        f"grid.") from e


class AMGSolver:
    name = "cg+amg"
    is_direct = False

    def __init__(self, cfg=None):
        pass


# The reference's extension surface maps solver names to factories
# (ext/CircuitscapePardisoExt.jl:6,31-45); config._parse_solver reads
# the names registered here.
_SOLVER_REGISTRY: dict = {
    "cg+amg": (AMGSolver, "Solver used: AMG accelerated by CG"),
}


def get_solver(cfg):
    """src/core.jl:74-94 (registry-backed)."""
    entry = _SOLVER_REGISTRY.get(str(cfg.solver).lower())
    if entry is None:
        raise NotImplementedError(
            f"solver = {cfg.solver} is not carried by circuitscape_tpu_torch "
            "yet; use cg+amg (direct tier: ROADMAP queue 1 item 9)")
    factory, message = entry
    if message:
        cslog.info(message)
    return factory(cfg)
