"""circuitscape_tpu_torch — the PyTorch/CUDA port of circuitscape_tpu.

Runs circuit-theory connectivity jobs (effective resistances between
focal points of a conductance raster) on an NVIDIA GPU.  Plain tensor
work is PyTorch; the stencil kernels of the preconditioned CG solve are
hand-written CUDA C++ (csrc/, built with nvcc on first use).  It imports
neither JAX nor the circuitscape_tpu package.

It does everything the JAX package does: the raster scenarios on the
stencil device path (pairwise in shortcut mode and with current and
voltage maps, exclude pairs, short-circuit polygons and focal regions,
advanced, one-to-all / all-to-one; grids above CS_DEVICE_MG_MAX cells
with a host-built multigrid hierarchy), every other job on the general
sparse-graph tier (network scenarios, small grids, the direct solvers),
and, when more than one device is visible, the stencil path row-sharded
over a ('nodes', 'batch') device mesh (parallel/mesh.py).

Public API mirrors the reference; every entry point runs on CUDA unless
the caller passes device="cpu":
    compute(path_or_dict, device=None) -> run a job from an INI file or
        config dict
    start(device=None)                 -> interactive config wizard (TUI)
    compute_omniscape_current(...)     -> in-memory advanced solve
    calculate_cum_current_map / calculate_max_current_map
    register_solver(name, factory, message) -> add a solver tier
"""

from .config import CSConfig, init_config, parse_config, write_config
from .run import compute
from .solve.dispatch import register_solver
from .utils import (calculate_cum_current_map, calculate_max_current_map,
                    compute_omniscape_current)

__version__ = "0.2.0"

__all__ = [
    "compute", "CSConfig", "parse_config", "init_config", "write_config",
    "compute_omniscape_current", "calculate_cum_current_map",
    "calculate_max_current_map", "register_solver", "start",
]


def start(device=None):
    """Launch the interactive configuration wizard (INIBuilder parity);
    a job it runs goes to `device` (default: CUDA)."""
    from .tui import start as _start
    return _start(device=device)
