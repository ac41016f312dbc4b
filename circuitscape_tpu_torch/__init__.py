"""circuitscape_tpu_torch — the PyTorch/CUDA port of circuitscape_tpu.

Runs circuit-theory connectivity jobs (effective resistances between
focal points of a conductance raster) on an NVIDIA GPU.  Plain tensor
work is PyTorch; the stencil kernels of the preconditioned CG solve are
hand-written CUDA C++ (csrc/, built with nvcc on first use).  It imports
neither JAX nor the circuitscape_tpu package.

This package carries the raster scenarios on the stencil device path
(pairwise in shortcut mode and with current and voltage maps, exclude
pairs, short-circuit polygons and focal regions, advanced, one-to-all /
all-to-one; grids above CS_DEVICE_MG_MAX cells with a host-built
multigrid hierarchy) and every other job on the general sparse-graph
tier (network scenarios, small grids, the direct solvers).

Public API mirrors the reference:
    compute(path_or_dict, device=None) -> run a job from an INI file or
        config dict on `device` (default: CUDA; pass device="cpu" to run
        on the CPU)
"""

from .config import CSConfig, init_config, parse_config, write_config
from .run import compute

__version__ = "0.1.0"

__all__ = ["compute", "CSConfig", "parse_config", "init_config",
           "write_config"]
