"""Public compute entry point and scenario dispatch.

Counterpart of circuitscape_tpu/run.py.  Parity reference: src/run.jl:1-67
(compute, _run, _compute).  Runs on the GPU ("cuda") unless the caller
passes device="cpu".  Rasters arrive as AAGrid, GeoTIFF, ESRI EHdr,
ENVI or NPY files; grids of any size that fits the card run on the
stencil path, and with more than one card visible the stencil path
row-shards over a device mesh (parallel/mesh.py), as the JAX package
does over its devices.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import cslog, stats
from .config import CSConfig, init_config, parse_config, write_config
from .timer import CSTIMER


def resolve_device(device=None) -> torch.device:
    """The device a job runs on: CUDA unless the caller asks otherwise.
    Without a card, only an explicit device="cpu" runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "circuitscape_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def compute(path_or_dict, device=None):
    """Run a job from an INI file path or a raw config dict
    (src/run.jl:14-24) on `device` (default: the current CUDA device).
    The job's span log (CSTIMER) starts here: its root span covers the
    whole call."""
    with CSTIMER.job("compute"):
        dev = resolve_device(device)
        with CSTIMER.span("read config"):
            if isinstance(path_or_dict, str):
                cfg = parse_config(path_or_dict)
            else:
                cfg_dict = init_config()
                cfg_dict.update(path_or_dict)
                cfg = CSConfig.from_dict(cfg_dict)
        return _run(cfg, dev)


def _run(cfg: CSConfig, device: torch.device):
    """src/run.jl:26-45."""
    with CSTIMER.span("write config"):
        cslog.update_logging(cfg)
        write_config(cfg)
    dtype = np.float32 if cfg.precision == "single" else np.float64
    if dtype == np.float32 and cfg.solver == "mklpardiso":
        cslog.warn("Pardiso solver works only in double precision. "
                   "Switching precision to double.")
        dtype = np.float64
    cslog.info("Precision used: %s", cfg.precision)
    if cfg.parallelize:
        cslog.info("Solves are batched on the accelerator "
                   "(parallelize flag accepted for compatibility)")
    CSTIMER.reset()
    stats.reset()
    with CSTIMER("complete job"):
        r = _compute(cfg, dtype, device)
    if cfg.log_level == logging.DEBUG:
        cslog.info("\n%s", CSTIMER.table())
    return r


def _compute(cfg: CSConfig, dtype, device):
    """src/run.jl:47-67."""
    from .drivers.advanced import raster_advanced
    from .drivers.network import network_advanced, network_pairwise
    from .drivers.onetoall import raster_one_to_all
    from .drivers.raster import raster_pairwise

    if cfg.data_type == "raster":
        if cfg.scenario == "pairwise":
            return raster_pairwise(cfg, dtype, device)
        if cfg.scenario == "advanced":
            return raster_advanced(cfg, dtype, device)
        return raster_one_to_all(cfg, dtype, device)
    if cfg.scenario == "pairwise":
        return network_pairwise(cfg, dtype, device)
    return network_advanced(cfg, dtype, device)
