"""Setup for the stencil device path: conductance map -> device operator
+ geometric-MG hierarchy.

Counterpart of circuitscape_tpu/solve/prepare.py, single-device branch:
the plain setup and the pen-aware one of the advanced and one-to-all
paths.  Grids above DEVICE_MG_MAX cells (the JAX package's host-built
hierarchy for large single devices) and multi-device meshes are not
carried yet (ROADMAP queue 1 items 11 and 12).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import stats
from .geomg import build_geo_mg_device, geomg_apply
from .stencil import (_to_dtype, advanced_ground_penalty,
                      stencil_activity_stats, stencil_from_gmap_device)

# Largest grid (cells) whose hierarchy builds on the device in one go;
# the JAX package's default CS_DEVICE_MG_MAX.
DEVICE_MG_MAX = 1_200_000


def _bucket(n: int) -> int:
    """A grid side padded up to a 128-cell multiple (one operator shape
    per size bucket)."""
    return -(-n // 128) * 128


def _upload_operator(gmap, avg_res, four_neighbors, device):
    """The conductance map, padded to its bucket with inactive cells, and
    its five float64 stencil planes built on the device.  Returns
    (padded host map, S64)."""
    H0, W0 = gmap.shape
    g = np.zeros((_bucket(H0), _bucket(W0)), np.float64)
    g[:H0, :W0] = np.where(gmap > 0, gmap, 0.0)
    return g, stencil_from_gmap_device(torch.as_tensor(g, device=device),
                                       bool(avg_res), bool(four_neighbors))


def _too_large(H0, W0):
    return NotImplementedError(
        f"a {H0}x{W0} grid exceeds the {DEVICE_MG_MAX}-cell device "
        "hierarchy build; large single-device grids are not carried by "
        "circuitscape_tpu_torch yet (ROADMAP queue 1 item 11)")


def _record(g, four_neighbors, prec, device):
    route = "cuda" if device.type == "cuda" else "torch"
    stats.record(fine_nnz=stencil_activity_stats(g, four_neighbors),
                 cells=g.size,
                 device_name=(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                 mg_kernels=[route] * len(prec.levels))


def prepare_stencil_solver_from_gmap(gmap, avg_res, four_neighbors,
                                     device):
    """Upload the (H, W) conductance map and build the five float64
    stencil planes on the device, then the float32 MG hierarchy.

    Returns (S64, prec, prec_apply, (H0, W0))."""
    device = torch.device(device)
    gmap = np.asarray(gmap)
    H0, W0 = gmap.shape
    if gmap.size > DEVICE_MG_MAX:
        raise _too_large(H0, W0)
    g, S64 = _upload_operator(gmap, avg_res, four_neighbors, device)
    # bucketed grids are >= 128 x 128, so the hierarchy always pays off
    prec = build_geo_mg_device(_to_dtype(S64, torch.float32))
    _record(g, four_neighbors, prec, device)
    return S64, prec, geomg_apply, (H0, W0)


def prepare_stencil_solver_from_gmap_pen(gmap, avg_res, four_neighbors,
                                         pen_spec, device):
    """Setup for the advanced and one-to-all solves: the ground diagonal
    is baked into the MG hierarchy (coarsened per level, see
    geomg._build_levels_device), so the V-cycle preconditions the
    grounded operator.

    pen_spec: (H0, W0) float64 host field of per-cell ground
    conductances; np.inf marks a direct ground, resolved to
    advanced_ground_penalty(S64).  The penalty is added in float32 to
    the float32 diagonal, so prec.levels[0].A is the f32 L + diag(pen):
    the inner CG applies it with pen=None
    (stencil.stencil_solve_advanced_batch, pen_in_prec=True).

    Returns (S64, prec, prec_apply, (H0, W0), pen_host), pen_host the
    resolved (H0, W0) float64 field for the operator's diagonal term."""
    device = torch.device(device)
    gmap = np.asarray(gmap)
    H0, W0 = gmap.shape
    if _bucket(H0) * _bucket(W0) > DEVICE_MG_MAX:
        # the JAX package builds this (padded) hierarchy on the host
        raise _too_large(H0, W0)
    g, S64 = _upload_operator(gmap, avg_res, four_neighbors, device)

    penalty = advanced_ground_penalty(S64)
    pen_host = np.where(np.isinf(pen_spec), penalty,
                        np.asarray(pen_spec, np.float64))
    pen_pad = np.zeros(g.shape, np.float64)
    pen_pad[:H0, :W0] = pen_host
    prec = build_geo_mg_device(
        _to_dtype(S64, torch.float32),
        pen=torch.as_tensor(pen_pad, dtype=torch.float32, device=device))
    _record(g, four_neighbors, prec, device)
    return S64, prec, geomg_apply, (H0, W0), pen_host
