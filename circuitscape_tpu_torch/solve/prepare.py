"""Setup for the stencil device path: conductance map -> device operator
+ geometric-MG hierarchy.

Counterpart of circuitscape_tpu/solve/prepare.py, single-device branch.
Grids above DEVICE_MG_MAX cells (the JAX package's host-built hierarchy
for large single devices) and multi-device meshes are not carried yet
(ROADMAP queue 1 items 11 and 12).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import stats
from .geomg import build_geo_mg_device, geomg_apply
from .stencil import (_to_dtype, stencil_activity_stats,
                      stencil_from_gmap_device)

# Largest grid (cells) whose hierarchy builds on the device in one go;
# the JAX package's default CS_DEVICE_MG_MAX.
DEVICE_MG_MAX = 1_200_000


def prepare_stencil_solver_from_gmap(gmap, avg_res, four_neighbors,
                                     device):
    """Upload the (H, W) conductance map and build the five float64
    stencil planes on the device, then the float32 MG hierarchy.

    The grid pads up to a 128-cell multiple in each dimension with
    inactive cells (one operator shape per size bucket).  Returns
    (S64, prec, prec_apply, (H0, W0))."""
    device = torch.device(device)
    gmap = np.asarray(gmap)
    H0, W0 = gmap.shape
    if gmap.size > DEVICE_MG_MAX:
        raise NotImplementedError(
            f"a {H0}x{W0} grid exceeds the {DEVICE_MG_MAX}-cell device "
            "hierarchy build; large single-device grids are not carried by "
            "circuitscape_tpu_torch yet (ROADMAP queue 1 item 11)")

    qh = qw = 128   # shape bucketing
    Hp = -(-H0 // qh) * qh
    Wp = -(-W0 // qw) * qw
    g = np.zeros((Hp, Wp), np.float64)
    g[:H0, :W0] = np.where(gmap > 0, gmap, 0.0)
    S64 = stencil_from_gmap_device(torch.as_tensor(g, device=device),
                                   bool(avg_res), bool(four_neighbors))

    # bucketed grids are >= 128 x 128, so the hierarchy always pays off
    prec = build_geo_mg_device(_to_dtype(S64, torch.float32))

    route = "cuda" if device.type == "cuda" else "torch"
    stats.record(fine_nnz=stencil_activity_stats(g, four_neighbors),
                 cells=Hp * Wp,
                 device_name=(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                 mg_kernels=[route] * len(prec.levels))
    return S64, prec, geomg_apply, (H0, W0)
