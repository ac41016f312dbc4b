"""Setup for the stencil device path: conductance map -> device operator
+ geometric-MG hierarchy.

Counterpart of circuitscape_tpu/solve/prepare.py, single-device branch:
the plain setup and the pen-aware one of the advanced and one-to-all
paths.  Grids of at most CS_DEVICE_MG_MAX cells (read at call time,
default 1200000, as in the JAX package) build their hierarchy on the
device; larger ones take the JAX package's large-grid route: the
float64 operator still builds on the device from the uploaded map, the
fine level is its float32 cast, and the coarser levels coarsen on the
host in float64 (geomg.build_geo_mg).  Multi-device meshes are not
carried yet (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import stats
from ..timer import CSTIMER
from .geomg import build_geo_mg, build_geo_mg_device, geomg_apply
from .stencil import (_to_dtype, advanced_ground_penalty,
                      stencil_activity_stats, stencil_from_gmap_device,
                      stencil_planes_np)


def _device_mg_max() -> int:
    """Largest grid (cells) whose hierarchy builds on the device; above
    it the hierarchy builds on the host.  The JAX package's knob."""
    return int(os.environ.get("CS_DEVICE_MG_MAX", "1200000"))


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


def _record(g, four_neighbors, prec, device, build):
    route = "cuda" if device.type == "cuda" else "torch"
    stats.record(fine_nnz=stencil_activity_stats(g, four_neighbors),
                 cells=g.size,
                 device_name=(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                 mg_kernels=[route] * len(prec.levels), mg_build=build)


def prepare_stencil_solver_from_gmap(gmap, avg_res, four_neighbors,
                                     device):
    """Upload the (H, W) conductance map and build the five float64
    stencil planes on the device, then the float32 MG hierarchy: on the
    device, or on the host when the unpadded grid has more than
    CS_DEVICE_MG_MAX cells (_prepare_large_single).

    Returns (S64, prec, prec_apply, (H0, W0))."""
    device = torch.device(device)
    gmap = np.asarray(gmap)
    H0, W0 = gmap.shape
    if gmap.size > _device_mg_max():
        return _prepare_large_single(gmap, avg_res, four_neighbors, device)
    g, S64 = _upload_operator(gmap, avg_res, four_neighbors, device)
    # bucketed grids are >= 128 x 128, so the hierarchy always pays off
    prec = build_geo_mg_device(_to_dtype(S64, torch.float32))
    _record(g, four_neighbors, prec, device, "device")
    return S64, prec, geomg_apply, (H0, W0)


def _prepare_large_single(gmap, avg_res, four_neighbors, device):
    """Device-built operator, host-coarsened hierarchy and a fine level
    derived on the device from the operator (the JAX package's
    _prepare_large_single), for grids above CS_DEVICE_MG_MAX cells."""
    H0, W0 = gmap.shape
    with CSTIMER("device operator"):
        g, S64 = _upload_operator(gmap, avg_res, four_neighbors, device)
        A32 = _to_dtype(S64, torch.float32)
    with CSTIMER("host planes"):
        planes = stencil_planes_np(g, avg_res, four_neighbors)
    with CSTIMER("host hierarchy"):
        prec = build_geo_mg(planes, device=device,
                            fine_device_ops=A32.planes)
    del planes
    _record(g, four_neighbors, prec, device, "host")
    return S64, prec, geomg_apply, (H0, W0)


def prepare_stencil_solver_from_gmap_pen(gmap, avg_res, four_neighbors,
                                         pen_spec, device):
    """Setup for the advanced and one-to-all solves: the ground diagonal
    is baked into the MG hierarchy (coarsened per level, see
    geomg._build_levels_device and geomg.build_geo_mg), so the V-cycle
    preconditions the grounded operator.  The hierarchy builds on the
    host when the padded grid has more than CS_DEVICE_MG_MAX cells (the
    JAX package compares the padded size here, the unpadded one in
    prepare_stencil_solver_from_gmap).

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
    g, S64 = _upload_operator(gmap, avg_res, four_neighbors, device)

    penalty = advanced_ground_penalty(S64)
    pen_host = np.where(np.isinf(pen_spec), penalty,
                        np.asarray(pen_spec, np.float64))
    pen_pad = np.zeros(g.shape, np.float64)
    pen_pad[:H0, :W0] = pen_host
    A32 = _to_dtype(S64, torch.float32)
    pen32 = torch.as_tensor(pen_pad, dtype=torch.float32, device=device)
    if g.size <= _device_mg_max():
        prec = build_geo_mg_device(A32, pen=pen32)
        build = "device"
    else:
        prec = build_geo_mg(
            stencil_planes_np(g, avg_res, four_neighbors), device=device,
            pen_np=pen_pad, fine_device_ops=A32.planes[:4] + (
                A32.diag + pen32,))
        build = "host"
    _record(g, four_neighbors, prec, device, build)
    return S64, prec, geomg_apply, (H0, W0), pen_host
