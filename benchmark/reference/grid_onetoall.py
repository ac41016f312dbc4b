"""Plain reference for raster one-to-all jobs: the resistance of each
focal point to all the others, and the cumulative and max node current
maps over the points.

It follows Circuitscape's documented one-to-all semantics, written here
from them and from nothing of the program under test:

- the graph, the focal points and the node currents are those of
  grid_pairwise (its readers, edge planes, PCG and node currents are
  used as they are);
- each focal point i that shares its component with another focal point
  is solved once: a unit current into i's cell, every other focal point
  of the job a direct ground (held at 0 V); its result is the voltage at
  i, its current map the node currents of that solution;
- the cumulative map sums the points' current maps, the max map takes
  their elementwise maximum; a point alone in its component adds
  nothing, and its result is -1.

The solve grounds all N points at once, so that one operator and one
hierarchy serve every column: on the cells of the components that hold
two or more points, less the points' own cells, it solves for the
harmonic function h_i that is 1 at i and 0 at the other points (the
right-hand side is the conductance of each edge into i).  h_i draws a
current I_i out of i; the unit-current solution is v_i = h_i / I_i, and
the resistance is 1 / I_i.  Exact, and independent of how the program
grounds its points.

`pairwise(..., control=True)` computes the same in TF32 arithmetic, as
grid_pairwise's control does.  The name `pairwise` is the one the
benchmark's harness calls on every configuration's reference.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from benchmark.reference.grid_pairwise import (  # noqa: F401 (re-exported)
    CONTROL_RTOL, RTOL, Hierarchy, Level, _edge_planes, _grounded_level,
    _node_currents, conductance, pcg, read_asc, read_points,
    read_resistances, tf32)


def pairwise(habitat_file, point_file, device="cpu", maps=False,
             control=False, col_block=32, resistances=False, avg_res=False):
    """One-to-all (named `pairwise`, as the harness calls every
    reference): {"resistances": (n, 2) table of point id and resistance
    to the other points (-1 for a point alone in its component), "cum":
    cumulative map, "max": max map (maps only), "iters", "relres"}.
    `resistances`: the habitat file holds resistances; `avg_res`: edges
    average resistances.  control=True computes the answers in TF32
    arithmetic."""
    g_np, hdr = conductance(habitat_file, resistances)
    pts = read_points(point_file, hdr)
    ids = np.array([p[0] for p in pts], np.int64)
    cells = np.array([(p[1], p[2]) for p in pts], np.int64)
    n = len(pts)
    if len({tuple(c) for c in cells}) != n or len(set(ids.tolist())) != n:
        raise ValueError("the reference takes distinct points on "
                         "distinct cells")
    if np.any(g_np[cells[:, 0], cells[:, 1]] <= 0):
        raise ValueError("a focal point lies off the graph")

    labels, _ = ndimage.label(g_np > 0, structure=np.ones((3, 3)))
    comp = labels[cells[:, 0], cells[:, 1]]
    shared = [c for c in set(comp.tolist()) if np.sum(comp == c) > 1]
    active = np.isin(comp, shared)
    grounds = cells[active]

    dtype = torch.float32 if control else torch.float64
    rnd = tf32 if control else None
    dev = torch.device(device)
    g = torch.as_tensor(g_np, dtype=dtype, device=dev)
    keep = torch.as_tensor(np.isin(labels, shared), device=dev)
    anc = torch.as_tensor(grounds.reshape(-1, 2), device=dev)
    keep[anc[:, 0], anc[:, 1]] = False
    H, W = g.shape
    e, s, se, sw = _edge_planes(g, avg_res)
    flat = Level(e, s, se, sw, torch.zeros_like(g),
                 torch.ones_like(keep), rnd)

    table = np.column_stack([ids, -np.ones(n)])
    result = {"resistances": table, "iters": 0, "relres": 0.0}
    cum = torch.zeros((H, W), dtype=torch.float64, device=dev)
    mx = torch.zeros((H, W), dtype=dtype, device=dev)
    cols = np.nonzero(active)[0].tolist()
    if cols:
        hier = Hierarchy(_grounded_level(g, keep, anc, rnd, avg_res))
    for c0 in range(0, len(cols), col_block):
        blk = cols[c0:c0 + col_block]
        at = torch.arange(len(blk), device=dev)
        rows = torch.as_tensor(cells[blk, 0], device=dev)
        cs_ = torch.as_tensor(cells[blk, 1], device=dev)
        unit = torch.zeros((len(blk), H, W), dtype=dtype, device=dev)
        unit[at, rows, cs_] = 1.0
        # the harmonic h: 1 at the column's point, 0 at every ground, the
        # interior solved from the edges into the point (minus L's column
        # there, off the point)
        b = torch.where(keep, -flat.matvec(unit), 0.0)
        x, rel, it = pcg(hier, b, CONTROL_RTOL if control else RTOL)
        result["iters"] += it
        result["relres"] = max(result["relres"], float(rel.max()))
        h = torch.where(keep, x, 0.0) + unit
        current = flat.matvec(h)[at, rows, cs_]
        v = h / current[:, None, None]
        table[blk, 1] = (1.0 / current).double().cpu().numpy()
        if maps:
            cur = _node_currents(flat, v)
            cum += cur.sum(dim=0).double()
            mx = torch.maximum(mx, cur.amax(dim=0))
    if maps:
        result["cum"] = cum.cpu().numpy()
        result["max"] = mx.double().cpu().numpy()
    return result
