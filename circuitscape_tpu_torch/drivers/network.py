"""Network (edge-list graph) scenario drivers.

Counterpart of circuitscape_tpu/drivers/network.py.  Parity reference:
src/network/pairwise.jl:1-93, src/network/advanced.jl:1-51.  A network
has no stencil, so it solves on the general sparse-graph tier: the
iterative one (ELL PCG with the SA-AMG V-cycle, on the job's device) or
the native Cholesky on the host.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from .. import cslog, out
from ..graph import build
from ..io.loaders import get_network_data
from ..solve.dispatch import DirectSolver, get_solver
from ..timer import CSTIMER
from .advanced import AdvancedProblem, advanced_kernel, get_sources_and_grounds
from .core import GraphProblem, single_ground_all_pairs
from .flags import get_network_flags


def _pick_network_solver(cfg, n_nodes: int):
    """Solver tier of a network job.  A cg+amg job of at most
    CS_NETWORK_DIRECT_MAX nodes (default 2M) routes to the native
    direct tier, as in the JAX package: at such sizes the supernodal
    Cholesky factors a network Laplacian in about a second and
    back-substitutes every pair column in one batch.
    CS_NETWORK_DIRECT_MAX=0 always honours cfg.solver (the iterative
    tier on the device)."""
    solver = get_solver(cfg)
    if solver.is_direct:
        return solver
    limit = int(os.environ.get("CS_NETWORK_DIRECT_MAX", "2000000"))
    if 0 < n_nodes <= limit:
        cslog.info("Network tier: routing to native direct solver "
                   "(%s nodes <= CS_NETWORK_DIRECT_MAX)", n_nodes)
        return DirectSolver(cfg)
    return solver


def _assemble(coords, dtype):
    i, j, v = coords
    if np.any(i < 1) or np.any(j < 1):
        raise ValueError("Indices no good")
    m = int(max(i.max(), j.max()))
    A = sp.coo_matrix((v.astype(dtype), (i - 1, j - 1)), shape=(m, m)).tocsr()
    A = (A + A.T).tocsr()
    A.sum_duplicates()
    return A


def network_pairwise(cfg, dtype, device):
    """src/network/pairwise.jl:4-29."""
    with CSTIMER("load network data"):
        networkdata = get_network_data(cfg, dtype)
    flags = get_network_flags(cfg)
    with CSTIMER("construct graph"):
        graphdata = compute_graph_data(networkdata, cfg, dtype)
    with CSTIMER("solve pairwise resistances"):
        ret = single_ground_all_pairs(graphdata, flags, cfg, device)

    if flags.outputflags.write_cur_maps:
        with CSTIMER("write cumulative currents"):
            cum = graphdata.cum
            node_arr = np.column_stack([
                np.arange(1, len(cum.cum_node_curr) + 1, dtype=dtype),
                cum.cum_node_curr])
            coords = np.asarray(cum.coords, dtype)
            branch_arr = np.column_stack([coords[:, 0], coords[:, 1],
                                          cum.cum_branch_curr])
            out.write_currents(node_arr, branch_arr, "_cum", cfg)
    return ret


def compute_graph_data(data, cfg, dtype=np.float64):
    """src/network/pairwise.jl:31-65."""
    A = _assemble(data.coords, dtype)
    cc = build.components(A)
    cslog.info("Graph has %s nodes and %s connected components",
               A.shape[0], len(cc))
    G = build.laplacian(A)

    solver = _pick_network_solver(cfg, A.shape[0])
    cum = out.initialize_cum_vectors(data.coords, G.shape[0])

    empty_i = np.zeros((0, 0), np.int64)
    return GraphProblem(G, cc, data.fp.astype(np.int64),
                        data.fp.astype(np.int64), [], empty_i, empty_i,
                        None, np.zeros((0, 0), dtype), cum, solver)


def network_advanced(cfg, dtype, device):
    """src/network/advanced.jl:1-51; returns (node id, voltage) rows."""
    with CSTIMER("load network data"):
        data = get_network_data(cfg, dtype)
    flags = get_network_flags(cfg)
    with CSTIMER("construct graph and sources"):
        advanced_data = compute_advanced_data_network(data, flags, cfg,
                                                      dtype)
    v, _ = advanced_kernel(advanced_data, flags, cfg, device)
    return v


def compute_advanced_data_network(data, flags, cfg, dtype=np.float64):
    """src/network/advanced.jl:22-51."""
    A = _assemble(data.coords, dtype)
    cc = build.components(A)
    cslog.info("Graph has %s nodes and %s connected components",
               A.shape[0], len(cc))
    G = build.laplacian(A)

    solver = _pick_network_solver(cfg, A.shape[0])
    sources, grounds, finite_grounds = get_sources_and_grounds(
        data, flags, G, np.zeros((0, 0), np.int64))

    empty_i = np.zeros((0, 0), np.int64)
    return AdvancedProblem(G, cc, empty_i, empty_i, None, sources, grounds,
                           np.zeros((0, 0), dtype), finite_grounds, -1, 0,
                           np.zeros((0, 0), dtype), solver)
