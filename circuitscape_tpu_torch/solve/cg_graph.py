"""The stencil CG iteration run through one interface on every route, and
on one card captured once as a CUDA graph and replayed.

An iteration of the stencil PCG loop (stencil._cg_loop) is tens of device
operations: the hand-written kernels of the V-cycle and the body (the
body's glue fused into kernels of its own, stencil._fused_step, where
there is no penalty field or projector), and torch's ops between them,
each one Python call and one launch.  At 1M cells the card finishes
them faster than the host issues them and waits.  The body of an
iteration (stencil._cg_step_) works in place on the loop's buffers
(stencil._CGBuffers, handed in by the caller), and CGGraphs.run runs
it: on one card it is captured once as a CUDA graph and replayed, one
launch an iteration; on the CPU and on a mesh (a CGGraphs without a
graph type) it runs directly.  The host keeps the loop: after each
iteration it fetches the stop quantities in one sync and decides
(stencil._cg_iterate).

There are two bodies: the plain iteration and the one that replaces the
residual by the true one every 64 iterations.  On the card each runs
directly the first time it is reached, on the capture stream (that
stream's cuBLAS handle and workspace, and every kernel the body
launches, are then set up), and is captured the next time, then
replayed.  Graphs last one solve (graph_scope).  All share one memory
pool, a device's for the process (CaptureContext): only an iteration's
temporaries live there, since all that one iteration hands the next is
in the buffers, and no two graphs ever run at once.

A capture runs nothing, so the kernel launches its wrappers counted
(cuda_stencil.LAUNCHES, LAUNCHES_AT, LAUNCHES_BHW and, for the fused
glue, FUSED_LAUNCHES) are taken back out,
kept with the graph, and counted again at every replay: the counters
count executions, as the profiler does.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

# the attribute of an operator that holds the graphs its loops keep
GRAPH_SLOT = "_cg_graphs"


def _launch_counter():
    """solve/cuda_stencil, whose wrappers count the launches (imported
    at use: it imports stencil, which imports this module)."""
    from . import cuda_stencil
    return cuda_stencil


class CaptureContext:
    """A device's capture stream and memory pool, made once for the
    process and shared by every solve's graphs.  A stream of its own for
    each solve would get a cuBLAS workspace of its own (32 MiB), which
    torch keeps for the life of the process; a pool of its own would
    take fresh device memory at each capture and hand it back only when
    an allocation fails.  The pool lives while a graph captured into it
    does: last holds the newest, so that one outlives its solve."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.last = None


_CONTEXTS = {}


def _capture_context(device: torch.device) -> CaptureContext:
    index = torch.device(device).index
    if index not in _CONTEXTS:
        _CONTEXTS[index] = CaptureContext(device)
    return _CONTEXTS[index]


class CGGraphs:
    """The two bodies of one loop state (bufs, a stencil._CGBuffers):
    for each, keyed by its replace flag, the graph captured from it and
    the kernel launches the capture recorded.  graph: the graph type
    (torch.cuda.CUDAGraph on the card), None to run every iteration
    directly; context: the capture stream and pool (a CaptureContext;
    None or a stream of None: the current stream).  replays and
    captures count what it did."""

    def __init__(self, bufs, graph=None, context=None):
        self.bufs = bufs
        self.graph, self.context = graph, context
        self.graphs = {}
        self.warm = set()
        self.replays = self.captures = 0

    @classmethod
    def on_card(cls, bufs) -> "CGGraphs":
        return cls(bufs, torch.cuda.CUDAGraph,
                   _capture_context(bufs.B.device))

    @contextlib.contextmanager
    def _capture_stream(self):
        stream = self.context and self.context.stream
        if stream is None:
            yield
            return
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            yield
        current.wait_stream(stream)

    def run(self, replace: bool, body) -> None:
        """One iteration: the replace body's graph replayed where it has
        been captured; else body() run directly (on the capture stream)
        if it has not run there yet or there is no graph type, else
        captured and then replayed."""
        if replace not in self.graphs:
            if self.graph is None or replace not in self.warm:
                with self._capture_stream():
                    body()
                self.warm.add(replace)
                return
            self.graphs[replace] = self._capture(body)
        graph, launches = self.graphs[replace]
        graph.replay()
        _launch_counter().count_launches(launches)
        self.replays += 1

    def _capture(self, body):
        graph = self.graph()
        cuda_stencil = _launch_counter()
        before = cuda_stencil.launch_counts()
        with self._capture_stream():
            # thread_local: a thread writing map files meanwhile may use
            # the CUDA runtime without ending the capture
            graph.capture_begin(pool=self.context.pool,
                                capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        self.context.last = graph
        launches = cuda_stencil.launch_counts() - before
        cuda_stencil.count_launches(launches, -1)    # nothing ran yet
        self.captures += 1
        return graph, launches


def graphs_for(A, B: torch.Tensor, tol, safe_bnorm: torch.Tensor, prec,
               prec_apply, pen, proj, buffers) -> CGGraphs:
    """The graphs of a loop of A on B's shape on one card: those an
    earlier loop of the same solve left on A with the same
    preconditioner, projector, block shape and dtypes, or new ones on
    buffers(B, tol, safe_bnorm) (which then replace them).  A graph
    replays the storage it was captured on, so only a loop whose
    preconditioner application forms no tensors of its own (a hierarchy
    and no penalty field: stencil._make_prec_apply) leaves its graphs on
    A, for the solve's next refinement pass; the solve drops them when
    it returns (graph_scope).  They hold no reference to A or to the
    hierarchy, which free by reference counts alone."""
    tol = torch.as_tensor(tol, device=B.device)
    key = (tuple(B.shape), B.dtype, tuple(tol.shape), tol.dtype,
           safe_bnorm.dtype, prec_apply)
    keep = pen is None and prec is not None and prec_apply is not None
    kept = A.__dict__.get(GRAPH_SLOT)
    if (keep and kept is not None and kept.key == key and
            kept.prec() is prec and kept.proj is proj):
        return kept
    graphs = CGGraphs.on_card(buffers(B, tol, safe_bnorm))
    if keep:
        graphs.key, graphs.prec, graphs.proj = key, weakref.ref(prec), proj
        A.__dict__[GRAPH_SLOT] = graphs
    return graphs


@contextlib.contextmanager
def graph_scope(A):
    """The graphs kept on A (graphs_for) last until the end of this
    block, one solve: its refinement passes share them, and they go,
    with their buffers and memory pool, when it returns."""
    try:
        yield
    finally:
        A.__dict__.pop(GRAPH_SLOT, None)
