"""The stencil CG loop's graph route (stencil._cg_loop_static,
solve/cg_graph.py) on the CPU: its in-place iteration body gives the eager
loop's bits, the route follows the block's device and type, a replayed
graph's kernel launches count once per replay and never for the capture,
graphs are kept per operator only where they may be replayed again, and
the benchmark's solve.graph_iter_pct reads the counters.  One test,
marked `cuda`, holds the route against the eager loop on the card
(chip_smoke.phase_graph); it skips here.  This file imports neither JAX
nor circuitscape_tpu."""

import gc
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from circuitscape_tpu_torch import stats
from circuitscape_tpu_torch.parallel.mesh import MeshBlock
from circuitscape_tpu_torch.solve import cg_graph, cuda_stencil
from circuitscape_tpu_torch.solve import prepare as tpr
from circuitscape_tpu_torch.solve import stencil as tst

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hierarchy(n, seed, mismatch):
    """The fine float32 operator of a random n x n map (conductances over
    e^-2..e^2, 10% holes) and the geometric hierarchy of that map with
    each conductance scaled by up to e^+-mismatch: a valid preconditioner
    that converges slowly enough for the loop to run past iteration 64
    without meeting its guards."""
    rng = np.random.default_rng(seed)
    g = np.exp(rng.uniform(-2.0, 2.0, (n, n)))
    g[rng.random((n, n)) < 0.1] = 0.0
    g2 = np.where(g > 0, g * np.exp(rng.uniform(-mismatch, mismatch,
                                                (n, n))), 0.0)
    _, prec, prec_apply, _ = tpr.prepare_stencil_solver_from_gmap(
        g2, False, False, "cpu")
    _, own, _, _ = tpr.prepare_stencil_solver_from_gmap(g, False, False,
                                                        "cpu")
    return g, own.levels[0].A, prec, prec_apply


def _case(body, mismatch=4.0):
    """(A, B, prec, prec_apply, pen, proj) on a 32 x 32 map, 2 columns:
    the plain body, a penalty field (ground cells, the advanced solves'
    body) or a shared polygon projector."""
    g, A, prec, prec_apply = _hierarchy(32, 3, mismatch)
    rng = np.random.default_rng(4)
    act = np.argwhere(g > 0)
    B = torch.zeros((2,) + A.shape, dtype=torch.float32)
    for b in range(2):
        (i, j), (k, m) = act[rng.choice(len(act), 2, replace=False)]
        B[b, i, j], B[b, k, m] = 1.0, -1.0
    pen = proj = None
    if body == "pen":
        pen = torch.zeros_like(B)
        for b in range(2):
            i, j = act[rng.integers(len(act))]
            pen[b, i, j] = 1e3
    elif body == "proj":
        nodemap = np.zeros(g.shape, np.int64)
        nodemap[g > 0] = np.arange(1, int((g > 0).sum()) + 1)
        nodemap[4:9, 4:9][g[4:9, 4:9] > 0] = 10_000     # one polygon
        proj = tst.build_poly_projector(nodemap, A.shape)
        B = tst.poly_project(proj, B)
    return A, B, prec, prec_apply, pen, proj


@pytest.mark.parametrize("body", ["plain", "pen", "proj"])
def test_inplace_body_matches_eager_loop(body):
    """The graph route's loop run eagerly (no capture) on the CPU against
    the eager loop, in two calls as the chunked driver makes them (to
    k = 40 from the initial state, then to 70 from the returned one, past
    the residual replacement at 64): the same k, best and since, and the
    same bits in X, R, P, rz and rn2."""
    A, B, prec, prec_apply, pen, proj = _case(body)
    bnorm = torch.sqrt(tst._colsum(B * B))
    safe = torch.where(bnorm == 0, 1.0, bnorm)
    tol = torch.zeros_like(bnorm)
    apply_M = tst._make_prec_apply(A, prec, prec_apply, pen, proj)
    graphs = cg_graph.CGGraphs(tst._CGBuffers(B, tol, safe))
    eager = static = None
    for k_stop in (40, 70):
        eager = tst._cg_loop(A, B, eager, tol, safe, k_stop, 1000, prec,
                             prec_apply, pen, proj)
        static = tst._cg_loop_static(A, B, static, tol, safe, k_stop, 1000,
                                     apply_M, graphs, pen, proj)
        assert static.k == eager.k == k_stop
        assert static.since == eager.since
        assert type(static.best) is np.float32 and static.best == eager.best
        for f in ("X", "R", "P", "rz", "rn2"):
            assert torch.equal(getattr(static, f), getattr(eager, f)), f
    assert graphs.replays == graphs.captures == 0


def test_route_follows_the_block():
    """The graph route takes a plain tensor on a CUDA device and nothing
    else: not a CPU tensor, not a mesh's MeshBlock."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        on_card = torch.empty((2, 4, 4), device="cuda")
    assert tst._graph_route(on_card)
    cpu = torch.zeros((2, 4, 4))
    assert not tst._graph_route(cpu)
    assert not tst._graph_route(MeshBlock(None, [[cpu]], True))


def test_cpu_solve_asks_for_no_graphs(monkeypatch):
    """A solve on CPU tensors takes the eager loop, never the graphs."""
    def refuse(*a, **k):
        raise AssertionError("graphs asked for on the CPU")
    monkeypatch.setattr(cg_graph, "graphs_for", refuse)
    A, B, prec, prec_apply, _, _ = _case("plain", mismatch=0.0)
    X, rel, it = tst.stencil_cg(A, B, 1e-4, prec=prec,
                                prec_apply=prec_apply)
    assert it > 0 and float(rel.max()) < 1e-3


class _Graph:
    """A stand-in for torch.cuda.CUDAGraph: counts its calls."""
    made = []

    def __init__(self):
        self.calls = []
        _Graph.made.append(self)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append(("begin", pool, capture_error_mode))

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        self.calls.append("replay")


def test_replays_count_launches_captures_do_not():
    """A body that launches three kernels, run five times: once eagerly
    (its launches counted by the wrappers), then captured (its launches
    taken back out) and replayed four times (added at each replay).  The
    three counters end at five iterations' launches, no entry at zero;
    the body ran twice, the graph was captured once with the pool (and
    kept as the pool's newest) and replayed four times; the other body
    has its own graph."""
    cuda_stencil.reset_launch_counts()
    _Graph.made.clear()
    ran = []

    def body(B):
        ran.append(B)
        cuda_stencil._launched("matvec_pap", B, 64, 64)
        cuda_stencil._launched("cheb_init", B, 64, 64)
        cuda_stencil._launched("cheb_init", B, 32, 32)

    context = SimpleNamespace(stream=None, pool="pool", last=None)
    graphs = cg_graph.CGGraphs(None, _Graph, context)
    for _ in range(5):
        graphs.run(False, lambda: body(8))
    assert len(ran) == 2 and graphs.captures == 1 and graphs.replays == 4
    (g,) = _Graph.made
    assert context.last is g        # the pool lives while g does
    assert g.calls == [("begin", "pool", "thread_local"), "end"] + [
        "replay"] * 4
    assert cuda_stencil.LAUNCHES["matvec_pap"] == 5
    assert cuda_stencil.LAUNCHES["cheb_init"] == 10
    assert dict(cuda_stencil.LAUNCHES_AT) == {
        ("matvec_pap", 64, 64): 5, ("cheb_init", 64, 64): 5,
        ("cheb_init", 32, 32): 5}
    assert dict(cuda_stencil.LAUNCHES_BHW) == {
        ("matvec_pap", 8, 64, 64): 5, ("cheb_init", 8, 64, 64): 5,
        ("cheb_init", 8, 32, 32): 5}
    for _ in range(3):
        graphs.run(True, lambda: body(4))
    assert graphs.captures == 2 and graphs.replays == 6
    assert cuda_stencil.LAUNCHES_BHW[("cheb_init", 4, 32, 32)] == 3
    assert cuda_stencil.LAUNCHES["matvec_pap"] == 8
    cuda_stencil.reset_launch_counts()


def test_loop_records_replays():
    """_cg_loop_static records the iterations it replayed and the graphs
    it captured in the job's stats.  Iteration 0 runs eagerly, iteration
    1 is captured (the stand-in's capture runs the body on the CPU) and
    replayed; the stand-in's replays run nothing, so from there the stop
    quantities stand still and the stall detector ends the loop 50
    replays later."""
    A, B, prec, prec_apply, _, _ = _case("plain")
    bnorm = torch.sqrt(tst._colsum(B * B))
    safe = torch.where(bnorm == 0, 1.0, bnorm)
    tol = torch.zeros_like(bnorm)
    apply_M = tst._make_prec_apply(A, prec, prec_apply)
    graphs = cg_graph.CGGraphs(
        tst._CGBuffers(B, tol, safe), _Graph,
        SimpleNamespace(stream=None, pool=None, last=None))
    stats.reset()
    try:
        st = tst._cg_loop_static(A, B, None, tol, safe, 70, 70, apply_M,
                                 graphs)
        job = stats.finalize()
    finally:
        stats.reset()
        cuda_stencil.reset_launch_counts()
    assert (st.k, st.since) == (52, 50)
    assert (job["graph_replays"], job["graph_captures"]) == (51, 1)


def _variants(A, B, prec, prec_apply):
    """graphs_for on A with a penalty field, without a hierarchy, and on
    another block shape."""
    pen = torch.zeros_like(B)
    for b, p, pa, pn in ((B, prec, prec_apply, pen), (B, None, None, None),
                         (B[:1], prec, prec_apply, None)):
        t = torch.ones(b.shape[0])
        yield cg_graph.graphs_for(A, b, t, t, p, pa, pn, None)


def test_graphs_kept_on_the_operator(monkeypatch):
    """graphs_for keeps a loop's graphs on its operator for the next loop
    of the same hierarchy, projector and block shape; a penalty field, a
    loop without a hierarchy, another shape (which replaces the kept
    graphs) or another hierarchy get new ones; a solve's scope drops them
    when it ends; the kept graphs hold neither the operator nor the
    hierarchy, which free by their reference counts alone once the
    caller drops them."""
    monkeypatch.setattr(cg_graph.CGGraphs, "on_card",
                        classmethod(lambda cls, bufs: cls(bufs)))
    A, B, prec, prec_apply, _, _ = _case("plain")
    one = torch.ones(B.shape[0])

    def graphs(p=prec):
        return cg_graph.graphs_for(A, B, one, one, p, prec_apply, None, None)

    first = graphs()
    assert graphs() is first
    assert all(g is not first for g in _variants(A, B, prec, prec_apply))
    kept = graphs()
    assert kept is not first and graphs() is kept
    _, _, other, _ = _hierarchy(32, 5, 0.0)
    assert graphs(other) is not kept
    with tst._graph_scope(A):        # one solve: kept until it returns
        kept = graphs()
        assert graphs() is kept
    assert graphs() is not kept
    del kept
    refs = [cg_graph.weakref.ref(x) for x in (A, prec, other)]
    gc.disable()
    try:
        del A, prec, other, graphs
        assert [r() for r in refs] == [None] * 3
    finally:
        gc.enable()


def test_graph_iter_pct_reads_the_counters():
    """solve.graph_iter_pct: 100 x graph_replays / cg_iters, mean over the
    run's span jobs; None where a job lacks the counter (a program
    without the graph route) or there are no jobs."""
    from benchmark import cells

    class Job:
        def __init__(self, **st):
            self.stats = st

    class Run:
        def __init__(self, *jobs):
            self.span_jobs = list(jobs)

    read = cells.reader("solve.graph_iter_pct", True)
    assert read(Run(Job(cg_iters=80, graph_replays=78),
                    Job(cg_iters=100, graph_replays=99))) == pytest.approx(
        (97.5 + 99.0) / 2)
    assert read(Run(Job(cg_iters=80, graph_replays=78),
                    Job(cg_iters=80))) is None
    assert read(Run()) is None


def test_span_report_graph_share():
    """span_report's per-job graph line: the counters beside cg_iters and
    the replayed and penalty-body shares; None where the program has no
    graph route or no penalty counter."""
    import span_report
    assert span_report.graph_share(
        {"cg_iters": 80, "graph_replays": 78, "graph_captures": 2}) == {
        "cg_iters": 80, "graph_captures": 2, "graph_replays": 78,
        "replay_pct": 97.5, "pen_iters": None, "pen_pct": None}
    assert span_report.graph_share({"cg_iters": 80}) == {
        "cg_iters": 80, "graph_captures": None, "graph_replays": None,
        "replay_pct": None, "pen_iters": None, "pen_pct": None}
    assert span_report.graph_share(
        {"cg_iters": 40, "graph_replays": 38, "graph_captures": 1,
         "pen_iters": 40}) == {
        "cg_iters": 40, "graph_captures": 1, "graph_replays": 38,
        "replay_pct": 95.0, "pen_iters": 40, "pen_pct": 100.0}


@pytest.mark.cuda
def test_graph_route_on_card(tmp_path):
    """The graph route against the forced eager loop on the card, on the
    bench job and its maps recipe at 1M cells: chip_smoke.phase_graph
    (the same CG iterations per pass, X within 1e-6 relative per column,
    launch counts equal to the profiler's kernel counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import make_job, phase_graph
    cfg, _ = make_job(str(tmp_path), 1000, 1000)
    phase_graph(cfg)
