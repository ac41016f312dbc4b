"""The stencil CG loop's graph route (stencil._cg_loop_static,
solve/cg_graph.py) on the CPU: its in-place iteration body gives the eager
loop's bits, the route follows the block's device and type, a replayed
graph's kernel launches count once per replay and never for the capture,
graphs are kept per operator only where they may be replayed again, and
the benchmark's solve.graph_iter_pct reads the counters; the body without
a penalty field or projector goes through the fused glue wrappers, whose
iterations count in stats fused_iters (read by solve.fused_iter_pct) and
whose launches count apart from the seven kernels'.  One test,
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
    the replayed, penalty-body and fused-body shares; None where the
    program has no graph route, no penalty counter or no fused body."""
    import span_report
    assert span_report.graph_share(
        {"cg_iters": 80, "graph_replays": 78, "graph_captures": 2}) == {
        "cg_iters": 80, "graph_captures": 2, "graph_replays": 78,
        "replay_pct": 97.5, "pen_iters": None, "pen_pct": None,
        "fused_iters": None, "fused_pct": None}
    assert span_report.graph_share({"cg_iters": 80}) == {
        "cg_iters": 80, "graph_captures": None, "graph_replays": None,
        "replay_pct": None, "pen_iters": None, "pen_pct": None,
        "fused_iters": None, "fused_pct": None}
    assert span_report.graph_share(
        {"cg_iters": 40, "graph_replays": 38, "graph_captures": 1,
         "pen_iters": 40, "fused_iters": 0}) == {
        "cg_iters": 40, "graph_captures": 1, "graph_replays": 38,
        "replay_pct": 95.0, "pen_iters": 40, "pen_pct": 100.0,
        "fused_iters": 0, "fused_pct": 0.0}
    assert span_report.graph_share(
        {"cg_iters": 80, "graph_replays": 78, "graph_captures": 2,
         "fused_iters": 80})["fused_pct"] == 100.0


@pytest.mark.parametrize("body", ["plain", "pen", "proj"])
def test_fused_iters_count_the_fused_body(body, monkeypatch):
    """stencil_cg on a one-card-sized float32 block (here on the CPU,
    where the fused wrappers run their plain versions): every iteration
    of the plain body goes through cg_update_xr, cg_dots and cg_update_p
    once each and counts in stats fused_iters, which then equals the
    solve's iterations; under a penalty field or a projector none does
    and fused_iters is 0."""
    calls = []
    for name in ("cg_update_xr", "cg_dots", "cg_update_p"):
        real = getattr(cuda_stencil, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(cuda_stencil, name, counted)
    A, B, prec, prec_apply, pen, proj = _case(body, mismatch=0.0)
    stats.reset()
    try:
        _, rel, it = tst.stencil_cg(A, B, 1e-4, prec=prec,
                                    prec_apply=prec_apply, pen=pen,
                                    proj=proj)
        job = stats.finalize()
    finally:
        stats.reset()
    assert it > 0 and float(rel.max()) < 1e-3
    fused = it if body == "plain" else 0
    assert job["fused_iters"] == fused
    assert sorted(calls) == sorted(
        ["cg_update_xr", "cg_dots", "cg_update_p"] * fused)


def test_fused_step_matches_composite_body():
    """One fused iteration (_fused_step, the plain versions on the CPU)
    against the composite body's expressions (the penalty and projector
    bodies' code, with neither): the same bits in X, R, P, rz, rn2 and
    the stop quantities, with and without the residual replacement."""
    A, B, prec, prec_apply, _, _ = _case("plain")
    bnorm = torch.sqrt(tst._colsum(B * B))
    safe = torch.where(bnorm == 0, 1.0, bnorm)
    tol = 1e-3 * bnorm
    apply_M = tst._make_prec_apply(A, prec, prec_apply)
    st = tst._cg_state_init(A, B, prec, prec_apply)
    for replace in (False, True):
        X, R, P, rz, rn2 = (t.clone() for t in (st.X, st.R, st.P, st.rz,
                                                st.rn2))
        stop = torch.empty(2)
        tst._fused_step(A, B, X, R, P, rz, rn2, safe, tol, stop, replace,
                        apply_M)
        AP, pAp = A.matvec_pap(st.P)
        alpha = torch.where(pAp > 0,
                            st.rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
        X2 = st.X + alpha[:, None, None] * st.P
        R2 = (B - A.matvec(X2) if replace else
              st.R - alpha[:, None, None] * AP)
        Z2 = apply_M(R2)
        rz2 = tst._colsum(R2 * Z2)
        beta = torch.where(st.rz > 0,
                           rz2 / torch.where(st.rz == 0, 1.0, st.rz), 0.0)
        P2 = Z2 + beta[:, None, None] * st.P
        rn22 = tst._colsum(R2 * R2)
        for got, want in ((X, X2), (R, R2), (P, P2), (rz, rz2),
                          (rn2, rn22),
                          (stop, tst._cg_stop(rn22, safe, tol))):
            assert torch.equal(got, want)


def test_glue_launches_count_apart():
    """The glue kernels' launches (cuda_stencil._fused) count in
    FUSED_LAUNCHES alone, never in LAUNCHES, LAUNCHES_AT or LAUNCHES_BHW
    (the benchmark's roofline metrics read those, and know only the
    seven); a captured body's glue launches are taken back at the
    capture and counted again at each replay, as the seven's are."""
    cuda_stencil.reset_launch_counts()
    glue = ("cg_update_xr", "cg_dots", "cg_dots_finish", "cg_update_p",
            "prolong_add")

    def body():
        cuda_stencil._launched("matvec_pap", 8, 64, 64)
        for name in glue:
            cuda_stencil._fused(name, 8, 64, 64)
        cuda_stencil._fused("prolong_add", 8, 32, 32)

    graphs = cg_graph.CGGraphs(None, _Graph, SimpleNamespace(
        stream=None, pool=None, last=None))
    try:
        for _ in range(4):
            graphs.run(False, body)
        assert graphs.captures == 1 and graphs.replays == 3
        want = {(name, 8, 64, 64): 4 for name in glue}
        want[("prolong_add", 8, 32, 32)] = 4
        assert dict(cuda_stencil.FUSED_LAUNCHES) == want
        assert dict(cuda_stencil.LAUNCHES_BHW) == {
            ("matvec_pap", 8, 64, 64): 4}
        assert dict(cuda_stencil.LAUNCHES_AT) == {
            ("matvec_pap", 64, 64): 4}
        assert set(cuda_stencil.LAUNCHES) == set(frozen_kernels())
        assert cuda_stencil.launch_counts() == (
            cuda_stencil.LAUNCHES_BHW + cuda_stencil.FUSED_LAUNCHES)
    finally:
        cuda_stencil.reset_launch_counts()
    assert not cuda_stencil.FUSED_LAUNCHES


def frozen_kernels():
    from benchmark import frozen
    return frozen.KERNELS


def test_fused_iter_pct_reads_the_counters():
    """solve.fused_iter_pct: 100 x fused_iters / cg_iters, mean over the
    run's span jobs; None where a job lacks the counter (a program
    without the fused body) or there are no jobs."""
    from benchmark import cells

    class Job:
        def __init__(self, **st):
            self.stats = st

    class Run:
        def __init__(self, *jobs):
            self.span_jobs = list(jobs)

    read = cells.reader("solve.fused_iter_pct", True)
    assert read(Run(Job(cg_iters=80, fused_iters=80),
                    Job(cg_iters=100, fused_iters=100))) == 100.0
    assert read(Run(Job(cg_iters=80, fused_iters=0),
                    Job(cg_iters=100, fused_iters=50))) == pytest.approx(
        25.0)
    assert read(Run(Job(cg_iters=80, fused_iters=80),
                    Job(cg_iters=80))) is None
    assert read(Run()) is None


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
