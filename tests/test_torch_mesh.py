"""circuitscape_tpu_torch.parallel.mesh against the JAX package's mesh,
on the CPU: eight virtual shards of the CPU, shaped (2, 4) like the
JAX package's eight virtual CPU devices (tests/conftest.py), mirroring
tests/test_parallel.py and tests/test_stream_build.py.  Both packages
run their mesh with CS_FORCE_MESH=1; the single-device references set
CS_DISABLE_MESH.

CG iteration counts.  The JAX package sums a column over the mesh with
psum, the port adds the row shards' partial sums in shard order, and
single-device sums run in yet another order; a float32 pass stopping
near its rounding floor may then take one iteration more or less.  So
a pass's count is held within one of the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import record_passes
from circuitscape_tpu.parallel import mesh as jm
from circuitscape_tpu.solve import geomg as jmg
from circuitscape_tpu.solve import prepare as jpr
from circuitscape_tpu.solve import stencil as jst
from circuitscape_tpu_torch import stats
from circuitscape_tpu_torch.parallel import mesh as tm
from circuitscape_tpu_torch.solve import geomg as tmg
from circuitscape_tpu_torch.solve import prepare as tpr
from circuitscape_tpu_torch.solve import stencil as tst

torch.set_num_threads(1)

F32_TOL = 1e-5   # float32, sum order differs between XLA and torch
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture()
def vmesh(monkeypatch):
    """Eight virtual CPU shards for the port; the mesh forced on in both
    packages (the JAX package sees conftest's eight CPU devices)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    monkeypatch.setattr(tm, "visible_devices", lambda: list(CPU8))
    monkeypatch.setenv("CS_FORCE_MESH", "1")
    monkeypatch.delenv("CS_MESH_SHAPE", raising=False)
    monkeypatch.delenv("CS_DISABLE_MESH", raising=False)
    return monkeypatch


def _grid(H, W, seed, holes=0.05):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < holes] = 0.0
    return g, rng


def _main_cells(g, rng, n):
    """n random cells of the largest 8-connected component."""
    from scipy.ndimage import label
    lab, _ = label(g > 0, structure=np.ones((3, 3)))
    main = np.argmax(np.bincount(lab.ravel())[1:]) + 1
    cells = []
    while len(cells) < n:
        r, c = rng.integers(0, g.shape[0]), rng.integers(0, g.shape[1])
        if lab[r, c] == main:
            cells.append((r, c))
    return np.asarray(cells, np.int64)


def _single(monkeypatch):
    monkeypatch.setenv("CS_DISABLE_MESH", "1")


def _meshed(monkeypatch):
    monkeypatch.delenv("CS_DISABLE_MESH", raising=False)


# --- the mesh itself --------------------------------------------------------

@pytest.mark.parametrize("shape", [None, "4,2", "8,1", "1,8"])
def test_mesh_axes_match_jax(vmesh, shape):
    if shape:
        vmesh.setenv("CS_MESH_SHAPE", shape)
    m = tm.make_mesh(8)
    j = jm.make_mesh(8)
    assert m.axis_names == tuple(j.axis_names) == ("nodes", "batch")
    assert m.shape == dict(j.shape)
    assert m.size == 8 and m.lead == torch.device("cpu")


def test_mesh_shape_override_must_match(vmesh):
    vmesh.setenv("CS_MESH_SHAPE", "3,2")
    with pytest.raises(ValueError):
        tm.make_mesh(8)
    with pytest.raises(ValueError):
        jm.make_mesh(8)


def test_active_mesh_reads_env_at_call_time(vmesh):
    assert tm.active_mesh(100, "cpu").shape == {"nodes": 2, "batch": 4}
    # a job on another device type never takes the CPU mesh
    assert tm.active_mesh(100, "cuda") is None
    vmesh.delenv("CS_FORCE_MESH")
    assert tm.active_mesh(100, "cpu") is None
    assert tm.active_mesh(65536, "cpu") is not None
    vmesh.setenv("CS_MESH_MIN_CELLS", "1000")
    assert tm.active_mesh(1000, "cpu") is not None
    vmesh.setenv("CS_DISABLE_MESH", "1")
    assert tm.active_mesh(10 ** 8, "cpu") is None
    vmesh.setattr(tm, "visible_devices", lambda: CPU8[:1])
    vmesh.delenv("CS_DISABLE_MESH")
    assert tm.active_mesh(10 ** 8, "cpu") is None


def test_active_mesh_on_cuda_only_past_one_card(vmesh):
    """Over CUDA devices a job takes the mesh by default only when its
    grid would not fit one card's free memory at CARD_BYTES_PER_CELL;
    CS_FORCE_MESH and CS_MESH_MIN_CELLS still turn it on.  (The devices
    are only named here: nothing is allocated on them.)"""
    cards = [torch.device("cuda", i) for i in range(4)]
    vmesh.setattr(tm, "visible_devices", lambda: list(cards))
    vmesh.setattr(tm, "_free_bytes", lambda d: 80 * 10 ** 9)
    fits = 80 * 10 ** 9 // tm.CARD_BYTES_PER_CELL
    assert tm.active_mesh(fits, "cuda").shape == {"nodes": 2, "batch": 2}
    vmesh.delenv("CS_FORCE_MESH")
    assert tm.active_mesh(10 ** 6, "cuda") is None
    assert tm.active_mesh(fits, "cuda") is None
    assert tm.active_mesh(fits + 1, "cuda").lead == cards[0]
    vmesh.setenv("CS_MESH_MIN_CELLS", "1000")
    assert tm.active_mesh(1000, "cuda") is not None
    assert tm.active_mesh(1000, "cpu") is None


@pytest.mark.parametrize("shape", [(63, 17), (5, 63, 17), (8, 64, 3)])
def test_pad_to_mesh_matches_jax(vmesh, shape):
    a = np.random.default_rng(0).random(shape)
    got = tm.pad_to_mesh(a, tm.make_mesh(8))
    np.testing.assert_array_equal(got, jm.pad_to_mesh(a, jm.make_mesh(8)))
    if a.ndim == 3:
        assert got.shape[0] % 4 == 0
    assert got.shape[-2] % 2 == 0


# --- blocks and the halo-exchange stencil -----------------------------------

def test_mesh_block_layout_and_sums(vmesh):
    """Split and gather round-trip; elementwise arithmetic with scalars,
    per-column factors and planes; per-column sums; the whole block's
    maximum; anything else raises."""
    mesh = tm.make_mesh(8)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((8, 32, 10)))
    p = torch.as_tensor(rng.random((32, 10)))
    a = torch.as_tensor(rng.random(8))
    b = tm.shard_rhs(mesh, x)
    assert b.shape == (8, 32, 10) and b.nsh == 2
    assert b.col_counts == (2, 2, 2, 2) and b.row_counts == (16, 16)
    torch.testing.assert_close(b.gather(), x, rtol=0, atol=0)
    pb = tm.MeshBlock.split(p, mesh, 2, batched=False)
    y = 2.0 * b - a[:, None, None] * (pb[None] * b) + 1.0
    ref = 2.0 * x - a[:, None, None] * (p[None] * x) + 1.0
    torch.testing.assert_close(y.gather(), ref, rtol=0, atol=0)
    z = torch.where(pb[None] > 0.5, 0.0, b / 3.0)
    torch.testing.assert_close(z.gather(),
                               torch.where(p[None] > 0.5, 0.0, x / 3.0),
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.sum(b * b, dim=(-2, -1)),
                               torch.sum(x * x, dim=(-2, -1)))
    assert float(torch.max(pb)) == float(torch.max(p))
    with pytest.raises(TypeError):
        torch.matmul(b, b)


def test_mesh_block_inplace_ops_rebind(vmesh):
    """The in-place forms the CG body writes its buffers with (copy_,
    add_, sub_, zero_, out= on torch.add, torch.sub and torch.sum,
    torch.empty_like): each rebinds the block's parts to new tensors,
    never writing a part, and gives the out-of-place op's values."""
    mesh = tm.make_mesh(8)
    rng = np.random.default_rng(2)
    x, y = (torch.as_tensor(rng.standard_normal((8, 32, 10)),
                            dtype=torch.float32) for _ in range(2))
    a = torch.as_tensor(rng.random(8), dtype=torch.float32)
    bx, by = tm.shard_rhs(mesh, x), tm.shard_rhs(mesh, y)
    e = torch.empty_like(bx)
    assert isinstance(e, tm.MeshBlock) and e.shape == bx.shape
    for op, ref in (
            (lambda b: b.copy_(by), y),
            (lambda b: b.add_(a[:, None, None] * by),
             x + a[:, None, None] * y),
            (lambda b: b.sub_(by), x - y),
            (lambda b: b.zero_(), torch.zeros_like(x)),
            (lambda b: torch.add(by, 2.0 * b, out=b), y + 2.0 * x),
            (lambda b: torch.sub(by, b, out=b), y - x),
            (lambda b: b.copy_(x.double()), x)):
        b = tm.shard_rhs(mesh, x)
        before = [t for row in b.parts for t in row]
        kept = [t.clone() for t in before]
        assert op(b) is b
        after = [t for row in b.parts for t in row]
        assert all(t is not u for t, u in zip(after, before))
        assert all(torch.equal(t, u) for t, u in zip(before, kept))
        torch.testing.assert_close(b.gather(), ref, rtol=0, atol=0)
    out = torch.empty(8)
    assert torch.sum(bx * bx, dim=(-2, -1), out=out) is out
    torch.testing.assert_close(out, (bx * bx).colsum(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shard_matvec_matches_single_device_and_jax(vmesh, dtype):
    """The halo-exchange matvec equals the single-device stencil matvec
    cell for cell (the halo rows replace the zero fill at the seams),
    and the JAX package's shard_map matvec to F32_TOL."""
    rng = np.random.default_rng(3)
    H, W, B = 128, 96, 8
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.1] = 0.0
    planes = tst.stencil_planes_np(g, False, False)
    A = tst.operator_from_numpy(planes, dtype)
    x = rng.standard_normal((B, H, W))
    xt = torch.as_tensor(x, dtype=dtype)
    ss = tm.build_shard_stencil(tm.make_mesh(8), A)
    assert ss.nsh == 2 and ss.h_local == 64
    assert ss.ops[0][0].we.shape == (66, 96)
    y = tm.shard_matvec(ss, tm.shard_rhs(ss.mesh, xt)).gather()
    torch.testing.assert_close(y, tst.stencil_matvec(A, xt), rtol=0, atol=0)

    S = jst.stencil_from_gmap(g, False, False, jnp.float32)
    jss = jm.build_shard_stencil(jm.make_mesh(8), S, want_pallas=False)
    S2 = jst.StencilOperator(S.we, S.ws, S.wse, S.wne, S.diag, None, jss)
    ref = np.asarray(jst.stencil_matvec(S2, jnp.asarray(x, jnp.float32)))
    assert np.abs(y.numpy() - ref).max() <= F32_TOL * np.abs(ref).max()


def test_shard_stencil_refuses_short_shards(vmesh):
    mesh = tm.make_mesh(8)
    A = tst.operator_from_numpy(
        tst.stencil_planes_np(np.ones((14, 9)), False, False))
    assert tm.build_shard_stencil(mesh, A) is None       # 7 rows a shard
    with pytest.raises(ValueError):
        tm.shard_stencil(mesh, A)


@pytest.mark.parametrize("B", [8, 3])
def test_node_currents_on_mesh_match_single_device(vmesh, B):
    """Node currents over the mesh (halo voltages, the cutoff's max over
    every shard first), with finite grounds, equal the single-device
    ones; B = 3 does not split over 'batch' and runs as one group."""
    g, rng = _grid(64, 40, 4)
    A = tst.operator_from_numpy(tst.stencil_planes_np(g, False, False),
                                torch.float64)
    ss = tm.build_shard_stencil(tm.make_mesh(8), A)
    V = torch.as_tensor(rng.standard_normal((B, 64, 40)))
    V[:, 20:40] *= 1e-7     # a band of tiny branch currents near the cutoff
    fg = torch.as_tensor(rng.random((64, 40)) * (rng.random((64, 40)) < .1))
    got = tst.stencil_node_currents(ss, V, fg=fg)
    ref = tst.stencil_node_currents(A, V, fg=fg)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# --- the hierarchy ----------------------------------------------------------

def _j_sharded(a) -> bool:
    spec = getattr(a.sharding, "spec", ())
    return len(spec) > 0 and spec[0] == "nodes"


@pytest.mark.parametrize("shape", [(300, 200), (96, 96)])
def test_shard_hierarchy_places_levels_as_jax(vmesh, shape):
    """The mesh setup pads rows to lcm(128, 8 x nodes), shards the same
    levels over 'nodes' as the JAX package (and holds the others whole),
    with the same float32 arrays and lams, and the fine level's halo
    rows."""
    g, _ = _grid(*shape, 7)
    planes = tst.stencil_planes_np(g, False, False)
    S, prec, _, sh0 = tpr.prepare_stencil_solver(planes, tm.make_mesh(8))
    Sj, precj, _, shj = jpr.prepare_stencil_solver(
        jst.stencil_planes_np(g, False, False))
    assert sh0 == shj == shape
    assert S.shape == Sj.shape and isinstance(S, tm.ShardStencil)
    full = S.full()
    for k, name in enumerate(("we", "ws", "wse", "wne", "diag")):
        np.testing.assert_array_equal(full.planes[k].numpy(),
                                      np.asarray(getattr(Sj, name)))
    assert len(prec.levels) == len(precj.levels)
    for L, Lj in zip(prec.levels, precj.levels):
        assert (L.A.nsh > 1) == _j_sharded(Lj.A.diag), L.A.shape
        assert not L.fused
        f = L.A.full()
        for k, name in enumerate(("we", "ws", "wse", "wne", "diag")):
            np.testing.assert_array_equal(f.planes[k].numpy(),
                                          np.asarray(getattr(Lj.A, name)))
        np.testing.assert_array_equal(L.inv_diag.gather().numpy(),
                                      np.asarray(Lj.inv_diag))
        assert L.lam_max == Lj.lam_max
    assert prec.coarse_shape == tuple(precj.coarse_shape)
    np.testing.assert_array_equal(prec.coarse_pinv.gather().numpy(),
                                  np.asarray(precj.coarse_pinv))


# --- solves -----------------------------------------------------------------

def test_sharded_cg_matches_single_device_and_jax(vmesh):
    """Jacobi CG over the mesh (sharded_stencil_cg) against this
    package's single-device stencil_cg and the JAX package's
    sharded_stencil_cg: solutions equal up to a per-column constant."""
    rng = np.random.default_rng(0)
    g = rng.uniform(0.5, 3.0, (64, 64))
    planes = tst.stencil_planes_np(g, False, False)
    B = np.zeros((8, 64, 64), np.float32)
    for k in range(8):
        r1, c1, r2, c2 = rng.integers(0, 64, 4)
        B[k, r1, c1] += -1
        B[k, r2, c2] += 1
    A = tst.operator_from_numpy(planes, torch.float32)
    X1, rel1, it1 = tst.stencil_cg(A, torch.as_tensor(B), itmax=2000)
    mesh = tm.make_mesh(8)
    X8, rel8, it8 = tm.sharded_stencil_cg(mesh, A, torch.as_tensor(B),
                                          itmax=2000)
    S = jst.stencil_from_gmap(g, False, False, np.float32)
    jmesh = jm.make_mesh(8)
    with jmesh:
        Xj, relj, itj = jm.sharded_stencil_cg(jmesh, S, jnp.asarray(B),
                                              itmax=2000)

    def centred(a):
        a = np.asarray(a)[:, :64, :64]
        return a - a.mean(axis=(1, 2), keepdims=True)
    assert np.max(np.abs(centred(X8) - centred(X1))) < 1e-3
    assert np.max(np.abs(centred(X8) - centred(Xj))) < 1e-3
    assert np.all(rel8.numpy() < 1e-5)
    assert abs(int(it8) - int(itj)) <= 1


def test_sharded_pair_solve_matches_jax(vmesh):
    """The production pair solve (geo-MG V-cycle, mixed-precision
    refinement) on the mesh against the JAX package's mesh run and this
    package's single-device run on a 256 x 256 grid with holes: focal
    voltages to F32_TOL, and the iterations within one a pass."""
    g, rng = _grid(256, 256, 3)
    src, dst, pts = (_main_cells(g, rng, n) for n in (5, 5, 4))
    planes = tst.stencil_planes_np(g, False, False)

    _single(vmesh)
    S1, p1, a1, _ = tpr.prepare_stencil_solver_from_gmap(g, False, False,
                                                         "cpu")
    _, Vp1, rel1, _ = tst._fused_pair_solve(S1, src, dst, pts, 1e-8, 10 ** 5,
                                            p1, a1, 4)
    _meshed(vmesh)
    S8, p8, a8, _ = tpr.prepare_stencil_solver(planes, tm.make_mesh(8))
    assert tm.mesh_of(S8) is not None
    stats.reset()
    X8, Vp8, rel8, it8 = tst._fused_pair_solve(S8, src, dst, pts, 1e-8,
                                               10 ** 5, p8, a8, 4)
    passes = stats.JOB["pass_iters"]
    assert X8.shape == (8, 256, 256)       # 5 columns padded to 8
    assert np.all(rel8 < 1e-6) and np.all(rel8[5:] == 0)
    Sj, pj, aj, _ = jpr.prepare_stencil_solver(
        jst.stencil_planes_np(g, False, False))
    _, Vpj, relj, itj = jst._fused_pair_solve(Sj, src, dst, pts, 1e-8,
                                              10 ** 5, pj, aj, 4)
    Vpj = np.asarray(Vpj)[:5]
    assert np.abs(Vp8[:5] - Vpj).max() <= F32_TOL * np.abs(Vpj).max()
    assert np.abs(Vp8[:5] - Vp1[:5]).max() <= F32_TOL * np.abs(Vpj).max()
    assert abs(it8 - int(itj)) <= len(passes)


def test_sharded_advanced_batch_matches_jax(vmesh):
    """Batched advanced solves (penalty grounds, the masked
    preconditioner) on the mesh, with the batch padded to the 'batch'
    axis, against the JAX package's mesh run.  With 1e8-scale penalties
    a pass's float32 rounding sets the next pass's right-hand side, so
    the passes after the first follow each package's own rounding (the
    JAX package's own mesh runs differ between runs): the first pass is
    held to the JAX count, and every JAX pass, replayed on this
    package's mesh from that pass's own operator, right-hand side,
    tolerance, hierarchy and penalty, stops within one iteration of
    it."""
    from test_torch_advanced import carry_hierarchy, carry_operator
    g, rng = _grid(128, 128, 11, holes=0.0)
    planes = tst.stencil_planes_np(g, False, False)
    nb, K = 3, 2       # 3 columns: NOT a multiple of the batch axis
    src_cells = rng.integers(0, 128, (nb, K, 2))
    src_vals = rng.uniform(0.5, 2.0, (nb, K))
    gnd_cells = rng.integers(0, 128, (nb, K, 2))

    S, prec, ap, _ = tpr.prepare_stencil_solver(planes, tm.make_mesh(8))
    gnd_vals = np.full((nb, K), tst.advanced_ground_penalty(S))
    with record_passes(keep=False, mod=tst) as t:
        X, rel, _ = tst.stencil_solve_advanced_batch(
            S, src_cells, src_vals, gnd_cells, gnd_vals, rtol=1e-7,
            prec=prec, prec_apply=ap)
    Sj, pj, apj, _ = jpr.prepare_stencil_solver(
        jst.stencil_planes_np(g, False, False))
    assert tst.advanced_ground_penalty(S) == jst.advanced_ground_penalty(Sj)
    with record_passes(keep=True, mod=jst) as j:
        Xj, relj, _ = jst.stencil_solve_advanced_batch(
            Sj, src_cells, src_vals, gnd_cells, gnd_vals, rtol=1e-7,
            prec=pj, prec_apply=apj)
    assert X.shape == (4, 128, 128) and rel.shape == (3,)
    assert np.all(rel < 1e-5)
    assert abs(t.iters[0] - j.iters[0]) <= 1
    mesh = tm.make_mesh(8)
    for ((A, B, rtol), k), n in zip(j.calls, j.iters):
        _, _, it = t.real(
            tm.build_shard_stencil(mesh, carry_operator(A)),
            tm.shard_rhs(mesh, torch.as_tensor(np.array(B))), rtol,
            itmax=k["itmax"],
            prec=tm.shard_hierarchy(mesh, carry_hierarchy(k["prec"])),
            prec_apply=tmg.geomg_apply,
            pen=tm.shard_rhs(mesh, torch.as_tensor(np.array(k["pen"]))))
        assert abs(int(it) - n) <= 1
    Xj = np.asarray(Xj)[:nb]
    assert np.abs(X.numpy()[:nb] - Xj).max() <= F32_TOL * np.abs(Xj).max()


def test_odd_local_rows_on_a_sharded_level(vmesh):
    """1152 x 128 on eight 'nodes' shards: level 4 (72 x 8) shards with 9
    rows each, so its restriction pairs rows across a seam.  The port
    joins that level's residual rows before restricting (the next level,
    the coarse grid, is whole); the solve matches the single-device one
    and the JAX package's mesh run."""
    vmesh.setenv("CS_MESH_SHAPE", "8,1")
    g, rng = _grid(1152, 128, 5)
    planes = tst.stencil_planes_np(g, False, False)
    S, prec, ap, _ = tpr.prepare_stencil_solver(planes, tm.make_mesh(8))
    odd = [L.A for L in prec.levels if L.A.nsh > 1 and L.A.h_local % 2]
    assert [a.shape for a in odd] == [(72, 8)] and odd[0].h_local == 9
    src, dst, pts = (_main_cells(g, rng, n) for n in (2, 2, 3))
    stats.reset()
    _, Vp, rel, it = tst._fused_pair_solve(S, src, dst, pts, 1e-8, 10 ** 5,
                                           prec, ap, 4)
    passes = len(stats.JOB["pass_iters"])
    _single(vmesh)
    S1, p1, a1, _ = tpr.prepare_stencil_solver_from_gmap(g, False, False,
                                                         "cpu")
    _, Vp1, _, _ = tst._fused_pair_solve(S1, src, dst, pts, 1e-8, 10 ** 5,
                                         p1, a1, 4)
    _meshed(vmesh)
    Sj, pj, aj, _ = jpr.prepare_stencil_solver(
        jst.stencil_planes_np(g, False, False))
    _, Vpj, _, itj = jst._fused_pair_solve(Sj, src, dst, pts, 1e-8, 10 ** 5,
                                           pj, aj, 4)
    Vpj = np.asarray(Vpj)[:2]
    assert np.all(rel[:2] < 1e-6)
    assert np.abs(Vp[:2] - Vpj).max() <= F32_TOL * np.abs(Vpj).max()
    assert np.abs(Vp[:2] - Vp1[:2]).max() <= F32_TOL * np.abs(Vpj).max()
    assert abs(it - int(itj)) <= passes


# --- the streamed build -----------------------------------------------------

@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("last", [True, False])
def test_coarsen_planes_slab_matches_jax(first, last):
    rng = np.random.default_rng(2)
    planes = [rng.random((12, 9)) * (rng.random((12, 9)) < 0.8)
              for _ in range(4)]
    got = tmg._coarsen_planes_slab(*planes, first=first, last=last)
    ref = jmg._coarsen_planes_slab(*planes, first=first, last=last)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _mkmap(side=160, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (side, side))
    g[rng.random((side, side)) < 0.10] = 0.0
    return g


def _assert_same_levels(a, b, jax_side=False):
    for La, Lb in zip(a.levels, b.levels):
        fa = La.A.full()
        for k, name in enumerate(("we", "ws", "wse", "wne", "diag")):
            pb = (np.asarray(getattr(Lb.A, name)) if jax_side else
                  Lb.A.full().planes[k].numpy())
            np.testing.assert_array_equal(fa.planes[k].numpy(), pb,
                                          err_msg=f"{La.A.shape} {name}")
        ib = (np.asarray(Lb.inv_diag) if jax_side else
              Lb.inv_diag.gather().numpy())
        np.testing.assert_array_equal(La.inv_diag.gather().numpy(), ib)


@pytest.mark.parametrize("four", [False, True])
def test_streamed_matches_materialized_and_jax(vmesh, four):
    """The shard-local streamed build equals the materialized mesh build
    and the JAX package's streamed build array for array: the float64
    operator, every level's float32 planes and inverse diagonal (level 1
    from the slab coarsener with the NE carry), the coarse
    pseudo-inverse."""
    g = _mkmap()
    mesh = tm.make_mesh(8)
    S_s, p_s, _, sh_s = tpr.prepare_stencil_solver_streamed(
        g, False, four, mesh)
    S_m, p_m, _, sh_m = tpr.prepare_stencil_solver(
        tst.stencil_planes_np(g, False, four), mesh)
    S_j, p_j, _, sh_j = jpr.prepare_stencil_solver_streamed(
        g, False, four, jm.make_mesh(8))
    assert sh_s == sh_m == sh_j
    fs, fm = S_s.full(), S_m.full()
    for k, name in enumerate(("we", "ws", "wse", "wne", "diag")):
        np.testing.assert_array_equal(fs.planes[k].numpy(),
                                      fm.planes[k].numpy())
        np.testing.assert_array_equal(fs.planes[k].numpy(),
                                      np.asarray(getattr(S_j, name)))
    assert len(p_s.levels) == len(p_m.levels) == len(p_j.levels)
    assert [L.A.nsh for L in p_s.levels] == [L.A.nsh for L in p_m.levels]
    _assert_same_levels(p_s, p_m)
    # the JAX streamed fine level keeps placeholder weight planes (its
    # shard_map reads the halo copies): its diagonal and inverse there,
    # every array of levels 1 and down
    f0, L0 = p_s.levels[0], p_j.levels[0]
    np.testing.assert_array_equal(f0.A.full().diag.numpy(),
                                  np.asarray(L0.A.diag))
    np.testing.assert_array_equal(f0.inv_diag.gather().numpy(),
                                  np.asarray(L0.inv_diag))
    assert f0.lam_max == L0.lam_max
    _assert_same_levels(type(p_s)(p_s.levels[1:], p_s.coarse_pinv,
                                  p_s.coarse_shape),
                        type(p_j)(p_j.levels[1:], p_j.coarse_pinv,
                                  p_j.coarse_shape), jax_side=True)
    np.testing.assert_array_equal(p_s.coarse_pinv.gather().numpy(),
                                  np.asarray(p_j.coarse_pinv))


def test_streamed_solve_answers(vmesh):
    g = _mkmap(seed=5)
    mesh = tm.make_mesh(8)
    S_s, p_s, a_s, _ = tpr.prepare_stencil_solver_streamed(
        g, False, False, mesh)
    from scipy import ndimage
    lab, _ = ndimage.label(g > 0, structure=np.ones((3, 3)))
    main = np.argmax(np.bincount(lab.ravel())[1:]) + 1
    cells = np.argwhere(lab == main)
    X, rel, _ = tst.stencil_solve_pairs(S_s, cells[:1], cells[-1:],
                                        rtol=1e-6, prec=p_s, prec_apply=a_s)
    assert np.all(rel < 1e-4)
    Sj, pj, aj, _ = jpr.prepare_stencil_solver_streamed(
        g, False, False, jm.make_mesh(8))
    Xj, relj, _ = jst.stencil_solve_pairs(Sj, cells[:1], cells[-1:],
                                          rtol=1e-6, prec=pj, prec_apply=aj)

    def v(X):
        X = np.asarray(X)
        return X[0, cells[-1][0], cells[-1][1]] - X[0, cells[0][0],
                                                    cells[0][1]]
    assert abs(v(X) - v(Xj)) <= F32_TOL * max(1.0, abs(v(Xj)))


def test_stream_build_threshold_routes(vmesh):
    """prepare_stencil_solver_from_gmap on a mesh takes the streamed
    build above CS_STREAM_BUILD_MIN (read at call time) and the
    materialized one below; the same arrays either way."""
    g = _mkmap(side=150)
    out = {}
    for label, lim in (("streamed", "1"), ("materialized", "100000000")):
        vmesh.setenv("CS_STREAM_BUILD_MIN", lim)
        stats.reset()
        out[label] = tpr.prepare_stencil_solver_from_gmap(
            g, False, False, "cpu")
        assert (stats.JOB["mg_build"] == "host streamed") == \
            (label == "streamed")
    _assert_same_levels(out["streamed"][1], out["materialized"][1])


def test_pen_setup_falls_back_on_mesh(vmesh):
    """Under a mesh the pen-aware setup returns pen_host None (the
    sharded hierarchy carries no penalty), as the JAX package's does."""
    g = _mkmap(side=130)
    spec = np.zeros(g.shape)
    spec[5, 5] = np.inf
    out = tpr.prepare_stencil_solver_from_gmap_pen(g, False, False, spec,
                                                   "cpu")
    ref = jpr.prepare_stencil_solver_from_gmap_pen(g, False, False, spec)
    assert out[4] is None and ref[4] is None
    assert isinstance(out[0], tm.ShardStencil)


def test_chunk_budget_counts_every_shard(vmesh, monkeypatch):
    """Chunks size by the smallest free memory over the mesh's devices:
    on virtual shards every shard's bytes count against the one
    device."""
    from circuitscape_tpu_torch.solve import dispatch
    monkeypatch.delenv("CS_SHORTCUT_CHUNK_BYTES", raising=False)
    monkeypatch.setattr(dispatch, "_free_bytes", lambda d: 8 * 10 ** 9)
    mesh = tm.make_mesh(8)
    one = dispatch.solve_chunk_budget(100, torch.device("cpu"))
    assert dispatch.solve_chunk_budget(100, torch.device("cpu"),
                                       mesh=mesh) == one
    real = tm.Mesh([[torch.device("cpu", 0), torch.device("cpu", 1)]])
    monkeypatch.setattr(dispatch, "_free_bytes",
                        lambda d: (4 if d.index else 8) * 10 ** 9)
    assert dispatch.solve_chunk_budget(100, torch.device("cpu"),
                                       mesh=real) == int(0.9 * 8 * 10 ** 9)
