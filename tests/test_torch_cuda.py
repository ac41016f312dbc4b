"""The CUDA kernels of circuitscape_tpu_torch against their plain versions,
on the card.  Marked `cuda`: they skip without a CUDA device.  On a
machine with one (which need not have JAX), run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor circuitscape_tpu."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 1e-5   # max |kernel - plain| <= TOL * max |plain|: f32 sum order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _operator(H, W, dev, seed=0):
    from circuitscape_tpu_torch.solve.stencil import (
        _to_dtype, stencil_from_gmap_device)
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.15] = 0.0
    A = _to_dtype(stencil_from_gmap_device(torch.as_tensor(g, device=dev),
                                           False, False), torch.float32)
    dinv = torch.where(A.diag > 0, 1.0 / torch.where(A.diag == 0, 1.0,
                                                     A.diag), 0.0)
    blocks = [torch.randn((4,) + (H, W), generator=torch.Generator(
        device=dev).manual_seed(seed + k), device=dev) for k in range(3)]
    return A, dinv.contiguous(), blocks


def _close(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.parametrize("B", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(37, 53), (64, 100)])
def test_kernels_match_plain(dev, B, shape):
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    A, dinv, (x, b, d) = _operator(*shape, dev)
    x, b, d = x[:B].contiguous(), b[:B].contiguous(), d[:B].contiguous()
    cs.reset_launch_counts()
    _close(cs.matvec(A, x), cs.matvec_plain(A, x))
    _close(cs.matvec_pap(A, x), cs.matvec_pap_plain(A, x))
    _close(cs.cheb_step(A, dinv, b, d, x, 0.37, 1.21),
           cs.cheb_step_plain(A, dinv, b, d, x, 0.37, 1.21))
    _close(cs.residual_restrict(A, b, x), cs.residual_restrict_plain(A, b, x))
    c, ca, cb = 0.8, 0.33, 1.07
    _close(cs.cheb_init(A, dinv, b, c, ca, cb),
           cs.cheb_init_plain(A, dinv, b, c, ca, cb))
    _close(cs.residual_init(A, dinv, b, x, c),
           cs.residual_init_plain(A, dinv, b, x, c))
    _close(cs.cheb_finish(A, dinv, d, x, c, ca, cb),
           cs.cheb_finish_plain(A, dinv, d, x, c, ca, cb))
    torch.cuda.synchronize()
    assert all(n == 1 for n in cs.LAUNCHES.values())


def test_wrappers_refuse_what_kernels_do_not_take(dev):
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    A, dinv, (x, b, _) = _operator(16, 16, dev)
    with pytest.raises(ValueError):
        cs.matvec(A, x.double())
    with pytest.raises(ValueError):
        cs.matvec(A, x[:, :, :8])
    with pytest.raises(ValueError):
        cs.matvec(A, x.transpose(1, 2))
    with pytest.raises(ValueError):
        cs.cheb_init(A, dinv.double(), b, 0.8, 0.3, 1.1)
    with pytest.raises(ValueError):
        cs.residual_init(A, dinv, b[:, :, :8], x[:, :, :8], 0.8)
    with pytest.raises(ValueError):
        cs.cheb_finish(A, dinv, x.transpose(1, 2), b, 0.8, 0.3, 1.1)


def test_glue_wrappers_refuse_what_kernels_do_not_take(dev):
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    x, r, p = _blocks(4, 16, 16, dev, 3)
    col = torch.ones(4, device=dev)
    stop = torch.empty(2, device=dev)
    with pytest.raises(ValueError):
        cs.cg_update_xr(x.double(), r, p, r, col, col, False)
    with pytest.raises(ValueError):
        cs.cg_update_xr(x, r, p, r[:, :, :8], col, col, False)
    with pytest.raises(ValueError):
        cs.cg_update_p(p.transpose(1, 2), x, col)
    with pytest.raises(ValueError):
        cs.cg_update_p(p, x, col[:3])
    with pytest.raises(ValueError):
        cs.cg_dots(r, x, col, col.clone(), col.double(), col, stop)
    with pytest.raises(ValueError):
        cs.prolong_add(x, x[:, :8, :8].contiguous()[:, :7], 1.9)
    with pytest.raises(ValueError):
        cs.prolong_add(x, x[:, :8, :8].double(), 1.9)


@pytest.mark.parametrize("B", [1, 5, 40])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (31, 33), (37, 53),
                                   (1024, 1024)])
def test_glue_kernels_match_plain(dev, B, shape):
    """The CG and V-cycle glue kernels (csrc/cg_kernels.cu) against their
    plain versions run by torch on the card (chip_smoke.check_glue):
    elementwise outputs to the bit, cg_dots's sums within TOL and
    repeating to the bit, the zero guards (pAp = 0 in column 0), odd and
    cropped grids."""
    from chip_smoke import _glue_pairs, check_glue
    for name, (kern, plain, _) in _glue_pairs(B, *shape, dev,
                                              seed=B).items():
        check_glue(name, kern, plain, f"B={B} {shape}")


# the staged kernels (tiles in shared memory, a chunk of the batch per
# block): every tile edge, odd sides, widths that are not a multiple of 32
# or 4, the coarse level where the V-cycle runs matvec and cheb_step, and
# the wide-grid width the TPU kernels tile by columns (pallas_stencil.py:
# 357, 911)
STAGED_SHAPES = [(1, 1), (2, 3), (31, 33), (32, 32), (37, 53), (64, 100),
                 (129, 257), (257, 333), (64, 4200)]


def _blocks(B, H, W, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, H, W), generator=g, device=dev)
            for _ in range(3)]


def _staged_match_plain(A, dinv, x, b, d):
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    _close(cs.residual_restrict(A, b, x), cs.residual_restrict_plain(A, b, x))
    _close(cs.matvec(A, x), cs.matvec_plain(A, x))
    _close(cs.matvec_pap(A, x), cs.matvec_pap_plain(A, x))
    _close(cs.cheb_step(A, dinv, b, d, x, 0.37, 1.21),
           cs.cheb_step_plain(A, dinv, b, d, x, 0.37, 1.21))
    c, ca, cb = 0.8, 0.33, 1.07
    _close(cs.cheb_init(A, dinv, b, c, ca, cb),
           cs.cheb_init_plain(A, dinv, b, c, ca, cb))
    _close(cs.cheb_finish(A, dinv, b, x, c, ca, cb),
           cs.cheb_finish_plain(A, dinv, b, x, c, ca, cb))


@pytest.mark.parametrize("B", [1, 2, 3, 5, 8, 32])
@pytest.mark.parametrize("shape", STAGED_SHAPES)
def test_staged_kernels_match_plain(dev, B, shape):
    A, dinv, _ = _operator(*shape, dev)
    x, b, d = _blocks(B, *shape, dev, seed=B)
    _staged_match_plain(A, dinv, x, b, d)
    torch.cuda.synchronize()


def test_staged_kernels_match_plain_at_fine_level(dev):
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    A, dinv, _ = _operator(1024, 1024, dev)
    x, b, d = _blocks(32, 1024, 1024, dev, seed=5)
    _staged_match_plain(A, dinv, x, b, d)
    # b one float off an 8-byte boundary: the scalar path of b's patch
    bb = torch.empty(b.numel() + 1, device=dev)
    bb[1:] = b.reshape(-1)
    b1 = bb[1:].view(b.shape)
    _close(cs.residual_restrict(A, b1, x), cs.residual_restrict_plain(A, b, x))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(37, 53), (1024, 1024)])
def test_matvec_pap_repeats_to_the_bit(dev, shape):
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    A, _, _ = _operator(*shape, dev)
    x = _blocks(32, *shape, dev, seed=9)[0]
    y1, p1 = cs.matvec_pap(A, x)
    y2, p2 = cs.matvec_pap(A, x)
    assert torch.equal(p1, p2) and torch.equal(y1, y2)


@pytest.mark.parametrize("per_column", [False, True])
def test_poly_project_repeats_and_matches_cpu(dev, per_column):
    """The polygon projector's torch glue on the card: poly_project and
    poly_sum give the same bits on two calls and agree with the CPU, on
    a shared (1024^2, B = 32) and a per-column (three rows) projector."""
    from circuitscape_tpu_torch.solve import stencil as st
    rng = np.random.default_rng(3)
    H = W = 1024 if not per_column else 96
    nm = np.arange(1, H * W + 1).reshape(H, W)
    rows = []
    for k in range(3 if per_column else 1):
        m = nm.copy()
        for _ in range(5):
            r, c = rng.integers(0, H - 9, 2)
            m[r:r + 9, c:c + 9] = m[r, c]
        rows.append(m)
    build = ((lambda d: st.build_poly_projector_rows(rows, (H, W), d))
             if per_column else
             (lambda d: st.build_poly_projector(rows[0], (H, W), d)))
    proj, ref = build(dev), build("cpu")
    x = torch.as_tensor(rng.standard_normal((len(rows) if per_column else
                                             32, H, W)), dtype=torch.float32)
    for fn in (st.poly_project, st.poly_sum):
        a, b = fn(proj, x.to(dev)), fn(proj, x.to(dev))
        assert torch.equal(a, b)
        _close(a.cpu(), fn(ref, x))


def _pen_grid(H, W, seed=4):
    """A conductance map with 6 direct grounds (inf) and 6 finite ones."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.1] = 0.0
    act = np.argwhere(g > 0)
    pick = act[rng.choice(len(act), 12, replace=False)]
    cond = np.zeros((H, W))
    cond[pick[:6, 0], pick[:6, 1]] = np.inf
    cond[pick[6:, 0], pick[6:, 1]] = 0.5
    return g, cond


@pytest.mark.parametrize("B", [1, 8])
def test_kernels_match_plain_on_pen_hierarchy(dev, B):
    """Every kernel on every level of a penalty-baked hierarchy (ground
    conductances up to 1e8 times the grid's in the diagonal), per cell:
    |kernel - plain| <= TOL * (|plain| + max |plain| over unpenalized
    cells); matvec_pap's p.Ap per column."""
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.solve.geomg import (_diag_from_planes_torch,
                                                    _restrict)
    from circuitscape_tpu_torch.solve.prepare import \
        prepare_stencil_solver_from_gmap_pen
    g, cond = _pen_grid(200, 230)
    _, prec, _, _, _ = prepare_stencil_solver_from_gmap_pen(
        g, False, False, cond, dev)
    c, ca, cb = 0.8, 0.33, 1.07
    for lvl, L in enumerate(prec.levels):
        A, dinv, (H, W) = L.A, L.inv_diag, L.A.shape
        pen = (A.diag - _diag_from_planes_torch(A.we, A.ws, A.wse,
                                                A.wne)) > 0
        assert pen.any()
        coarse = _restrict(pen[None].float())[0] > 0
        x, b, d = _blocks(B, H, W, dev, seed=lvl)
        for got, ref in (
                (cs.matvec(A, x), cs.matvec_plain(A, x)),
                (cs.matvec_pap(A, x), cs.matvec_pap_plain(A, x)),
                (cs.cheb_step(A, dinv, b, d, x, 0.37, 1.21),
                 cs.cheb_step_plain(A, dinv, b, d, x, 0.37, 1.21)),
                (cs.residual_restrict(A, b, x),
                 cs.residual_restrict_plain(A, b, x)),
                (cs.cheb_init(A, dinv, b, c, ca, cb),
                 cs.cheb_init_plain(A, dinv, b, c, ca, cb)),
                (cs.residual_init(A, dinv, b, x, c),
                 cs.residual_init_plain(A, dinv, b, x, c)),
                (cs.cheb_finish(A, dinv, b, x, c, ca, cb),
                 cs.cheb_finish_plain(A, dinv, b, x, c, ca, cb))):
            for g_, r_ in zip(got if isinstance(got, tuple) else (got,),
                              ref if isinstance(ref, tuple) else (ref,)):
                if r_.dim() == 1:
                    scale = r_.abs()
                else:
                    m = pen if r_.shape[-2:] == (H, W) else coarse
                    scale = r_.abs() + r_.abs()[:, ~m].max()
                assert float(((g_ - r_).abs() / scale).max()) <= TOL, lvl


def _scenario_job(d, scenario, H=256, W=256, npoints=8):
    """A bench-recipe raster (~10% NODATA) with npoints focal points, as
    NPY files in d, for scenario; advanced: points 1-3 sources of
    strength 1-3, 4-5 finite grounds (resistance 2), 6-8 direct grounds,
    voltage and current maps; all-to-one: per-point current maps."""
    import os
    rng = np.random.default_rng(42)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.10] = -9999.0
    pts = np.zeros((H, W))
    placed = 0
    while placed < npoints:
        r, c = rng.integers(0, H), rng.integers(0, W)
        if g[r, c] > 0 and pts[r, c] == 0:
            placed += 1
            pts[r, c] = placed
    for name, a in (("cell", g), ("pts", pts)):
        np.save(os.path.join(d, f"{name}.npy"), a)
    cfg = {"data_type": "raster", "scenario": scenario,
           "habitat_file": os.path.join(d, "cell.npy"),
           "habitat_map_is_resistances": "False",
           "point_file": os.path.join(d, "pts.npy"), "solver": "cg+amg",
           "suppress_messages": "True"}
    if scenario == "advanced":
        gnd = np.full((H, W), -9999.0)
        gnd[(pts >= 4) & (pts <= 5)] = 2.0
        gnd[pts >= 6] = 0.0
        np.save(os.path.join(d, "src.npy"), np.where(pts <= 3, pts, 0.0))
        np.save(os.path.join(d, "gnd.npy"), gnd)
        cfg.update(source_file=os.path.join(d, "src.npy"),
                   ground_file=os.path.join(d, "gnd.npy"),
                   ground_file_is_resistances="True",
                   write_volt_maps="True", write_cur_maps="True")
    elif scenario == "all-to-one":
        cfg["write_cur_maps"] = "True"
    return cfg


@pytest.mark.parametrize("scenario", ["advanced", "one-to-all",
                                      "all-to-one"])
def test_scenario_cuda_matches_cpu(dev, tmp_path, scenario):
    """The three scenarios at 256^2 on the card and on the CPU: results
    within 1e-5 (of max |cpu| for the advanced voltage grid, per point
    otherwise) and the same maps, each within 1e-5 of its max."""
    import os

    import circuitscape_tpu_torch as cst
    cfg = _scenario_job(str(tmp_path), scenario)
    out, files = {}, {}
    for d in ("cuda", "cpu"):
        od = tmp_path / d
        od.mkdir()
        out[d] = cst.compute(dict(cfg, output_file=str(od / "job.out")),
                             device=dev if d == "cuda" else "cpu")
        files[d] = sorted(f for f in os.listdir(od) if f.endswith(".asc"))
    a, b = out["cuda"], out["cpu"]
    assert a.shape == b.shape and np.all(np.isfinite(a))
    if scenario == "advanced":
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()
    else:
        assert np.all(np.abs(a - b) <= TOL * np.abs(b))
    assert files["cuda"] == files["cpu"]
    assert len(files["cpu"]) == {"advanced": 2, "one-to-all": 0,
                                 "all-to-one": 9}[scenario]
    for f in files["cpu"]:
        ga = np.loadtxt(tmp_path / "cuda" / f, skiprows=6)
        gc = np.loadtxt(tmp_path / "cpu" / f, skiprows=6)
        assert np.abs(ga - gc).max() <= TOL * np.abs(gc).max(), f


def test_native_libraries_build(dev):
    """Both host libraries build from native/*.cpp on this machine and
    load: the Cholesky (with or without a BLAS) and the text writer."""
    from circuitscape_tpu_torch.io import fastio
    from circuitscape_tpu_torch.solve import native_chol
    assert native_chol._load() is not None and fastio.load() is not None


def _network_laplacian(side=20, seed=3):
    """A side x side lattice network's Laplacian (a few hundred nodes),
    regularized as the general tier regularizes it in float32."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    n = side * side
    i0 = np.arange(n)
    E = np.vstack([np.column_stack([i0[i0 + o < n], (i0 + o)[i0 + o < n]])
                   for o in (1, side)])
    A = sp.coo_matrix((rng.uniform(0.5, 3.0, len(E)), (E[:, 0], E[:, 1])),
                      shape=(n, n)).tocsr()
    A = A + A.T
    L = (sp.diags(np.asarray(A.sum(axis=1)).ravel()) - A).tocsr()
    L = L.astype(np.float32)
    L.data = L.data + np.finfo(np.float32).eps * np.linalg.norm(L.data)
    return L


@pytest.mark.parametrize("B", [1, 3, 32])
def test_cg_context_cuda_matches_cpu(dev, B):
    """CGContext (ELL PCG with the SA-AMG V-cycle) on the card against
    the CPU at 400 nodes: pair solutions, normalized to their sources,
    within 1e-5 of max, and CG iterations within one of the CPU's."""
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve.dispatch import CGContext
    L = _network_laplacian()
    n = L.shape[0]
    rng = np.random.default_rng(B)
    rhs = np.zeros((n, B), np.float32)
    src = rng.choice(n, B)
    for c in range(B):
        dst = (src[c] + 1 + rng.integers(n - 1)) % n
        rhs[src[c], c], rhs[dst, c] = -1, 1
    out, iters = {}, {}
    for d in (dev, "cpu"):
        stats.reset()
        x = CGContext(L, np.float32, d).solve(rhs)
        out[str(d)] = x - x[src, np.arange(B)][None, :]
        iters[str(d)] = stats.JOB["cg_iters"]
    g, c = out[str(dev)], out["cpu"]
    assert np.all(np.isfinite(g))
    assert np.abs(g - c).max() <= TOL * np.abs(c).max()
    assert abs(iters[str(dev)] - iters["cpu"]) <= 1


def test_host_built_route_cuda_matches_cpu(dev, tmp_path, monkeypatch):
    """The large-grid route (CS_DEVICE_MG_MAX=1: a hierarchy coarsened on
    the host under the device-built operator) for a 256^2 bench-recipe
    job with 8 points, on the card and on the CPU: resistances within
    1e-5 relative and the same CG iteration count."""
    import circuitscape_tpu_torch as cst
    from chip_smoke import make_job
    from circuitscape_tpu_torch import stats
    monkeypatch.setenv("CS_DEVICE_MG_MAX", "1")
    cfg, _ = make_job(str(tmp_path), 256, 256, npoints=8)
    out, iters = {}, {}
    for d in ("cuda", "cpu"):
        out[d] = cst.compute(dict(cfg, output_file=str(tmp_path / f"{d}.out")),
                             device=dev if d == "cuda" else "cpu")
        st = stats.finalize()
        assert st["mg_build"] == "host"
        iters[d] = st["cg_iters"]
    off = ~np.eye(8, dtype=bool)
    a, b = out["cuda"][1:, 1:][off], out["cpu"][1:, 1:][off]
    assert np.all(np.isfinite(a)) and np.all(a > 0)
    assert np.all(np.abs(a - b) <= TOL * np.abs(b))
    assert iters["cuda"] == iters["cpu"]


@pytest.mark.parametrize("name", ["matvec", "matvec_pap", "cheb_step",
                                  "residual_restrict", "cheb_init",
                                  "residual_init", "cheb_finish"])
def test_kernel_past_2_31_matches_plain(dev, name):
    """Each kernel once at B = 44 on a 7040^2 grid (2.18e9 floats a
    block, past 2^31): its first and last columns against the plain
    version run on those columns (chip_smoke.check_past_2_31)."""
    from chip_smoke import check_past_2_31
    rng = np.random.default_rng(3)
    g = rng.uniform(0.5, 3.0, (7040, 7040))
    g[rng.random(g.shape) < 0.1] = 0.0
    check_past_2_31(g, dev, {name: {"max_abs_err": 0.0}}, names=(name,))
