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
