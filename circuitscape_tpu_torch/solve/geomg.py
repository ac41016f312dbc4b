"""Geometric multigrid preconditioner for the stencil operator, in torch.

Counterpart of circuitscape_tpu/solve/geomg.py (the device build, the
host build and the V-cycle).  Every level stays a 9-point stencil, so
the V-cycle is shifted-plane arithmetic plus 2x2 patch reductions.

Coarsening is Galerkin with a piecewise-constant 2x2-patch prolongator.
For a graph Laplacian that collapses exactly to the Laplacian of the
patch-collapsed graph: each fine directed edge either stays inside a
patch (vanishes) or adds its weight to one coarse directed edge chosen
by the parity of its endpoint coordinates.  The hierarchy builds on the
device in float32 (build_geo_mg_device) or, for grids above
CS_DEVICE_MG_MAX cells as in the JAX package, on the host in float64
with each level cast to float32 (build_geo_mg); either way the coarsest
level's dense pseudo-inverse builds on the host in float64.

Smoother: degree-2 Chebyshev on D^-1 A, symmetric V(1,1), so the cycle
is a valid SPD preconditioner for CG.  Its fine work runs in the
hand-written kernels of solve/cuda_stencil.py.  Two configurations, as
in the JAX package, which differ only in rounding:
  - fused (levels of at least 64 rows and at most 4094 columns, the
    JAX package's Pallas gates): the pre-smoother from zero is one
    cheb_init pass, the post-smoother residual_init then cheb_finish;
  - generic (other levels, or a hierarchy built with
    fused_smoother=False): an elementwise Dinv pass and the fused
    cheb_step, plus a matvec for the post-smoother's residual.
The residual + restrict of every level is one residual_restrict pass.

The generic smoother and the V-cycle reach a level only through its
operator's methods (matvec, cheb_step, residual_restrict, prolong,
coarse_solve).  On a device mesh (parallel/mesh.shard_hierarchy) each
level's operator is a ShardStencil, whose methods run per shard with
halo rows, and every level takes the generic configuration, as the JAX
package's mesh hierarchy does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_stencil import cheb_finish, cheb_init, residual_init
from .stencil import StencilOperator, _sh, operator_from_numpy, \
    stencil_matvec


@dataclass
class GeoMgLevel:
    A: StencilOperator
    inv_diag: torch.Tensor  # (H, W) plain 1/diag (0 on empty cells)
    lam_max: float          # estimate of rho(D^-1 A) for Chebyshev
    fused: bool = False     # smooths with the premultiplied-Dinv kernels


def fused_smoother_supported(shape) -> bool:
    """Levels that take the fused smoother: the JAX package's gates for
    its init planes (pallas_stencil.supported: H >= 64) and kernels
    (cheb_init_supported, warm_smooth_supported: W <= 4094), without
    their VMEM row-fit checks, which are TPU machinery."""
    H, W = shape
    return H >= 64 and W <= 4094


@dataclass
class GeoMgHierarchy:
    levels: tuple
    coarse_pinv: torch.Tensor  # (hc*wc, hc*wc)
    coarse_shape: tuple
    overcorrect: float = 1.9   # coarse-correction scaling


def _sym_pinv(A: np.ndarray) -> np.ndarray:
    """Pseudo-inverse of a symmetric PSD matrix via eigh."""
    w, V = np.linalg.eigh(A)
    cutoff = max(A.shape) * np.finfo(A.dtype).eps * np.max(np.abs(w))
    inv_w = np.where(w > cutoff, 1.0 / np.where(w == 0, 1.0, w), 0.0)
    return (V * inv_w) @ V.T


def _dense_laplacian(we, ws, wse, wne) -> np.ndarray:
    H, W = we.shape
    n = H * W
    A = np.zeros((n, n))

    def add(i, j, di, dj, w):
        a = i * W + j
        b = (i + di) * W + (j + dj)
        A[a, b] -= w
        A[b, a] -= w
        A[a, a] += w
        A[b, b] += w

    for i in range(H):
        for j in range(W):
            if j + 1 < W and we[i, j]:
                add(i, j, 0, 1, we[i, j])
            if i + 1 < H and ws[i, j]:
                add(i, j, 1, 0, ws[i, j])
            if i + 1 < H and j + 1 < W and wse[i, j]:
                add(i, j, 1, 1, wse[i, j])
            if i - 1 >= 0 and j + 1 < W and wne[i, j]:
                add(i, j, -1, 1, wne[i, j])
    return A


def _coarsen_planes_torch(we, ws, wse, wne):
    """One 2x2 Galerkin coarsening step on the device (counterpart of
    geomg._coarsen_planes_jnp): odd dims pad with a zero row/column, and
    each fine edge routes to a coarse plane by endpoint parity."""
    H, W = we.shape
    if H % 2 or W % 2:
        pads = (0, W % 2, 0, H % 2)
        we, ws, wse, wne = (F.pad(p, pads) for p in (we, ws, wse, wne))
        H, W = we.shape
    hc, wc = H // 2, W // 2

    def patch(ip, jp, p):
        return p[ip::2, jp::2][:hc, :wc]

    cE = patch(0, 1, we) + patch(1, 1, we) + patch(0, 1, wse) + \
        patch(1, 1, wne)
    cS = patch(1, 0, ws) + patch(1, 1, ws) + patch(1, 0, wse)
    cSE = patch(1, 1, wse).clone()
    cNE = patch(0, 1, wne).clone()
    # N edges from even-even NE entries land on the UPPER patch's S plane
    n_up = patch(0, 0, wne)
    cS[:-1, :] += n_up[1:, :]

    # zero the out-of-range boundaries
    cE[:, -1] = 0
    cS[-1, :] = 0
    cSE[-1, :] = 0
    cSE[:, -1] = 0
    cNE[0, :] = 0
    cNE[:, -1] = 0
    return cE, cS, cSE, cNE


def _diag_from_planes_torch(we, ws, wse, wne):
    """Laplacian diagonal from the four directed planes (counterpart of
    geomg._diag_from_planes_jnp)."""
    return (we + _sh(we[None], 0, 1)[0] +
            ws + _sh(ws[None], 1, 0)[0] +
            wse + _sh(wse[None], 1, 1)[0] +
            wne + _sh(wne[None], -1, 1)[0])


def _lam_device(A: StencilOperator, inv, iters=12) -> torch.Tensor:
    """Power iteration for rho(D^-1 A) from a deterministic
    non-eigenvector start (the JAX package's sin(0.37 k) start); a
    0-d device tensor, so a whole build fetches its lams at once."""
    H, W = A.shape
    dt = A.diag.dtype
    x = (torch.sin(torch.arange(H * W, dtype=dt, device=A.diag.device) *
                   0.37).reshape(1, H, W) + 0.01)
    x = x / torch.sqrt(torch.sum(x * x))
    lam = torch.tensor(2.0, dtype=dt, device=A.diag.device)
    for _ in range(iters):
        y = inv[None] * stencil_matvec(A, x)
        n = torch.sqrt(torch.sum(y * y))
        lam = torch.where(n == 0, torch.tensor(2.0, dtype=dt,
                                               device=n.device), n)
        x = y / (n + 1e-30)
    return torch.minimum(lam * 1.05, torch.tensor(2.0, dtype=dt,
                                                  device=lam.device))


def _coarsen_pen_torch(p: torch.Tensor) -> torch.Tensor:
    """2x2 patch sum of a diagonal (penalty) field, the exact Galerkin
    coarse diagonal P^T diag(p) P for the piecewise-constant 2x2
    prolongator (counterpart of geomg._coarsen_pen_jnp); odd dims pad
    with zeros.  Each patch adds in the window's row-major order, as
    XLA's reduce_window does, so the float32 sums agree to the bit."""
    H, W = p.shape
    if H % 2 or W % 2:
        p = F.pad(p, (0, W % 2, 0, H % 2))
    return ((p[0::2, 0::2] + p[0::2, 1::2]) + p[1::2, 0::2]) + p[1::2, 1::2]


def _build_levels_device(we, ws, wse, wne, nlevels, est_mask, pen=None):
    """Per-level coarsening, diagonals and Chebyshev lam estimates on
    the device.  pen: an optional (H, W) diagonal (ground) field, added
    to every level's diagonal and coarsened by 2x2 patch sums, so each
    level is the Galerkin coarse version of L + diag(pen) (advanced
    grounds; without it the V-cycle would precondition the floating
    Laplacian, whose near-null constant mode the grounded operator does
    not share).  Returns ([(A, inv_diag)] per level, lams (nlevels,)
    device tensor or None, coarsest (we, ws, wse, wne, pen or None))."""
    out, lams = [], []
    for lvl in range(nlevels):
        diag = _diag_from_planes_torch(we, ws, wse, wne)
        if pen is not None:
            diag = diag + pen
        inv = torch.where(diag > 0,
                          1.0 / torch.where(diag == 0, 1.0, diag), 0.0)
        A = StencilOperator(*(p.contiguous()
                              for p in (we, ws, wse, wne, diag)))
        lams.append(_lam_device(A, inv) if est_mask[lvl] else
                    torch.tensor(2.0, dtype=diag.dtype, device=diag.device))
        out.append((A, inv.contiguous()))
        we, ws, wse, wne = _coarsen_planes_torch(we, ws, wse, wne)
        if pen is not None:
            pen = _coarsen_pen_torch(pen)
    return (out, torch.stack(lams) if lams else None,
            (we, ws, wse, wne, pen))


def build_geo_mg_device(S32: StencilOperator, coarse_cells=256,
                        max_levels=12, fused_smoother=True,
                        pen=None) -> GeoMgHierarchy:
    """Hierarchy setup on the device from the (already uploaded) f32
    fine operator; only the per-level lams and the tiny coarsest planes
    (<= coarse_cells) go to the host, where the dense pseudo-inverse
    builds in f64.

    fused_smoother: the counterpart of the JAX package's expand_pallas;
    on, the levels fused_smoother_supported() admits take the
    premultiplied-Dinv smoother kernels; off, every level takes the
    generic configuration.

    pen: an optional float32 (H, W) ground field baked into every level
    (_build_levels_device) and into the coarse dense Laplacian's
    diagonal; the fine level's operator is then the f32 L + diag(pen).

    Levels above 64k cells use the Gershgorin-safe lam = 2.0 (for a
    graph Laplacian rho(D^-1 L) <= 2); smaller levels power-iterate."""
    shapes = []
    H, W = S32.shape
    while (H * W > coarse_cells and len(shapes) < max_levels and
           min(H, W) >= 2):
        shapes.append((H, W))
        H, W = -(-H // 2), -(-W // 2)
    est_mask = tuple(h * w <= 65536 for (h, w) in shapes)

    levels_raw, lams_dev, coarsest = _build_levels_device(
        S32.we, S32.ws, S32.wse, S32.wne, len(shapes), est_mask, pen)
    cpen = coarsest[4]
    planes = coarsest[:4] + ((cpen,) if cpen is not None else ())
    # one host fetch for the lams, the coarsest planes and their pen
    packed = torch.cat(
        ([lams_dev.to(torch.float64)] if lams_dev is not None else []) +
        [torch.stack(planes).to(torch.float64).ravel()]).cpu().numpy()
    lams = packed[:len(shapes)]
    levels = tuple(GeoMgLevel(A, inv, float(lam),
                              fused_smoother and
                              fused_smoother_supported(A.shape))
                   for (A, inv), lam in zip(levels_raw, lams))

    hc, wc = coarsest[0].shape
    cplanes = packed[len(shapes):].reshape(len(planes), hc, wc)
    dense = _dense_laplacian(*cplanes[:4])
    if cpen is not None:
        dense[np.diag_indices_from(dense)] += cplanes[4].ravel()
    # benign identity on empty (all-inactive) coarse cells
    empty = dense.diagonal() == 0
    dense[empty, empty] = 1.0
    pinv = torch.as_tensor(_sym_pinv(dense), dtype=S32.diag.dtype,
                           device=S32.diag.device)
    return GeoMgHierarchy(levels, pinv, (hc, wc), 1.9)


# --- host build: the JAX package's build_geo_mg, for grids above
# CS_DEVICE_MG_MAX cells (solve/prepare.py) -------------------------------

def _pad_even(p: np.ndarray) -> np.ndarray:
    H, W = p.shape
    return np.pad(p, ((0, H % 2), (0, W % 2)))


def _coarsen_planes(we, ws, wse, wne):
    """One 2x2 Galerkin coarsening step on the four directed host planes,
    in float64 (geomg._coarsen_planes of the JAX package, the same
    edge-parity routing as _coarsen_planes_torch)."""
    we, ws, wse, wne = map(_pad_even, (we, ws, wse, wne))
    H, W = we.shape
    hc, wc = H // 2, W // 2

    def patch(i_par, j_par, p):
        return p[i_par::2, j_par::2][:hc, :wc]

    cE = np.zeros((hc, wc))
    cS = np.zeros((hc, wc))
    cSE = np.zeros((hc, wc))
    cNE = np.zeros((hc, wc))
    cE += patch(0, 1, we) + patch(1, 1, we)
    cS += patch(1, 0, ws) + patch(1, 1, ws)
    cSE += patch(1, 1, wse)
    cS += patch(1, 0, wse)
    cE += patch(0, 1, wse)
    cNE += patch(0, 1, wne)
    # N edges from even-even NE entries land on the UPPER patch's S plane
    n_up = patch(0, 0, wne)
    cS[:-1, :] += n_up[1:, :]
    cE += patch(1, 1, wne)

    cE[:, -1] = 0
    cS[-1, :] = 0
    cSE[-1, :] = 0
    cSE[:, -1] = 0
    cNE[0, :] = 0
    cNE[:, -1] = 0
    return cE, cS, cSE, cNE


def _coarsen_planes_slab(we, ws, wse, wne, first: bool, last: bool):
    """_coarsen_planes for one even-aligned row slab of the fine grid
    (geomg._coarsen_planes_slab of the JAX package), for the streamed
    mesh build (solve/prepare.py): each shard's slab coarsens on its own,
    so the full fine planes never exist on the host.  Row-boundary
    zeroing applies only at the true grid edges (first / last), and the
    NE even-even contribution of the slab's first patch row, which
    belongs to the previous slab's last coarse S row, is returned as
    `carry` instead of being dropped.

    Returns (cE, cS, cSE, cNE, carry), carry a (wc,) row (zeros when
    first: the full-grid build drops it there too)."""
    H, W = we.shape
    assert H % 2 == 0, "slab height must be even"
    we, ws, wse, wne = map(_pad_even, (we, ws, wse, wne))
    H, W = we.shape
    hc, wc = H // 2, W // 2

    def patch(i_par, j_par, p):
        return p[i_par::2, j_par::2][:hc, :wc]

    cE = patch(0, 1, we) + patch(1, 1, we) + patch(0, 1, wse) + \
        patch(1, 1, wne)
    cS = patch(1, 0, ws) + patch(1, 1, ws) + patch(1, 0, wse)
    cSE = patch(1, 1, wse).copy()   # patch() returns a view
    cNE = patch(0, 1, wne).copy()
    n_up = patch(0, 0, wne)
    cS[:-1, :] += n_up[1:, :]
    carry = np.zeros(wc) if first else n_up[0, :].copy()

    cE[:, -1] = 0
    cSE[:, -1] = 0
    cNE[:, -1] = 0
    if last:
        cS[-1, :] = 0
        cSE[-1, :] = 0
    if first:
        cNE[0, :] = 0
    return cE, cS, cSE, cNE, carry


def _np_diag(we, ws, wse, wne):
    """Host Laplacian diagonal from the four directed planes."""
    diag = np.zeros(we.shape)
    diag[:, :-1] += we[:, :-1]
    diag[:, 1:] += we[:, :-1]
    diag[:-1, :] += ws[:-1, :]
    diag[1:, :] += ws[:-1, :]
    diag[:-1, :-1] += wse[:-1, :-1]
    diag[1:, 1:] += wse[:-1, :-1]
    diag[1:, :-1] += wne[1:, :-1]
    diag[:-1, 1:] += wne[1:, :-1]
    return diag


def _estimate_lam_max(we, ws, wse, wne, iters=12, pen=None) -> float:
    """Host estimate of rho(D^-1 A) for the Chebyshev interval: 12 float64
    power iterations from np.random.default_rng(0) on levels of at most
    65536 cells, the Gershgorin-safe 2.0 above (rho(D^-1 L) <= 2 for a
    graph Laplacian), as the JAX package's host build."""
    if we.size > 65536:
        return 2.0
    from .stencil import stencil_matvec_np
    diag = _np_diag(we, ws, wse, wne)
    if pen is not None:
        diag = diag + pen
    dinv = np.where(diag > 0, 1.0 / np.where(diag == 0, 1.0, diag), 0.0)
    op = StencilOperator(we, ws, wse, wne, diag)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1,) + we.shape)
    x /= np.linalg.norm(x) + 1e-30
    lam = 2.0
    for _ in range(iters):
        y = dinv[None] * stencil_matvec_np(op, x)
        nrm = np.linalg.norm(y)
        if nrm == 0:
            return 2.0
        lam = nrm
        x = y / nrm
    return float(min(lam * 1.05, 2.0))


def _coarsen_pen_np(p: np.ndarray) -> np.ndarray:
    """Host 2x2 patch sum of a diagonal penalty field (P^T diag(p) P)."""
    p = _pad_even(p)
    H, W = p.shape
    return p.reshape(H // 2, 2, W // 2, 2).sum(axis=(1, 3))


def _upload32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def build_geo_mg(planes_np, device="cpu", fine_device_ops=None,
                 pen_np=None) -> GeoMgHierarchy:
    """Hierarchy setup on the host (the JAX package's build_geo_mg): the
    levels coarsen in float64 numpy from the host planes planes_np
    (we, ws, wse, wne[, diag]), and each level's five planes and
    inv_diag are cast to float32 and uploaded to device.  The coarsest
    level's dense pseudo-inverse builds in float64, stored in float32.

    fine_device_ops: the float32 fine operator's five planes, already on
    device (the cast of the device-built float64 operator); level 0 is
    then that operator, its inv_diag computed on the device, and only
    the coarser levels are uploaded.  With pen_np, its diag must already
    include the penalty.

    pen_np: optional (H, W) float64 ground field, added to every level's
    diagonal and coarsened by 2x2 patch sums (as _build_levels_device
    does on the device).  Levels, coarsest size and smoother choice as
    build_geo_mg_device's defaults."""
    we, ws, wse, wne = (np.asarray(p, np.float64) for p in planes_np[:4])
    pen = None if pen_np is None else np.asarray(pen_np, np.float64)
    levels = []
    while (we.shape[0] * we.shape[1] > 256 and len(levels) < 12 and
           min(we.shape) >= 2):
        if not levels and fine_device_ops is not None:
            A = StencilOperator(*(p.contiguous() for p in fine_device_ops))
            inv = torch.where(A.diag > 0,
                              1.0 / torch.where(A.diag == 0, 1.0, A.diag),
                              0.0)
        else:
            diag = _np_diag(we, ws, wse, wne)
            if pen is not None:
                diag = diag + pen
            inv = np.where(diag > 0,
                           1.0 / np.where(diag == 0, 1.0, diag), 0.0)
            A = StencilOperator(*(_upload32(p, device)
                                  for p in (we, ws, wse, wne, diag)))
            inv = _upload32(inv, device)
        lam = _estimate_lam_max(we, ws, wse, wne, pen=pen)
        levels.append(GeoMgLevel(A, inv.contiguous(), lam,
                                 fused_smoother_supported(A.shape)))
        we, ws, wse, wne = _coarsen_planes(we, ws, wse, wne)
        if pen is not None:
            pen = _coarsen_pen_np(pen)

    dense = _dense_laplacian(we, ws, wse, wne)
    if pen is not None:
        dense[np.diag_indices_from(dense)] += _pad_even(pen)[
            :we.shape[0], :we.shape[1]].ravel()
    # benign identity on empty (all-inactive) coarse cells
    empty = dense.diagonal() == 0
    dense[empty, empty] = 1.0
    pinv = _upload32(_sym_pinv(dense), device)
    return GeoMgHierarchy(tuple(levels), pinv, tuple(we.shape), 1.9)


def from_jax_numpy(levels, coarse_pinv, coarse_shape, overcorrect=1.9,
                   device="cpu", dtype=torch.float32,
                   fused_smoother=True) -> GeoMgHierarchy:
    """A hierarchy carried across from the JAX package as numpy arrays.

    levels: one mapping per level with keys we, ws, wse, wne, diag,
    inv_diag (host arrays) and lam_max (float); coarse_pinv:
    (hc*wc, hc*wc); coarse_shape: (hc, wc); fused_smoother as in
    build_geo_mg_device.  Lets a test run this package's V-cycle on
    exactly the JAX package's hierarchy."""
    lv = tuple(
        GeoMgLevel(
            operator_from_numpy([L[k] for k in ("we", "ws", "wse", "wne",
                                                "diag")], dtype, device),
            torch.as_tensor(np.array(L["inv_diag"]),
                            dtype=dtype, device=device),
            float(L["lam_max"]),
            fused_smoother and
            fused_smoother_supported(np.shape(L["diag"])))
        for L in levels)
    pinv = torch.as_tensor(np.array(coarse_pinv), dtype=dtype,
                           device=device)
    return GeoMgHierarchy(lv, pinv, tuple(int(s) for s in coarse_shape),
                          float(overcorrect))


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """2x2 patch sum (P^T); pads odd dims with zero."""
    B, H, W = r.shape
    if H % 2 or W % 2:
        r = F.pad(r, (0, W % 2, 0, H % 2))
        H, W = r.shape[-2:]
    return r.reshape(B, H // 2, 2, W // 2, 2).sum(dim=(2, 4))


def _prolong(xc: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Piecewise-constant interpolation (P); crops padded dims."""
    up = torch.repeat_interleave(torch.repeat_interleave(xc, 2, dim=1),
                                 2, dim=2)
    return up[:, :H, :W]


CHEB_DEGREE = 2


def _cheb_smooth(L: GeoMgLevel, b, x):
    """Chebyshev polynomial smoother of fixed degree on D^-1 A (Adams et
    al. recurrence), from x = 0 when x is None.

    Fused levels run the whole degree-2 smoother as one cheb_init pass
    (from zero) or residual_init + cheb_finish (warm), with the JAX
    package's coefficients (geomg.py:626-657).  Other levels take the
    generic configuration: the post-smoother's residual is one matvec
    kernel, each recurrence step one fused cheb_step kernel."""
    lmax = L.lam_max
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    Dinv = L.inv_diag[None]

    if L.fused and CHEB_DEGREE == 2:
        rho_new = 1.0 / (2.0 * sigma - rho)
        c = float(1.0 / theta)
        ca = float(rho_new * rho)
        cb = float(2.0 * rho_new / delta)
        if x is None:
            return cheb_init(L.A, L.inv_diag, b, c, ca, cb)
        r0, x1 = residual_init(L.A, L.inv_diag, b, x, c)
        return cheb_finish(L.A, L.inv_diag, r0, x1, c, ca, cb)

    r = b if x is None else b - L.A.matvec(x)
    d = (1.0 / theta) * (Dinv * r)
    x = d if x is None else x + d
    for _ in range(CHEB_DEGREE - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r, d, x = L.A.cheb_step(L.inv_diag, r, d, x,
                                ca=float(rho_new * rho),
                                cb=float(2.0 * rho_new / delta))
        rho = rho_new
    return x


def full_precision_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32: a float32 matmul on the card may use TF32
    (about 3 decimal digits), which would truncate a coarse correction
    the way bf16 MXU passes did on the TPU.  Both switches are off for
    this product, where the only matmuls of the solves (the coarse
    pseudo-inverses of the geometric and the algebraic V-cycle) run, and
    are put back after it, so a program embedding the package keeps its
    own setting."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return a @ b
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def coarse_solve(pinv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The coarsest grid's dense pseudo-inverse solve of blocks b."""
    B, hc, wc = b.shape
    return full_precision_matmul(b.reshape(B, hc * wc),
                                 pinv.T).reshape(B, hc, wc)


def _vcycle(hier: GeoMgHierarchy, lvl: int, b):
    L = hier.levels[lvl]
    coarse = hier.levels[lvl + 1].A if lvl + 1 < len(hier.levels) else None
    x = _cheb_smooth(L, b, None)        # pre-smooth from zero
    # fused residual + restrict: the pre-smooth residual exists only to
    # be restricted, so the kernel never writes it
    rc = L.A.residual_restrict(b, x, coarse)
    xc = (_vcycle(hier, lvl + 1, rc) if coarse is not None else
          L.A.coarse_solve(hier.coarse_pinv, rc))
    # piecewise-constant-prolongator MG underestimates the correction;
    # a fixed over-correction factor restores grid-independent rates
    x = x + hier.overcorrect * L.A.prolong(xc)
    x = _cheb_smooth(L, b, x)           # post-smooth
    return x


def geomg_apply(hier: GeoMgHierarchy, R):
    """Preconditioner application M^-1 R for the stencil CG."""
    if not hier.levels:     # a grid no larger than the coarse one
        return coarse_solve(hier.coarse_pinv, R)
    return _vcycle(hier, 0, R)
