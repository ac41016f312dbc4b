"""Hand-written CUDA kernels of the stencil solve, and their plain versions.

Counterpart of circuitscape_tpu/solve/pallas_stencil.py.  Seven kernels,
all float32 on (B, H, W) blocks with zero-fill grid boundaries, compiled
by nvcc for sm_90a from csrc/stencil_kernels.cu into a shared library
with a plain C interface, loaded with ctypes on first use:

  matvec            y = L x                       (replaces pallas_matvec)
  matvec_pap        y = L x, pAp[b] = sum x.y     (pallas_matvec_pap)
  cheb_step         r' = r - L d; d' = ca d + cb Dinv r'; x' = x + d'
                                                  (pallas_cheb_step)
  residual_restrict rc = 2x2 patch sums of b - L x (pallas_residual_restrict)
  cheb_init         x = (1+ca) c Dinv b + cb Dinv (b - c L Dinv b)
                                                  (pallas_cheb_init)
  residual_init     r0 = b - L x; x1 = x + c Dinv r0 (pallas_residual_init)
  cheb_finish       x2 = x1 + ca c Dinv r0 + cb Dinv (r0 - c L Dinv r0)
                                                  (pallas_cheb_finish)

The last three are the V-cycle's degree-2 Chebyshev smoother in the JAX
package's premultiplied-Dinv configuration: the pre-smoother from zero
in one pass, the post-smoother in two (cheb_finish reads r0 at
neighbour offsets, so all of r0 must be written first).

All seven are bound by memory bytes: per cell and column they do ~20
flops against >= 8 bytes, far below the card's flop:byte ratio.  The
design moves each byte once: a thread loads its cells' nine weights
each from the five base planes into registers once and then loops over
the batch, so plane bytes are read once per block rather than once per
column (the TPU kernel got the same reuse from its batch-fastest grid).
Unlike the TPU kernels, which read nine pre-shifted plane copies to
avoid unaligned shifts, these read the five base planes at neighbour
offsets: 5 instead of 9 plane bytes per cell.  For L Dinv the TPU reads
nine premultiplied planes plus Dinv; these kernels form
w * Dinv[neighbour] in registers, once per cell: 6 plane reads, not 10.

All seven stage each column's tile of the block the stencil reads with
a one-cell halo (x; b for cheb_init, r0 for cheb_finish, d for
cheb_step), and the tile of any other input (residual_restrict and
residual_init: b; cheb_finish: x1; cheb_step: r and x), in shared
memory through a three-buffer cp.async ring (the next two columns'
copies in flight while one is computed; the copy zero-fills cells
outside the grid, and takes any width and alignment).  Their first
design, a thread per cell reading through L1, reached under half of
the byte bound (at 1024^2, or over a bench job's levels).  A thread
owns several cells: residual_restrict one 2x2 fine patch (its four
residuals summed in registers, one coalesced store of its coarse cell),
the six others a vertical strip of four in one column (matvec, cheb_step
and residual_init: one cell where strips of four would leave SMs idle,
for residual_init under half a wave of resident blocks;
each staged value read ~3 times per strip from shared memory, not 9
through L1; matvec_pap reduces once per column per block rather than per
cell, the smoother kernels hold the strip's 36 Dinv-premultiplied
weights in registers, residual_init takes x1's x from the staged
window's centre).
Their blocks each take a chunk of the batch, sized per launch so the
grid fills the card (two waves of resident blocks; residual_init 2 x
SMs blocks, at most one wave): on the coarse levels the batch is spread
over blocks instead of walked 32 deep by each thread.

Each wrapper takes CPU tensors to its plain-torch version (the tests run
there) and CUDA tensors to its kernel; on a CUDA tensor it launches the
kernel or raises, never falls back.  LAUNCHES counts kernel launches per
wrapper, LAUNCHES_AT per wrapper and (H, W) of the grid, LAUNCHES_BHW
per wrapper and (B, H, W) of the block (plain calls do not count); a
replayed CUDA graph's launches count at each replay and not at its
capture (solve/cg_graph.py).

Beside the seven, csrc/cg_kernels.cu holds the glue of the single-card
float32 CG iteration and of the V-cycle, which replace no Pallas kernel
but the XLA-fused ops around them (each bound by bytes):

  cg_update_xr      alpha = rz / pAp; X += alpha P, R -= alpha AP
  cg_dots           rz <- R.Z, rn2 <- R.R, beta, the loop's stop quantities
  cg_update_p       P = Z + beta P
  prolong_add       x += s * prolong(xc)

Their wrappers write in place, on either device (the CG loop's buffers,
the V-cycle's fresh pre-smoothed iterate), and count their launches in
FUSED_LAUNCHES, per (kernel, B, H, W), apart from the seven's counters
that the benchmark's roofline metrics read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

from .stencil import StencilOperator, _cg_stop, _sh, stencil_matvec

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches per wrapper, for showing that a run went through the kernels,
# per (wrapper, H, W) of the launch's grid and per (wrapper, B, H, W) of
# its block
LAUNCHES = {"matvec": 0, "matvec_pap": 0, "cheb_step": 0,
            "residual_restrict": 0, "cheb_init": 0, "residual_init": 0,
            "cheb_finish": 0}
LAUNCHES_AT = Counter()
LAUNCHES_BHW = Counter()
# launches of csrc/cg_kernels.cu per (kernel, B, H, W)
FUSED_LAUNCHES = Counter()

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # planes (we, ws, wse, wne, diag), then the function's own tensors,
    # then B, H, W and the stream
    "cs_matvec": [_P] * 5 + [_P, _P] + [_I] * 3 + [_P],
    "cs_matvec_pap": [_P] * 5 + [_P, _P, _P] + [_I] * 3 + [_P],
    "cs_cheb_step": ([_P] * 5 + [_P] * 7 + [_F, _F] + [_I] * 3 + [_P]),
    "cs_residual_restrict": [_P] * 5 + [_P, _P, _P] + [_I] * 3 + [_P],
    "cs_cheb_init": [_P] * 5 + [_P] * 3 + [_F] * 3 + [_I] * 3 + [_P],
    "cs_residual_init": [_P] * 5 + [_P] * 5 + [_F] + [_I] * 3 + [_P],
    "cs_cheb_finish": [_P] * 5 + [_P] * 4 + [_F] * 3 + [_I] * 3 + [_P],
    "cs_matvec_pap_blocks": [_I, _I],
    # csrc/cg_kernels.cu: blocks, flags and scalars, then B, H, W and the
    # stream
    "cs_cg_chunks": [_I, _I],
    "cs_cg_update_xr": [_P] * 6 + [_I] + [_I] * 3 + [_P],
    "cs_cg_dots": [_P] * 9 + [_I] * 3 + [_P],
    "cs_cg_update_p": [_P] * 3 + [_I] * 3 + [_P],
    "cs_prolong_add": [_P, _P, _F] + [_I] * 3 + [_P],
}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_AT.clear()
    LAUNCHES_BHW.clear()
    FUSED_LAUNCHES.clear()


def launch_counts() -> Counter:
    """Every kernel launch counted so far, per (wrapper or kernel, B, H,
    W): LAUNCHES_BHW and FUSED_LAUNCHES together."""
    return LAUNCHES_BHW + FUSED_LAUNCHES


def _launched(name: str, B: int, H: int, W: int):
    LAUNCHES[name] += 1
    LAUNCHES_AT[(name, H, W)] += 1
    LAUNCHES_BHW[(name, B, H, W)] += 1


def count_launches(launches, times: int = 1):
    """Add launches ({(wrapper, B, H, W): n}, as launch_counts gives them)
    times over to their counters, the seven's three or FUSED_LAUNCHES: a
    replayed CUDA graph's kernels, which run without a call of their
    wrappers (times=-1 takes back those a capture counted)."""
    for (name, B, H, W), n in launches.items():
        if name not in LAUNCHES:
            key = (name, B, H, W)
            FUSED_LAUNCHES[key] += times * n
            if not FUSED_LAUNCHES[key]:
                del FUSED_LAUNCHES[key]
            continue
        LAUNCHES[name] += times * n
        for c, key in ((LAUNCHES_AT, (name, H, W)),
                       (LAUNCHES_BHW, (name, B, H, W))):
            c[key] += times * n
            if not c[key]:
                del c[key]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "circuitscape_tpu_torch build on first use and "
                           "need the CUDA toolkit")
    return path


def build() -> Path:
    """Compile csrc/*.cu into build/kernels/ (keyed on a hash of the
    sources and flags) unless that library exists; returns its path."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libcs_stencil_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" +
                               res.stdout + res.stderr)
        os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _check(A: StencilOperator, *blocks: torch.Tensor, extra_planes=()):
    """The kernels take contiguous float32 CUDA tensors on one device:
    planes (H, W) (the operator's five and extra_planes), blocks
    (B, H, W) with B >= 1 and H * W < 2^31."""
    dev = A.diag.device
    H, W = A.shape
    if H * W >= 2**31:
        # the C entry points take int sides and index within a plane in
        # int (across the batch in size_t: B * H * W may pass 2^31)
        raise ValueError(f"stencil kernels take grids of under 2^31 "
                         f"cells, got {H}x{W}")
    for p in A.planes + tuple(extra_planes):
        if (p.device != dev or p.dtype != torch.float32 or
                not p.is_contiguous() or tuple(p.shape) != (H, W)):
            raise ValueError("stencil kernels need five contiguous float32 "
                             f"(H, W) planes on one device, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    for t in blocks:
        if (t.device != dev or t.dtype != torch.float32 or
                not t.is_contiguous() or t.dim() != 3 or t.shape[0] < 1 or
                tuple(t.shape[1:]) != (H, W)):
            raise ValueError("stencil kernels need contiguous float32 "
                             f"(B>=1, {H}, {W}) blocks on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(dev: torch.device):
    """The current stream of dev, which must be the current device (the
    C functions launch in the current device's context)."""
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"stencil kernels launch on the current CUDA "
                         f"device ({torch.cuda.current_device()}); the "
                         f"tensors are on {dev}")
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_if(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


# --- plain versions (CPU path, and the oracle the kernels are held to) ---

def cg_update_xr_plain(X, R, P, AP, rz, pAp, replace: bool):
    alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
    X.add_(alpha[:, None, None] * P)
    if not replace:
        R.sub_(alpha[:, None, None] * AP)


def cg_dots_plain(R, Z, rz, rn2, safe_bnorm, tol, stop):
    rz_new = torch.sum(R * Z, dim=(-2, -1))
    beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
    rz.copy_(rz_new)
    torch.sum(R * R, dim=(-2, -1), out=rn2)
    _cg_stop(rn2, safe_bnorm, tol, out=stop)
    return beta


def cg_update_p_plain(P, Z, beta):
    torch.add(Z, beta[:, None, None] * P, out=P)


def prolong_add_plain(x, xc, scale: float):
    from .geomg import _prolong
    return x.add_(scale * _prolong(xc, *x.shape[1:]))


def matvec_plain(A: StencilOperator, x: torch.Tensor) -> torch.Tensor:
    return stencil_matvec(A, x)


def matvec_pap_plain(A: StencilOperator, x: torch.Tensor):
    y = stencil_matvec(A, x)
    return y, torch.sum(x * y, dim=(-2, -1))


def cheb_step_plain(A: StencilOperator, dinv, r, d, x, ca: float,
                    cb: float):
    r = r - stencil_matvec(A, d)
    d = ca * d + cb * (dinv[None] * r)
    return r, d, x + d


def residual_restrict_plain(A: StencilOperator, b, x):
    from .geomg import _restrict
    return _restrict(b - stencil_matvec(A, x))


def expand_planes(A: StencilOperator, dinv: torch.Tensor) -> torch.Tensor:
    """The nine output-aligned planes (9, H, W) of L Dinv in the order
    the TPU kernels read them: E, W, S, N, SE, NW, NE, SW, centre, each
    the weight of the term that reads x at that offset, premultiplied by
    dinv at the cell that term reads (the centre: diag * dinv).
    Counterpart of pallas_stencil._expand_planes_dinv cropped to
    (H, W)."""
    we, ws, wse, wne, diag = A.planes

    def east(p):    # p[:, j] <- p[:, j+1]
        return _sh(p[None], 0, -1)[0]

    def west(p):    # p[:, j] <- p[:, j-1]
        return _sh(p[None], 0, 1)[0]

    def up(p):      # p[i] <- p[i-1]
        return _sh(p[None], 1, 0)[0]

    def dn(p):      # p[i] <- p[i+1]
        return _sh(p[None], -1, 0)[0]

    planes = [we, west(we), ws, up(ws), wse, west(up(wse)), wne,
              west(dn(wne)), diag]
    reads = [east(dinv), west(dinv), dn(dinv), up(dinv), dn(east(dinv)),
             up(west(dinv)), up(east(dinv)), dn(west(dinv)), dinv]
    return torch.stack([p * v for p, v in zip(planes, reads)])


def _lap9(P9: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The stencil of the nine aligned planes P9 applied to v (B, H, W),
    summed in the TPU kernels' order (pairs of terms)."""
    wE, wW, wS, wN, wSE, wNW, wNE, wSW, dd = (p[None] for p in P9)
    y = dd * v
    y = y - (wE * _sh(v, 0, -1) + wW * _sh(v, 0, 1))
    y = y - (wS * _sh(v, -1, 0) + wN * _sh(v, 1, 0))
    y = y - (wSE * _sh(v, -1, -1) + wNW * _sh(v, 1, 1))
    y = y - (wNE * _sh(v, 1, -1) + wSW * _sh(v, -1, 1))
    return y


def cheb_init_plain(A: StencilOperator, dinv, b, c: float, ca: float,
                    cb: float):
    iv = dinv[None]
    r1 = b - c * _lap9(expand_planes(A, dinv), b)
    return (1.0 + ca) * c * (iv * b) + cb * (iv * r1)


def residual_init_plain(A: StencilOperator, dinv, b, x, c: float):
    r0 = b - stencil_matvec(A, x)
    return r0, x + c * (dinv[None] * r0)


def cheb_finish_plain(A: StencilOperator, dinv, r0, x1, c: float, ca: float,
                      cb: float):
    iv = dinv[None]
    r1 = r0 - c * _lap9(expand_planes(A, dinv), r0)
    return x1 + ca * c * (iv * r0) + cb * (iv * r1)


# --- kernel wrappers ------------------------------------------------------

def matvec(A: StencilOperator, x: torch.Tensor) -> torch.Tensor:
    """y = L x for x (B, H, W).  Replaces pallas_stencil.pallas_matvec
    (circuitscape_tpu/solve/pallas_stencil.py:899); bound by bytes."""
    if not x.is_cuda:
        return matvec_plain(A, x)
    _check(A, x)
    lib = _load()
    y = torch.empty_like(x)
    B, H, W = x.shape
    _raise_if(lib.cs_matvec(*map(_ptr, A.planes), _ptr(x), _ptr(y),
                            B, H, W, _stream(x.device)), "matvec")
    _launched("matvec", B, H, W)
    return y


def matvec_pap(A: StencilOperator, x: torch.Tensor):
    """(L x, per-column x . L x) in one pass.  Replaces
    pallas_stencil.pallas_matvec_pap (pallas_stencil.py:856); bound by
    bytes.  Each 32 x 32 tile writes one partial dot per column to a
    scratch tensor, summed here in a fixed order (no float atomics), as
    the JAX wrapper sums its per-slab partials; two calls on the same
    input give the same bits."""
    if not x.is_cuda:
        return matvec_pap_plain(A, x)
    _check(A, x)
    lib = _load()
    B, H, W = x.shape
    y = torch.empty_like(x)
    part = torch.empty((B, lib.cs_matvec_pap_blocks(H, W)),
                       dtype=torch.float32, device=x.device)
    _raise_if(lib.cs_matvec_pap(*map(_ptr, A.planes), _ptr(x), _ptr(y),
                                _ptr(part), B, H, W, _stream(x.device)),
              "matvec_pap")
    _launched("matvec_pap", B, H, W)
    return y, part.sum(dim=1)


def cheb_step(A: StencilOperator, dinv: torch.Tensor, r, d, x, ca: float,
              cb: float):
    """One Chebyshev recurrence step in one pass: returns
    (r - L d, ca*d + cb*Dinv*(r - L d), x + d').  Replaces
    pallas_stencil.pallas_cheb_step (pallas_stencil.py:340); bound by
    bytes (3 blocks in, 3 out)."""
    if not r.is_cuda:
        return cheb_step_plain(A, dinv, r, d, x, ca, cb)
    _check(A, r, d, x, extra_planes=(dinv,))
    lib = _load()
    B, H, W = r.shape
    ro, do, xo = (torch.empty_like(r) for _ in range(3))
    _raise_if(lib.cs_cheb_step(*map(_ptr, A.planes), _ptr(dinv), _ptr(r),
                               _ptr(d), _ptr(x), _ptr(ro), _ptr(do),
                               _ptr(xo), ca, cb, B, H, W,
                               _stream(r.device)),
              "cheb_step")
    _launched("cheb_step", B, H, W)
    return ro, do, xo


def residual_restrict(A: StencilOperator, b: torch.Tensor, x: torch.Tensor):
    """restrict(b - L x): the 2x2 patch sums of the residual, output
    (B, ceil(H/2), ceil(W/2)); odd H or W restrict as if zero-padded,
    exactly as geomg._restrict.  Replaces
    pallas_stencil.pallas_residual_restrict (pallas_stencil.py:761),
    which the TPU gates to even H and W % 256 == 0; bound by bytes (the
    full-size residual is never written)."""
    if not x.is_cuda:
        return residual_restrict_plain(A, b, x)
    _check(A, b, x)
    lib = _load()
    B, H, W = x.shape
    rc = torch.empty((B, -(-H // 2), -(-W // 2)), dtype=torch.float32,
                     device=x.device)
    _raise_if(lib.cs_residual_restrict(*map(_ptr, A.planes), _ptr(b),
                                       _ptr(x), _ptr(rc), B, H, W,
                                       _stream(x.device)),
              "residual_restrict")
    _launched("residual_restrict", B, H, W)
    return rc


def cheb_init(A: StencilOperator, dinv: torch.Tensor, b: torch.Tensor,
              c: float, ca: float, cb: float) -> torch.Tensor:
    """The degree-2 Chebyshev pre-smoother from x = 0 in one pass:
    x = (1+ca) c Dinv b + cb Dinv (b - c L Dinv b).  Replaces
    pallas_stencil.pallas_cheb_init (pallas_stencil.py:502); bound by
    bytes (1 block in, 1 out, 6 planes)."""
    if not b.is_cuda:
        return cheb_init_plain(A, dinv, b, c, ca, cb)
    _check(A, b, extra_planes=(dinv,))
    lib = _load()
    B, H, W = b.shape
    x = torch.empty_like(b)
    _raise_if(lib.cs_cheb_init(*map(_ptr, A.planes), _ptr(dinv), _ptr(b),
                               _ptr(x), c, ca, cb, B, H, W,
                               _stream(b.device)), "cheb_init")
    _launched("cheb_init", B, H, W)
    return x


def residual_init(A: StencilOperator, dinv: torch.Tensor, b: torch.Tensor,
                  x: torch.Tensor, c: float):
    """Pass 1 of the warm (post-)smoother: returns (r0, x1) with
    r0 = b - L x and x1 = x + c Dinv r0.  Replaces
    pallas_stencil.pallas_residual_init (pallas_stencil.py:631); bound
    by bytes (2 blocks in, 2 out, 6 planes)."""
    if not x.is_cuda:
        return residual_init_plain(A, dinv, b, x, c)
    _check(A, b, x, extra_planes=(dinv,))
    lib = _load()
    B, H, W = x.shape
    r0, x1 = torch.empty_like(x), torch.empty_like(x)
    _raise_if(lib.cs_residual_init(*map(_ptr, A.planes), _ptr(dinv),
                                   _ptr(b), _ptr(x), _ptr(r0), _ptr(x1), c,
                                   B, H, W, _stream(x.device)),
              "residual_init")
    _launched("residual_init", B, H, W)
    return r0, x1


def cheb_finish(A: StencilOperator, dinv: torch.Tensor, r0: torch.Tensor,
                x1: torch.Tensor, c: float, ca: float,
                cb: float) -> torch.Tensor:
    """Pass 2 of the warm (post-)smoother:
    x2 = x1 + ca c Dinv r0 + cb Dinv (r0 - c L Dinv r0).  Replaces
    pallas_stencil.pallas_cheb_finish (pallas_stencil.py:660); bound by
    bytes (2 blocks in, 1 out, 6 planes).  A launch of its own: it reads
    r0 at neighbour offsets, which residual_init must have written."""
    if not r0.is_cuda:
        return cheb_finish_plain(A, dinv, r0, x1, c, ca, cb)
    _check(A, r0, x1, extra_planes=(dinv,))
    lib = _load()
    B, H, W = r0.shape
    x2 = torch.empty_like(r0)
    _raise_if(lib.cs_cheb_finish(*map(_ptr, A.planes), _ptr(dinv), _ptr(r0),
                                 _ptr(x1), _ptr(x2), c, ca, cb, B, H, W,
                                 _stream(r0.device)), "cheb_finish")
    _launched("cheb_finish", B, H, W)
    return x2


# --- the CG iteration's and the V-cycle's glue (csrc/cg_kernels.cu) -------

def _check_blocks(*blocks: torch.Tensor):
    """The glue kernels take contiguous float32 (B, H, W) blocks of one
    shape on one device, 1 <= B <= 65535 and H * W < 2^31."""
    shape, dev = tuple(blocks[0].shape), blocks[0].device
    for t in blocks:
        if (t.device != dev or t.dtype != torch.float32 or
                not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError("the CG glue kernels need contiguous float32 "
                             f"blocks of one shape on one device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if len(shape) != 3 or not 1 <= shape[0] <= 65535 or \
            shape[1] * shape[2] >= 2**31:
        raise ValueError(f"the CG glue kernels take (B, H, W) blocks with "
                         f"1 <= B <= 65535 and H * W < 2^31, got {shape}")
    return shape


def _check_columns(B: int, dev, *cols: torch.Tensor, dtype=torch.float32):
    for t in cols:
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous() or
                tuple(t.shape) != (B,)):
            raise ValueError(f"the CG glue kernels need contiguous {dtype} "
                             f"({B},) column vectors on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _fused(name: str, B: int, H: int, W: int):
    FUSED_LAUNCHES[(name, B, H, W)] += 1


def cg_update_xr(X, R, P, AP, rz, pAp, replace: bool) -> None:
    """The CG body's first update, in place: alpha = where(pAp > 0,
    rz / pAp, 0) per column, X += alpha P and, unless replace (the
    iteration that recomputes the true residual), R -= alpha AP.
    Replaces XLA glue of the JAX CG body (circuitscape_tpu/solve/
    stencil.py:603-605), no Pallas kernel; bound by bytes (6 B H W floats,
    3 with replace)."""
    if not X.is_cuda:
        return cg_update_xr_plain(X, R, P, AP, rz, pAp, replace)
    B, H, W = _check_blocks(X, R, P, AP)
    _check_columns(B, X.device, rz, pAp)
    lib = _load()
    _raise_if(lib.cs_cg_update_xr(*map(_ptr, (X, R, P, AP, rz, pAp)),
                                  int(bool(replace)), B, H, W,
                                  _stream(X.device)), "cg_update_xr")
    _fused("cg_update_xr", B, H, W)


def cg_dots(R, Z, rz, rn2, safe_bnorm, tol, stop) -> torch.Tensor:
    """The CG body's column sums and what follows from them, in place:
    beta = where(rz > 0, R.Z / rz, 0) (returned), rz <- R.Z, rn2 <- R.R
    and stop <- [max sqrt(rn2) / safe_bnorm, any sqrt(rn2) > tol]
    (stencil._cg_stop).  Two launches: per-block partial sums (2 B x
    cs_cg_chunks floats, a fixed order, no float atomics: the same bits on
    every run) and one block that finishes them.  Replaces XLA glue of the
    JAX CG body (stencil.py:614-619); bound by bytes (2 B H W floats)."""
    if not R.is_cuda:
        return cg_dots_plain(R, Z, rz, rn2, safe_bnorm, tol, stop)
    B, H, W = _check_blocks(R, Z)
    _check_columns(B, R.device, rz, rn2, safe_bnorm)
    tol = tol.to(torch.float64)
    _check_columns(B, R.device, tol, dtype=torch.float64)
    _check_columns(2, R.device, stop)
    lib = _load()
    part = torch.empty((B, lib.cs_cg_chunks(H, W), 2), dtype=torch.float32,
                       device=R.device)
    beta = torch.empty_like(rz)
    _raise_if(lib.cs_cg_dots(*map(_ptr, (R, Z, part, rz, rn2, beta,
                                         safe_bnorm, tol, stop)),
                             B, H, W, _stream(R.device)), "cg_dots")
    _fused("cg_dots", B, H, W)
    _fused("cg_dots_finish", B, H, W)
    return beta


def cg_update_p(P, Z, beta) -> None:
    """The CG body's last update, in place: P = Z + beta P.  Replaces XLA
    glue of the JAX CG body (stencil.py:616); bound by bytes (3 B H W
    floats)."""
    if not P.is_cuda:
        return cg_update_p_plain(P, Z, beta)
    B, H, W = _check_blocks(P, Z)
    _check_columns(B, P.device, beta)
    lib = _load()
    _raise_if(lib.cs_cg_update_p(_ptr(P), _ptr(Z), _ptr(beta), B, H, W,
                                 _stream(P.device)), "cg_update_p")
    _fused("cg_update_p", B, H, W)


def prolong_add(x, xc, scale: float) -> torch.Tensor:
    """x += scale * geomg._prolong(xc) in place (returns x): the V-cycle's
    coarse correction, xc (B, ceil(H/2), ceil(W/2)) read at (i/2, j/2)
    and cropped to x's (H, W).  Replaces XLA glue of the JAX V-cycle
    (circuitscape_tpu/solve/geomg.py:715); bound by bytes (2 B H W +
    B ceil(H/2) ceil(W/2) floats)."""
    if not x.is_cuda:
        return prolong_add_plain(x, xc, scale)
    B, H, W = _check_blocks(x)
    if (tuple(xc.shape) != (B, -(-H // 2), -(-W // 2)) or
            xc.device != x.device or xc.dtype != torch.float32 or
            not xc.is_contiguous()):
        raise ValueError(f"prolong_add needs a contiguous float32 coarse "
                         f"block ({B}, {-(-H // 2)}, {-(-W // 2)}) on "
                         f"{x.device}, got {xc.dtype} {tuple(xc.shape)} "
                         f"on {xc.device}")
    lib = _load()
    _raise_if(lib.cs_prolong_add(_ptr(x), _ptr(xc), scale, B, H, W,
                                 _stream(x.device)), "prolong_add")
    _fused("prolong_add", B, H, W)
    return x
