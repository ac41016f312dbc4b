"""ctypes binding for the native C++ sparse Cholesky (native/cholesky.cpp).

Counterpart of circuitscape_tpu/solve/native_chol.py: the direct tier's
equivalent of the reference's CHOLMOD, factorizing once per component
and back-substituting batched multi-RHS blocks (src/core.jl:519-523,
:446-493).  The library's supernodal factorization takes its dense
kernels from scipy's bundled OpenBLAS when one is found (_find_blas,
handed over through chol_set_blas), else runs its scalar engine; its
fill-reducing ordering is native (chol_order).

The library is built with g++ from native/cholesky.cpp into
build/native/ on first use (native_build.py).  A failed build raises;
there is no SciPy fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import threading

import numpy as np
import scipy.sparse as sp

from .. import cslog
from ..native_build import build

_lib = None
_lock = threading.Lock()
BLAS = None     # the BLAS library handed to the engine, or None


def _find_blas() -> str | None:
    """A dense BLAS shared library for the supernodal engine: the
    OpenBLAS that scipy wheels bundle (symbols scipy_dgemm_ etc)."""
    import scipy
    libs_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(scipy.__file__))), "scipy.libs")
    hits = sorted(glob.glob(os.path.join(libs_dir, "*openblas*.so*")))
    return hits[0] if hits else None


def _load():
    global _lib, BLAS
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build("cholesky.cpp", "libcschol",
                                    libs=("-ldl",))))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.chol_set_blas.restype = ctypes.c_int
        lib.chol_set_blas.argtypes = [ctypes.c_char_p]
        lib.chol_factorize.restype = ctypes.c_void_p
        lib.chol_factorize.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                                       i64p]
        lib.chol_solve.restype = None
        lib.chol_solve.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64]
        lib.chol_nnz.restype = ctypes.c_int64
        lib.chol_nnz.argtypes = [ctypes.c_void_p]
        lib.chol_order.restype = None
        lib.chol_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
        lib.chol_free.restype = None
        lib.chol_free.argtypes = [ctypes.c_void_p]
        blas = _find_blas()
        if blas is not None and lib.chol_set_blas(blas.encode()):
            BLAS = blas
        else:
            cslog.info("native Cholesky: no BLAS library found; the scalar "
                       "engine runs")
        _lib = lib
        return lib


class NativeCholesky:
    """Factorization of an SPD sparse matrix by the native library."""

    def __init__(self, matrix: sp.spmatrix):
        lib = _load()
        A = matrix.tocsc().astype(np.float64)
        n = A.shape[0]
        perm = np.empty(n, np.int64)
        indptr = np.ascontiguousarray(A.indptr, np.int64)
        indices = np.ascontiguousarray(A.indices, np.int64)
        lib.chol_order(np.int64(n), indptr, indices, perm)
        self.perm = perm
        # the permutation is applied inside the library
        self._handle = lib.chol_factorize(
            np.int64(n), indptr, indices,
            np.ascontiguousarray(A.data, np.float64), perm)
        if not self._handle:
            raise RuntimeError("native Cholesky: matrix not positive definite")
        self.n = n
        self.nnz_L = lib.chol_nnz(self._handle)

    def solve(self, b: np.ndarray) -> np.ndarray:
        one_d = b.ndim == 1
        B = b.reshape(-1, 1) if one_d else b
        Bp = np.array(B, np.float64, order="C")  # always a fresh copy
        _load().chol_solve(self._handle, Bp, np.int64(Bp.shape[1]))
        return Bp[:, 0] if one_d else Bp

    def __del__(self):
        if getattr(self, "_handle", None) and _lib is not None:
            _lib.chol_free(self._handle)
