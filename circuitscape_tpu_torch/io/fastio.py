"""ctypes binding for the native text formatter (native/fastio.cpp).

Counterpart of circuitscape_tpu/io/fastio.py.  Python-level formatting
costs ~1 s per 1M-cell ASC map, and the network pairwise job writes
hundreds of node and branch current files of 10^5-2*10^5 rows; the
native writers format in parallel (OpenMP) and release the GIL.  The
library is built from native/fastio.cpp into build/native/ on first use
(native_build.py); a failed build raises.

  write_asc_body  the ASC grid body, C printf "%.12g" per value: the
                  same text as the Python "%.12g" formatter
  write_dlm_body  a delimited matrix, `digits` significant digits (the
                  JAX package's route for large _writedlm writes)

The JAX package's fast ASC formatter (csio_write_asc_body_fast, whose
last digit may differ from printf's) and node_currents_f32 are not
bound: the port writes grids through the exact formatter and computes
node currents on the device.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..native_build import build

_lib = None
_lock = threading.Lock()


def load():
    """The loaded library, built from source on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build("fastio.cpp", "libcsio")))
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.csio_write_asc_body.restype = ctypes.c_longlong
            lib.csio_write_asc_body.argtypes = [
                ctypes.c_char_p, f64p, ctypes.c_int64, ctypes.c_int64]
            lib.csio_write_dlm.restype = ctypes.c_longlong
            lib.csio_write_dlm.argtypes = [
                ctypes.c_char_p, f64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_char]
            _lib = lib
    return _lib


def write_dlm_body(path: str, arr: np.ndarray, delim: str,
                   digits: int = 17) -> None:
    """Write a 2-D array as delimited text (truncating path), `digits`
    significant digits per value (17: exact float64 round trip)."""
    if len(delim) != 1:
        raise ValueError(f"write_dlm_body: one-character delimiter, not "
                         f"{delim!r}")
    a = np.ascontiguousarray(arr, np.float64)
    if load().csio_write_dlm(path.encode(), a, a.shape[0], a.shape[1],
                             int(digits), delim.encode()) < 0:
        raise OSError(f"write_dlm_body: cannot write {path}")


def write_asc_body(path: str, arr: np.ndarray) -> None:
    """Append the grid body of arr (one "%.12g" value per cell, one line
    per row) to path, whose header the caller wrote."""
    a = np.ascontiguousarray(arr, np.float64)
    if load().csio_write_asc_body(path.encode(), a, a.shape[0],
                                  a.shape[1]) < 0:
        raise OSError(f"write_asc_body: cannot write {path}")
