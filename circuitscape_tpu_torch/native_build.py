"""Builds the host C++ libraries of native/ from source, on first use.

native/cholesky.cpp (the direct tier's supernodal Cholesky) and
native/fastio.cpp (the text formatter) are compiled with g++ into
build/native/, never into native/ itself, and never loaded from a
prebuilt copy: the flags are native/Makefile's, including -march=native,
so a library is only valid on the CPU that built it.  The file name is
keyed on a hash of the source, the flags and the host CPU's feature
list, so a tree copied to another machine rebuilds there.  Where the
compiler has no OpenMP runtime (no libgomp), the library is built
without -fopenmp and named "*-serial.so": both sources guard every
OpenMP use with _OPENMP and then run on one thread.  A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NATIVE_SRC = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS, plus -shared
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-Wall", "-shared")

_lock = threading.Lock()


def _cpu_features() -> bytes:
    """The host CPU's feature flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def build(source: str, stem: str, libs=()) -> Path:
    """Compile native/<source> into build/native/<stem>-<hash>.so (or
    <stem>-<hash>-serial.so) unless it exists; returns its path."""
    src = NATIVE_SRC / source
    key = hashlib.sha256(src.read_bytes() + repr((CXXFLAGS, libs)).encode() +
                         _cpu_features()).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}-{key}.so"
    serial = BUILD_DIR / f"{stem}-{key}-serial.so"
    with _lock:
        for path in (out, serial):
            if path.exists():
                return path
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"building {src}: no C++ compiler (g++) found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = _compile(cxx, CXXFLAGS, src, out, libs)
        if proc.returncode != 0 and "libgomp" in proc.stderr:
            out = serial
            proc = _compile(cxx, tuple(f for f in CXXFLAGS
                                       if f != "-fopenmp"), src, out, libs)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{proc.stderr}")
    return out


def _compile(cxx, flags, src, out, libs):
    # build under a private name, then rename: concurrent builds
    # (test workers) never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(src), *libs],
                          capture_output=True, text=True)
    if proc.returncode == 0:
        os.replace(tmp, out)
    return proc
