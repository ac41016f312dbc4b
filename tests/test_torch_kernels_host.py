"""The CUDA kernels of circuitscape_tpu_torch, run on the host: their
source, csrc/stencil_kernels.cu, compiled by the host C++ compiler against
a small header that stands in for the CUDA runtime and builtins, with each
C entry point held against the kernel's plain version.

The header runs a launch block by block, each block's threads as host
threads; __syncthreads is a barrier, a warp shuffle goes through a buffer
between two barriers, and a cp.async copy is deferred to the
__pipeline_wait_prior that must see it, so a kernel that reads a stage
of its ring too early reads stale data here too.  This checks the
kernels' indexing, edges, ring order and column chunks on the CPU; what
only the card can show (that nvcc builds them, their speed) is
chip_smoke.py's and tests/test_torch_cuda.py's.  Skips without g++."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from circuitscape_tpu_torch.solve import cuda_stencil as cs
from circuitscape_tpu_torch.solve.stencil import (_to_dtype,
                                                  stencil_from_gmap_device)

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

TOL = 1e-5   # max |kernel - plain| <= TOL * max |plain|: f32 sum order

HEADER = r"""
#pragma once
#include <atomic>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 { float x, y; };
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

namespace emu {
inline int sms = 132;            // multiprocessors the launches see
inline int blocks_per_sm = 3;
inline std::atomic<int> error{0};
}
extern "C" void emu_set_card(int sms, int blocks_per_sm) {
    emu::sms = sms;
    emu::blocks_per_sm = blocks_per_sm;
}
inline int cudaGetLastError() {
    const int e = emu::error;
    emu::error = cudaSuccess;
    return e;
}
inline int cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
    *v = emu::sms;
    return cudaSuccess;
}
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
    *n = emu::blocks_per_sm;
    return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline int min(int a, int b) { return a < b ? a : b; }
template <class T> inline T __ldg(const T* p) { return *p; }

namespace emu {
struct Barrier {
    std::mutex m;
    std::condition_variable cv;
    int n = 0, count = 0;
    long gen = 0;
    void wait() {
        std::unique_lock<std::mutex> l(m);
        const long g = gen;
        if (++count == n) {
            count = 0;
            ++gen;
            cv.notify_all();
        } else {
            cv.wait(l, [&] { return gen != g; });
        }
    }
};
inline Barrier bar;
inline std::vector<float> lanes;
struct Copy { void* dst; const void* src; size_t size, zfill; };
inline thread_local std::vector<Copy> open_group;
inline thread_local std::deque<std::vector<Copy>> groups;

inline int tid() {
    return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
}

inline void launch(dim3 g, dim3 b, const std::function<void()>& body) {
    gridDim = g;
    blockDim = b;
    const int nt = b.x * b.y * b.z;
    bar.n = nt;
    lanes.assign(nt, 0.0f);
    for (unsigned bz = 0; bz < g.z; ++bz)
        for (unsigned by = 0; by < g.y; ++by)
            for (unsigned bx = 0; bx < g.x; ++bx) {
                std::vector<std::thread> ts;
                for (int t = 0; t < nt; ++t) {
                    ts.emplace_back([=, &body] {
                        blockIdx = dim3(bx, by, bz);
                        threadIdx = dim3(t % b.x, (t / b.x) % b.y,
                                         t / (b.x * b.y));
                        open_group.clear();
                        groups.clear();
                        body();
                        bool pending = !open_group.empty();
                        for (auto& q : groups) pending |= !q.empty();
                        if (pending) error = 999;   // never waited for
                    });
                }
                for (auto& t : ts) t.join();
            }
}
}  // namespace emu

inline void __syncthreads() { emu::bar.wait(); }
inline float __shfl_down_sync(unsigned, float v, int off) {
    const int t = emu::tid();
    emu::lanes[t] = v;
    emu::bar.wait();
    const float r = (t % 32) + off < 32 ? emu::lanes[t + off] : v;
    emu::bar.wait();
    return r;
}
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
    emu::open_group.push_back({dst, src, size, zfill});
}
inline void __pipeline_commit() {
    emu::groups.push_back(emu::open_group);
    emu::open_group.clear();
}
inline void __pipeline_wait_prior(size_t n) {
    while (emu::groups.size() > n) {
        for (auto& c : emu::groups.front()) {
            memcpy(c.dst, c.src, c.size - c.zfill);
            memset((char*)c.dst + (c.size - c.zfill), 0, c.zfill);
        }
        emu::groups.pop_front();
    }
}
"""


def _split_args(s):
    """Top-level comma split of a launch configuration."""
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += (ch in "([") - (ch in ")]")
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def host_source(cu: str) -> str:
    """The .cu source with its CUDA includes dropped and each
    `kernel<<<grid, block, ...>>>(args);` turned into a host launch."""
    cu = re.sub(r"#include <cuda_(pipeline|runtime)\.h>\n", "", cu)

    def launch(m):
        grid, block = (a.strip() for a in _split_args(m.group(2))[:2])
        return (f"emu::launch({grid}, {block}, [&] {{ "
                f"{m.group(1)}({m.group(3)}); }});")
    return ('#include "cuda_host.h"\n' +
            re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", launch, cu,
                   flags=re.S))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    d = tmp_path_factory.mktemp("kernels_host")
    (d / "cuda_host.h").write_text(HEADER)
    src = d / "stencil_kernels.cpp"
    src.write_text(host_source(
        (cs.CSRC / "stencil_kernels.cu").read_text()))
    so = d / "libstencil_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
                    "-Wno-unknown-pragmas", f"-I{d}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in cs._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.emu_set_card.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _inputs(B, H, W, seed):
    """A float32 operator of a random (H, W) conductance grid with holes,
    its Dinv, and three (B, H, W) blocks."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 3.0, (H, W))
    g[rng.random((H, W)) < 0.15] = 0.0
    A = _to_dtype(stencil_from_gmap_device(torch.as_tensor(g), False,
                                           False), torch.float32)
    dinv = torch.where(A.diag > 0,
                       1.0 / torch.where(A.diag == 0, 1.0, A.diag),
                       0.0).contiguous()
    blocks = [torch.as_tensor(rng.standard_normal((B, H, W)),
                              dtype=torch.float32) for _ in range(3)]
    return A, dinv, blocks


def _run(lib, name, A, dinv, x, b, d):
    """One kernel's C entry point on CPU tensors, and its plain version;
    outputs start as NaN so that a cell the kernel misses shows."""
    P = [ctypes.c_void_p(p.data_ptr()) for p in A.planes]

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def empty():
        return torch.full_like(x, float("nan"))
    B, H, W = x.shape
    c, ca, cb = 0.8, 0.37, 1.21
    shape = (B, H, W)
    if name == "matvec":
        y = empty()
        err = lib.cs_matvec(*P, ptr(x), ptr(y), *shape, None)
        got, ref = (y,), (cs.matvec_plain(A, x),)
    elif name == "matvec_pap":
        y = empty()
        part = torch.full((B, lib.cs_matvec_pap_blocks(H, W)), float("nan"))
        err = lib.cs_matvec_pap(*P, ptr(x), ptr(y), ptr(part), *shape, None)
        got, ref = (y, part.sum(dim=1)), cs.matvec_pap_plain(A, x)
    elif name == "cheb_step":
        ro, do, xo = empty(), empty(), empty()
        err = lib.cs_cheb_step(*P, ptr(dinv), ptr(b), ptr(d), ptr(x),
                               ptr(ro), ptr(do), ptr(xo), ca, cb, *shape,
                               None)
        got = (ro, do, xo)
        ref = cs.cheb_step_plain(A, dinv, b, d, x, ca, cb)
    elif name == "residual_restrict":
        rc = torch.full((B, -(-H // 2), -(-W // 2)), float("nan"))
        err = lib.cs_residual_restrict(*P, ptr(b), ptr(x), ptr(rc), *shape,
                                       None)
        got, ref = (rc,), (cs.residual_restrict_plain(A, b, x),)
    elif name == "cheb_init":
        xo = empty()
        err = lib.cs_cheb_init(*P, ptr(dinv), ptr(b), ptr(xo), c, ca, cb,
                               *shape, None)
        got, ref = (xo,), (cs.cheb_init_plain(A, dinv, b, c, ca, cb),)
    elif name == "residual_init":
        r0, x1 = empty(), empty()
        err = lib.cs_residual_init(*P, ptr(dinv), ptr(b), ptr(x), ptr(r0),
                                   ptr(x1), c, *shape, None)
        got, ref = (r0, x1), cs.residual_init_plain(A, dinv, b, x, c)
    else:
        x2 = empty()
        err = lib.cs_cheb_finish(*P, ptr(dinv), ptr(d), ptr(x), ptr(x2), c,
                                 ca, cb, *shape, None)
        got, ref = (x2,), (cs.cheb_finish_plain(A, dinv, d, x, c, ca, cb),)
    assert err == 0
    return got, ref


def _close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert not torch.isnan(g).any()
        assert float((g - r).abs().max()) <= TOL * float(r.abs().max())


KERNELS = ("matvec", "matvec_pap", "cheb_step", "residual_restrict",
           "cheb_init", "residual_init", "cheb_finish")


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (31, 33), (37, 53)])
def test_kernel_matches_plain_on_host(lib, name, shape):
    lib.emu_set_card(132, 3)
    A, dinv, (x, b, d) = _inputs(3, *shape, seed=shape[0] * 100 + shape[1])
    _close(*_run(lib, name, A, dinv, x, b, d))


@pytest.mark.parametrize("card", [(1, 1), (132, 3), (4, 2)])
@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("B", [1, 5, 40])
def test_staged_kernel_column_chunks_on_host(lib, name, B, card):
    """The staged kernels with all B columns in one chunk per tile (a card
    of one multiprocessor that holds one block) and with the columns
    spread over blocks (132 multiprocessors of 3 blocks; 4 of 2, where
    residual_init takes strips of 4 in two chunks, the last one short
    at B = 5), on a grid of a few tiles with odd sides: every column
    walks the ring, and 40 columns in one block make matvec_pap's
    partial sums go in two groups."""
    lib.emu_set_card(*card)
    A, dinv, (x, b, d) = _inputs(B, 33, 35, seed=B)
    _close(*_run(lib, name, A, dinv, x, b, d))


def _nan_fenced(p):
    """p (H, W) as a contiguous view into a buffer that holds NaN for a
    whole row and more before and after it: a read outside the plane's
    rows turns the result into NaN."""
    H, W = p.shape
    pad = 2 * W + 2
    buf = torch.full((H * W + 2 * pad,), float("nan"), dtype=p.dtype)
    buf[pad:pad + H * W] = p.reshape(-1)
    return buf[pad:pad + H * W].view(H, W)


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_on_cropped_grid_on_host(lib, name):
    """A 33 x 35 crop from inside a grid with no holes, so that the edge
    cells have non-zero weights toward neighbours outside the crop: those
    neighbours (and, for the smoother kernels, their Dinv) must read as 0,
    and the planes and Dinv, fenced by NaN, must never be read outside
    the grid."""
    lib.emu_set_card(132, 3)
    rng = np.random.default_rng(4)
    g = rng.uniform(0.5, 3.0, (41, 45))
    full = stencil_from_gmap_device(torch.as_tensor(g), False, False)
    planes = [_nan_fenced(p[4:37, 5:40].to(torch.float32))
              for p in full.planes]
    A = type(full)(*planes)
    assert all(float(p.abs().min()) > 0 for p in (A.we[:, -1], A.ws[-1],
                                                  A.wse[-1], A.wne[0]))
    dinv = _nan_fenced(1.0 / A.diag)
    x, b, d = (torch.as_tensor(rng.standard_normal((3, 33, 35)),
                               dtype=torch.float32) for _ in range(3))
    _close(*_run(lib, name, A, dinv, x, b, d))


def test_residual_restrict_misaligned_b_on_host(lib):
    """b one float off an 8-byte boundary: the staged copy takes any
    address."""
    lib.emu_set_card(132, 3)
    A, dinv, (x, b, d) = _inputs(2, 20, 34, seed=3)
    buf = torch.empty(b.numel() + 1)
    buf[1:] = b.reshape(-1)
    got, _ = _run(lib, "residual_restrict", A, dinv, x,
                  buf[1:].view(b.shape), d)
    _close(got, (cs.residual_restrict_plain(A, b, x),))


def test_ptxas_report_names_each_kernel():
    """chip_smoke.py's `registers` lines from an `nvcc -Xptxas -v` report:
    each entry function by its kernel name (with its strip height where
    it is a template), its registers, shared memory and spills."""
    from chip_smoke import ptxas_kernels
    fn = ("_ZN12_GLOBAL__N_120residual_init_kernelILi4EEEvNS_6PlanesEPKfS3_"
          "S3_PfS4_fiiii")
    out = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{fn}' for 'sm_90a'
ptxas info    : Function properties for {fn}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 26160 bytes smem, 452 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117matvec_pap_kernelENS_6PlanesEPKfPfS3_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117matvec_pap_kernelENS_6PlanesEPKfPfS3_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 76 registers, used 1 barriers, 14000 bytes smem, 400 bytes cmem[0]
"""
    assert ptxas_kernels(out) == [
        "registers residual_init_kernel<4>: 80 registers, 26160 bytes smem, "
        "spills 8 / 4 bytes",
        "registers matvec_pap_kernel: 76 registers, 14000 bytes smem, "
        "spills 0 / 0 bytes"]
