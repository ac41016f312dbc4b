// The glue of the single-card float32 PCG iteration and of the V-cycle, as
// hand-written kernels for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by circuitscape_tpu_torch/solve/cuda_stencil.py beside the seven
// stencil kernels of stencil_kernels.cu; the plain torch version of each is
// there too.
//
// None of them replaces a Pallas kernel: they replace XLA glue, the
// elementwise and reduction ops that XLA fuses around the Pallas kernels in
// the JAX package's CG body (circuitscape_tpu/solve/stencil.py:596-622:
// alpha, the X, R and P updates, the R.Z and R.R column sums and the stop
// quantities) and in its V-cycle's prolong-and-add
// (circuitscape_tpu/solve/geomg.py:715).  Run as torch ops, that glue was
// ~25 launches and ~22 full passes over the (B, H, W) block an iteration
// outside matvec_pap and the V-cycle, and ~7 passes a level in the
// prolongation; here it is four launches and 11 passes, and one launch and
// 2.25 passes a level:
//
//   cg_update_xr   alpha = rz / pAp per column; X += alpha P, R -= alpha AP
//                  (the residual replacement's variant: X only)
//                  bound: 6 B H W floats (3 B H W for the variant)
//   cg_dots        per-block partial sums of R.Z and R.R
//                  bound: 2 B H W floats
//   cg_dots_finish the partials summed per column in a fixed order; beta,
//                  rz <- R.Z, rn2 <- R.R, and the loop's stop quantities
//                  [max ||r|| / ||b||, any ||r|| > tol]; one block
//   cg_update_p    P = Z + beta P
//                  bound: 3 B H W floats
//   prolong_add    x += s * prolong(xc), the coarse block read at (i/2, j/2)
//                  and cropped to (H, W) as geomg._prolong does
//                  bound: 2 B H W + B ceil(H/2) ceil(W/2) floats
//
// All are bound by memory bytes (one or two flops a float moved).
//
// Rounding: the elementwise arithmetic rounds as the plain expression does,
// a product rounded, then a sum rounded (__fmul_rn, __fadd_rn: never
// contracted to an FMA), so given the same per-column scalars these outputs
// equal the plain version's bits.  Column sums are added in a fixed order of
// their own (each thread's elements in turn, a warp-shuffle tree, the warps
// in order; the partials per column likewise) with no float atomics: the same
// inputs give the same bits on every run, which differ from torch.sum's only
// in the order of the additions.  The host's stall and stop decisions then
// repeat from run to run.
//
// Layout: a block of B columns, each a contiguous (H, W) plane of n = H * W
// floats.  The column kernels' grid is (chunks, B): block (c, b) owns
// elements [c * EPB, (c + 1) * EPB) of column b, and thread t the elements
// c * EPB + k * NT + t, k < U, so each warp's accesses are coalesced and each
// thread has its U loads of every input in flight before it uses one.  Any
// alignment and any n (odd and cropped grids) take the same code.
//
// Each entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int CG_WARPS = 8;
constexpr int CG_NT = 32 * CG_WARPS;    // threads per block
constexpr int CG_U = 8;                 // elements a thread owns
constexpr int CG_EPB = CG_NT * CG_U;    // elements a block owns

// The plain version's where(den > 0, num / where(den == 0, 1, den), 0):
// alpha from (rz, pAp), beta from (rz_new, rz).
__device__ __forceinline__ float cg_ratio(float num, float den) {
    return den > 0.0f ? __fdiv_rn(num, den) : 0.0f;
}

// This thread's elements of its block's share of column blockIdx.y: element
// k is at column offset e(k), inside the column while e(k) < n.
struct Share {
    size_t base;
    long long e0;
    long long n;

    __device__ __forceinline__ explicit Share(int cells)
        : base((size_t)blockIdx.y * cells),
          e0((long long)blockIdx.x * CG_EPB + threadIdx.x), n(cells) {}
    __device__ __forceinline__ long long e(int k) const {
        return e0 + (long long)k * CG_NT;
    }
    __device__ __forceinline__ bool has(int k) const { return e(k) < n; }
    __device__ __forceinline__ size_t at(int k) const {
        return base + (size_t)e(k);
    }
};

// A warp's values summed down to lane 0 in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    return v;
}

// torch.max's rule: a NaN wins.
__device__ __forceinline__ float max_nan(float a, float v) {
    return (v > a || isnan(v)) ? v : a;
}

template <bool REPLACE>
__global__ void __launch_bounds__(CG_NT)
cg_update_xr_kernel(float* __restrict__ x, float* __restrict__ r,
                    const float* __restrict__ p, const float* __restrict__ ap,
                    const float* __restrict__ rz,
                    const float* __restrict__ pap, int n) {
    const float alpha = cg_ratio(rz[blockIdx.y], pap[blockIdx.y]);
    const Share s(n);
    float xv[CG_U], pv[CG_U], rv[CG_U], av[CG_U];
#pragma unroll
    for (int k = 0; k < CG_U; ++k) {
        if (s.has(k)) {
            xv[k] = x[s.at(k)];
            pv[k] = p[s.at(k)];
            if (!REPLACE) {
                rv[k] = r[s.at(k)];
                av[k] = ap[s.at(k)];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < CG_U; ++k) {
        if (s.has(k)) {
            x[s.at(k)] = __fadd_rn(xv[k], __fmul_rn(alpha, pv[k]));
            if (!REPLACE) {
                r[s.at(k)] = __fsub_rn(rv[k], __fmul_rn(alpha, av[k]));
            }
        }
    }
}

// part[(b * chunks + c) * 2 + {0, 1}]: block (c, b)'s sums of r z and r r.
__global__ void __launch_bounds__(CG_NT)
cg_dots_kernel(const float* __restrict__ r, const float* __restrict__ z,
               float* __restrict__ part, int n) {
    __shared__ float sums[2][CG_WARPS];
    const Share s(n);
    float rv[CG_U], zv[CG_U];
#pragma unroll
    for (int k = 0; k < CG_U; ++k) {
        if (s.has(k)) {
            rv[k] = r[s.at(k)];
            zv[k] = z[s.at(k)];
        }
    }
    float rz = 0.0f, rr = 0.0f;
#pragma unroll
    for (int k = 0; k < CG_U; ++k) {
        if (s.has(k)) {
            rz = __fadd_rn(rz, __fmul_rn(rv[k], zv[k]));
            rr = __fadd_rn(rr, __fmul_rn(rv[k], rv[k]));
        }
    }
    rz = warp_sum(rz);
    rr = warp_sum(rr);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (lane == 0) {
        sums[0][w] = rz;
        sums[1][w] = rr;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < CG_WARPS; ++k) {
            t = __fadd_rn(t, sums[threadIdx.x][k]);
        }
        part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 +
             threadIdx.x] = t;
    }
}

// One block of FIN_NT threads: warp w takes columns w, w + FIN_WARPS, ...;
// lane l adds the column's partials of chunks l, l + 32, ... (four loads in
// flight at a time), then a shuffle tree sums the lanes.  Lane 0 writes
// beta = where(rz > 0, rz_new / rz, 0), rz <- rz_new and rn2, and keeps its
// columns' max of sqrt(rn2) / safe and whether any sqrt(rn2) > tol
// (compared in float64, as torch promotes a float32 norm against a float64
// target); thread 0 joins the warps' in warp order into stop = [worst,
// active].  Every warp runs the same number of rounds.
constexpr int FIN_WARPS = 32;
constexpr int FIN_NT = 32 * FIN_WARPS;
constexpr int FIN_U = 4;

__global__ void __launch_bounds__(FIN_NT)
cg_dots_finish_kernel(const float2* __restrict__ part, int chunks, int B,
                      float* __restrict__ rz, float* __restrict__ rn2,
                      float* __restrict__ beta,
                      const float* __restrict__ safe,
                      const double* __restrict__ tol,
                      float* __restrict__ stop) {
    __shared__ float worst_w[FIN_WARPS];
    __shared__ int active_w[FIN_WARPS];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    float worst = -INFINITY;
    int active = 0;
    for (int b0 = 0; b0 < B; b0 += FIN_WARPS) {
        const int b = b0 + w;
        float srz = 0.0f, srr = 0.0f;
        if (b < B) {
            const float2* pb = part + (size_t)b * chunks;
            for (int c = lane; c < chunks; c += 32 * FIN_U) {
                float2 v[FIN_U];
#pragma unroll
                for (int q = 0; q < FIN_U; ++q) {
                    const int at = c + 32 * q;
                    v[q] = at < chunks ? pb[at] : float2{0.0f, 0.0f};
                }
#pragma unroll
                for (int q = 0; q < FIN_U; ++q) {
                    srz = __fadd_rn(srz, v[q].x);
                    srr = __fadd_rn(srr, v[q].y);
                }
            }
        }
        srz = warp_sum(srz);
        srr = warp_sum(srr);
        if (lane == 0 && b < B) {
            beta[b] = cg_ratio(srz, rz[b]);
            rz[b] = srz;
            rn2[b] = srr;
            const float res = __fsqrt_rn(srr);
            worst = max_nan(worst, __fdiv_rn(res, safe[b]));
            active |= (double)res > tol[b];
        }
    }
    if (lane == 0) {
        worst_w[w] = worst;
        active_w[w] = active;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 1; k < FIN_WARPS; ++k) {
            worst = max_nan(worst, worst_w[k]);
            active |= active_w[k];
        }
        stop[0] = worst;
        stop[1] = active ? 1.0f : 0.0f;
    }
}

__global__ void __launch_bounds__(CG_NT)
cg_update_p_kernel(float* __restrict__ p, const float* __restrict__ z,
                   const float* __restrict__ beta, int n) {
    const float bt = beta[blockIdx.y];
    const Share s(n);
    float pv[CG_U], zv[CG_U];
#pragma unroll
    for (int k = 0; k < CG_U; ++k) {
        if (s.has(k)) {
            pv[k] = p[s.at(k)];
            zv[k] = z[s.at(k)];
        }
    }
#pragma unroll
    for (int k = 0; k < CG_U; ++k) {
        if (s.has(k)) p[s.at(k)] = __fadd_rn(zv[k], __fmul_rn(bt, pv[k]));
    }
}

// x (B, H, W) += scale * xc (B, ceil(H/2), ceil(W/2)) at (i/2, j/2): the
// piecewise-constant prolongation, its padded row and column cropped.
__global__ void __launch_bounds__(CG_NT)
prolong_add_kernel(float* __restrict__ x, const float* __restrict__ xc,
                   float scale, int H, int W) {
    const int wc = (W + 1) / 2;
    const size_t coarse = (size_t)((H + 1) / 2) * wc;
    const float* cb = xc + blockIdx.y * coarse;
    const Share s(H * W);
    float xv[CG_U], cv[CG_U];
#pragma unroll
    for (int k = 0; k < CG_U; ++k) {
        if (s.has(k)) {
            const int e = (int)s.e(k);
            const int i = e / W;
            const int j = e - i * W;
            xv[k] = x[s.at(k)];
            cv[k] = cb[(size_t)(i >> 1) * wc + (j >> 1)];
        }
    }
#pragma unroll
    for (int k = 0; k < CG_U; ++k) {
        if (s.has(k)) x[s.at(k)] = __fadd_rn(xv[k], __fmul_rn(scale, cv[k]));
    }
}

inline int bad_shape(int B, int H, int W) {
    // the wrappers never send an empty launch; refuse one.  Offsets within
    // a column are int (H * W < 2^31), across the batch size_t; columns go
    // in gridDim.y.
    return B < 1 || B > 65535 || H < 1 || W < 1 ||
           (long long)H * W > 0x7fffffffLL;
}

inline int chunks_of(int H, int W) {
    return (int)(((long long)H * W + CG_EPB - 1) / CG_EPB);
}

inline dim3 column_grid(int B, int H, int W) {
    return dim3(chunks_of(H, W), B);
}

}  // namespace

extern "C" {

// cg_dots's partial sums per column: one pair per block of its grid.
int cs_cg_chunks(int H, int W) { return chunks_of(H, W); }

int cs_cg_update_xr(float* x, float* r, const float* p, const float* ap,
                    const float* rz, const float* pap, int replace, int B,
                    int H, int W, void* stream) {
    if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
    const dim3 grid = column_grid(B, H, W);
    const cudaStream_t s = (cudaStream_t)stream;
    if (replace) {
        cg_update_xr_kernel<true><<<grid, CG_NT, 0, s>>>(x, r, p, ap, rz, pap,
                                                         H * W);
    } else {
        cg_update_xr_kernel<false><<<grid, CG_NT, 0, s>>>(x, r, p, ap, rz,
                                                          pap, H * W);
    }
    return (int)cudaGetLastError();
}

// part holds 2 * B * cs_cg_chunks(H, W) floats.
int cs_cg_dots(const float* r, const float* z, float* part, float* rz,
               float* rn2, float* beta, const float* safe, const double* tol,
               float* stop, int B, int H, int W, void* stream) {
    if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
    const dim3 grid = column_grid(B, H, W);
    const cudaStream_t s = (cudaStream_t)stream;
    cg_dots_kernel<<<grid, CG_NT, 0, s>>>(r, z, part, H * W);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    cg_dots_finish_kernel<<<1, FIN_NT, 0, s>>>(
        reinterpret_cast<const float2*>(part), (int)grid.x, B, rz, rn2, beta,
        safe, tol, stop);
    return (int)cudaGetLastError();
}

int cs_cg_update_p(float* p, const float* z, const float* beta, int B, int H,
                   int W, void* stream) {
    if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
    cg_update_p_kernel<<<column_grid(B, H, W), CG_NT, 0,
                         (cudaStream_t)stream>>>(p, z, beta, H * W);
    return (int)cudaGetLastError();
}

int cs_prolong_add(float* x, const float* xc, float scale, int B, int H,
                   int W, void* stream) {
    if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
    prolong_add_kernel<<<column_grid(B, H, W), CG_NT, 0,
                         (cudaStream_t)stream>>>(x, xc, scale, H, W);
    return (int)cudaGetLastError();
}

}  // extern "C"
