// Stencil-Laplacian kernels of the geometric-multigrid preconditioned CG
// solve, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// circuitscape_tpu_torch/solve/cuda_stencil.py, which also holds the plain
// torch version of each function.
//
// All tensors are contiguous float32.  The operator is five (H, W) planes:
//   we   weight of edge (i, j)-(i, j+1)       ws   weight of edge (i, j)-(i+1, j)
//   wse  weight of edge (i, j)-(i+1, j+1)     wne  weight of edge (i, j)-(i-1, j+1)
//   diag Laplacian diagonal
// Blocks are (B, H, W); cells outside the grid read as zero.  For cell (i, j)
//   (L x)[i,j] = diag x[i,j] - we[i,j] x[i,j+1] - we[i,j-1] x[i,j-1]
//              - ws[i,j] x[i+1,j] - ws[i-1,j] x[i-1,j]
//              - wse[i,j] x[i+1,j+1] - wse[i-1,j-1] x[i-1,j-1]
//              - wne[i,j] x[i-1,j+1] - wne[i+1,j-1] x[i+1,j-1]
//
// The smoother kernels (cheb_init, cheb_finish) also apply L to Dinv v, i.e.
// they use the weights premultiplied by the inverse diagonal at the cell each
// term reads: w[q] * dinv[off[q]] (the centre: diag * dinv).  The TPU kernels
// read these as nine premultiplied plane copies; here the products are formed
// in registers from the five base planes and dinv, once per cell.
//
// Every kernel here is bound by memory bytes (~20 flops per cell and column
// against at least 8 bytes).  The design moves each byte once: a thread owns
// one cell (residual_restrict: a vertical pair of cells), loads its nine
// weights and the nine offsets of its x reads into registers once, and loops
// over the B columns, so the planes are read once per launch and not once
// per column; x's neighbour reads hit L1, where the neighbouring threads of
// the 32 x 8 tile have brought them.  Neighbours outside the grid get weight
// 0 and an offset clamped into the grid, so the column loop has no branches.
// The column loop stays rolled (cheb_step: unrolled by 2): on the H100,
// unrolling further raised the register count and lost more to occupancy
// than it gained in loads in flight.
// Each entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TX = 32;            // tile columns: one warp along a row
constexpr int TY = 8;             // tile rows
constexpr int NT = TX * TY;       // threads per block
constexpr int NWARP = NT / 32;

struct Planes {
    const float* we;
    const float* ws;
    const float* wse;
    const float* wne;
    const float* diag;
};

// The nine terms of (L x)[i, j], in the plain version's order: centre, E, W,
// S, N, SE, NW, NE, SW.  w: the weight (0 where the neighbour is outside the
// grid), read from its base plane at the edge's source cell; off: the
// neighbour's offset within one (H, W) plane.
struct Stencil9 {
    float w[9];
    int off[9];
};

__device__ __forceinline__ float ld(const float* __restrict__ p, int i, int j,
                                    int H, int W) {
    return (i >= 0 && i < H && j >= 0 && j < W)
               ? __ldg(p + (size_t)i * W + j) : 0.0f;
}

__device__ __forceinline__ Stencil9 load_stencil(const Planes& P, int i,
                                                 int j, int H, int W) {
    constexpr int di[9] = {0, 0, 0, 1, -1, 1, -1, -1, 1};
    constexpr int dj[9] = {0, 1, -1, 0, 0, 1, -1, 1, -1};
    Stencil9 k;
    k.w[0] = ld(P.diag, i, j, H, W);
    k.w[1] = ld(P.we, i, j, H, W);
    k.w[2] = ld(P.we, i, j - 1, H, W);
    k.w[3] = ld(P.ws, i, j, H, W);
    k.w[4] = ld(P.ws, i - 1, j, H, W);
    k.w[5] = ld(P.wse, i, j, H, W);
    k.w[6] = ld(P.wse, i - 1, j - 1, H, W);
    k.w[7] = ld(P.wne, i, j, H, W);
    k.w[8] = ld(P.wne, i + 1, j - 1, H, W);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
        const int ni = i + di[q];
        const int nj = j + dj[q];
        const bool ok = ni >= 0 && ni < H && nj >= 0 && nj < W;
        if (!ok) k.w[q] = 0.0f;
        k.off[q] = ok ? ni * W + nj : i * W + j;
    }
    return k;
}

// The stencil of L Dinv: each weight times dinv at the cell its term reads.
// Terms outside the grid keep weight 0 (their offset is the cell's own).
__device__ __forceinline__ Stencil9 premultiply(Stencil9 k,
                                                const float* __restrict__ dinv) {
#pragma unroll
    for (int q = 0; q < 9; ++q) k.w[q] *= __ldg(dinv + k.off[q]);
    return k;
}

// (L x)[i, j] for one column x (H, W).
__device__ __forceinline__ float lap(const Stencil9& k,
                                     const float* __restrict__ x) {
    float y = k.w[0] * __ldg(x + k.off[0]);
#pragma unroll
    for (int q = 1; q < 9; ++q) y -= k.w[q] * __ldg(x + k.off[q]);
    return y;
}

__global__ void __launch_bounds__(NT)
matvec_kernel(Planes P, const float* __restrict__ x, float* __restrict__ y,
              int B, int H, int W) {
    const int j = blockIdx.x * TX + threadIdx.x;
    const int i = blockIdx.y * TY + threadIdx.y;
    if (i >= H || j >= W) return;
    const Stencil9 k = load_stencil(P, i, j, H, W);
    const size_t plane = (size_t)H * W;
    const int at = i * W + j;
#pragma unroll 1
    for (int b = 0; b < B; ++b) {
        y[b * plane + at] = lap(k, x + b * plane);
    }
}

// y = L x, and part[b, block] = sum over the block's cells of x * y.  The
// block sum is a fixed-order tree (warp shuffles, then the warps' sums in
// warp order), so the result is deterministic; no atomics.  Columns go in
// groups of 32, one barrier pair per group.
__global__ void __launch_bounds__(NT)
matvec_pap_kernel(Planes P, const float* __restrict__ x, float* __restrict__ y,
                  float* __restrict__ part, int B, int H, int W) {
    __shared__ float warp_sum[32][NWARP];
    const int j = blockIdx.x * TX + threadIdx.x;
    const int i = blockIdx.y * TY + threadIdx.y;
    const bool inside = i < H && j < W;
    const int tid = threadIdx.y * TX + threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nblk = gridDim.x * gridDim.y;
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    Stencil9 k;
    if (inside) {
        k = load_stencil(P, i, j, H, W);
    } else {
#pragma unroll
        for (int q = 0; q < 9; ++q) {
            k.w[q] = 0.0f;
            k.off[q] = 0;
        }
    }
    const size_t plane = (size_t)H * W;
    const int at = inside ? i * W + j : 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
        const int nb = min(32, B - b0);
#pragma unroll 1
        for (int c = 0; c < nb; ++c) {
            const size_t base = (size_t)(b0 + c) * plane;
            float v = 0.0f;
            if (inside) {
                const float yv = lap(k, x + base);
                y[base + at] = yv;
                v = __ldg(x + base + at) * yv;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                v += __shfl_down_sync(0xffffffffu, v, off);
            }
            if (lane == 0) warp_sum[c][warp] = v;
        }
        __syncthreads();
        if (tid < nb) {
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < NWARP; ++w) s += warp_sum[tid][w];
            part[(size_t)(b0 + tid) * nblk + blk] = s;
        }
        __syncthreads();
    }
}

// r' = r - L d;  d' = ca d + cb dinv r';  x' = x + d'.
__global__ void __launch_bounds__(NT)
cheb_step_kernel(Planes P, const float* __restrict__ dinv,
                 const float* __restrict__ r, const float* __restrict__ d,
                 const float* __restrict__ x, float* __restrict__ r_out,
                 float* __restrict__ d_out, float* __restrict__ x_out,
                 float ca, float cb, int B, int H, int W) {
    const int j = blockIdx.x * TX + threadIdx.x;
    const int i = blockIdx.y * TY + threadIdx.y;
    if (i >= H || j >= W) return;
    const Stencil9 k = load_stencil(P, i, j, H, W);
    const size_t plane = (size_t)H * W;
    const int at = i * W + j;
    const float dv = __ldg(dinv + at);
#pragma unroll 2
    for (int b = 0; b < B; ++b) {
        const size_t o = b * plane + at;
        const float* db = d + b * plane;
        const float rn = __ldg(r + o) - lap(k, db);
        const float dn = ca * __ldg(db + at) + cb * (dv * rn);
        r_out[o] = rn;
        d_out[o] = dn;
        x_out[o] = __ldg(x + o) + dn;
    }
}

// rc[b, I, J] = sum over the fine cells (2I + a, 2J + c), a, c in {0, 1},
// inside the grid, of (b - L x); odd H or W restrict as if zero-padded.  A
// thread owns the vertical pair (2I, j), (2I + 1, j) of fine column j; the
// even lane of each lane pair adds its odd neighbour's pair sum and writes
// coarse cell (I, j / 2).  All lanes stay for the shuffle.
__global__ void __launch_bounds__(NT)
residual_restrict_kernel(Planes P, const float* __restrict__ bvec,
                         const float* __restrict__ x, float* __restrict__ rc,
                         int B, int H, int W) {
    const int Hc = (H + 1) / 2;
    const int Wc = (W + 1) / 2;
    const int j = blockIdx.x * TX + threadIdx.x;
    const int I = blockIdx.y * TY + threadIdx.y;
    const bool top = I < Hc && j < W;            // fine row 2I is inside
    const bool bot = top && 2 * I + 1 < H;       // fine row 2I + 1 too
    Stencil9 k0, k1;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
        k0.w[q] = k1.w[q] = 0.0f;
        k0.off[q] = k1.off[q] = 0;
    }
    if (top) k0 = load_stencil(P, 2 * I, j, H, W);
    if (bot) k1 = load_stencil(P, 2 * I + 1, j, H, W);
    const int at0 = top ? 2 * I * W + j : 0;
    const int at1 = bot ? at0 + W : 0;
    const bool writer = (threadIdx.x & 1) == 0 && I < Hc && j / 2 < Wc &&
                        j < W;
    const size_t plane = (size_t)H * W;
    const size_t cplane = (size_t)Hc * Wc;
    const size_t cat = (size_t)I * Wc + j / 2;
#pragma unroll 1
    for (int b = 0; b < B; ++b) {
        const float* xb = x + b * plane;
        const float* bb = bvec + b * plane;
        float s = 0.0f;
        if (top) s = __ldg(bb + at0) - lap(k0, xb);
        if (bot) s += __ldg(bb + at1) - lap(k1, xb);
        s += __shfl_down_sync(0xffffffffu, s, 1);
        if (writer) rc[b * cplane + cat] = s;
    }
}

// The degree-2 Chebyshev smoother from x = 0 in one pass:
//   x = (1 + ca) c dinv b + cb dinv (b - c L (dinv b)).
__global__ void __launch_bounds__(NT)
cheb_init_kernel(Planes P, const float* __restrict__ dinv,
                 const float* __restrict__ bvec, float* __restrict__ x,
                 float c, float ca, float cb, int B, int H, int W) {
    const int j = blockIdx.x * TX + threadIdx.x;
    const int i = blockIdx.y * TY + threadIdx.y;
    if (i >= H || j >= W) return;
    const Stencil9 k = premultiply(load_stencil(P, i, j, H, W), dinv);
    const size_t plane = (size_t)H * W;
    const int at = i * W + j;
    const float dv = __ldg(dinv + at);
    const float c0 = (1.0f + ca) * c;
#pragma unroll 1
    for (int b = 0; b < B; ++b) {
        const float* bb = bvec + b * plane;
        const float bv = __ldg(bb + at);
        const float r1 = bv - c * lap(k, bb);
        x[b * plane + at] = c0 * (dv * bv) + cb * (dv * r1);
    }
}

// Pass 1 of the warm smoother: r0 = b - L x;  x1 = x + c dinv r0.
__global__ void __launch_bounds__(NT)
residual_init_kernel(Planes P, const float* __restrict__ dinv,
                     const float* __restrict__ bvec,
                     const float* __restrict__ x, float* __restrict__ r_out,
                     float* __restrict__ x1_out, float c, int B, int H,
                     int W) {
    const int j = blockIdx.x * TX + threadIdx.x;
    const int i = blockIdx.y * TY + threadIdx.y;
    if (i >= H || j >= W) return;
    const Stencil9 k = load_stencil(P, i, j, H, W);
    const size_t plane = (size_t)H * W;
    const int at = i * W + j;
    const float dv = __ldg(dinv + at);
#pragma unroll 1
    for (int b = 0; b < B; ++b) {
        const size_t o = b * plane + at;
        const float* xb = x + b * plane;
        const float r = __ldg(bvec + o) - lap(k, xb);
        r_out[o] = r;
        x1_out[o] = __ldg(xb + at) + c * (dv * r);
    }
}

// Pass 2 of the warm smoother:
//   x2 = x1 + ca c dinv r0 + cb dinv (r0 - c L (dinv r0)).
// Reads r0 at neighbour offsets, so pass 1 must have written all of it.
__global__ void __launch_bounds__(NT)
cheb_finish_kernel(Planes P, const float* __restrict__ dinv,
                   const float* __restrict__ r0, const float* __restrict__ x1,
                   float* __restrict__ x2, float c, float ca, float cb, int B,
                   int H, int W) {
    const int j = blockIdx.x * TX + threadIdx.x;
    const int i = blockIdx.y * TY + threadIdx.y;
    if (i >= H || j >= W) return;
    const Stencil9 k = premultiply(load_stencil(P, i, j, H, W), dinv);
    const size_t plane = (size_t)H * W;
    const int at = i * W + j;
    const float dv = __ldg(dinv + at);
    const float cac = ca * c;
#pragma unroll 1
    for (int b = 0; b < B; ++b) {
        const size_t o = b * plane + at;
        const float* rb = r0 + b * plane;
        const float rv = __ldg(rb + at);
        const float r1 = rv - c * lap(k, rb);
        x2[o] = __ldg(x1 + o) + cac * (dv * rv) + cb * (dv * r1);
    }
}

inline dim3 tiles(int rows, int cols) {
    return dim3((cols + TX - 1) / TX, (rows + TY - 1) / TY);
}

inline int launch_error(int B, int H, int W) {
    // the wrappers never send an empty launch; refuse one rather than
    // launching a zero-sized grid
    if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    return -1;
}

}  // namespace

extern "C" {

int cs_matvec_pap_blocks(int H, int W) {
    const dim3 g = tiles(H, W);
    return (int)(g.x * g.y);
}

int cs_matvec(const float* we, const float* ws, const float* wse,
              const float* wne, const float* diag, const float* x, float* y,
              int B, int H, int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    matvec_kernel<<<tiles(H, W), dim3(TX, TY), 0, (cudaStream_t)stream>>>(
        P, x, y, B, H, W);
    return (int)cudaGetLastError();
}

int cs_matvec_pap(const float* we, const float* ws, const float* wse,
                  const float* wne, const float* diag, const float* x,
                  float* y, float* part, int B, int H, int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    matvec_pap_kernel<<<tiles(H, W), dim3(TX, TY), 0,
                        (cudaStream_t)stream>>>(P, x, y, part, B, H, W);
    return (int)cudaGetLastError();
}

int cs_cheb_step(const float* we, const float* ws, const float* wse,
                 const float* wne, const float* diag, const float* dinv,
                 const float* r, const float* d, const float* x, float* r_out,
                 float* d_out, float* x_out, float ca, float cb, int B, int H,
                 int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    cheb_step_kernel<<<tiles(H, W), dim3(TX, TY), 0, (cudaStream_t)stream>>>(
        P, dinv, r, d, x, r_out, d_out, x_out, ca, cb, B, H, W);
    return (int)cudaGetLastError();
}

int cs_residual_restrict(const float* we, const float* ws, const float* wse,
                         const float* wne, const float* diag, const float* b,
                         const float* x, float* rc, int B, int H, int W,
                         void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    // one thread per fine column and coarse row
    residual_restrict_kernel<<<tiles((H + 1) / 2, W), dim3(TX, TY), 0,
                               (cudaStream_t)stream>>>(P, b, x, rc, B, H, W);
    return (int)cudaGetLastError();
}

int cs_cheb_init(const float* we, const float* ws, const float* wse,
                 const float* wne, const float* diag, const float* dinv,
                 const float* b, float* x, float c, float ca, float cb, int B,
                 int H, int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    cheb_init_kernel<<<tiles(H, W), dim3(TX, TY), 0, (cudaStream_t)stream>>>(
        P, dinv, b, x, c, ca, cb, B, H, W);
    return (int)cudaGetLastError();
}

int cs_residual_init(const float* we, const float* ws, const float* wse,
                     const float* wne, const float* diag, const float* dinv,
                     const float* b, const float* x, float* r_out,
                     float* x1_out, float c, int B, int H, int W,
                     void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    residual_init_kernel<<<tiles(H, W), dim3(TX, TY), 0,
                           (cudaStream_t)stream>>>(P, dinv, b, x, r_out,
                                                   x1_out, c, B, H, W);
    return (int)cudaGetLastError();
}

int cs_cheb_finish(const float* we, const float* ws, const float* wse,
                   const float* wne, const float* diag, const float* dinv,
                   const float* r0, const float* x1, float* x2, float c,
                   float ca, float cb, int B, int H, int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    cheb_finish_kernel<<<tiles(H, W), dim3(TX, TY), 0,
                         (cudaStream_t)stream>>>(P, dinv, r0, x1, x2, c, ca,
                                                 cb, B, H, W);
    return (int)cudaGetLastError();
}

}  // extern "C"
