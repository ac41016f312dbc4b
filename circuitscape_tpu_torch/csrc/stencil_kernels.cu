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
// term reads: w[q] * dinv[neighbour q] (the centre: diag * dinv).  The TPU
// kernels read these as nine premultiplied plane copies; here the products
// are formed in registers from the five base planes and dinv, once per cell
// and block.
//
// Every kernel here is bound by memory bytes (~20 flops per cell and column
// against at least 8 bytes), and each moves every byte once: the weights are
// read once per block, not once per column, because a block loops over the
// B columns (or over a chunk of them) with the weights it needs held in
// registers.
//
// The seven stage their inputs: for each column, the block copies the tile
// of the block the stencil reads with a one-cell halo (x; b for cheb_init,
// r0 for cheb_finish, d for cheb_step), and the tile of any other input
// block (residual_restrict, residual_init: b; cheb_finish: x1; cheb_step: r
// and x), into shared memory with cp.async, into a ring of NSTAGE buffers,
// so the copies of the next two columns are in flight while this column's
// stencils are computed from shared memory.  (Their first design, one
// thread per cell or cell pair reading through L1 and walking all B
// columns, reached under half of the byte bound at 1024^2 or per job, or
// launched too few blocks to fill the card on the coarse levels where the
// main path runs them.)  Cells outside the grid are zero-filled by the
// copy, so they read as zero without clamped offsets, and every width takes
// the same 4-byte copies (no 16-byte alignment needed, unlike TMA).  Each
// thread owns several cells (residual_restrict: one 2 x 2 fine patch; the
// others: a vertical strip of 4 in one fine column, of 1 on the levels too
// small for strips of 4 to fill the card) and holds their weights in
// registers, loaded while the first copies fly.  A block owns one tile and
// a chunk of the B columns (blockIdx.x), chosen per launch so the grid
// fills the card (two waves of resident blocks; residual_init: 2 * sms
// blocks, at most one wave): small levels spread the columns over blocks
// rather than walk them in sequence.  The chunk index varies fastest, so
// the blocks of one tile run together and share its weights in L2.
//
// Each entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NWARP = 8;
constexpr int NT = 32 * NWARP;    // threads per block

struct Planes {
    const float* we;
    const float* ws;
    const float* wse;
    const float* wne;
    const float* diag;
};

__device__ __forceinline__ float ld(const float* __restrict__ p, int i, int j,
                                    int H, int W) {
    return (i >= 0 && i < H && j >= 0 && j < W)
               ? __ldg(p + (size_t)i * W + j) : 0.0f;
}

// --- staged kernels: each column's tiles in shared memory ----------------

constexpr int NSTAGE = 3;         // ring buffers: two columns in flight

// The nine weights of cell (i, j) in the plain version's order of the terms
// of (L x)[i, j] (centre, E, W, S, N, SE, NW, NE, SW), each read from its
// base plane at the edge's source cell: 0 where that cell is outside the
// grid, and all 0 for a cell outside the grid (odd sides: its residual is
// 0, as zero padding makes it).  A neighbour outside the grid reads as 0
// from the staged window.
__device__ __forceinline__ void load_weights(const Planes& P, int i, int j,
                                             int H, int W, float (&w)[9]) {
    const bool in = i < H && j < W;
    w[0] = in ? ld(P.diag, i, j, H, W) : 0.0f;
    w[1] = in ? ld(P.we, i, j, H, W) : 0.0f;
    w[2] = in ? ld(P.we, i, j - 1, H, W) : 0.0f;
    w[3] = in ? ld(P.ws, i, j, H, W) : 0.0f;
    w[4] = in ? ld(P.ws, i - 1, j, H, W) : 0.0f;
    w[5] = in ? ld(P.wse, i, j, H, W) : 0.0f;
    w[6] = in ? ld(P.wse, i - 1, j - 1, H, W) : 0.0f;
    w[7] = in ? ld(P.wne, i, j, H, W) : 0.0f;
    w[8] = in ? ld(P.wne, i + 1, j - 1, H, W) : 0.0f;
}

// (L x) at the centre of a 3 x 3 window n[row][col] of x, in the plain
// version's order.
__device__ __forceinline__ float lap3x3(const float (&w)[9], float n00,
                                        float n01, float n02, float n10,
                                        float n11, float n12, float n20,
                                        float n21, float n22) {
    float y = w[0] * n11;
    y -= w[1] * n12;
    y -= w[2] * n10;
    y -= w[3] * n21;
    y -= w[4] * n01;
    y -= w[5] * n22;
    y -= w[6] * n00;
    y -= w[7] * n02;
    y -= w[8] * n20;
    return y;
}

// A ROWS x COLS window of one (H, W) plane, staged by the whole block.  Its
// cells' offsets in the plane are the same for every column, so each thread
// computes those of its K cells once; -1 marks a cell outside the grid,
// which the copy zero-fills.
template <int ROWS, int COLS>
struct Window {
    static constexpr int N = ROWS * COLS;
    static constexpr int K = (N + NT - 1) / NT;
    int src[K];

    __device__ __forceinline__ Window(int gi0, int gj0, int H, int W) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int e = threadIdx.x + k * NT;
            const int r = e / COLS;
            const int gi = gi0 + r;
            const int gj = gj0 + e - r * COLS;
            src[k] = (e < N && gi >= 0 && gi < H && gj >= 0 && gj < W)
                         ? gi * W + gj : -1;
        }
    }

    // Start the copy of plane xb's window into s (row stride COLS).
    __device__ __forceinline__ void stage(float* s,
                                          const float* __restrict__ xb) const {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int e = threadIdx.x + k * NT;
            if (e < N) {
                const bool ok = src[k] >= 0;
                __pipeline_memcpy_async(s + e, xb + (ok ? src[k] : 0),
                                        sizeof(float), ok ? 0 : sizeof(float));
            }
        }
    }
};

// The nb columns of a block's chunk go through a ring of NSTAGE buffers.
// fill(buf, c) starts the copies of column c into buf.  ring_start starts
// columns 0 .. NSTAGE - 2, so a kernel can load its weights while they are
// in flight; ring_walk then runs body(c, buf) for every column once its
// copies have landed, with those of columns c + 1 and c + 2 in flight.  One
// barrier per column: it also guarantees that every thread is done with
// column c - 1's buffer, which the copies issued right after it refill.
template <class Stage, class Fill>
__device__ __forceinline__ void ring_start(Stage* ring, int nb, Fill fill) {
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nb) fill(ring[s], s);
        __pipeline_commit();
    }
}

template <class Stage, class Fill, class Body>
__device__ __forceinline__ void ring_walk(Stage* ring, int nb, Fill fill,
                                          Body body) {
#pragma unroll 1
    for (int c = 0; c < nb; ++c) {
        __pipeline_wait_prior(NSTAGE - 2);
        __syncthreads();
        const int next = c + NSTAGE - 1;
        if (next < nb) fill(ring[next % NSTAGE], next);
        __pipeline_commit();
        body(c, ring[c % NSTAGE]);
    }
}

// The strip kernels (all but residual_restrict): a 32-column x
// NWARP*R-row tile; thread (tx, ty) owns the strip of R cells (rows
// ty*R ...) of fine column tx.  R is ST_R, except for the launches of
// matvec and cheb_step on levels too coarse to fill the card
// (short_strips), and of residual_init on levels whose strips of ST_R
// would fill under half a wave: there R = 1.  A staged window over the
// tile with a one-cell halo has NWARP*R + 2 rows of ST_COLS.
constexpr int ST_R = 4;
constexpr int ST_TX = 32;
constexpr int ST_TY = NWARP * ST_R;
constexpr int ST_ROWS = ST_TY + 2;
constexpr int ST_COLS = ST_TX + 2;

// What the strip of thread (tx, ty) reads of a staged window t (N = R + 2
// rows): window rows ty*R .. ty*R + R + 1 (the window row of cell i0 + r is
// ty*R + r + 1), columns tx .. tx + 2.
template <int N>
__device__ __forceinline__ void read_strip(const float* t, int tx, int ty,
                                           float (&n)[N][3]) {
    const float* s = t + ty * (N - 2) * ST_COLS + tx;
#pragma unroll
    for (int r = 0; r < N; ++r) {
#pragma unroll
        for (int q = 0; q < 3; ++q) n[r][q] = s[r * ST_COLS + q];
    }
}

// (L v) at cell r of a strip whose neighbourhood is n (with the smoother
// kernels' premultiplied weights, L Dinv v).
template <int N>
__device__ __forceinline__ float lap_strip(const float (&w)[9],
                                           const float (&n)[N][3], int r) {
    return lap3x3(w, n[r][0], n[r][1], n[r][2], n[r + 1][0], n[r + 1][1],
                  n[r + 1][2], n[r + 2][0], n[r + 2][1], n[r + 2][2]);
}

// The body of matvec (DOT false) and matvec_pap (DOT true): y = L x, and
// with DOT part[b, tile] = sum over the tile's cells of x * y.  Bound by
// bytes (x in, y out, five planes).  x is staged through the ring; each
// thread slides down its strip reading three x values per row from shared
// memory (each x value about 3 times per strip of 4, not 9) and keeps the
// strip's weights in registers, summed in the plain version's order.  With
// DOT it keeps its x . y in one register and the block reduces once per
// column, in a fixed order (warp shuffles, then the warps' sums in warp
// order), so p.Ap repeats to the bit; no atomics.  Columns go in groups of
// 32, one extra barrier per group.
template <bool DOT, int R>
__device__ __forceinline__ void matvec_strip(
        const Planes& P, const float* __restrict__ x, float* __restrict__ y,
        float* __restrict__ part, int B, int cb, int H, int W) {
    constexpr int TY = NWARP * R;
    __shared__ __align__(16) float ring[NSTAGE][(TY + 2) * ST_COLS];
    __shared__ float warp_sum[DOT ? 32 : 1][NWARP];
    const int tid = threadIdx.x;
    const int tx = tid & 31;
    const int ty = tid >> 5;
    const int j = blockIdx.y * ST_TX + tx;
    const int i0 = blockIdx.z * TY + ty * R;
    const int b0 = blockIdx.x * cb;
    const int nb = min(cb, B - b0);
    const Window<TY + 2, ST_COLS> win((int)blockIdx.z * TY - 1,
                                      (int)blockIdx.y * ST_TX - 1, H, W);
    const size_t plane = (size_t)H * W;
    const auto fill = [&](float* buf, int c) {
        win.stage(buf, x + (b0 + c) * plane);
    };
    ring_start(ring, nb, fill);
    float w[R][9];
#pragma unroll
    for (int r = 0; r < R; ++r) load_weights(P, i0 + r, j, H, W, w[r]);
    const bool col_in = j < W;
    ring_walk(ring, nb, fill, [&](int c, const float* t) {
        float n[R + 2][3];
        read_strip(t, tx, ty, n);
        float* yb = y + (b0 + c) * plane;
        float v = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float yv = lap_strip(w[r], n, r);
            if (col_in && i0 + r < H) yb[(size_t)(i0 + r) * W + j] = yv;
            if (DOT) v += n[r + 1][1] * yv;
        }
        if constexpr (DOT) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                v += __shfl_down_sync(0xffffffffu, v, off);
            }
            const int g = c & 31;
            if (tx == 0) warp_sum[g][ty] = v;
            if (g == 31 || c == nb - 1) {
                // a group of up to 32 columns is done: one thread per
                // column adds the warps' sums in warp order.  The ring's
                // barrier at the next column keeps warp_sum from being
                // overwritten first.
                __syncthreads();
                if (tid <= g) {
                    float sum = 0.0f;
#pragma unroll
                    for (int k = 0; k < NWARP; ++k) sum += warp_sum[tid][k];
                    const int ntile = gridDim.y * gridDim.z;
                    const int tile = blockIdx.z * gridDim.y + blockIdx.y;
                    part[(size_t)(b0 + c - g + tid) * ntile + tile] = sum;
                }
            }
        }
    });
}

// Replaces _kernel / pallas_matvec (pallas_stencil.py:175, 900).  y = L x.
// Staged as matvec_pap (its first design, a thread per cell of a 32 x 8
// tile walking all B columns, launched 4 blocks at 32^2, the one level where
// the main path's V-cycle runs it, and took 10 us there).
template <int R>
__global__ void __launch_bounds__(NT)
matvec_kernel(Planes P, const float* __restrict__ x, float* __restrict__ y,
              int B, int cb, int H, int W) {
    matvec_strip<false, R>(P, x, y, nullptr, B, cb, H, W);
}

// Replaces _mv_dot_kernel / pallas_matvec_pap (pallas_stencil.py:820, 856).
__global__ void __launch_bounds__(NT)
matvec_pap_kernel(Planes P, const float* __restrict__ x, float* __restrict__ y,
                  float* __restrict__ part, int B, int cb, int H, int W) {
    matvec_strip<true, ST_R>(P, x, y, part, B, cb, H, W);
}

// residual_restrict: a 32 x 8 tile of coarse cells; thread (tx, ty) owns
// coarse cell (ty, tx) of it, the 2 x 2 fine patch at (2ty, 2tx).  A stage of
// the ring holds x's window over the tile's 16 fine rows and 64 columns with
// a one-cell halo, and one more column each side so that every patch starts
// at an even (8-byte aligned) offset, and b's window over the tile.
constexpr int RR_TX = 32;
constexpr int RR_TY = NWARP;
constexpr int RR_ROWS = 2 * RR_TY + 2;
constexpr int RR_COLS = 2 * RR_TX + 4;

struct RRStage {
    float x[RR_ROWS * RR_COLS];
    float b[2 * RR_TY * 2 * RR_TX];
};

// Replaces _rr_kernel / pallas_residual_restrict (pallas_stencil.py:724,
// 761).  rc[b, I, J] = sum over the fine cells (2I + a, 2J + c), a, c in
// {0, 1}, inside the grid, of (b - L x); odd H or W restrict as if
// zero-padded.  Bound by bytes (x and b in, the quarter-size rc out, five
// planes; the full-size residual is never written).  x and b are staged
// through the ring; a thread reads its patch's 4 x 4 neighbourhood of x as
// three float2 per row and its 2 x 2 of b as two, keeps the patch's 36
// weights in registers, sums its four residuals in registers and writes one
// coarse cell: consecutive threads, consecutive cells.
__global__ void __launch_bounds__(NT)
residual_restrict_kernel(Planes P, const float* __restrict__ bvec,
                         const float* __restrict__ x, float* __restrict__ rc,
                         int B, int cb, int H, int W) {
    __shared__ __align__(16) RRStage ring[NSTAGE];
    const int tid = threadIdx.x;
    const int tx = tid & 31;
    const int ty = tid >> 5;
    const int Hc = (H + 1) / 2;
    const int Wc = (W + 1) / 2;
    const int I = blockIdx.z * RR_TY + ty;
    const int J = blockIdx.y * RR_TX + tx;
    const bool owns = I < Hc && J < Wc;   // the coarse cell is inside
    const int b0 = blockIdx.x * cb;
    const int nb = min(cb, B - b0);
    // the tile's first fine cell
    const int gi0 = 2 * (int)blockIdx.z * RR_TY;
    const int gj0 = 2 * (int)blockIdx.y * RR_TX;
    const Window<RR_ROWS, RR_COLS> xwin(gi0 - 1, gj0 - 2, H, W);
    const Window<2 * RR_TY, 2 * RR_TX> bwin(gi0, gj0, H, W);
    const size_t plane = (size_t)H * W;
    const size_t cplane = (size_t)Hc * Wc;
    const auto fill = [&](RRStage& st, int c) {
        xwin.stage(st.x, x + (b0 + c) * plane);
        bwin.stage(st.b, bvec + (b0 + c) * plane);
    };
    ring_start(ring, nb, fill);
    float w[2][2][9];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            load_weights(P, owns ? 2 * I + a : H, 2 * J + c, H, W, w[a][c]);
        }
    }
    ring_walk(ring, nb, fill, [&](int c, const RRStage& st) {
        // the patch's neighbourhood: fine rows 2I - 1 .. 2I + 2 are x window
        // rows 2ty .. 2ty + 3; fine columns 2J - 1 .. 2J + 2 are x window
        // columns 2tx + 1 .. 2tx + 4, read as the float2 pairs at 2tx,
        // 2tx + 2 and 2tx + 4
        const float* s = st.x + 2 * ty * RR_COLS + 2 * tx;
        float n[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float2* p = reinterpret_cast<const float2*>(s + r * RR_COLS);
            const float2 p0 = p[0], p1 = p[1], p2 = p[2];
            n[r][0] = p0.y;
            n[r][1] = p1.x;
            n[r][2] = p1.y;
            n[r][3] = p2.x;
        }
        float sum = 0.0f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            const float2 bp = *reinterpret_cast<const float2*>(
                st.b + (2 * ty + a) * 2 * RR_TX + 2 * tx);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                sum += (q ? bp.y : bp.x) -
                       lap3x3(w[a][q], n[a][q], n[a][q + 1], n[a][q + 2],
                              n[a + 1][q], n[a + 1][q + 1], n[a + 1][q + 2],
                              n[a + 2][q], n[a + 2][q + 1], n[a + 2][q + 2]);
            }
        }
        if (owns) rc[(b0 + c) * cplane + (size_t)I * Wc + J] = sum;
    });
}

// cheb_init and cheb_finish, the smoother kernels that apply L Dinv, are
// strip kernels with strips of ST_R.  A stage of the ring holds the window
// of the block the stencil reads (b, r0) over the tile with a one-cell
// halo; cheb_finish's also holds x1's tile.  dinv's window, of the same
// geometry, is staged once per block.

// The weights of L Dinv and the dinv values of thread (tx, ty)'s strip, in
// registers.  dsh is dinv's window over the tile, in the stencil window's
// geometry, whose copies the kernel issued with column 0's, so it holds 0
// outside the grid and dinv is never read there.  The base weights' loads
// are issued first; then the thread waits for column 0's copy group and
// multiplies each weight by dinv at the cell its term reads (the centre:
// diag * dinv at the cell), one float32 product as expand_planes forms it,
// so the two agree to the bit.
__device__ __forceinline__ void strip_weights_dinv(
        const Planes& P, const float* dsh, int i0, int j, int tx, int ty,
        int H, int W, float (&w)[ST_R][9], float (&dv)[ST_R]) {
    constexpr int di[9] = {0, 0, 0, 1, -1, 1, -1, -1, 1};
    constexpr int dj[9] = {0, 1, -1, 0, 0, 1, -1, 1, -1};
#pragma unroll
    for (int r = 0; r < ST_R; ++r) load_weights(P, i0 + r, j, H, W, w[r]);
    __pipeline_wait_prior(NSTAGE - 2);
    __syncthreads();
    const float* s = dsh + (ty * ST_R + 1) * ST_COLS + tx + 1;
#pragma unroll
    for (int r = 0; r < ST_R; ++r) {
        const float* sr = s + r * ST_COLS;
#pragma unroll
        for (int q = 0; q < 9; ++q) w[r][q] *= sr[di[q] * ST_COLS + dj[q]];
        dv[r] = sr[0];
    }
}


// Replaces _cheb_init_kernel / pallas_cheb_init (pallas_stencil.py:473,
// 502).  The degree-2 Chebyshev smoother from x = 0 in one pass:
//   x = (1 + ca) c dinv b + cb dinv (b - c L (dinv b)).
// Bound by bytes (b in, x out, five planes and dinv).  b is staged through
// the ring; each thread slides down its strip reading three b values a row
// from shared memory, and holds the strip's 36 premultiplied weights and 4
// dinv values in registers, formed once per block from dinv's window,
// staged once (read through __ldg instead, it took 96 registers against 74
// and the bench job's launches 7% longer on the H100).
__global__ void __launch_bounds__(NT)
cheb_init_kernel(Planes P, const float* __restrict__ dinv,
                 const float* __restrict__ bvec, float* __restrict__ x,
                 float c, float ca, float cb, int B, int chunk, int H,
                 int W) {
    __shared__ __align__(16) float ring[NSTAGE][ST_ROWS * ST_COLS];
    __shared__ float dsh[ST_ROWS * ST_COLS];
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
    const int j = blockIdx.y * ST_TX + tx;
    const int i0 = blockIdx.z * ST_TY + ty * ST_R;
    const int b0 = blockIdx.x * chunk;
    const int nb = min(chunk, B - b0);
    const Window<ST_ROWS, ST_COLS> win((int)blockIdx.z * ST_TY - 1,
                                       (int)blockIdx.y * ST_TX - 1, H, W);
    const size_t plane = (size_t)H * W;
    const auto fill = [&](float* buf, int k) {
        win.stage(buf, bvec + (b0 + k) * plane);
    };
    win.stage(dsh, dinv);   // joins column 0's copy group
    ring_start(ring, nb, fill);
    float w[ST_R][9], dv[ST_R];
    strip_weights_dinv(P, dsh, i0, j, tx, ty, H, W, w, dv);
    const float c0 = (1.0f + ca) * c;
    const bool col_in = j < W;
    ring_walk(ring, nb, fill, [&](int k, const float* t) {
        float n[ST_R + 2][3];
        read_strip(t, tx, ty, n);
        float* xb = x + (b0 + k) * plane;
#pragma unroll
        for (int r = 0; r < ST_R; ++r) {
            const float bv = n[r + 1][1];
            const float r1 = bv - c * lap_strip(w[r], n, r);
            if (col_in && i0 + r < H) {
                xb[(size_t)(i0 + r) * W + j] =
                    c0 * (dv[r] * bv) + cb * (dv[r] * r1);
            }
        }
    });
}

// Replaces _res_init_kernel / pallas_residual_init (pallas_stencil.py:573,
// 631).  Pass 1 of the warm smoother: r0 = b - L x;  x1 = x + c dinv r0.
// Bound by bytes (b and x in, r0 and x1 out, five planes and dinv).
// cheb_step's design: x, which the stencil reads, is staged through the
// ring with a one-cell halo and b's tile in the same stage; x1 takes x at
// the cell from the window's centre, so x is read from device memory once.
// The base weights and dinv at the strip's own cells are loaded into
// registers while the first copies fly.  Its first design (a thread per
// cell of a 32 x 8 tile walking all B columns, neighbours through L1)
// reached 65% of the byte bound at 1024^2 and ~37% on the bench job's
// 512^2-64^2 levels, where it launched 16-1024 blocks on the H100's 132
// SMs.
template <int R>
struct RIStage {
    static constexpr int TY = NWARP * R;
    float x[(TY + 2) * ST_COLS];
    float b[TY * ST_TX];
};

template <int R>
__global__ void __launch_bounds__(NT)
residual_init_kernel(Planes P, const float* __restrict__ dinv,
                     const float* __restrict__ bvec,
                     const float* __restrict__ x, float* __restrict__ r_out,
                     float* __restrict__ x1_out, float c, int B, int chunk,
                     int H, int W) {
    using Stage = RIStage<R>;
    constexpr int TY = Stage::TY;
    __shared__ __align__(16) Stage ring[NSTAGE];
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
    const int j = blockIdx.y * ST_TX + tx;
    const int i0 = blockIdx.z * TY + ty * R;
    const int b0 = blockIdx.x * chunk;
    const int nb = min(chunk, B - b0);
    const int gi0 = (int)blockIdx.z * TY;
    const int gj0 = (int)blockIdx.y * ST_TX;
    const Window<TY + 2, ST_COLS> xwin(gi0 - 1, gj0 - 1, H, W);
    const Window<TY, ST_TX> bwin(gi0, gj0, H, W);
    const size_t plane = (size_t)H * W;
    const auto fill = [&](Stage& st, int k) {
        const size_t o = (b0 + k) * plane;
        xwin.stage(st.x, x + o);
        bwin.stage(st.b, bvec + o);
    };
    ring_start(ring, nb, fill);
    const bool col_in = j < W;
    float w[R][9], dv[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
        load_weights(P, i0 + q, j, H, W, w[q]);
        dv[q] = col_in && i0 + q < H ? __ldg(dinv + (size_t)(i0 + q) * W + j)
                                     : 0.0f;
    }
    ring_walk(ring, nb, fill, [&](int k, const Stage& st) {
        float n[R + 2][3];
        read_strip(st.x, tx, ty, n);
        const int t = ty * R * ST_TX + tx;
        const size_t o = (b0 + k) * plane + (size_t)i0 * W + j;
#pragma unroll
        for (int q = 0; q < R; ++q) {
            const float rv = st.b[t + q * ST_TX] - lap_strip(w[q], n, q);
            if (col_in && i0 + q < H) {
                const size_t at = o + (size_t)q * W;
                r_out[at] = rv;
                x1_out[at] = n[q + 1][1] + c * (dv[q] * rv);
            }
        }
    });
}

// Replaces _cheb_fin_kernel / pallas_cheb_finish (pallas_stencil.py:595,
// 660).  Pass 2 of the warm smoother:
//   x2 = x1 + ca c dinv r0 + cb dinv (r0 - c L (dinv r0)).
// Reads r0 at neighbour offsets, so pass 1 must have written all of it.
// Bound by bytes (r0 and x1 in, x2 out, five planes and dinv).  cheb_init's
// design, with x1's tile staged in the same stage as r0's window (x1 read
// from device memory when its column is computed made the kernel twice as
// slow on the H100: those loads had nothing in flight ahead of them).
struct CFStage {
    float r[ST_ROWS * ST_COLS];
    float x1[ST_TY * ST_TX];
};

__global__ void __launch_bounds__(NT)
cheb_finish_kernel(Planes P, const float* __restrict__ dinv,
                   const float* __restrict__ r0, const float* __restrict__ x1,
                   float* __restrict__ x2, float c, float ca, float cb, int B,
                   int chunk, int H, int W) {
    __shared__ __align__(16) CFStage ring[NSTAGE];
    __shared__ float dsh[ST_ROWS * ST_COLS];
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
    const int j = blockIdx.y * ST_TX + tx;
    const int i0 = blockIdx.z * ST_TY + ty * ST_R;
    const int b0 = blockIdx.x * chunk;
    const int nb = min(chunk, B - b0);
    const int gi0 = (int)blockIdx.z * ST_TY;
    const int gj0 = (int)blockIdx.y * ST_TX;
    const Window<ST_ROWS, ST_COLS> rwin(gi0 - 1, gj0 - 1, H, W);
    const Window<ST_TY, ST_TX> xwin(gi0, gj0, H, W);
    const size_t plane = (size_t)H * W;
    const auto fill = [&](CFStage& st, int k) {
        rwin.stage(st.r, r0 + (b0 + k) * plane);
        xwin.stage(st.x1, x1 + (b0 + k) * plane);
    };
    rwin.stage(dsh, dinv);   // joins column 0's copy group
    ring_start(ring, nb, fill);
    float w[ST_R][9], dv[ST_R];
    strip_weights_dinv(P, dsh, i0, j, tx, ty, H, W, w, dv);
    const float cac = ca * c;
    const bool col_in = j < W;
    ring_walk(ring, nb, fill, [&](int k, const CFStage& st) {
        float n[ST_R + 2][3];
        read_strip(st.r, tx, ty, n);
        const float* xs = st.x1 + ty * ST_R * ST_TX + tx;
        float* xb = x2 + (b0 + k) * plane;
#pragma unroll
        for (int r = 0; r < ST_R; ++r) {
            const float rv = n[r + 1][1];
            const float r1 = rv - c * lap_strip(w[r], n, r);
            if (col_in && i0 + r < H) {
                xb[(size_t)(i0 + r) * W + j] =
                    xs[r * ST_TX] + cac * (dv[r] * rv) + cb * (dv[r] * r1);
            }
        }
    });
}

// Replaces _cheb_kernel / pallas_cheb_step (pallas_stencil.py:307, 341).
// One step of the generic (not premultiplied) smoother:
//   r' = r - L d;  d' = ca d + cb dinv r';  x' = x + d'.
// Bound by bytes (r, d and x in, r', d' and x' out, five planes and dinv).
// cheb_finish's design with the base weights: d, which the stencil reads,
// is staged through the ring with a one-cell halo, and r's and x's tiles in
// the same stage; dinv is read only at the strip's own cells, so its four
// values are loaded with the weights.  Its first design (a thread per cell
// of a 32 x 8 tile walking all B columns) launched 4 blocks at 32^2, the one
// level where the main path's V-cycle runs it, and took 11 us there.
template <int R>
struct CSStage {
    static constexpr int TY = NWARP * R;
    float d[(TY + 2) * ST_COLS];
    float r[TY * ST_TX];
    float x[TY * ST_TX];
};

template <int R>
__global__ void __launch_bounds__(NT)
cheb_step_kernel(Planes P, const float* __restrict__ dinv,
                 const float* __restrict__ r, const float* __restrict__ d,
                 const float* __restrict__ x, float* __restrict__ r_out,
                 float* __restrict__ d_out, float* __restrict__ x_out,
                 float ca, float cb, int B, int chunk, int H, int W) {
    using Stage = CSStage<R>;
    constexpr int TY = Stage::TY;
    __shared__ __align__(16) Stage ring[NSTAGE];
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
    const int j = blockIdx.y * ST_TX + tx;
    const int i0 = blockIdx.z * TY + ty * R;
    const int b0 = blockIdx.x * chunk;
    const int nb = min(chunk, B - b0);
    const int gi0 = (int)blockIdx.z * TY;
    const int gj0 = (int)blockIdx.y * ST_TX;
    const Window<TY + 2, ST_COLS> dwin(gi0 - 1, gj0 - 1, H, W);
    const Window<TY, ST_TX> twin(gi0, gj0, H, W);
    const size_t plane = (size_t)H * W;
    const auto fill = [&](Stage& st, int k) {
        const size_t o = (b0 + k) * plane;
        dwin.stage(st.d, d + o);
        twin.stage(st.r, r + o);
        twin.stage(st.x, x + o);
    };
    ring_start(ring, nb, fill);
    const bool col_in = j < W;
    float w[R][9], dv[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
        load_weights(P, i0 + q, j, H, W, w[q]);
        dv[q] = col_in && i0 + q < H ? __ldg(dinv + (size_t)(i0 + q) * W + j)
                                     : 0.0f;
    }
    ring_walk(ring, nb, fill, [&](int k, const Stage& st) {
        float n[R + 2][3];
        read_strip(st.d, tx, ty, n);
        const int t = ty * R * ST_TX + tx;
        const size_t o = (b0 + k) * plane + (size_t)i0 * W + j;
#pragma unroll
        for (int q = 0; q < R; ++q) {
            const float rn = st.r[t + q * ST_TX] - lap_strip(w[q], n, q);
            const float dn = ca * n[q + 1][1] + cb * (dv[q] * rn);
            if (col_in && i0 + q < H) {
                const size_t at = o + (size_t)q * W;
                r_out[at] = rn;
                d_out[at] = dn;
                x_out[at] = st.x[t + q * ST_TX] + dn;
            }
        }
    });
}

inline int launch_error(int B, int H, int W) {
    // the wrappers never send an empty launch; refuse one rather than
    // launching a zero-sized grid.  Offsets within one (H, W) plane are
    // int (a cell's neighbour offsets, the staged windows' sources);
    // every offset across the batch is size_t (column * plane), so
    // B * H * W may pass 2^31 but H * W may not.  Tile rows go in
    // gridDim.y or z (at most 65535 tiles of at least 8 rows).
    if (B < 1 || H < 1 || W < 1 || (long long)H * W > 0x7fffffffLL ||
        H > 8 * 65535) {
        return (int)cudaErrorInvalidValue;
    }
    return -1;
}

// The current card's SM count.  A failed query leaves its error for the
// caller's cudaGetLastError().
inline int card_sms() {
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

// Blocks of kernel resident on one SM (at least 1).  A failed query leaves
// its error for the caller's cudaGetLastError().
template <class Kernel>
int resident(Kernel kernel) {
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
    return per_sm > 0 ? per_sm : 1;
}

// Grid of a staged kernel over tiles_x x tiles_y tiles with the B columns
// in `chunks` chunks (at least 1, at most B) of cb columns (cb is
// returned): x is the chunk, fastest, so that the chunks of one tile run
// side by side.
inline dim3 column_chunks(int tiles_x, int tiles_y, int B, long chunks,
                          int* cb) {
    if (chunks > B) chunks = B;
    if (chunks < 1) chunks = 1;
    *cb = (B + (int)chunks - 1) / (int)chunks;
    return dim3((B + *cb - 1) / *cb, tiles_x, tiles_y);
}

// The grid of the six kernels other than residual_init: chunks of the most
// columns that still give the card (sms SMs, queried unless the launch has
// done so already) two waves of resident blocks, so the weights are read as
// few times as the card's occupancy allows.
template <class Kernel>
dim3 chunked_grid(Kernel kernel, int tiles_x, int tiles_y, int B, int* cb,
                  int sms = card_sms()) {
    const long want = 2L * sms * resident(kernel);
    const long tiles = (long)tiles_x * tiles_y;
    return column_chunks(tiles_x, tiles_y, B, (want + tiles - 1) / tiles, cb);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Whether matvec and cheb_step take strips of one cell (8-row tiles): where
// strips of ST_R, even at one column a block (chunked_grid's finest split),
// would leave SMs without a block.  The V-cycle's 32^2 level at B = 32 then
// gets 128 blocks instead of 32, each waiting on a quarter of the copies
// and weight loads.  The launch queries the SM count once, for this test
// and for chunked_grid.
inline bool short_strips(int sms, int B, int H, int W) {
    return (long)ceil_div(W, ST_TX) * ceil_div(H, ST_TY) * B < sms;
}

template <int R>
int launch_matvec(const Planes& P, const float* x, float* y, int B, int H,
                  int W, int sms, cudaStream_t stream) {
    int cb = B;
    const dim3 grid = chunked_grid(matvec_kernel<R>, ceil_div(W, ST_TX),
                                   ceil_div(H, NWARP * R), B, &cb, sms);
    matvec_kernel<R><<<grid, NT, 0, stream>>>(P, x, y, B, cb, H, W);
    return (int)cudaGetLastError();
}

template <int R>
int launch_cheb_step(const Planes& P, const float* dinv, const float* r,
                     const float* d, const float* x, float* r_out,
                     float* d_out, float* x_out, float ca, float cb, int B,
                     int H, int W, int sms, cudaStream_t stream) {
    int chunk = B;
    const dim3 grid = chunked_grid(cheb_step_kernel<R>, ceil_div(W, ST_TX),
                                   ceil_div(H, NWARP * R), B, &chunk, sms);
    cheb_step_kernel<R><<<grid, NT, 0, stream>>>(
        P, dinv, r, d, x, r_out, d_out, x_out, ca, cb, B, chunk, H, W);
    return (int)cudaGetLastError();
}

// residual_init's launch, chosen on the H100 over the level shapes of the
// bench, scale and Omniscape jobs at B = 1 ... 32 (compare_residual_init.py):
// fewer, longer-lived blocks than chunked_grid's two waves, which made it
// up to 1.6x slower than its first design at 384^2 - 512^2 and B = 4: a
// block with one or two columns has no column for its ring to overlap
// with its first copies and weight loads.  Strips of ST_R where their
// tiles fill at least half a wave of resident blocks (cs_residual_init),
// else of one cell; the columns in the fewest chunks that give the grid
// 2 * sms blocks, but never more blocks than the card holds at once
// (per_sm blocks of residual_init_kernel<R> an SM).
template <int R>
int launch_residual_init(const Planes& P, const float* dinv, const float* b,
                         const float* x, float* r_out, float* x1_out,
                         float c, int B, int H, int W, int sms, int per_sm,
                         cudaStream_t stream) {
    const int tiles_x = ceil_div(W, ST_TX);
    const int tiles_y = ceil_div(H, NWARP * R);
    const long tiles = (long)tiles_x * tiles_y;
    const long fit = (long)sms * per_sm / tiles;
    const long want = (2L * sms + tiles - 1) / tiles;
    int chunk = B;
    const dim3 grid = column_chunks(tiles_x, tiles_y, B,
                                    want < fit ? want : fit, &chunk);
    residual_init_kernel<R><<<grid, NT, 0, stream>>>(
        P, dinv, b, x, r_out, x1_out, c, B, chunk, H, W);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// matvec_pap's partial sums per column: one per tile of the grid.
int cs_matvec_pap_blocks(int H, int W) {
    return ceil_div(W, ST_TX) * ceil_div(H, ST_TY);
}

int cs_matvec(const float* we, const float* ws, const float* wse,
              const float* wne, const float* diag, const float* x, float* y,
              int B, int H, int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    const cudaStream_t s = (cudaStream_t)stream;
    const int sms = card_sms();
    return short_strips(sms, B, H, W)
               ? launch_matvec<1>(P, x, y, B, H, W, sms, s)
               : launch_matvec<ST_R>(P, x, y, B, H, W, sms, s);
}

int cs_matvec_pap(const float* we, const float* ws, const float* wse,
                  const float* wne, const float* diag, const float* x,
                  float* y, float* part, int B, int H, int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    int cb = B;
    const dim3 grid = chunked_grid(matvec_pap_kernel, ceil_div(W, ST_TX),
                                   ceil_div(H, ST_TY), B, &cb);
    matvec_pap_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        P, x, y, part, B, cb, H, W);
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
    const cudaStream_t s = (cudaStream_t)stream;
    const int sms = card_sms();
    return short_strips(sms, B, H, W)
               ? launch_cheb_step<1>(P, dinv, r, d, x, r_out, d_out, x_out,
                                     ca, cb, B, H, W, sms, s)
               : launch_cheb_step<ST_R>(P, dinv, r, d, x, r_out, d_out,
                                        x_out, ca, cb, B, H, W, sms, s);
}

int cs_residual_restrict(const float* we, const float* ws, const float* wse,
                         const float* wne, const float* diag, const float* b,
                         const float* x, float* rc, int B, int H, int W,
                         void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    int cb = B;
    const dim3 grid = chunked_grid(residual_restrict_kernel,
                                   ceil_div((W + 1) / 2, RR_TX),
                                   ceil_div((H + 1) / 2, RR_TY), B, &cb);
    residual_restrict_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        P, b, x, rc, B, cb, H, W);
    return (int)cudaGetLastError();
}

int cs_cheb_init(const float* we, const float* ws, const float* wse,
                 const float* wne, const float* diag, const float* dinv,
                 const float* b, float* x, float c, float ca, float cb, int B,
                 int H, int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    int chunk = B;
    const dim3 grid = chunked_grid(cheb_init_kernel, ceil_div(W, ST_TX),
                                   ceil_div(H, ST_TY), B, &chunk);
    cheb_init_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        P, dinv, b, x, c, ca, cb, B, chunk, H, W);
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
    const cudaStream_t s = (cudaStream_t)stream;
    const int sms = card_sms();
    const long tiles = (long)ceil_div(W, ST_TX) * ceil_div(H, ST_TY);
    const int per_sm = resident(residual_init_kernel<ST_R>);
    return 2 * tiles < (long)sms * per_sm
               ? launch_residual_init<1>(P, dinv, b, x, r_out, x1_out, c, B,
                                         H, W, sms,
                                         resident(residual_init_kernel<1>), s)
               : launch_residual_init<ST_R>(P, dinv, b, x, r_out, x1_out, c,
                                            B, H, W, sms, per_sm, s);
}

int cs_cheb_finish(const float* we, const float* ws, const float* wse,
                   const float* wne, const float* diag, const float* dinv,
                   const float* r0, const float* x1, float* x2, float c,
                   float ca, float cb, int B, int H, int W, void* stream) {
    const int bad = launch_error(B, H, W);
    if (bad >= 0) return bad;
    const Planes P{we, ws, wse, wne, diag};
    int chunk = B;
    const dim3 grid = chunked_grid(cheb_finish_kernel, ceil_div(W, ST_TX),
                                   ceil_div(H, ST_TY), B, &chunk);
    cheb_finish_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        P, dinv, r0, x1, x2, c, ca, cb, B, chunk, H, W);
    return (int)cudaGetLastError();
}

}  // extern "C"
