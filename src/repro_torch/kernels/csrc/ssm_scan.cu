// Chunked scalar-decay linear scan (the SSD form of Mamba-2, and the mLSTM
// core) for Hopper, chunk-parallel:
//
//   h_t = exp(log_a_t) h_{t-1} + k_t v_t^T      h: (N, P), h_0 = 0
//   y_t = q_t . h_t                              q_t, k_t: (N,), v_t: (P,)
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py:_ssm_kernel
// (launched by ssm_scan, reached through repro/kernels/ops.py ssm_scan; the
// same function as repro/models/ssm.py chunked_linear_scan with h0 = 0).  It
// returns y in v's dtype and the final state h in fp32.
//
// What bounds it.  At the hymba-1.5b prefill shape (B = 4, S = 1024, 8 heads,
// N = 16, P = 400, bf16; q and k shared by the heads) the function must read
// v, q, k and log_a and write y and h: 53.6 MB, ~16 us at 3.35 TB/s, while
// its products take ~1 us on the tensor cores, so bytes bound it.  This
// design adds its chunk states' round trips through device memory (13.1 MB
// written, read and rewritten, read again): ~106 MB, a floor of ~32 us of its
// own.  At the xlstm-125m shape (B = 4, S = 512, 4 heads, N = 384, P = 385,
// an fp32 k) the recurrence's 4.8 GFLOP in fp32 on the CUDA cores bound it
// (~72 us; 41 MB of inputs and outputs), and the design's wide chunk states
// (76 MB) add ~91 us of bytes of their own.
//
// Design: Mamba-2's SSD decomposition in chunks of L = 64 steps, three
// launches.  With cum the inclusive prefix of log_a inside a chunk and T_c
// its total (log_a = 0 past the end of the sequence):
//   1. chunk states, every chunk at once:
//        S_c = sum_s exp(T_c - cum_s) k_s v_s^T             (N x P, fp32)
//      into a workspace the wrapper allocates (rows padded to 16 bytes),
//      the chunk totals T_c after the states (ssm_scan_launch gives the
//      workspace's size and refuses a smaller one);
//   2. state passing, sequential over the chunks but elementwise over N x P
//      (4 elements a thread):
//        h_in(0) = 0,  h_in(c) = exp(T_{c-1}) h_in(c-1) + S_{c-1}
//      overwriting S_c with h_in(c); the last step writes h_final;
//   3. outputs, every chunk at once:
//        y_t = sum_{s<=t} (q_t . k_s) exp(cum_t - cum_s) v_s
//              + exp(cum_t) q_t . h_in(c)
// Every product is a 64 x 64 tile of a block of 4 warps, 16 rows a warp.
//
// Tensor cores, when q, k and v are all bf16 (hymba): mma.sync m16n8k16,
// bf16 operands, fp32 accumulators.  Tiles are copied into shared memory
// with cp.async as they lie in memory (16-byte copies, zero-filled past the
// ragged ends); a product reads a fragment as one 32-bit load where its
// reduction axis runs along a tile's rows and with ldmatrix.trans where it
// runs down the columns, so nothing is transposed on the way in.  Step 1: a
// block per (b, h, chunk, 64-row N-tile) splits the decayed k rows once into
// bf16 high and low parts (two products, so the fp32 states and h_final keep
// ~16 bits of k) and streams the P-tiles of v through a 4-stage ring.  Step
// 3: a block per (b, h, chunk) sums the score tile over the N-tiles once,
// gates it into bf16 high and low parts, and streams (P-tile, N-tile) items
// of h_in (split in shared memory into bf16 high and low parts) and v
// through a 3-stage ring; y goes out through shared memory in 16-byte
// stores.  cum, the gates, every accumulator, the passed states and h_final
// stay fp32.
//
// CUDA cores, when any of q, k, v is fp32 (the mLSTM's k, the fp32 models):
// the same decomposition with a block per (b, h, chunk, N-tile, P-tile) in
// step 1 and per (b, h, chunk, P-tile) in step 3; the operands go through
// registers (8 columns a load, every load of a thread issued first) into
// reduction-major fp32 tiles, each thread owning the same 32 outputs of its
// warp's tile as the tensor-core fragments.
//
// q, k, v and log_a are read in place through (batch, seq, head) strides
// with a unit stride along N or P; a stride of 0 along the heads is allowed
// (the Mamba heads share one q and one k).  q, k and v are each fp32 or bf16;
// log_a is fp32.  Shared memory does not grow with N or P, which are tiled.
//
// Plain C interface, loaded with ctypes.  The three launches go to the
// caller's stream, do not synchronise and allocate nothing (the workspace
// comes from the wrapper); the return value is cudaGetLastError() after the
// last launch (or the first error on the way).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SC_L 64                 // chunk length
#define SC_T 64                 // N- and P-tile
#define SC_THREADS 128          // 4 warps, 16 tile rows each
#define SC_BS 72                // bf16 tile row stride: 64 + 8 (no bank conflicts)
#define SC_FS 66                // fp32 tile row stride: 64 + 2 (float2 aligned)
#define SC_OS 68                // row stride of the fp32 h_in buffers
#define SC_PASS_THREADS 256
#define SC_MAX_DEVICES 64

struct ScanParams {
    const void* q;
    const void* k;
    const void* v;
    const float* la;
    void* y;
    float* h;          // (B, H, N, P) h_final
    float* ws;         // (B, H, nc, N, Pw) chunk states, then h_in
    float* tot;        // (B, H, nc) chunk totals of log_a
    long long sq[3];   // strides in elements: batch, seq, head
    long long sk[3];
    long long sv[3];
    long long sla[3];
    long long sy[3];
    int H;
    int S;
    int N;
    int P;
    int Pw;            // workspace row stride: P rounded up to 4 (16 bytes)
    int nc;            // chunks: ceil(S / SC_L)
    int q_dt;          // 0 = fp32, 1 = bf16; y is in v's dtype
    int k_dt;
    int v_dt;
};

__device__ __forceinline__ float load(const void* base, long long i, int dt) {
    return dt == 0 ? static_cast<const float*>(base)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
}

// ---------------------------------------------------------------------------
// slabs: a (rows x cols) block of a row-major global tensor, read 8 columns
// (one 16-byte load where aligned) at a time, every load of a thread issued
// before any is used
// ---------------------------------------------------------------------------

#define SC_CHUNKS 4             // 8-column chunks a thread holds: 64 x 64 / 8 / 128

struct Slab {
    float v[SC_CHUNKS][8];
};

// rows r < rows at base + r * rstride (elements), columns c < cols (a
// multiple of 8, at most 64); zero at r >= nrow or c >= ncol
__device__ __forceinline__ void slab_load(Slab& sl, const void* base, int dt,
                                          long long rstride, int rows, int cols,
                                          int nrow, int ncol) {
    const int cpr = cols / 8;
    const int total = rows * cpr;
    const uintptr_t align = reinterpret_cast<uintptr_t>(base)
                          | (uintptr_t)(rows > 1 ? rstride * (dt ? 2 : 4) : 0);
    const bool vec = (align & 15) == 0;
#pragma unroll
    for (int u = 0; u < SC_CHUNKS; ++u) {
        const int ch = threadIdx.x + u * SC_THREADS;
        const int r = ch / cpr;
        const int c8 = (ch - r * cpr) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) sl.v[u][e] = 0.f;
        if (ch >= total || r >= nrow || c8 >= ncol) continue;
        const long long off = r * rstride + c8;
        if (vec && c8 + 8 <= ncol) {
            if (dt) {
                const uint4 x = *reinterpret_cast<const uint4*>(
                    static_cast<const __nv_bfloat16*>(base) + off);
                const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 f = __bfloat1622float2(b2[e]);
                    sl.v[u][2 * e] = f.x;
                    sl.v[u][2 * e + 1] = f.y;
                }
            } else {
                const float4* f4 = reinterpret_cast<const float4*>(
                    static_cast<const float*>(base) + off);
                const float4 a = f4[0], b = f4[1];
                sl.v[u][0] = a.x; sl.v[u][1] = a.y; sl.v[u][2] = a.z; sl.v[u][3] = a.w;
                sl.v[u][4] = b.x; sl.v[u][5] = b.y; sl.v[u][6] = b.z; sl.v[u][7] = b.w;
            }
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                if (c8 + e < ncol) sl.v[u][e] = load(base, off + e, dt);
        }
    }
}

// calls put(row, col, values[8]) for every chunk slab_load filled
template <class Put>
__device__ __forceinline__ void slab_each(Slab& sl, int rows, int cols, Put put) {
    const int cpr = cols / 8;
#pragma unroll
    for (int u = 0; u < SC_CHUNKS; ++u) {
        const int ch = threadIdx.x + u * SC_THREADS;
        if (ch >= rows * cpr) continue;
        const int r = ch / cpr;
        put(r, (ch - r * cpr) * 8, sl.v[u]);
    }
}

// ---------------------------------------------------------------------------
// operand tiles and the warp-level 64 x 64 products.  Every product adds
// A . B^T over a reduction axis to a 64 x 64 accumulator tile of the block's
// 4 warps, 16 rows a warp: acc[4 j + e] is row 16 w + g + 8 (e / 2), column
// 8 j + 2 c + e % 2, with g = lane / 4, c = lane % 4 (the mma.sync
// accumulator layout, on both routes).
// ---------------------------------------------------------------------------

// CUDA cores: a 64 x 64 fp32 operand tile, reduction-major (row r holds
// reduction index r for the 64 rows of A or columns of B)
struct F32Tile {
    float d[SC_T * SC_FS];
    // 8 consecutive columns of a slab row; red_col: the slab's columns are
    // the reduction axis (stored transposed)
    __device__ __forceinline__ void put8(int row, int col, const float (&x)[8],
                                         bool red_col) {
        if (red_col) {
#pragma unroll
            for (int e = 0; e < 8; ++e) d[(col + e) * SC_FS + row] = x[e];
        } else {
#pragma unroll
            for (int e = 0; e < 8; e += 2)
                *reinterpret_cast<float2*>(&d[row * SC_FS + col + e]) = make_float2(x[e], x[e + 1]);
        }
    }
};

// acc += A . B^T over r < klen, column blocks j < jmax
__device__ __forceinline__ void warp_fma(float (&acc)[32], const F32Tile& A,
                                         const F32Tile& B, int klen, int jmax) {
    const int w = threadIdx.x / 32;
    const int g = (threadIdx.x % 32) / 4;
    const int c = threadIdx.x % 4;
    const int r0 = 16 * w + g;
#pragma unroll 4
    for (int r = 0; r < klen; ++r) {
        const float a0 = A.d[r * SC_FS + r0];
        const float a1 = A.d[r * SC_FS + r0 + 8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (j < jmax) {
                const float2 b = *reinterpret_cast<const float2*>(&B.d[r * SC_FS + 8 * j + 2 * c]);
                acc[4 * j + 0] = fmaf(a0, b.x, acc[4 * j + 0]);
                acc[4 * j + 1] = fmaf(a0, b.y, acc[4 * j + 1]);
                acc[4 * j + 2] = fmaf(a1, b.x, acc[4 * j + 2]);
                acc[4 * j + 3] = fmaf(a1, b.y, acc[4 * j + 3]);
            }
    }
}

// tensor cores: a bf16 tile in shared memory as loaded (row-major, ld
// elements a row, ld a multiple of 8 so that rows fall in distinct banks)
struct BView {
    __nv_bfloat16* d;
    int ld;
    __device__ __forceinline__ uint32_t pair(int row, int col) const {
        return *reinterpret_cast<const uint32_t*>(&d[row * ld + col]);
    }
    __device__ __forceinline__ uint32_t addr(int row, int col) const {
        return static_cast<uint32_t>(__cvta_generic_to_shared(&d[row * ld + col]));
    }
};

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// acc += A . B^T over reduction indices < klen (the tiles zero from klen to
// the next multiple of 16), column blocks j < jmax.  A_RED_COL / B_RED_COL:
// the tile holds its reduction axis along its rows (a fragment is one 32-bit
// load) or down its columns (ldmatrix.trans)
template <bool A_RED_COL, bool B_RED_COL>
__device__ __forceinline__ void warp_mma(float (&acc)[32], BView A, BView B, int klen,
                                         int jmax) {
    const int lane = threadIdx.x % 32;
    const int w = threadIdx.x / 32;
    const int g = lane / 4;
    const int c = lane % 4;
    const int r0 = 16 * w + g;
    const int lr = lane % 8;      // ldmatrix: lanes 8 i .. 8 i + 7 address matrix i
    const int lm = lane / 8;
    for (int k0 = 0; k0 < klen; k0 += 16) {
        uint32_t a0, a1, a2, a3;
        if constexpr (A_RED_COL) {
            a0 = A.pair(r0, k0 + 2 * c);
            a1 = A.pair(r0 + 8, k0 + 2 * c);
            a2 = A.pair(r0, k0 + 2 * c + 8);
            a3 = A.pair(r0 + 8, k0 + 2 * c + 8);
        } else {   // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
            ldsm_x4_trans(A.addr(k0 + 8 * (lm / 2) + lr, 16 * w + 8 * (lm % 2)),
                          a0, a1, a2, a3);
        }
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
            if (j >= jmax) continue;
            uint32_t b0, b1, b2, b3;
            if constexpr (B_RED_COL) {
                b0 = B.pair(8 * j + g, k0 + 2 * c);
                b1 = B.pair(8 * j + g, k0 + 2 * c + 8);
                b2 = B.pair(8 * j + 8 + g, k0 + 2 * c);
                b3 = B.pair(8 * j + 8 + g, k0 + 2 * c + 8);
            } else {
                ldsm_x4_trans(B.addr(k0 + 8 * (lm % 2) + lr, 8 * j + 8 * (lm / 2)),
                              b0, b1, b2, b3);
            }
            mma_bf16(&acc[4 * j], a0, a1, a2, a3, b0, b1);
            if (j + 1 < jmax) mma_bf16(&acc[4 * j + 4], a0, a1, a2, a3, b2, b3);
        }
    }
}

// ---------------------------------------------------------------------------
// asynchronous tile loads (the tensor-core route): cp.async of 16 bytes, no
// registers held, a block's next tiles in flight while it works on these
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                    "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows r < rows, columns c < cols (a multiple of 8) of a bf16 tensor at
// base + r * rstride + c into a tile; zero at r >= nrow or c >= ncol.
// 16-byte copies where the rows are 16-byte aligned, element by element
// where not.
__device__ __forceinline__ void tile_load_bf16(BView t, const __nv_bfloat16* base,
                                               long long rstride, int rows, int cols,
                                               int nrow, int ncol) {
    const bool vec = ((reinterpret_cast<uintptr_t>(base)
                       | (uintptr_t)(rows > 1 ? rstride * 2 : 0)) & 15) == 0;
    if (vec) {
        const int cpr = cols / 8;
        for (int ch = threadIdx.x; ch < rows * cpr; ch += SC_THREADS) {
            const int r = ch / cpr;
            const int c8 = (ch - r * cpr) * 8;
            const bool in = r < nrow && c8 < ncol;
            cp_async16(&t.d[r * t.ld + c8], in ? base + r * rstride + c8 : base,
                       in ? 2 * min(8, ncol - c8) : 0);
        }
    } else {
        for (int i = threadIdx.x; i < rows * cols; i += SC_THREADS) {
            const int r = i / cols;
            const int c = i - r * cols;
            t.d[r * t.ld + c] = (r < nrow && c < ncol) ? base[r * rstride + c]
                                                       : __float2bfloat16(0.f);
        }
    }
}

// the same for 64 columns of the fp32 workspace (rows 16-byte aligned) into
// a buffer of row stride SC_OS
__device__ __forceinline__ void tile_load_f32(float* t, const float* base, long long rstride,
                                              int rows, int nrow, int ncol) {
    for (int ch = threadIdx.x; ch < rows * (SC_T / 4); ch += SC_THREADS) {
        const int r = ch / (SC_T / 4);
        const int c4 = (ch % (SC_T / 4)) * 4;
        const bool in = r < nrow && c4 < ncol;
        cp_async16(&t[r * SC_OS + c4], in ? base + r * rstride + c4 : base,
                   in ? 4 * min(4, ncol - c4) : 0);
    }
}

// x = hi + lo, hi = bf16(x), lo = bf16(x - hi) for rows r < rows of a 64-
// column fp32 buffer into two bf16 tiles: a product over the pair keeps ~16
// bits of x
__device__ __forceinline__ void split_rows(const float* x, int xld, BView hi, BView lo,
                                           int rows) {
    for (int i = threadIdx.x; i < rows * SC_T / 2; i += SC_THREADS) {
        const int r = (2 * i) / SC_T;
        const int col = 2 * i - r * SC_T;
        const float2 v = *reinterpret_cast<const float2*>(&x[r * xld + col]);
        const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
        const float2 hf = __bfloat1622float2(h);
        *reinterpret_cast<__nv_bfloat162*>(&hi.d[r * hi.ld + col]) = h;
        *reinterpret_cast<__nv_bfloat162*>(&lo.d[r * lo.ld + col]) =
            __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
    }
}

// ---------------------------------------------------------------------------
// chunk prefix, staging and stores
// ---------------------------------------------------------------------------

// cum[0 .. SC_L) = inclusive prefix of log_a over the chunk starting at c0
// (log_a = 0 past the end of the sequence), by warp 0, two steps a lane;
// the caller synchronises before reading it
__device__ __forceinline__ void chunk_cum(const ScanParams& p, long long lo, int c0,
                                          float* cum) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int s0 = c0 + 2 * lane;
    const float a0 = s0 < p.S ? p.la[lo + (long long)s0 * p.sla[1]] : 0.f;
    const float a1 = s0 + 1 < p.S ? p.la[lo + (long long)(s0 + 1) * p.sla[1]] : 0.f;
    float run = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += o;
    }
    cum[2 * lane] = run - a1;
    cum[2 * lane + 1] = run;
}

// this warp's accumulator rows straight to base + row * rstride + col, rows
// < nrow, columns < ncol, in dtype dt (pairs of columns where aligned)
__device__ __forceinline__ void store_acc(const float (&acc)[32], void* base, int dt,
                                          long long rstride, int nrow, int ncol) {
    const int w = threadIdx.x / 32;
    const int g = (threadIdx.x % 32) / 4;
    const int cq = 2 * (threadIdx.x % 4);
    const bool pairs = ((reinterpret_cast<uintptr_t>(base)
                         | (uintptr_t)(rstride * (dt ? 2 : 4))) & (dt ? 3 : 7)) == 0;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
        const int r = 16 * w + g + 4 * e;        // e = 2: row + 8
        if (r >= nrow) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + cq;
            if (col >= ncol) continue;
            const long long off = r * rstride + col;
            const float x0 = acc[4 * j + e], x1 = acc[4 * j + e + 1];
            if (dt) {   // round to nearest even, as astype does
                __nv_bfloat16* o = static_cast<__nv_bfloat16*>(base) + off;
                if (pairs && col + 1 < ncol) {
                    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
                } else {
                    o[0] = __float2bfloat16(x0);
                    if (col + 1 < ncol) o[1] = __float2bfloat16(x1);
                }
            } else {
                float* o = static_cast<float*>(base) + off;
                if (pairs && col + 1 < ncol) {
                    *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
                } else {
                    o[0] = x0;
                    if (col + 1 < ncol) o[1] = x1;
                }
            }
        }
    }
}

// this warp's accumulator rows, rounded to bf16, into a 64 x 64 tile
__device__ __forceinline__ void acc_to_tile(const float (&acc)[32], BView t) {
    const int w = threadIdx.x / 32;
    const int g = (threadIdx.x % 32) / 4;
    const int cq = 2 * (threadIdx.x % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
            *reinterpret_cast<__nv_bfloat162*>(&t.d[(16 * w + g + 4 * e) * t.ld + 8 * j + cq]) =
                __floats2bfloat162_rn(acc[4 * j + e], acc[4 * j + e + 1]);
}

// rows r < nrow, columns c < ncol of a bf16 tile to base + r * rstride + c
// (16-byte stores where aligned)
__device__ __forceinline__ void tile_store_bf16(BView t, __nv_bfloat16* base,
                                                long long rstride, int nrow, int ncol) {
    const bool vec = ((reinterpret_cast<uintptr_t>(base)
                       | (uintptr_t)(nrow > 1 ? rstride * 2 : 0)) & 15) == 0;
    for (int ch = threadIdx.x; ch < nrow * (SC_T / 8); ch += SC_THREADS) {
        const int r = ch / (SC_T / 8);
        const int c8 = (ch % (SC_T / 8)) * 8;
        if (c8 >= ncol) continue;
        __nv_bfloat16* o = base + r * rstride + c8;
        if (vec && c8 + 8 <= ncol) {
            *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(&t.d[r * t.ld + c8]);
        } else {
            for (int e = 0; e < 8 && c8 + e < ncol; ++e) o[e] = t.d[r * t.ld + c8 + e];
        }
    }
}

// gate the scores (this warp's rows): M[t][s] = sc exp(cum_t - cum_s) for
// s <= t, else 0; put(t, s, m_s, m_s+1) for every column pair
template <class Put>
__device__ __forceinline__ void gate_scores(const float (&sc)[32], const float* cum, Put put) {
    const int w = threadIdx.x / 32;
    const int g = (threadIdx.x % 32) / 4;
    const int cq = 2 * (threadIdx.x % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
            const int t = 16 * w + g + 4 * e;    // e = 2: row + 8
            const int s = 8 * j + cq;
            const float m0 = s <= t ? sc[4 * j + e] * expf(cum[t] - cum[s]) : 0.f;
            const float m1 = s + 1 <= t ? sc[4 * j + e + 1] * expf(cum[t] - cum[s + 1]) : 0.f;
            put(t, s, m0, m1);
        }
}

// y = ya + exp(cum_t) yi on this warp's rows
__device__ __forceinline__ void combine(float (&ya)[32], const float (&yi)[32],
                                        const float* ecum) {
    const int w = threadIdx.x / 32;
    const int g = (threadIdx.x % 32) / 4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            ya[4 * j + e] = fmaf(ecum[16 * w + g + 8 * (e / 2)], yi[4 * j + e], ya[4 * j + e]);
}

// ---------------------------------------------------------------------------
// shared-memory layouts of the tensor-core kernels, which size their tiles
// along N by the block's widest N-tile, nwm = min(64, N rounded up to 16)
// (the host computes the same sizes).  Each streams its P-tiles through a
// ring of stages, the copies of the next stages in flight while it works.
// ---------------------------------------------------------------------------

#define SC_VT_BYTES (SC_T * SC_BS * 2)          // a 64 x 64 bf16 tile, rows of SC_BS
#define SC_STATE_STAGES 4
#define SC_OUT_STAGES 3

struct StateTcLayout {       // bytes from the base
    int kld, kraw, ah, al, v0, cum, wdec, total;
    __host__ __device__ StateTcLayout(int nwm) {
        kld = nwm + 8;
        const int kt = SC_L * kld * 2;
        kraw = 0;
        ah = kraw + kt;
        al = ah + kt;
        v0 = al + kt;                            // stage s at v0 + s * SC_VT_BYTES
        cum = v0 + SC_STATE_STAGES * SC_VT_BYTES;
        wdec = cum + 4 * SC_L;
        total = wdec + 4 * SC_L;
    }
};

struct OutTcLayout {
    int qld, q, k, mh, ml, hh, hl, hf0, v0, cum, ecum, total;
    __host__ __device__ OutTcLayout(int nwm) {
        qld = nwm + 8;
        const int qt = SC_L * qld * 2;
        q = 0;
        mh = q + qt;
        ml = mh + SC_VT_BYTES;
        hh = ml + SC_VT_BYTES;
        hl = hh + nwm * SC_BS * 2;
        k = hh;                                  // k while the scores are summed
        hf0 = hl + nwm * SC_BS * 2;              // stage s at hf0 + s * nwm * SC_OS * 4
        v0 = hf0 + SC_OUT_STAGES * nwm * SC_OS * 4;   // and v0 + s * SC_VT_BYTES
        cum = v0 + SC_OUT_STAGES * SC_VT_BYTES;
        ecum = cum + 4 * SC_L;
        total = ecum + 4 * SC_L;
    }
};

__device__ __forceinline__ BView view(unsigned char* base, int off, int ld) {
    return BView{reinterpret_cast<__nv_bfloat16*>(base + off), ld};
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------

// tensor cores: a block per (b, h, chunk, N-tile) walks the P-tiles.  k
// (rows s, columns n) is copied in once and split, decayed, into bf16 high
// and low parts; v (rows s, columns p) streams through the ring.
__global__ void __launch_bounds__(SC_THREADS)
ssm_chunk_state_tc_kernel(const ScanParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nwm = min(SC_T, (p.N + 15) & ~15);
    const StateTcLayout lay(nwm);
    const BView kraw = view(smem_raw, lay.kraw, lay.kld);
    const BView ah = view(smem_raw, lay.ah, lay.kld);
    const BView al = view(smem_raw, lay.al, lay.kld);
    float* cum = reinterpret_cast<float*>(smem_raw + lay.cum);
    float* wdec = reinterpret_cast<float*>(smem_raw + lay.wdec);

    const int n_pt = (p.P + SC_T - 1) / SC_T;
    const int n0 = blockIdx.x * SC_T;
    const int c = blockIdx.y;
    const int bh = blockIdx.z;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int c0 = c * SC_L;
    const int Lc = min(SC_L, p.S - c0);
    const int nn = min(SC_T, p.N - n0);
    const int tid = threadIdx.x;
    const int sw = (Lc + 15) & ~15;
    const int nw = (nn + 15) & ~15;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.sv[0]
                              + h * p.sv[2] + (long long)c0 * p.sv[1];
    float* out = p.ws + ((long long)bh * p.nc + c) * p.N * p.Pw + (long long)n0 * p.Pw;
    auto vstage = [&](int pt) {
        return view(smem_raw, lay.v0 + (pt % SC_STATE_STAGES) * SC_VT_BYTES, SC_BS);
    };
    auto issue = [&](int pt) {
        tile_load_bf16(vstage(pt), vb + pt * SC_T, p.sv[1], sw, SC_T, Lc,
                       min(SC_T, p.P - pt * SC_T));
    };

    // k with the first P-tile, then the rest of the ring's prologue: a
    // commit group for each P-tile
    tile_load_bf16(kraw, static_cast<const __nv_bfloat16*>(p.k) + b * p.sk[0]
                   + h * p.sk[2] + (long long)c0 * p.sk[1] + n0, p.sk[1], sw, nw, Lc, nn);
    for (int pt = 0; pt < SC_STATE_STAGES - 1; ++pt) {
        if (pt < n_pt) issue(pt);
        cp_async_commit();
    }
    chunk_cum(p, b * p.sla[0] + h * p.sla[2], c0, cum);
    __syncthreads();
    const float total = cum[SC_L - 1];
    if (tid < SC_L) wdec[tid] = expf(total - cum[tid]);
    cp_async_wait<SC_STATE_STAGES - 2>();        // k and P-tile 0
    __syncthreads();
    // A (row n, reduction s) = exp(T - cum_s) k[s][n], high and low parts;
    // the k tile holds the reduction down its rows
    for (int i = tid; i < sw * nw / 2; i += SC_THREADS) {
        const int s = (2 * i) / nw;
        const int n = 2 * i - s * nw;
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&kraw.d[s * kraw.ld + n]));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(wdec[s] * x.x, wdec[s] * x.y);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(&ah.d[s * ah.ld + n]) = hi;
        *reinterpret_cast<__nv_bfloat162*>(&al.d[s * al.ld + n]) =
            __floats2bfloat162_rn(fmaf(wdec[s], x.x, -hf.x), fmaf(wdec[s], x.y, -hf.y));
    }
    for (int pt = 0; pt < n_pt; ++pt) {
        if (pt > 0) cp_async_wait<SC_STATE_STAGES - 2>();    // P-tile pt landed
        __syncthreads();           // for every thread; the last P-tile's readers are done
        if (pt + SC_STATE_STAGES - 1 < n_pt) issue(pt + SC_STATE_STAGES - 1);
        cp_async_commit();
        if (16 * (tid / 32) < nn) {              // this warp has state rows
            float acc[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] = 0.f;
            warp_mma<false, false>(acc, ah, vstage(pt), sw, 8);
            warp_mma<false, false>(acc, al, vstage(pt), sw, 8);
            store_acc(acc, out + pt * SC_T, 0, p.Pw, nn, min(SC_T, p.P - pt * SC_T));
        }
    }
    if (blockIdx.x == 0 && tid == 0) p.tot[(long long)bh * p.nc + c] = total;
}

// CUDA cores: a block per (b, h, chunk, N-tile, P-tile); the slabs go
// through registers into reduction-major fp32 tiles
struct StateSmemF32 {
    F32Tile a;                // exp(T - cum_s) k (row n, reduction s)
    F32Tile v;
    float cum[SC_L];
    float wdec[SC_L];
};

__global__ void __launch_bounds__(SC_THREADS)
ssm_chunk_state_f32_kernel(const ScanParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    StateSmemF32& sm = *reinterpret_cast<StateSmemF32*>(smem_raw);
    const int n_pt = (p.P + SC_T - 1) / SC_T;
    const int p0 = (blockIdx.x % n_pt) * SC_T;
    const int n0 = (blockIdx.x / n_pt) * SC_T;
    const int c = blockIdx.y;
    const int bh = blockIdx.z;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int c0 = c * SC_L;
    const int Lc = min(SC_L, p.S - c0);
    const int nn = min(SC_T, p.N - n0);
    const int pn = min(SC_T, p.P - p0);
    const int tid = threadIdx.x;
    const int nw = (nn + 15) & ~15;

    Slab ks, vs;
    slab_load(ks, static_cast<const char*>(p.k) + (b * p.sk[0] + h * p.sk[2]
              + (long long)c0 * p.sk[1] + n0) * (p.k_dt ? 2 : 4),
              p.k_dt, p.sk[1], Lc, nw, Lc, nn);
    slab_load(vs, static_cast<const char*>(p.v) + (b * p.sv[0] + h * p.sv[2]
              + (long long)c0 * p.sv[1] + p0) * (p.v_dt ? 2 : 4),
              p.v_dt, p.sv[1], Lc, SC_T, Lc, pn);
    chunk_cum(p, b * p.sla[0] + h * p.sla[2], c0, sm.cum);
    __syncthreads();
    const float total = sm.cum[SC_L - 1];
    if (tid < SC_L) sm.wdec[tid] = expf(total - sm.cum[tid]);
    __syncthreads();
    slab_each(ks, Lc, nw, [&](int s, int n, float (&x)[8]) {
        const float wd = sm.wdec[s];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] *= wd;
        sm.a.put8(s, n, x, false);
    });
    slab_each(vs, Lc, SC_T, [&](int s, int col, float (&x)[8]) {
        sm.v.put8(s, col, x, false);
    });
    __syncthreads();

    if (16 * (tid / 32) < nn) {                  // this warp has state rows
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        warp_fma(acc, sm.a, sm.v, Lc, 8);
        store_acc(acc, p.ws + ((long long)bh * p.nc + c) * p.N * p.Pw
                  + (long long)n0 * p.Pw + p0, 0, p.Pw, nn, pn);
    }
    if (blockIdx.x == 0 && tid == 0) p.tot[(long long)bh * p.nc + c] = total;
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SC_PASS_THREADS)
ssm_state_pass_kernel(const ScanParams p) {
    // 4 consecutive elements of a state a thread (Pw is a multiple of 4)
    const long long np = (long long)p.N * p.Pw;
    const long long e = 4 * ((long long)blockIdx.x * SC_PASS_THREADS + threadIdx.x);
    if (e >= np) return;
    const int bh = blockIdx.y;
    float4* st = reinterpret_cast<float4*>(p.ws + (long long)bh * p.nc * np + e);
    const long long step = np / 4;
    const float* tot = p.tot + (long long)bh * p.nc;
    float4 hs = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < p.nc; c0 += 8) {
        float4 s[8];                             // loads ahead of the chain
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            s[i] = c0 + i < p.nc ? st[(c0 + i) * step] : make_float4(0.f, 0.f, 0.f, 0.f);
            a[i] = c0 + i < p.nc ? expf(tot[c0 + i]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (c0 + i < p.nc) {
                st[(c0 + i) * step] = hs;                    // h_in(c)
                hs.x = fmaf(a[i], hs.x, s[i].x);
                hs.y = fmaf(a[i], hs.y, s[i].y);
                hs.z = fmaf(a[i], hs.z, s[i].z);
                hs.w = fmaf(a[i], hs.w, s[i].w);
            }
    }
    const int n = (int)(e / p.Pw);
    const int col = (int)(e - (long long)n * p.Pw);
    float* hout = p.h + ((long long)bh * p.N + n) * p.P + col;
    const float hv[4] = {hs.x, hs.y, hs.z, hs.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (col + i < p.P) hout[i] = hv[i];
}

// ---------------------------------------------------------------------------
// 3. outputs
// ---------------------------------------------------------------------------

// tensor cores: a block per (b, h, chunk).  It sums the score tile over the
// N-tiles once and gates it into bf16 high and low parts, then walks (P-tile,
// N-tile) items: h_in and, at a P-tile's last N-tile, v stream through the
// ring; h_in is split into bf16 high and low parts in shared memory.  With
// one N-tile (N <= 64) q stays in shared memory; with more, each item copies
// its q tile in and waits for it.
__global__ void __launch_bounds__(SC_THREADS)
ssm_chunk_out_tc_kernel(const ScanParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nwm = min(SC_T, (p.N + 15) & ~15);
    const OutTcLayout lay(nwm);
    const BView qt = view(smem_raw, lay.q, lay.qld);
    const BView kt = view(smem_raw, lay.k, lay.qld);
    const BView mh = view(smem_raw, lay.mh, SC_BS);
    const BView ml = view(smem_raw, lay.ml, SC_BS);
    const BView hh = view(smem_raw, lay.hh, SC_BS);
    const BView hl = view(smem_raw, lay.hl, SC_BS);
    float* cum = reinterpret_cast<float*>(smem_raw + lay.cum);
    float* ecum = reinterpret_cast<float*>(smem_raw + lay.ecum);

    const int c = blockIdx.x;
    const int bh = blockIdx.y;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int c0 = c * SC_L;
    const int Lc = min(SC_L, p.S - c0);
    const int tid = threadIdx.x;
    const int w = tid / 32;
    const int sw = (Lc + 15) & ~15;
    const int n_nt = (p.N + SC_T - 1) / SC_T;
    const int n_pt = (p.P + SC_T - 1) / SC_T;
    const int n_items = n_pt * n_nt;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.sq[0]
                              + h * p.sq[2] + (long long)c0 * p.sq[1];
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.sk[0]
                              + h * p.sk[2] + (long long)c0 * p.sk[1];
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.sv[0]
                              + h * p.sv[2] + (long long)c0 * p.sv[1];
    const float* hin = p.ws + ((long long)bh * p.nc + c) * p.N * p.Pw;
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(p.y) + b * p.sy[0] + h * p.sy[2]
                        + (long long)c0 * p.sy[1];
    // item i = (P-tile i / n_nt, N-tile i % n_nt) in stage i % SC_OUT_STAGES
    auto hstage = [&](int i) {
        return reinterpret_cast<float*>(smem_raw + lay.hf0
                                        + (i % SC_OUT_STAGES) * nwm * SC_OS * 4);
    };
    auto vstage = [&](int i) {
        return view(smem_raw, lay.v0 + (i % SC_OUT_STAGES) * SC_VT_BYTES, SC_BS);
    };
    auto issue = [&](int i) {
        const int pt = i / n_nt;
        const int n0 = (i % n_nt) * SC_T;
        const int nn = min(SC_T, p.N - n0);
        const int pn = min(SC_T, p.P - pt * SC_T);
        tile_load_f32(hstage(i), hin + (long long)n0 * p.Pw + pt * SC_T, p.Pw,
                      (nn + 15) & ~15, nn, pn);
        if (n0 + SC_T >= p.N)
            tile_load_bf16(vstage(i), vb + pt * SC_T, p.sv[1], sw, SC_T, Lc, pn);
    };

    // the score tile over the N-tiles (the first copies in a commit group of
    // their own, then the ring's prologue)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    for (int n0 = 0; n0 < p.N; n0 += SC_T) {
        const int nn = min(SC_T, p.N - n0);
        const int nw = (nn + 15) & ~15;
        if (n0 > 0) __syncthreads();             // the last product is done
        tile_load_bf16(qt, qb + n0, p.sq[1], SC_L, nw, Lc, nn);
        tile_load_bf16(kt, kb + n0, p.sk[1], SC_L, nw, Lc, nn);
        cp_async_commit();
        if (n0 == 0) {
            for (int i = 0; i < SC_OUT_STAGES - 1; ++i) {
                if (i < n_items) issue(i);
                cp_async_commit();
            }
            chunk_cum(p, b * p.sla[0] + h * p.sla[2], c0, cum);
            cp_async_wait<SC_OUT_STAGES - 1>();  // q and k
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        // causal: the column blocks j >= 2 w + 2 lie above every row of warp w
        warp_mma<true, true>(sc, qt, kt, nw, min(8, 2 * w + 2));
    }
    if (tid < SC_L) ecum[tid] = expf(cum[tid]);
    gate_scores(sc, cum, [&](int t, int s, float m0, float m1) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(m0, m1);
        const float2 hf2 = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(&mh.d[t * SC_BS + s]) = hi;
        *reinterpret_cast<__nv_bfloat162*>(&ml.d[t * SC_BS + s]) =
            __floats2bfloat162_rn(m0 - hf2.x, m1 - hf2.y);
    });

    float yi[32];                  // q . h_in (t, p) of the current P-tile
#pragma unroll
    for (int i = 0; i < 32; ++i) yi[i] = 0.f;
    for (int i = 0; i < n_items; ++i) {
        const int pt = i / n_nt;
        const int n0 = (i % n_nt) * SC_T;
        const int nn = min(SC_T, p.N - n0);
        const int nw = (nn + 15) & ~15;
        cp_async_wait<SC_OUT_STAGES - 2>();      // item i landed
        __syncthreads();           // for every thread; the last item's readers are done
        if (i + SC_OUT_STAGES - 1 < n_items) issue(i + SC_OUT_STAGES - 1);
        cp_async_commit();
        if (n_nt > 1) {                          // q of this N-tile
            tile_load_bf16(qt, qb + n0, p.sq[1], SC_L, nw, Lc, nn);
            cp_async_commit();
            cp_async_wait<0>();
        }
        split_rows(hstage(i), SC_OS, hh, hl, nw);
        __syncthreads();
        warp_mma<true, false>(yi, qt, hh, nw, 8);
        warp_mma<true, false>(yi, qt, hl, nw, 8);
        if (n0 + SC_T >= p.N) {                  // the P-tile's last N-tile
            float ya[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) ya[j] = 0.f;
            // M is lower triangular: warp w's rows need s < 16 (w + 1)
            const int sk = min(sw, 16 * (w + 1));
            warp_mma<true, false>(ya, mh, vstage(i), sk, 8);
            warp_mma<true, false>(ya, ml, vstage(i), sk, 8);
            combine(ya, yi, ecum);
            // y through the item's v stage, free once every warp's product is done
            __syncthreads();
            acc_to_tile(ya, vstage(i));
            __syncthreads();
            tile_store_bf16(vstage(i), yb + pt * SC_T, p.sy[1], Lc, min(SC_T, p.P - pt * SC_T));
#pragma unroll
            for (int j = 0; j < 32; ++j) yi[j] = 0.f;
        }
    }
}

// CUDA cores: a block per (b, h, chunk, P-tile); the slabs go through
// registers into reduction-major fp32 tiles
struct OutSmemF32 {
    F32Tile q;                // (row t, reduction n); then the gated scores
    F32Tile k;                // (column s, reduction n); then v
    F32Tile hs;               // h_in (column p, reduction n)
    float cum[SC_L];
    float ecum[SC_L];
};

__global__ void __launch_bounds__(SC_THREADS)
ssm_chunk_out_f32_kernel(const ScanParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    OutSmemF32& sm = *reinterpret_cast<OutSmemF32*>(smem_raw);
    const int p0 = blockIdx.x * SC_T;
    const int c = blockIdx.y;
    const int bh = blockIdx.z;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int c0 = c * SC_L;
    const int Lc = min(SC_L, p.S - c0);
    const int pn = min(SC_T, p.P - p0);
    const int tid = threadIdx.x;
    const int w = tid / 32;
    const int qsz = p.q_dt ? 2 : 4;
    const int ksz = p.k_dt ? 2 : 4;
    const int vsz = p.v_dt ? 2 : 4;

    chunk_cum(p, b * p.sla[0] + h * p.sla[2], c0, sm.cum);

    float sc[32], yi[32];          // scores (t, s); q . h_in (t, p)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        sc[i] = 0.f;
        yi[i] = 0.f;
    }
    const char* qb = static_cast<const char*>(p.q)
        + (b * p.sq[0] + h * p.sq[2] + (long long)c0 * p.sq[1]) * qsz;
    const char* kb = static_cast<const char*>(p.k)
        + (b * p.sk[0] + h * p.sk[2] + (long long)c0 * p.sk[1]) * ksz;
    const float* hin = p.ws + ((long long)bh * p.nc + c) * p.N * p.Pw + p0;
    for (int n0 = 0; n0 < p.N; n0 += SC_T) {
        const int nn = min(SC_T, p.N - n0);
        const int nw = (nn + 15) & ~15;
        Slab qs, ks, hsl;
        slab_load(qs, qb + (long long)n0 * qsz, p.q_dt, p.sq[1], SC_L, nw, Lc, nn);
        slab_load(ks, kb + (long long)n0 * ksz, p.k_dt, p.sk[1], SC_L, nw, Lc, nn);
        slab_load(hsl, hin + (long long)n0 * p.Pw, 0, p.Pw, nn, SC_T, nn, pn);
        __syncthreads();                         // the last tiles' readers are done
        slab_each(qs, SC_L, nw, [&](int t, int n, float (&x)[8]) {
            sm.q.put8(t, n, x, true);
        });
        slab_each(ks, SC_L, nw, [&](int s, int n, float (&x)[8]) {
            sm.k.put8(s, n, x, true);
        });
        slab_each(hsl, nn, SC_T, [&](int n, int col, float (&x)[8]) {
            sm.hs.put8(n, col, x, false);
        });
        __syncthreads();
        // causal: the column blocks j >= 2 w + 2 lie above every row of warp w
        warp_fma(sc, sm.q, sm.k, nn, min(8, 2 * w + 2));
        warp_fma(yi, sm.q, sm.hs, nn, 8);
    }
    // v (rows s, columns p): loaded while the last products finish
    Slab vs;
    slab_load(vs, static_cast<const char*>(p.v) + (b * p.sv[0] + h * p.sv[2]
              + (long long)c0 * p.sv[1] + p0) * vsz, p.v_dt, p.sv[1], Lc, SC_T, Lc, pn);
    __syncthreads();                             // q, k and h_in tiles are done

    if (tid < SC_L) sm.ecum[tid] = expf(sm.cum[tid]);
    gate_scores(sc, sm.cum, [&](int t, int s, float m0, float m1) {
        sm.q.d[s * SC_FS + t] = m0;
        sm.q.d[(s + 1) * SC_FS + t] = m1;
    });
    slab_each(vs, Lc, SC_T, [&](int s, int col, float (&x)[8]) {
        sm.k.put8(s, col, x, false);
    });
    __syncthreads();

    float ya[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) ya[i] = 0.f;
    warp_fma(ya, sm.q, sm.k, Lc, 8);
    combine(ya, yi, sm.ecum);
    store_acc(ya, static_cast<char*>(p.y) + (b * p.sy[0] + h * p.sy[2]
              + (long long)c0 * p.sy[1] + p0) * vsz, p.v_dt, p.sy[1], Lc, pn);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The shared-memory limit of a kernel is raised once on each device, at its
// first launch there.
template <typename K>
static int raise_smem_once(K kernel, size_t smem, bool (&done)[SC_MAX_DEVICES]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= SC_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!done[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        done[dev] = true;
    }
    return 0;
}

static int pass_launch(const ScanParams& p, int BH, cudaStream_t stream) {
    const long long nq = (long long)p.N * p.Pw / 4;
    ssm_state_pass_kernel<<<dim3((unsigned)((nq + SC_PASS_THREADS - 1) / SC_PASS_THREADS), BH),
                            SC_PASS_THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

// all bf16: the tensor-core kernels, their shared memory sized by N
static int launch_tc(const ScanParams& p, int BH, cudaStream_t stream) {
    static bool set_state[SC_MAX_DEVICES] = {};
    static bool set_out[SC_MAX_DEVICES] = {};
    const int nwm = min(SC_T, (p.N + 15) & ~15);
    const size_t smem_state = StateTcLayout(SC_T).total;    // the largest, once
    const size_t smem_out = OutTcLayout(SC_T).total;
    int err = raise_smem_once(ssm_chunk_state_tc_kernel, smem_state, set_state);
    if (!err) err = raise_smem_once(ssm_chunk_out_tc_kernel, smem_out, set_out);
    if (err) return err;
    const int n_nt = (p.N + SC_T - 1) / SC_T;
    ssm_chunk_state_tc_kernel<<<dim3(n_nt, p.nc, BH), SC_THREADS,
                                StateTcLayout(nwm).total, stream>>>(p);
    err = (int)cudaGetLastError();
    if (!err) err = pass_launch(p, BH, stream);
    if (err) return err;
    ssm_chunk_out_tc_kernel<<<dim3(p.nc, BH), SC_THREADS, OutTcLayout(nwm).total,
                              stream>>>(p);
    return (int)cudaGetLastError();
}

// any fp32 operand: the CUDA-core kernels
static int launch_f32(const ScanParams& p, int BH, cudaStream_t stream) {
    static bool set_state[SC_MAX_DEVICES] = {};
    static bool set_out[SC_MAX_DEVICES] = {};
    int err = raise_smem_once(ssm_chunk_state_f32_kernel, sizeof(StateSmemF32), set_state);
    if (!err) err = raise_smem_once(ssm_chunk_out_f32_kernel, sizeof(OutSmemF32), set_out);
    if (err) return err;
    const int n_pt = (p.P + SC_T - 1) / SC_T;
    const int n_nt = (p.N + SC_T - 1) / SC_T;
    ssm_chunk_state_f32_kernel<<<dim3(n_pt * n_nt, p.nc, BH), SC_THREADS,
                                 sizeof(StateSmemF32), stream>>>(p);
    err = (int)cudaGetLastError();
    if (!err) err = pass_launch(p, BH, stream);
    if (err) return err;
    ssm_chunk_out_f32_kernel<<<dim3(n_pt, p.nc, BH), SC_THREADS, sizeof(OutSmemF32),
                               stream>>>(p);
    return (int)cudaGetLastError();
}

extern "C" {

// q, k: (B, S, H, N); v, y: (B, S, H, P); log_a: (B, S, H) fp32; h: (B, H,
// N, P) fp32 contiguous; ws: B*H*ceil(S/64)*N*Pw fp32 (Pw = P rounded up to
// 4) and tot: B*H*ceil(S/64) fp32 of workspace.  strides: 15 element
// strides, (batch, seq, head) for q, k, v, log_a and y in that order, with a
// unit stride along N and P.
// dtypes: 0 = fp32, 1 = bf16.  Returns 0 or a cudaError_t.
// fp32 elements of the workspace: an (N, Pw) state for each (b, h, chunk),
// then the B * H * nc chunk totals (kernels/ssm_scan.py workspace_numel).
static long long ssm_scan_workspace_floats(int B, int H, int S, int N, int P) {
    const long long nc = (S + SC_L - 1) / SC_L;
    return (long long)B * H * nc * ((long long)N * ((P + 3) & ~3) + 1);
}

int ssm_scan_launch(const void* q, const void* k, const void* v,
                    const float* log_a, void* y, float* h, float* ws,
                    long long ws_floats, const long long* strides, int B,
                    int S, int H, int N, int P, int q_dt, int k_dt, int v_dt,
                    void* stream) {
    const int nc = (S + SC_L - 1) / SC_L;
    if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || P <= 0
            || (long long)B * H > 65535 || nc > 65535
            || ws_floats < ssm_scan_workspace_floats(B, H, S, N, P))
        return (int)cudaErrorInvalidValue;
    ScanParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.la = log_a;
    p.y = y;
    p.h = h;
    p.ws = ws;
    p.tot = ws + (long long)B * H * nc * N * ((P + 3) & ~3);
    for (int a = 0; a < 3; ++a) {
        p.sq[a] = strides[a];
        p.sk[a] = strides[3 + a];
        p.sv[a] = strides[6 + a];
        p.sla[a] = strides[9 + a];
        p.sy[a] = strides[12 + a];
    }
    p.H = H;
    p.S = S;
    p.N = N;
    p.P = P;
    p.Pw = (P + 3) & ~3;
    p.nc = nc;
    p.q_dt = q_dt;
    p.k_dt = k_dt;
    p.v_dt = v_dt;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (q_dt == 1 && k_dt == 1 && v_dt == 1) return launch_tc(p, B * H, s);
    return launch_f32(p, B * H, s);
}

}  // extern "C"
