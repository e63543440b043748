// Backward of the chunked scalar-decay linear scan (csrc/ssm_scan.cu) for
// Hopper, from h_0 = 0:
//
//   h_t = exp(log_a_t) h_{t-1} + k_t v_t^T,   y_t = q_t . h_t
//
// given dy (and dh, the gradient of h_final, or none) -> dq, dk, dv in the
// inputs' dtypes and dlog_a in fp32.
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/ssm_scan.py:
// _ssm_kernel has no VJP, and the JAX package trains through its jnp
// chunked form (repro/models/ssm.py chunked_linear_scan under
// jax.checkpoint).  It is the backward of that kernel's port, which the
// port's training path runs (kernels/ops.py _SsmScanFn).
//
// What bounds it.  The function reads q, k, v, log_a and dy (and dh) once
// and writes dq and dk (one head's worth where the heads share q and k),
// dv and dlog_a once; its least work is 5 multiply-adds a state element a
// step (recompute h, the adjoint G, dq, dk, dv; dlog_a is O(N + P) a step,
// a reverse sum of q.dq - k.dk).  At the hymba-1.5b training shape (B = 4,
// S = 1024, 8 heads, N = 16, P = 400, bf16, q and k shared by the heads)
// that is ~79 MB, ~24 us at 3.35 TB/s, against 2.1 GFLOP (~6 us on the bf16
// tensor cores at fp32's accuracy, three passes a product): bytes bound
// it.  At the xlstm-125m shape (4 heads, N = 384, P = 385, an fp32 k) its
// 24 GFLOP bound it: four of the five products have a bf16 operand (three
// bf16 passes, 330 TFLOP/s), dv = K G has two fp32 ones (six passes, or
// three of TF32: ~165 TFLOP/s), ~0.088 ms in all; ~0.36 ms on the fp32
// CUDA cores.
//
// The algorithm: the forward's chunks of L = 64 steps.  With cum the
// in-chunk inclusive prefix of log_a, T_c the chunk total, h_in(c) the
// chunk's starting state and G(c) the gradient of h_in(c) (G(nc) = dh or
// 0):
//   1. sums, every chunk at once: U_c = sum_t exp(cum_t) q_t dy_t^T and the
//      chunk's own state L_c = sum_s exp(T_c - cum_s) k_s v_s^T (N x P), T_c,
//      and the chunk's gated (t, s) tiles, each formed once: D~ = dY V^T
//      exp(cum_t - cum_s) and S~ = Q K^T exp(cum_t - cum_s) for s <= t (0
//      above the diagonal), into the workspace;
//   2. state passes, elementwise over N x P: h_in(c+1) = exp(T_c) h_in(c)
//      + L_c from the first chunk, overwriting L_c with h_in(c); then the
//      adjoint from the last, G(c) = exp(T_c) G(c+1) + U_c, overwriting U_c
//      with G(c+1); each block also writes its part of the boundary term
//      <G(c+1), h_in(c+1)> (h_in(nc) = h_final) for every chunk.  The
//      states are recomputed in fp32 rather than read from the forward's
//      workspace: the forward's tensor-core states (bf16 hi + lo splits)
//      are less exact than fp32, and dlog_a, where its reverse sum and that
//      product cancel, took their error past the scan's bounds;
//   3. outputs, reading D~ and S~ (each output tile's state product first,
//      its rows scaled, then the gated product added):
//        dq = diag(exp(cum)) dY h_in(c)^T + D~ K
//        dk = diag(exp(T_c - cum)) V G(c+1)^T + D~^T Q
//        dv = diag(exp(T_c - cum)) K G(c+1) + S~^T dY
//      and their steps' parts of q.dq and k.dk;
//   4. a block per (b, h, chunk): dlog_a_t = sum over t' >= t in the chunk
//      of (q.dq - k.dk)_t' + <G(c+1), h_in(c+1)> (the reverse prefix of the
//      whole sequence, cut at the chunk's end, where the rest of it is that
//      state product), and 0 at t = 0 (h0 = 0).
// Sums across blocks go through the workspace in a fixed order: no atomics,
// so a call gives the same bits every time.
//
// The products.  Every one is a 64 x NT tile of a warpgroup on the tensor
// cores (wgmma m64nNTk16, bf16 operands, fp32 accumulators) from operands
// in 128-byte-swizzled panels of 64 reduction steps (flash_tc.cuh's
// layout).  An operand that is exact in bf16 (q, k, v or dy read as bf16)
// takes one panel; an fp32 one (the gated tiles, the states, the
// exp-scaled rows of q and k, or an fp32 input) three, hi + mid + lo, each
// the bf16 rounding of what the terms before it leave, so their sum holds
// fp32's 24 bits.  A product of a bf16 and an fp32 operand is then three
// passes, one of two fp32 operands six (the cross terms down to 2^-16 of
// the leading one, small ones first), so every product keeps fp32's
// accuracy: a two-way split (16 bits) took dlog_a past its bounds.  Six
// bf16 passes run at 989 / 6 TFLOP/s, three TF32 ones at 494.7 / 3: the
// same rate.  Each panel's passes are summed from 0 and added to the
// output tile with a rounded fp32 add: the tensor cores' own accumulation
// rounds with a bias, which over a long reduction (P = 400 at six passes)
// put an fp32 dk past its bounds.
//
// Two routes, by the inputs' dtypes alone: "bf16" when q, k and v are all
// bf16 (every product one pass or three), "mixed" otherwise.  Two designs,
// by shape:
//   * chunk-resident (bf16 route, N <= 16, P <= 448 a multiple of 8:
//     hymba's heads; dy and v rows must start at 16-byte aligned
//     addresses, or the call fails): launches 1 and 3 are a
//     block of two warpgroups per (b, h, chunk), which copies the chunk's
//     dy and v once (cp.async, 16 bytes a copy, straight into bf16 panels)
//     and forms every product of the chunk from them: D~ and U_c (dy read
//     K-major and MN-major: wgmma's transpose bit), S~ and L_c in launch 1;
//     dq and dk side by side, then dv by P-tile in launch 3.  Tiles are 16
//     wide along N: no zero rows in U_c, L_c, dq and dk.
//   * tiled (every other shape: xlstm's N = 384 with an fp32 k): a
//     warpgroup a block per output tile -- U_c and L_c by N-tile
//     (their P-tiles in turn), D~ and S~ a block each a chunk; dq and dk by
//     N-tile, dv by P-tile -- each staging its operands through registers,
//     the next panel's loads in flight while this one's products run.
//
// q, k, v, log_a and dy are read in place through (batch, seq, head)
// strides with a unit stride along N or P (a stride of 0 along the heads is
// allowed: the Mamba heads share one q and one k; the kernel writes every
// head's dq and dk and autograd sums them); q, k, v, dy each fp32 or bf16,
// dy in v's dtype; log_a, dh and the workspace fp32.  dq, dk, dv and
// dlog_a are written contiguous.
//
// Plain C interface, loaded with ctypes.  The four launches go to the
// caller's stream, do not synchronise and allocate nothing; the return value
// is cudaGetLastError() after the last launch (or the first error).

#include "flash_tc.cuh"

#define SB_L 64                 // chunk length (the forward's SC_L)
#define SB_T 64                 // a tile's rows and a panel's reduction steps
#define SB_THREADS 128          // a warpgroup
#define SB_PASS_THREADS 256
#define SB_PANEL 8192           // 64 rows x 64 bf16, 128-byte swizzled
#define RS_THREADS 256          // the chunk-resident blocks: two warpgroups
#define RS_PANELS 7             // their P-panels: P <= 448

struct BwdParams {
    const void* q;
    const void* k;
    const void* v;
    const float* la;
    const void* dy;
    const float* dh;        // (B, H, N, P) or null
    void* dq;               // (B, S, H, N) contiguous
    void* dk;
    void* dv;               // (B, S, H, P) contiguous
    float* dla;             // (B, S, H)
    float* g;               // (B, H, nc, N, P): U_c, then G(c+1)
    float* hs;              // (B, H, nc, N, P): L_c, then h_in(c)
    float* tot;             // (B, H, nc): T_c
    float* bnd;             // (B, H, nc, n_pass): parts of <G(c+1), h_in(c+1)>
    float* part;            // (B, H, nc, 2 n_nt, L): parts of q.dq, then k.dk
    float* dt;              // (B, H, nc, L, L): the gated dY.V^T tile, (t, s)
    float* st;              // (B, H, nc, L, L): the gated Q.K^T tile, (t, s)
    long long sq[3];        // element strides: batch, seq, head
    long long sk[3];
    long long sv[3];
    long long sla[3];
    long long sdy[3];
    int H, S, N, P, nc, n_nt, n_pt, n_pass;
    int q_dt, k_dt, v_dt;   // 0 = fp32, 1 = bf16; dy and dv in v's dtype
};

__device__ __forceinline__ float ld(const void* base, long long i, int dt) {
    return dt == 0 ? static_cast<const float*>(base)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
}

__device__ __forceinline__ void st(void* base, long long i, int dt, float x) {
    if (dt == 0) static_cast<float*>(base)[i] = x;
    else static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
}

// the address of element off of a tensor of dtype code dt
__device__ __forceinline__ const void* elem(const void* base, int dt, long long off) {
    return static_cast<const char*>(base) + off * (dt == 0 ? 4 : 2);
}

// ---------------------------------------------------------------------------
// operands and their panels
// ---------------------------------------------------------------------------

// An operand as a strided view: element (r, k) at base[r rs + k ks] for r
// < rows and k < cols, 0 elsewhere, of dtype code dt, times scale[k] when
// scale is given.  Every operand that is staged through registers is one:
// a block of q, k, v or dy read in place (either way round), of a state, or
// of a gated tile.
struct View {
    const void* base;
    long long rs, ks;
    int rows, cols, dt;
    const float* scale;
};

// bf16 panels a view takes: one when its elements are exact in bf16
__device__ __forceinline__ int terms(const View& v) {
    return v.dt == 0 || v.scale != nullptr ? 3 : 1;
}

// byte offset of element (r, c) in a panel: 128 bytes a row, the 16-byte
// chunk index XOR (r % 8) within each 1 KB group of 8 rows (TMA's 128-byte
// swizzle, which sw128_desc describes).  A K-major operand keeps its rows
// as the panel's rows; an MN-major one its reduction steps.
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
    return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// Staging a K-major panel through registers: rows [0, ROWS) and reduction
// steps [k0, k0 + kcols) of a view (kcols a multiple of 16; the wgmma
// reads no further), two steps a thread an iteration, by the 128 threads
// tid of a warpgroup.  load() brings a thread's elements into registers
// (Held), store() writes them to the panels: n = 1 their bf16 rounding,
// n = 3 the hi, mid and lo terms.  The two are apart so that a panel's
// loads can be in flight while the last one's products run.  The threads
// walk along r where the view is contiguous along its rows (rs = 1), else
// along k.
template <int ROWS>
struct Held {
    float x[ROWS * 32 / SB_THREADS][2];
};

template <int ROWS>
__device__ __forceinline__ void pair_at(bool rfast, int tid, int i, int& r, int& c) {
    r = rfast ? tid % ROWS : tid / 32 + (SB_THREADS / 32) * i;
    c = rfast ? 2 * (tid / ROWS) + 2 * (SB_THREADS / ROWS) * i : 2 * (tid % 32);
}

template <typename T>
__device__ __forceinline__ float ldv(const T* p) {
    if constexpr (sizeof(T) == 4) return *p;
    else return __bfloat162float(*p);
}

template <int ROWS, typename T>
__device__ __forceinline__ void load_t(Held<ROWS>& hd, const View& v, int k0, int kcols,
                                       int tid) {
    const T* src = static_cast<const T*>(v.base);
    const bool rfast = v.rs == 1;
#pragma unroll
    for (int i = 0; i < ROWS * 32 / SB_THREADS; ++i) {
        int r, c;
        pair_at<ROWS>(rfast, tid, i, r, c);
        const int k = k0 + c;
        const bool in = r < v.rows && c < kcols;
        const T* a = src + r * v.rs + k * v.ks;
        hd.x[i][0] = in && k < v.cols ? ldv(a) : 0.f;
        hd.x[i][1] = in && k + 1 < v.cols ? ldv(a + v.ks) : 0.f;
        if (v.scale != nullptr) {
            if (in && k < v.cols) hd.x[i][0] *= v.scale[k];
            if (in && k + 1 < v.cols) hd.x[i][1] *= v.scale[k + 1];
        }
    }
}

template <int ROWS>
__device__ __forceinline__ void load(Held<ROWS>& hd, const View& v, int k0, int kcols,
                                     int tid) {
    if (v.dt == 0) load_t<ROWS, float>(hd, v, k0, kcols, tid);
    else load_t<ROWS, __nv_bfloat16>(hd, v, k0, kcols, tid);
}

template <int ROWS>
__device__ __forceinline__ void store(uint8_t* pan, int n, const Held<ROWS>& hd,
                                      const View& v, int kcols, int tid) {
#pragma unroll
    for (int i = 0; i < ROWS * 32 / SB_THREADS; ++i) {
        int r, c;
        pair_at<ROWS>(v.rs == 1, tid, i, r, c);
        if (c >= kcols) continue;
        const uint32_t off = sw_off(r, c);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(hd.x[i][0], hd.x[i][1]);
        *reinterpret_cast<uint32_t*>(pan + off) = bf2_bits(hi);
        if (n > 1) {
            const float2 h = __bfloat1622float2(hi);
            const float r0 = hd.x[i][0] - h.x, r1 = hd.x[i][1] - h.y;
            const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
            *reinterpret_cast<uint32_t*>(pan + SB_PANEL + off) = bf2_bits(mid);
            const float2 m = __bfloat1622float2(mid);
            *reinterpret_cast<uint32_t*>(pan + 2 * SB_PANEL + off) =
                bf2_bits(__floats2bfloat162_rn(r0 - m.x, r1 - m.y));
        }
    }
}

// load, then store: a panel staged in one go
template <int ROWS>
__device__ __forceinline__ void stage(uint8_t* pan, int n, const View& v, int k0,
                                      int kcols, int tid) {
    Held<ROWS> hd;
    load(hd, v, k0, kcols, tid);
    store(pan, n, hd, v, kcols, tid);
}

// the generic proxy's shared-memory writes (stores, cp.async) visible to
// the tensor cores' reads, then a barrier of the block or of warpgroup wg
__device__ __forceinline__ void fence_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void panels_ready() {
    fence_async();
    __syncthreads();
}
__device__ __forceinline__ void wg_sync(int wg) {
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// ---------------------------------------------------------------------------
// the warpgroup's products
// ---------------------------------------------------------------------------

// D (64 x 16, fp32) += A (64 x 16) . B (16 x 16)^T from shared memory; TA,
// TB: the operand is MN-major (the transpose bit)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// the descriptor of a panel's kk-th 16 reduction steps: K-major, the steps
// along a row (16 bf16 = 32 bytes apart); MN-major, along the rows (16
// rows = 2 KB apart)
template <int T>
__device__ __forceinline__ uint64_t panel_desc(const uint8_t* pan, int kk) {
    if constexpr (T == 0) return sw128_desc(pan + 32 * kk, 16, 1024);
    else return sw128_desc(pan + 2048 * kk, SB_PANEL, 1024);
}

template <int NT, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[NT / 2], uint64_t da, uint64_t db) {
    if constexpr (NT == 16) wgmma_m64n16<TA, TB>(d, da, db);
    else wgmma_ss_m64n64<TA, TB>(d, da, db, 1);
}

// acc (64 x NT) = A B^T over the panels' first 16 KS steps: A's NA terms
// against B's NB, every pair whose order of size (hi 0, mid 1, lo 2) sums
// to at most 2, the smallest first.  Straight-line from the fence to the
// wait: a branch or a move of acc inside would serialise the wgmmas.
template <int NT, int TA, int TB, int NA, int NB, int KS>
__device__ __forceinline__ void panel_mma_k(float (&acc)[NT / 2], const uint8_t* a,
                                            const uint8_t* b) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int lev = 2; lev >= 0; --lev)
#pragma unroll
            for (int ia = 2; ia >= 0; --ia) {
                const int ib = lev - ia;
                if (ia < NA && ib >= 0 && ib < NB)
                    wgmma_ss<NT, TA, TB>(acc, panel_desc<TA>(a + ia * SB_PANEL, kk),
                                         panel_desc<TB>(b + ib * SB_PANEL, kk));
            }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
}

template <int NT, int TA, int TB, int NA, int NB>
__device__ __forceinline__ void panel_mma_t(float (&acc)[NT / 2], const uint8_t* a,
                                            const uint8_t* b, int ksteps) {
    switch (ksteps) {
        case 1: panel_mma_k<NT, TA, TB, NA, NB, 1>(acc, a, b); break;
        case 2: panel_mma_k<NT, TA, TB, NA, NB, 2>(acc, a, b); break;
        case 3: panel_mma_k<NT, TA, TB, NA, NB, 3>(acc, a, b); break;
        default: panel_mma_k<NT, TA, TB, NA, NB, 4>(acc, a, b); break;
    }
}

// acc += A B^T over one panel pair: the panel's passes summed from 0, then
// added to acc with a rounded fp32 add.  panel_mma_s: term counts known
// where it is called (the chunk-resident design: bf16 inputs, one term;
// an MN-major operand is a bf16 input's own panel), the panel's steps
// given (its last step's k-steps); panel_mma: term counts of the inputs'
// dtypes, a whole panel (the tiled design stages zeros past an operand's
// end), so each call site inlines four wgmma sequences, not sixteen
template <int NT, int TA, int TB, int NA, int NB>
__device__ __forceinline__ void panel_mma_s(float (&acc)[NT / 2], const uint8_t* a,
                                            const uint8_t* b, int ksteps) {
    float part[NT / 2];
    panel_mma_t<NT, TA, TB, NA, NB>(part, a, b, ksteps);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] += part[i];
}

template <int NT>
__device__ __forceinline__ void panel_mma(float (&acc)[NT / 2], const uint8_t* a, int na,
                                          const uint8_t* b, int nb) {
    float part[NT / 2];
    if (na == 1) {
        if (nb == 1) panel_mma_k<NT, 0, 0, 1, 1, 4>(part, a, b);
        else panel_mma_k<NT, 0, 0, 1, 3, 4>(part, a, b);
    } else {
        if (nb == 1) panel_mma_k<NT, 0, 0, 3, 1, 4>(part, a, b);
        else panel_mma_k<NT, 0, 0, 3, 3, 4>(part, a, b);
    }
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] += part[i];
}

__device__ __forceinline__ int ksteps_at(int K, int k0) {
    return min(4, (K - k0 + 15) / 16);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// thread (warp w of its warpgroup, lane l) holds accumulator element 4 j +
// e at row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2
__device__ __forceinline__ int acc_row(int e) {
    return 16 * (threadIdx.x % SB_THREADS / 32) + (threadIdx.x % 32) / 4 + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int j, int e) {
    return 8 * j + 2 * (threadIdx.x % 4) + (e & 1);
}

// acc's rows (acc_row) times scale[row]
template <int N>
__device__ __forceinline__ void scale_rows(float (&acc)[N], const float* scale) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= scale[acc_row(i % 4)];
}

// a row's sum over the 4 lanes that hold it (lanes l / 4 alike)
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// ---------------------------------------------------------------------------
// a chunk
// ---------------------------------------------------------------------------

struct ChunkCum {
    float cum[SB_L];        // the in-chunk inclusive prefix of log_a
    float ecum[SB_L];       // exp(cum_t)
    float erev[SB_L];       // exp(T - cum_s)
};

// the chunk's cum (0 past the sequence's end), its exps and the total
__device__ __forceinline__ void chunk_cum(ChunkCum& cc, const BwdParams& p, int b,
                                          int h, int c0, int Lc) {
    const int tid = threadIdx.x;
    if (tid < SB_L)
        cc.cum[tid] = tid < Lc ? p.la[b * p.sla[0] + (long long)(c0 + tid) * p.sla[1]
                                      + h * p.sla[2]] : 0.f;
    __syncthreads();
    if (tid < 32) {             // warp 0: an inclusive scan of two values a lane
        float a = cc.cum[2 * tid], b2 = a + cc.cum[2 * tid + 1];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float up = __shfl_up_sync(0xffffffffu, b2, o);
            if (tid >= o) {
                a += up;
                b2 += up;
            }
        }
        cc.cum[2 * tid] = a;
        cc.cum[2 * tid + 1] = b2;
    }
    __syncthreads();
    if (tid < SB_L) {
        cc.ecum[tid] = expf(cc.cum[tid]);
        cc.erev[tid] = expf(cc.cum[SB_L - 1] - cc.cum[tid]);
    }
    __syncthreads();
}

// the chunk's base offsets into q, k, v and dy
struct ChunkBase {
    long long q, k, v, y;
    __device__ ChunkBase(const BwdParams& p, int b, int h, int c0)
        : q(b * p.sq[0] + h * p.sq[2] + (long long)c0 * p.sq[1]),
          k(b * p.sk[0] + h * p.sk[2] + (long long)c0 * p.sk[1]),
          v(b * p.sv[0] + h * p.sv[2] + (long long)c0 * p.sv[1]),
          y(b * p.sdy[0] + h * p.sdy[2] + (long long)c0 * p.sdy[1]) {}
};

// a D~ or S~ tile (acc, (t, s)) gated by exp(cum_t - cum_s) for s <= t <
// Lc, 0 elsewhere, to the workspace
__device__ __forceinline__ void put_gated(float* out, const float (&acc)[32],
                                          const ChunkCum& cc, int Lc) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int t = acc_row(e), s = acc_col(j, e);
            out[t * SB_L + s] = (s <= t && t < Lc)
                ? acc[4 * j + e] * expf(cc.cum[t] - cc.cum[s]) : 0.f;
        }
}

// a dq or dk tile (acc: (step, n), columns n0 + ..) to the output, and its
// rows' part of q.dq (k.dk) to part
template <int NTN>
__device__ __forceinline__ void put_qk(const BwdParams& p, const float (&acc)[NTN / 2],
                                       bool is_q, const ChunkBase& cb, int b, int h, int c0,
                                       int Lc, int n0, float* part) {
    const void* x_in = is_q ? p.q : p.k;
    const long long xb = is_q ? cb.q : cb.k;
    const long long xs = is_q ? p.sq[1] : p.sk[1];
    const int xdt = is_q ? p.q_dt : p.k_dt;
    void* out = is_q ? p.dq : p.dk;
    const long long ob = (((long long)b * p.S + c0) * p.H + h) * p.N + n0;
    const long long os = (long long)p.H * p.N;                   // dq, dk row stride
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int t = acc_row(2 * half);
        float xsum = 0.f;
#pragma unroll
        for (int j = 0; j < NTN / 8; ++j)
#pragma unroll
            for (int e = 2 * half; e < 2 * half + 2; ++e) {
                const int n = acc_col(j, e);
                const float d = acc[4 * j + e];
                if (t < Lc && n0 + n < p.N) {
                    st(out, ob + t * os + n, xdt, d);
                    xsum = fmaf(ld(x_in, xb + t * xs + n0 + n, xdt), d, xsum);
                }
            }
        xsum = quad_sum(xsum);
        if ((threadIdx.x & 3) == 0) part[t] = xsum;
    }
}

// a dv tile (acc: (s, p), columns p0 + ..) to the output
__device__ __forceinline__ void put_v(const BwdParams& p, const float (&acc)[32], int b,
                                      int h, int c0, int Lc, int p0) {
    const long long ob = (((long long)b * p.S + c0) * p.H + h) * p.P + p0;
    const long long os = (long long)p.H * p.P;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int s = acc_row(e), pp = acc_col(j, e);
            if (s < Lc && p0 + pp < p.P) st(p.dv, ob + s * os + pp, p.v_dt, acc[4 * j + e]);
        }
}

// ---------------------------------------------------------------------------
// the tiled design: a warpgroup a block per output tile
// ---------------------------------------------------------------------------

struct TileSmem {
    uint8_t a[3 * SB_PANEL];    // A's terms
    uint8_t b[3 * SB_PANEL];    // B's terms (NT rows used)
    ChunkCum cc;
};
// 1 KB of slack to align the panels to the swizzle's 1 KB period
#define SB_SMEM (sizeof(TileSmem) + 1024)

template <class S>
__device__ __forceinline__ S& aligned_smem(unsigned char* raw) {
    return *reinterpret_cast<S*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// acc (64 x NT) += sum over k < K of A(r, k) B(n, k), panel by panel
// (whole panels, zeros past K), the next panel's loads issued before this
// one's products
template <int NT>
__device__ __forceinline__ void tile_mma(float (&acc)[NT / 2], int K, TileSmem& sm,
                                         const View& va, const View& vb) {
    const int na = terms(va), nb = terms(vb), tid = threadIdx.x;
    Held<SB_T> ha;
    Held<NT> hb;
    load(ha, va, 0, SB_T, tid);
    load(hb, vb, 0, SB_T, tid);
    for (int k0 = 0; k0 < K; k0 += SB_T) {
        store(sm.a, na, ha, va, SB_T, tid);
        store(sm.b, nb, hb, vb, SB_T, tid);
        panels_ready();
        if (k0 + SB_T < K) {
            load(ha, va, k0 + SB_T, SB_T, tid);
            load(hb, vb, k0 + SB_T, SB_T, tid);
        }
        panel_mma<NT>(acc, sm.a, na, sm.b, nb);
        __syncthreads();                  // the panels are read
    }
}

// 1. U_c, L_c by N-tile, and each chunk's D~ and S~: grid (2 n_nt + 2,
//    chunk, b h)
template <int NTN>
__global__ void __launch_bounds__(SB_THREADS)
ssm_bwd_sums_kernel(const BwdParams p) {
    extern __shared__ unsigned char smem_raw[];
    TileSmem& sm = aligned_smem<TileSmem>(smem_raw);
    const int c = blockIdx.y, bh = blockIdx.z, b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0), tid = threadIdx.x;
    chunk_cum(sm.cc, p, b, h, c0, Lc);
    const long long bhc = (long long)bh * p.nc + c;
    if (blockIdx.x == 0 && tid == 0) p.tot[bhc] = sm.cc.cum[SB_L - 1];
    const ChunkBase cb(p, b, h, c0);
    const int x = blockIdx.x;

    if (x < 2 * p.n_nt) {
        // U_c^T (L_c^T) of one N-tile, P-tile by P-tile: (p, n) = sum_t
        // dy_t[p] exp(cum_t) q_t[n] (v_s[p] exp(T - cum_s) k_s[n]); the
        // N-tile, B, is staged once (three terms), the P-tiles, A, in turn
        const bool is_u = x < p.n_nt;
        const int n0 = x % p.n_nt * NTN;
        const View vb = is_u
            ? View{elem(p.q, p.q_dt, cb.q + n0), 1, p.sq[1], p.N - n0, Lc, p.q_dt, sm.cc.ecum}
            : View{elem(p.k, p.k_dt, cb.k + n0), 1, p.sk[1], p.N - n0, Lc, p.k_dt, sm.cc.erev};
        stage<NTN>(sm.b, 3, vb, 0, SB_T, tid);
        float* out = (is_u ? p.g : p.hs) + bhc * p.N * p.P;
        const auto va_at = [&](int p0) {
            return is_u
                ? View{elem(p.dy, p.v_dt, cb.y + p0), 1, p.sdy[1], p.P - p0, Lc, p.v_dt,
                       nullptr}
                : View{elem(p.v, p.v_dt, cb.v + p0), 1, p.sv[1], p.P - p0, Lc, p.v_dt,
                       nullptr};
        };
        const int na = p.v_dt == 0 ? 3 : 1;
        Held<SB_T> ha;
        load(ha, va_at(0), 0, SB_T, tid);
        for (int p0 = 0; p0 < p.P; p0 += SB_T) {
            store(sm.a, na, ha, va_at(p0), SB_T, tid);
            panels_ready();
            if (p0 + SB_T < p.P) load(ha, va_at(p0 + SB_T), 0, SB_T, tid);
            float acc[NTN / 2];
            zero(acc);
            panel_mma<NTN>(acc, sm.a, na, sm.b, 3);
            __syncthreads();              // A's panels are read
#pragma unroll
            for (int j = 0; j < NTN / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int pp = p0 + acc_row(e), n = n0 + acc_col(j, e);
                    if (pp < p.P && n < p.N) out[(long long)n * p.P + pp] = acc[4 * j + e];
                }
        }
        return;
    }

    // D~ (x = 2 n_nt) over P, or S~ (x = 2 n_nt + 1) over N
    const bool is_d = x == 2 * p.n_nt;
    const View va = is_d ? View{elem(p.dy, p.v_dt, cb.y), p.sdy[1], 1, Lc, p.P, p.v_dt, nullptr}
                         : View{elem(p.q, p.q_dt, cb.q), p.sq[1], 1, Lc, p.N, p.q_dt, nullptr};
    const View vb = is_d ? View{elem(p.v, p.v_dt, cb.v), p.sv[1], 1, Lc, p.P, p.v_dt, nullptr}
                         : View{elem(p.k, p.k_dt, cb.k), p.sk[1], 1, Lc, p.N, p.k_dt, nullptr};
    float acc[32];
    zero(acc);
    tile_mma<64>(acc, is_d ? p.P : p.N, sm, va, vb);
    put_gated((is_d ? p.dt : p.st) + bhc * SB_L * SB_L, acc, sm.cc, Lc);
}

// 3. dq and dk by N-tile, dv by P-tile: grid (2 n_nt + n_pt, chunk, b h)
template <int NTN>
__global__ void __launch_bounds__(SB_THREADS)
ssm_bwd_out_kernel(const BwdParams p) {
    extern __shared__ unsigned char smem_raw[];
    TileSmem& sm = aligned_smem<TileSmem>(smem_raw);
    const int c = blockIdx.y, bh = blockIdx.z, b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0);
    chunk_cum(sm.cc, p, b, h, c0, Lc);
    const long long bhc = (long long)bh * p.nc + c;
    const ChunkBase cb(p, b, h, c0);
    const float* dtl = p.dt + bhc * SB_L * SB_L;                 // D~ (t, s)
    const float* gn = p.g + bhc * p.N * p.P;                      // G(c+1)
    const int x = blockIdx.x;

    if (x < 2 * p.n_nt) {
        const bool is_q = x < p.n_nt;
        const int nt = x % p.n_nt, n0 = nt * NTN;
        float acc[NTN / 2];
        zero(acc);
        if (is_q) {
            // dq[t][n] = exp(cum_t) sum_p dy_t[p] h_in[n][p] + sum_s D~[t][s] k_s[n]
            const float* hin = p.hs + bhc * p.N * p.P;            // h_in(c)
            tile_mma<NTN>(acc, p.P, sm,
                          View{elem(p.dy, p.v_dt, cb.y), p.sdy[1], 1, Lc, p.P, p.v_dt,
                               nullptr},
                          View{hin + (long long)n0 * p.P, p.P, 1, p.N - n0, p.P, 0, nullptr});
            scale_rows(acc, sm.cc.ecum);
            tile_mma<NTN>(acc, Lc, sm, View{dtl, SB_L, 1, SB_L, Lc, 0, nullptr},
                          View{elem(p.k, p.k_dt, cb.k + n0), 1, p.sk[1], p.N - n0, Lc,
                               p.k_dt, nullptr});
        } else {
            // dk[s][n] = exp(T - cum_s) sum_p v_s[p] G[n][p] + sum_t D~[t][s] q_t[n]
            tile_mma<NTN>(acc, p.P, sm,
                          View{elem(p.v, p.v_dt, cb.v), p.sv[1], 1, Lc, p.P, p.v_dt,
                               nullptr},
                          View{gn + (long long)n0 * p.P, p.P, 1, p.N - n0, p.P, 0, nullptr});
            scale_rows(acc, sm.cc.erev);
            tile_mma<NTN>(acc, Lc, sm, View{dtl, 1, SB_L, SB_L, Lc, 0, nullptr},
                          View{elem(p.q, p.q_dt, cb.q + n0), 1, p.sq[1], p.N - n0, Lc,
                               p.q_dt, nullptr});
        }
        put_qk<NTN>(p, acc, is_q, cb, b, h, c0, Lc, n0,
                    p.part + (bhc * 2 * p.n_nt + (is_q ? 0 : p.n_nt) + nt) * SB_L);
        return;
    }

    // dv[s][p] = exp(T - cum_s) sum_n k_s[n] G[n][p] + sum_t S~[t][s] dy_t[p]
    const float* stl = p.st + bhc * SB_L * SB_L;                 // S~ (t, s)
    const int p0 = (x - 2 * p.n_nt) * SB_T;
    float acc[32];
    zero(acc);
    tile_mma<64>(acc, p.N, sm,
                 View{elem(p.k, p.k_dt, cb.k), p.sk[1], 1, Lc, p.N, p.k_dt, nullptr},
                 View{gn + p0, 1, p.P, p.P - p0, p.N, 0, nullptr});
    scale_rows(acc, sm.cc.erev);
    tile_mma<64>(acc, Lc, sm, View{stl, 1, SB_L, SB_L, Lc, 0, nullptr},
                 View{elem(p.dy, p.v_dt, cb.y + p0), 1, p.sdy[1], p.P - p0, Lc, p.v_dt,
                      nullptr});
    put_v(p, acc, b, h, c0, Lc, p0);
}

// ---------------------------------------------------------------------------
// the chunk-resident design: two warpgroups a block per (b, h, chunk), the
// chunk's dy and v in shared memory
// ---------------------------------------------------------------------------

struct ResSmem {
    uint8_t dy[RS_PANELS][SB_PANEL];    // (t, p): K-major along p, MN-major along t
    uint8_t v[RS_PANELS][SB_PANEL];
    uint8_t wa[2][3 * SB_PANEL];        // each warpgroup's A terms
    uint8_t wb[2][3 * SB_PANEL];        // and B terms
    ChunkCum cc;
};
#define RS_SMEM (sizeof(ResSmem) + 1024)

// rows t < Lc of the chunk's (t, P) block of a bf16 tensor at base (row
// stride rs; 16-byte aligned rows) into np panels, 8 elements a copy,
// zeros past P and Lc; by the block's threads, not waited for
__device__ __forceinline__ void res_copy(uint8_t (*pan)[SB_PANEL],
                                         const __nv_bfloat16* base, long long rs,
                                         int Lc, int P, int np) {
    const int per = np * 8;                               // copies a row
    for (int e = threadIdx.x; e < SB_L * per; e += RS_THREADS) {
        const int t = e / per, ch = e % per;
        const int valid = t < Lc ? max(0, min(2 * (P - 8 * ch), 16)) : 0;
        const __nv_bfloat16* src = valid ? base + t * rs + 8 * ch : base;
        cp_async16(pan[ch >> 3] + sw_off(t, 8 * (ch & 7)), src, valid);
    }
}

// U_c^T or L_c^T (p, n) of the chunk, P-tile by P-tile: A the dy or v panel
// read MN-major (p the rows, t the steps), B the warpgroup's 16 x t terms
__device__ __forceinline__ void res_state_sums(const BwdParams& p,
                                               const uint8_t (*pan)[SB_PANEL],
                                               const uint8_t* wb, float* out, int np,
                                               int ks) {
    for (int j = 0; j < np; ++j) {
        float acc[8];
        zero(acc);
        panel_mma_s<16, 1, 0, 1, 3>(acc, pan[j], wb, ks);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int pp = SB_T * j + acc_row(e % 4), n = acc_col(e / 4, e % 4);
            if (pp < p.P && n < p.N) out[(long long)n * p.P + pp] = acc[e];
        }
    }
}

// 1. a block per (chunk, b h): warpgroup 0 forms D~ over P and U_c,
//    warpgroup 1 S~ over N and L_c
__global__ void __launch_bounds__(RS_THREADS, 1)
ssm_bwd_res_sums_kernel(const BwdParams p) {
    extern __shared__ unsigned char smem_raw[];
    ResSmem& sm = aligned_smem<ResSmem>(smem_raw);
    const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0);
    const long long bhc = (long long)bh * p.nc + c;
    const ChunkBase cb(p, b, h, c0);
    const int np = (p.P + SB_T - 1) / SB_T;
    res_copy(sm.dy, static_cast<const __nv_bfloat16*>(p.dy) + cb.y, p.sdy[1], Lc, p.P, np);
    res_copy(sm.v, static_cast<const __nv_bfloat16*>(p.v) + cb.v, p.sv[1], Lc, p.P, np);
    chunk_cum(sm.cc, p, b, h, c0, Lc);
    if (threadIdx.x == 0) p.tot[bhc] = sm.cc.cum[SB_L - 1];
    const int wg = threadIdx.x / SB_THREADS, wt = threadIdx.x % SB_THREADS;
    const int ks = ksteps_at(Lc, 0), ksn = ksteps_at(p.N, 0);
    const View vq{elem(p.q, p.q_dt, cb.q), p.sq[1], 1, Lc, p.N, p.q_dt, nullptr};
    const View vk{elem(p.k, p.k_dt, cb.k), p.sk[1], 1, Lc, p.N, p.k_dt, nullptr};
    // B of U_c (L_c): exp(cum_t) q_t[n] (exp(T - cum_s) k_s[n]) as 16 rows
    // n, three terms; then S~'s operand q (k), one term, (t, n)
    stage<16>(sm.wb[wg], 3,
              wg == 0 ? View{vq.base, 1, p.sq[1], p.N, Lc, p.q_dt, sm.cc.ecum}
                      : View{vk.base, 1, p.sk[1], p.N, Lc, p.k_dt, sm.cc.erev},
              0, 16 * ks, wt);
    stage<SB_T>(sm.wa[wg], 1, wg == 0 ? vq : vk, 0, 16 * ksn, wt);
    cp_async_wait_all();
    panels_ready();
    float acc[32];
    zero(acc);
    if (wg == 0) {
        for (int j = 0; j < np; ++j)
            panel_mma_s<64, 0, 0, 1, 1>(acc, sm.dy[j], sm.v[j], ksteps_at(p.P, SB_T * j));
        put_gated(p.dt + bhc * SB_L * SB_L, acc, sm.cc, Lc);
        res_state_sums(p, sm.dy, sm.wb[0], p.g + bhc * p.N * p.P, np, ks);
    } else {
        panel_mma_s<64, 0, 0, 1, 1>(acc, sm.wa[0], sm.wa[1], ksn);
        put_gated(p.st + bhc * SB_L * SB_L, acc, sm.cc, Lc);
        res_state_sums(p, sm.v, sm.wb[1], p.hs + bhc * p.N * p.P, np, ks);
    }
}

// 3. a block per (chunk, b h): warpgroup 0 forms dq, warpgroup 1 dk, side
//    by side; then the two take dv's P-tiles in turn
__global__ void __launch_bounds__(RS_THREADS, 1)
ssm_bwd_res_out_kernel(const BwdParams p) {
    extern __shared__ unsigned char smem_raw[];
    ResSmem& sm = aligned_smem<ResSmem>(smem_raw);
    const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0);
    const long long bhc = (long long)bh * p.nc + c;
    const ChunkBase cb(p, b, h, c0);
    const int np = (p.P + SB_T - 1) / SB_T;
    res_copy(sm.dy, static_cast<const __nv_bfloat16*>(p.dy) + cb.y, p.sdy[1], Lc, p.P, np);
    res_copy(sm.v, static_cast<const __nv_bfloat16*>(p.v) + cb.v, p.sv[1], Lc, p.P, np);
    chunk_cum(sm.cc, p, b, h, c0, Lc);
    const float* dtl = p.dt + bhc * SB_L * SB_L;                 // D~ (t, s)
    const float* stl = p.st + bhc * SB_L * SB_L;                 // S~ (t, s)
    const float* hin = p.hs + bhc * p.N * p.P;                    // h_in(c)
    const float* gn = p.g + bhc * p.N * p.P;                      // G(c+1)
    const int wg = threadIdx.x / SB_THREADS, wt = threadIdx.x % SB_THREADS;
    const bool is_q = wg == 0;
    const int ks = ksteps_at(Lc, 0), ksn = ksteps_at(p.N, 0);
    uint8_t* wa = sm.wa[wg];
    uint8_t* wb = sm.wb[wg];
    cp_async_wait_all();
    panels_ready();

    // dq = exp(cum) (dY h_in^T) + D~ K, dk = exp(T - cum) (V G^T) + D~^T Q
    float acc[8];
    zero(acc);
    const float* state = is_q ? hin : gn;
    for (int j = 0; j < np; ++j) {
        const int kj = ksteps_at(p.P, SB_T * j);
        stage<16>(wb, 3, View{state + SB_T * j, p.P, 1, p.N, p.P - SB_T * j, 0, nullptr}, 0,
                  16 * kj, wt);
        fence_async();
        wg_sync(wg);
        panel_mma_s<16, 0, 0, 1, 3>(acc, is_q ? sm.dy[j] : sm.v[j], wb, kj);
        wg_sync(wg);                      // wb is read
    }
    scale_rows(acc, is_q ? sm.cc.ecum : sm.cc.erev);
    const View vx = is_q ? View{elem(p.k, p.k_dt, cb.k), 1, p.sk[1], p.N, Lc, p.k_dt, nullptr}
                         : View{elem(p.q, p.q_dt, cb.q), 1, p.sq[1], p.N, Lc, p.q_dt, nullptr};
    stage<SB_T>(wa, 3,
                is_q ? View{dtl, SB_L, 1, SB_L, Lc, 0, nullptr}
                     : View{dtl, 1, SB_L, SB_L, Lc, 0, nullptr},
                0, 16 * ks, wt);
    stage<16>(wb, 1, vx, 0, 16 * ks, wt);
    fence_async();
    wg_sync(wg);
    panel_mma_s<16, 0, 0, 3, 1>(acc, wa, wb, ks);
    put_qk<16>(p, acc, is_q, cb, b, h, c0, Lc, 0,
               p.part + (bhc * 2 + (is_q ? 0 : 1)) * SB_L);
    __syncthreads();                      // both warpgroups are done with wa, wb

    // dv = exp(T - cum) (K G) + S~^T dY by P-tile: S~^T (s, t; three
    // terms) and K (s, n) staged once, dY read MN-major from its panel
    const View vk{elem(p.k, p.k_dt, cb.k), p.sk[1], 1, Lc, p.N, p.k_dt, nullptr};
    if (is_q) stage<SB_T>(sm.wa[0], 3, View{stl, 1, SB_L, SB_L, Lc, 0, nullptr}, 0, 16 * ks, wt);
    else stage<SB_T>(sm.wa[1], 1, vk, 0, 16 * ksn, wt);
    panels_ready();
    for (int j = wg; j < np; j += 2) {
        float av[32];
        zero(av);
        stage<SB_T>(wb, 3, View{gn + SB_T * j, 1, p.P, p.P - SB_T * j, p.N, 0, nullptr}, 0,
                    16 * ksn, wt);
        fence_async();
        wg_sync(wg);
        panel_mma_s<64, 0, 0, 1, 3>(av, sm.wa[1], wb, ksn);
        scale_rows(av, sm.cc.erev);
        panel_mma_s<64, 0, 1, 3, 1>(av, sm.wa[0], sm.dy[j], ks);
        wg_sync(wg);                      // wb is read
        put_v(p, av, b, h, c0, Lc, SB_T * j);
    }
}

// ---------------------------------------------------------------------------
// 2. state passes: a thread per state element, sequential over chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SB_PASS_THREADS)
ssm_bwd_pass_kernel(const BwdParams p) {
    __shared__ float red[SB_PASS_THREADS / 32];
    const long long np = (long long)p.N * p.P;
    const long long e = (long long)blockIdx.x * SB_PASS_THREADS + threadIdx.x;
    const bool live = e < np;
    const int bh = blockIdx.y;
    float* g = p.g + (long long)bh * p.nc * np + e;
    float* hs = p.hs + (long long)bh * p.nc * np + e;
    const float* tot = p.tot + (long long)bh * p.nc;
    // each chunk's loads are issued a chunk ahead of the store before them
    float hc = 0.f;                                               // h_in(c)
    if (live) {
        float l_next = hs[0];
        for (int c = 0; c < p.nc; ++c) {
            const float l = l_next;
            if (c + 1 < p.nc) l_next = hs[(long long)(c + 1) * np];
            hs[(long long)c * np] = hc;
            hc = fmaf(expf(tot[c]), hc, l);
        }
    }
    float carry = (live && p.dh) ? p.dh[(long long)bh * np + e] : 0.f;
    float u_next = live ? g[(long long)(p.nc - 1) * np] : 0.f;
    float hn_next = hc;
    for (int c = p.nc - 1; c >= 0; --c) {
        const float u = u_next, hn = hn_next;
        if (live && c > 0) {
            u_next = g[(long long)(c - 1) * np];
            hn_next = hs[(long long)c * np];
        }
        if (live) g[(long long)c * np] = carry;                  // G(c+1)
        float d = carry * hn;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = d;
        __syncthreads();
        if (threadIdx.x == 0) {
            float s = 0.f;
            for (int w = 0; w < SB_PASS_THREADS / 32; ++w) s += red[w];
            p.bnd[((long long)bh * p.nc + c) * p.n_pass + blockIdx.x] = s;
        }
        __syncthreads();
        carry = fmaf(expf(tot[c]), carry, u);
    }
}

// ---------------------------------------------------------------------------
// 4. dlog_a: a block of 64 threads per (chunk, b h)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SB_L)
ssm_bwd_dla_kernel(const BwdParams p) {
    __shared__ float x[SB_L];
    __shared__ float tail;
    const int c = blockIdx.x, bh = blockIdx.y, t = threadIdx.x;
    const int b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0);
    const float* part = p.part + ((long long)bh * p.nc + c) * 2 * p.n_nt * SB_L;
    float sq = 0.f, sk = 0.f;
    for (int nt = 0; nt < p.n_nt; ++nt) {
        sq += part[nt * SB_L + t];
        sk += part[(p.n_nt + nt) * SB_L + t];
    }
    x[t] = t < Lc ? sq - sk : 0.f;
    if (t == 0) {
        const float* bnd = p.bnd + ((long long)bh * p.nc + c) * p.n_pass;
        float sb = 0.f;
        for (int i = 0; i < p.n_pass; ++i) sb += bnd[i];
        tail = sb;
    }
    __syncthreads();
    float r = tail;
    for (int u = SB_L - 1; u >= t; --u) r += x[u];
    // the first step's gradient is a_0 <G_0, h0> = 0 exactly (h0 = 0),
    // where the reverse sum leaves the rounding of its cancelling terms
    if (t < Lc) p.dla[((long long)b * p.S + c0 + t) * p.H + h] = c0 + t ? r : 0.f;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

static void sizes(int H, int S, int N, int P, int& nc, int& n_nt, int& n_pt,
                  int& n_pass) {
    nc = (S + SB_L - 1) / SB_L;
    const int ntn = N <= 16 ? 16 : 64;
    n_nt = (N + ntn - 1) / ntn;
    n_pt = (P + SB_T - 1) / SB_T;
    n_pass = (int)(((long long)N * P + SB_PASS_THREADS - 1) / SB_PASS_THREADS);
}

// whether a bf16 tensor's (batch, seq, head) rows start at 16-byte aligned
// addresses (a dimension of size 1 is never stepped)
static bool rows_aligned(const void* ptr, const long long* st, int B, int S, int H) {
    if (reinterpret_cast<uintptr_t>(ptr) & 15) return false;
    const int dims[3] = {B, S, H};
    for (int a = 0; a < 3; ++a)
        if (dims[a] > 1 && (st[a] & 7)) return false;
    return true;
}

template <int NTN>
static int launch_tiled(const BwdParams& p, unsigned BH, cudaStream_t s) {
    static bool set_sums[FA_MAX_DEVICES] = {}, set_out[FA_MAX_DEVICES] = {};
    int err = raise_smem_once(ssm_bwd_sums_kernel<NTN>, SB_SMEM, set_sums);
    if (!err) err = raise_smem_once(ssm_bwd_out_kernel<NTN>, SB_SMEM, set_out);
    if (err) return err;
    ssm_bwd_sums_kernel<NTN><<<dim3(2 * p.n_nt + 2, p.nc, BH), SB_THREADS, SB_SMEM, s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_pass_kernel<<<dim3(p.n_pass, BH), SB_PASS_THREADS, 0, s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_out_kernel<NTN><<<dim3(2 * p.n_nt + p.n_pt, p.nc, BH), SB_THREADS, SB_SMEM,
                              s>>>(p);
    return (int)cudaGetLastError();
}

static int launch_resident(const BwdParams& p, unsigned BH, cudaStream_t s) {
    static bool set_sums[FA_MAX_DEVICES] = {}, set_out[FA_MAX_DEVICES] = {};
    int err = raise_smem_once(ssm_bwd_res_sums_kernel, RS_SMEM, set_sums);
    if (!err) err = raise_smem_once(ssm_bwd_res_out_kernel, RS_SMEM, set_out);
    if (err) return err;
    ssm_bwd_res_sums_kernel<<<dim3(p.nc, BH), RS_THREADS, RS_SMEM, s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_pass_kernel<<<dim3(p.n_pass, BH), SB_PASS_THREADS, 0, s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_res_out_kernel<<<dim3(p.nc, BH), RS_THREADS, RS_SMEM, s>>>(p);
    return (int)cudaGetLastError();
}

// whether a call of these dtypes and shapes runs the chunk-resident design
// (the rest run the tiled one): q, k, v bf16, N <= 16, P <= 448 and a
// multiple of 8 (kernels/ssm_scan.py bwd_resident)
static bool resident(int N, int P, int q_dt, int k_dt, int v_dt) {
    return q_dt == 1 && k_dt == 1 && v_dt == 1 && N <= 16 && P <= RS_PANELS * SB_T
        && P % 8 == 0;
}

extern "C" {

// fp32 elements of the backward's workspace: G and the states (B, H, nc,
// N, P) each, the chunk totals (B, H, nc), the boundary parts (B, H, nc,
// n_pass), the step parts (B, H, nc, 2 n_nt, 64), then the gated tiles D~
// and S~ (B, H, nc, 64, 64) each (kernels/ssm_scan.py bwd_workspace_numel).
long long ssm_scan_bwd_workspace_floats(int B, int H, int S, int N, int P) {
    int nc, n_nt, n_pt, n_pass;
    sizes(H, S, N, P, nc, n_nt, n_pt, n_pass);
    const long long bhc = (long long)B * H * nc;
    return bhc * (2LL * N * P + 1 + n_pass + 2LL * n_nt * SB_L + 2LL * SB_L * SB_L);
}

// q, k: (B, S, H, N); v, dy: (B, S, H, P); log_a: (B, S, H) fp32; dh: (B,
// H, N, P) fp32 contiguous or null; dq, dk (B, S, H, N), dv (B, S, H, P) and dla
// (B, S, H) contiguous; bws: ssm_scan_bwd_workspace_floats fp32.  strides:
// 15 element strides, (batch, seq, head) for q, k, v, log_a and dy, with a
// unit stride along N and P.  dtypes: 0 = fp32, 1 = bf16 (dy and dv in v's).
// Returns 0 or a cudaError_t.
int ssm_scan_bwd_launch(const void* q, const void* k, const void* v,
                        const float* log_a, const void* dy, const float* dh,
                        void* dq, void* dk, void* dv, float* dla, float* bws,
                        long long bws_floats, const long long* strides, int B,
                        int S, int H, int N, int P, int q_dt, int k_dt, int v_dt,
                        void* stream) {
    int nc, n_nt, n_pt, n_pass;
    sizes(H, S, N, P, nc, n_nt, n_pt, n_pass);
    const long long bhc = (long long)B * H * nc;
    if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || P <= 0
            || (long long)B * H > 65535 || nc > 65535
            || bws_floats < ssm_scan_bwd_workspace_floats(B, H, S, N, P))
        return (int)cudaErrorInvalidValue;
    BwdParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.la = log_a;
    p.dy = dy;
    p.dh = dh;
    p.dq = dq;
    p.dk = dk;
    p.dv = dv;
    p.dla = dla;
    p.g = bws;
    p.hs = bws + bhc * N * P;
    p.tot = p.hs + bhc * N * P;
    p.bnd = p.tot + bhc;
    p.part = p.bnd + bhc * n_pass;
    p.dt = p.part + bhc * 2 * n_nt * SB_L;
    p.st = p.dt + bhc * SB_L * SB_L;
    for (int a = 0; a < 3; ++a) {
        p.sq[a] = strides[a];
        p.sk[a] = strides[3 + a];
        p.sv[a] = strides[6 + a];
        p.sla[a] = strides[9 + a];
        p.sdy[a] = strides[12 + a];
    }
    p.H = H;
    p.S = S;
    p.N = N;
    p.P = P;
    p.nc = nc;
    p.n_nt = n_nt;
    p.n_pt = n_pt;
    p.n_pass = n_pass;
    p.q_dt = q_dt;
    p.k_dt = k_dt;
    p.v_dt = v_dt;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned BH = (unsigned)(B * H);
    int err;
    if (resident(N, P, q_dt, k_dt, v_dt)) {
        // its 16-byte copies need dy's and v's rows 16-byte aligned: the
        // caller copies them there (ops._ssm_bwd)
        if (!rows_aligned(v, strides + 6, B, S, H) || !rows_aligned(dy, strides + 12, B, S, H))
            return (int)cudaErrorMisalignedAddress;
        err = launch_resident(p, BH, s);
    }
    else
        err = N <= 16 ? launch_tiled<16>(p, BH, s) : launch_tiled<64>(p, BH, s);
    if (err) return err;
    ssm_bwd_dla_kernel<<<dim3(nc, BH), SB_L, 0, s>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
