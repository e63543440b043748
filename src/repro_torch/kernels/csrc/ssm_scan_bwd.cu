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
// that is ~79 MB, ~24 us at 3.35 TB/s, against 2.1 GFLOP (~2 us on the bf16
// tensor cores): bytes bound it.  At the xlstm-125m shape (4 heads, N =
// 384, P = 385, an fp32 k) its 24 GFLOP take ~0.36 ms on the fp32 CUDA
// cores, over ~0.03 ms of bytes.  This design runs the chunked form on the
// CUDA cores in fp32 (the tensor cores are later work), recomputing the
// chunks' starting states, the 64 x 64 score and dY.V^T tiles in each block
// that needs them and reading the state tiles once a block.

// Design: the forward's chunks of L = 64 steps.  With cum the in-chunk
// inclusive prefix of log_a, T_c the chunk total, h_in(c) the chunk's
// starting state and G(c) the gradient of h_in(c) (G(nc) = dh or 0):
//   1. U_c = sum_t exp(cum_t) q_t dy_t^T and the chunk's own state
//      L_c = sum_s exp(T_c - cum_s) k_s v_s^T, every chunk at once (N x P),
//      and T_c;
//   2. state passes, elementwise over N x P: h_in(c+1) = exp(T_c) h_in(c)
//      + L_c from the first chunk, overwriting L_c with h_in(c); then the
//      adjoint from the last, G(c) = exp(T_c) G(c+1) + U_c, overwriting U_c
//      with G(c+1); each block also writes its part of the boundary term
//      <G(c+1), h_in(c+1)> (h_in(nc) = h_final) for every chunk.  The
//      states are recomputed in fp32 rather than read from the forward's
//      workspace: the forward's tensor-core states (bf16 hi + lo splits)
//      are less exact than fp32, and dlog_a, where its reverse sum and that
//      product cancel, took their error past the scan's bounds;
//   3. a block per (b, h, chunk, 64-wide N-tile): D = dY V^T (t, s) gated by
//      exp(cum_t - cum_s) for s <= t, then
//        dq = D K + diag(exp(cum)) dY h_in(c)^T
//        dk = D^T Q + diag(exp(T_c - cum)) V G(c+1)^T
//      and its part of q.dq - k.dk for each step;
//   4. a block per (b, h, chunk, 64-wide P-tile): the gated score tile
//      Sc = Q K^T, then dv = Sc^T dY + diag(exp(T_c - cum)) K G(c+1);
//   5. a block per (b, h, chunk): dlog_a_t = sum over t' >= t in the chunk
//      of (q.dq - k.dk)_t' + <G(c+1), h_in(c+1)> (the reverse prefix of the
//      whole sequence, cut at the chunk's end, where the rest of it is that
//      state product), and 0 at t = 0 (h0 = 0).
// Every product is a 64 x 64 tile of a block of 256 threads, 4 x 4 outputs
// a thread, its operands staged through shared memory 16 reduction steps at
// a time.  Sums across blocks go through the workspace in a fixed order:
// no atomics, so a call gives the same bits every time.
//
// q, k, v, log_a and dy are read in place through (batch, seq, head)
// strides with a unit stride along N or P (a stride of 0 along the heads is
// allowed: the Mamba heads share one q and one k; the kernel writes every
// head's dq and dk and autograd sums them); q, k, v, dy each fp32 or bf16,
// dy in v's dtype; log_a, dh and the workspace fp32.  dq, dk, dv and
// dlog_a are written contiguous.
//
// Plain C interface, loaded with ctypes.  The five launches go to the
// caller's stream, do not synchronise and allocate nothing; the return value
// is cudaGetLastError() after the last launch (or the first error).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SB_L 64                 // chunk length (the forward's SC_L)
#define SB_T 64                 // output tile
#define SB_K 16                 // reduction steps a stage
#define SB_THREADS 256          // 16 x 16 threads, 4 x 4 outputs each
#define SB_PASS_THREADS 256
#define SB_AS (SB_T + 1)        // staged operand row stride

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
    float* part;            // (B, H, nc, n_nt, L): parts of q.dq - k.dk
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

// ---------------------------------------------------------------------------
// the block's 64 x 64 product: acc[i][j] (row ty + 16 i, column tx + 16 j)
// += sum_r A(row, r) B(r, col) over r < K.  fa / fb return an operand
// element (zero outside the operand); a_rfast / b_rfast say whether the
// operand runs fastest along r in memory, which sets how the threads walk
// it while staging.
// ---------------------------------------------------------------------------

struct Stage {
    float a[SB_K][SB_AS];
    float b[SB_K][SB_AS];
};

template <class FA, class FB>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], int K, Stage& sm,
                                         FA fa, bool a_rfast, FB fb, bool b_rfast) {
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    for (int r0 = 0; r0 < K; r0 += SB_K) {
#pragma unroll
        for (int e = 0; e < SB_T * SB_K / SB_THREADS; ++e) {
            const int idx = tid + SB_THREADS * e;
            int row = a_rfast ? idx / SB_K : idx % SB_T;
            int r = a_rfast ? idx % SB_K : idx / SB_T;
            sm.a[r][row] = r0 + r < K ? fa(row, r0 + r) : 0.f;
            row = b_rfast ? idx / SB_K : idx % SB_T;
            r = b_rfast ? idx % SB_K : idx / SB_T;
            sm.b[r][row] = r0 + r < K ? fb(r0 + r, row) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < SB_K; ++r) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sm.a[r][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = sm.b[r][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// the chunk's in-chunk inclusive prefix of log_a (0 past the sequence's
// end), its exps and the total, into shared memory
struct ChunkCum {
    float cum[SB_L];
    float ecum[SB_L];       // exp(cum_t)
    float erev[SB_L];       // exp(T - cum_s)
};

__device__ __forceinline__ void chunk_cum(ChunkCum& cc, const BwdParams& p, int b,
                                          int h, int c0, int Lc) {
    const int tid = threadIdx.x;
    if (tid < SB_L)
        cc.cum[tid] = tid < Lc ? p.la[b * p.sla[0] + (long long)(c0 + tid) * p.sla[1]
                                      + h * p.sla[2]] : 0.f;
    __syncthreads();
    if (tid == 0)
        for (int t = 1; t < SB_L; ++t) cc.cum[t] += cc.cum[t - 1];
    __syncthreads();
    if (tid < SB_L) {
        cc.ecum[tid] = expf(cc.cum[tid]);
        cc.erev[tid] = expf(cc.cum[SB_L - 1] - cc.cum[tid]);
    }
    __syncthreads();
}

// gate a (t, s) tile held as acc into shared memory: m[t][s] = acc *
// exp(cum_t - cum_s) for s <= t < Lc, else 0
__device__ __forceinline__ void gate_tile(float (*m)[SB_AS], const float (&acc)[4][4],
                                          const ChunkCum& cc, int Lc) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int t = ty + 16 * i, s = tx + 16 * j;
            m[t][s] = (s <= t && t < Lc) ? acc[i][j] * expf(cc.cum[t] - cc.cum[s]) : 0.f;
        }
}

// ---------------------------------------------------------------------------
// 1. U_c = sum_t exp(cum_t) q_t dy_t^T and L_c = sum_s exp(T_c - cum_s) k_s
//    v_s^T: a block per (product, N-tile x P-tile, chunk, b h)
// ---------------------------------------------------------------------------

struct USmem {
    Stage st;
    ChunkCum cc;
};

__global__ void __launch_bounds__(SB_THREADS)
ssm_bwd_u_kernel(const BwdParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    USmem& sm = *reinterpret_cast<USmem*>(smem_raw);
    const int tiles = p.n_nt * p.n_pt;
    const int which = blockIdx.x / tiles;                 // 0: U_c, 1: L_c
    const int nt = blockIdx.x % tiles / p.n_pt, pt = blockIdx.x % p.n_pt;
    const int c = blockIdx.y, bh = blockIdx.z, b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0);
    const int n0 = nt * SB_T, p0 = pt * SB_T;
    chunk_cum(sm.cc, p, b, h, c0, Lc);
    if (blockIdx.x == 0 && threadIdx.x == 0)
        p.tot[(long long)bh * p.nc + c] = sm.cc.cum[SB_L - 1];
    const long long qb = b * p.sq[0] + h * p.sq[2] + (long long)c0 * p.sq[1];
    const long long kb = b * p.sk[0] + h * p.sk[2] + (long long)c0 * p.sk[1];
    const long long vb = b * p.sv[0] + h * p.sv[2] + (long long)c0 * p.sv[1];
    const long long yb = b * p.sdy[0] + h * p.sdy[2] + (long long)c0 * p.sdy[1];
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const long long tile = ((long long)bh * p.nc + c) * p.N * p.P;
    float acc[4][4];
    zero(acc);
    if (which == 0)
        tile_mma(acc, Lc, sm.st,
                 [&](int n, int t) {
                     return n0 + n < p.N
                         ? sm.cc.ecum[t] * ld(p.q, qb + t * p.sq[1] + n0 + n, p.q_dt)
                         : 0.f;
                 }, false,
                 [&](int t, int pp) {
                     return p0 + pp < p.P ? ld(p.dy, yb + t * p.sdy[1] + p0 + pp, p.v_dt)
                                          : 0.f;
                 }, false);
    else
        tile_mma(acc, Lc, sm.st,
                 [&](int n, int s) {
                     return n0 + n < p.N
                         ? sm.cc.erev[s] * ld(p.k, kb + s * p.sk[1] + n0 + n, p.k_dt)
                         : 0.f;
                 }, false,
                 [&](int s, int pp) {
                     return p0 + pp < p.P ? ld(p.v, vb + s * p.sv[1] + p0 + pp, p.v_dt)
                                          : 0.f;
                 }, false);
    float* out = (which == 0 ? p.g : p.hs) + tile;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + ty + 16 * i, pp = p0 + tx + 16 * j;
            if (n < p.N && pp < p.P) out[(long long)n * p.P + pp] = acc[i][j];
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
    float hc = 0.f;                                               // h_in(c)
    if (live)
        for (int c = 0; c < p.nc; ++c) {
            const float l = hs[(long long)c * np];
            hs[(long long)c * np] = hc;
            hc = fmaf(expf(tot[c]), hc, l);
        }
    float carry = (live && p.dh) ? p.dh[(long long)bh * np + e] : 0.f;
    for (int c = p.nc - 1; c >= 0; --c) {
        const float u = live ? g[(long long)c * np] : 0.f;
        const float hn = !live ? 0.f
                       : c == p.nc - 1 ? hc : hs[(long long)(c + 1) * np];
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
// 3. dq and dk of one N-tile: a block per (N-tile, chunk, b h)
// ---------------------------------------------------------------------------

struct QKSmem {
    Stage st;
    ChunkCum cc;
    float m[SB_L][SB_AS];       // the gated dY.V^T tile, (t, s)
    float x[SB_L];              // q.dq of this tile, by step
};

// row-sum of a thread's 4 x 4 products over the 16 threads of its row
// group (lanes tx = 0..15 of one ty, within a warp)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__global__ void __launch_bounds__(SB_THREADS)
ssm_bwd_qk_kernel(const BwdParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    QKSmem& sm = *reinterpret_cast<QKSmem*>(smem_raw);
    const int nt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
    const int b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0), n0 = nt * SB_T;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    chunk_cum(sm.cc, p, b, h, c0, Lc);
    const long long qb = b * p.sq[0] + h * p.sq[2] + (long long)c0 * p.sq[1];
    const long long kb = b * p.sk[0] + h * p.sk[2] + (long long)c0 * p.sk[1];
    const long long vb = b * p.sv[0] + h * p.sv[2] + (long long)c0 * p.sv[1];
    const long long yb = b * p.sdy[0] + h * p.sdy[2] + (long long)c0 * p.sdy[1];
    const float* hin = p.hs + ((long long)bh * p.nc + c) * p.N * p.P;   // h_in(c)
    const float* gn = p.g + ((long long)bh * p.nc + c) * p.N * p.P;      // G(c+1)
    auto dyv = [&](int t, int pp) {
        return t < Lc ? ld(p.dy, yb + t * p.sdy[1] + pp, p.v_dt) : 0.f;
    };
    // D[t][s] = dy_t . v_s, gated
    float acc[4][4];
    zero(acc);
    tile_mma(acc, p.P, sm.st, dyv, true,
             [&](int pp, int s) {
                 return s < Lc ? ld(p.v, vb + s * p.sv[1] + pp, p.v_dt) : 0.f;
             }, true);
    gate_tile(sm.m, acc, sm.cc, Lc);
    __syncthreads();
    // dq[t][n] = sum_s D[t][s] k[s][n] + exp(cum_t) sum_p dy[t][p] h_in[n][p]
    zero(acc);
    tile_mma(acc, Lc, sm.st, [&](int t, int s) { return sm.m[t][s]; }, true,
             [&](int s, int n) {
                 return n0 + n < p.N ? ld(p.k, kb + s * p.sk[1] + n0 + n, p.k_dt) : 0.f;
             }, false);
    float acc2[4][4];
    zero(acc2);
    tile_mma(acc2, p.P, sm.st, dyv, true,
             [&](int pp, int n) {
                 return n0 + n < p.N ? hin[(long long)(n0 + n) * p.P + pp] : 0.f;
             }, true);
    const long long ob = (((long long)b * p.S + c0) * p.H + h) * p.N + n0;
    const long long os = (long long)p.H * p.N;                   // dq, dk row stride
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        float xs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = tx + 16 * j;
            const float d = fmaf(sm.cc.ecum[t], acc2[i][j], acc[i][j]);
            if (t < Lc && n0 + n < p.N) {
                st(p.dq, ob + t * os + n, p.q_dt, d);
                xs = fmaf(ld(p.q, qb + t * p.sq[1] + n0 + n, p.q_dt), d, xs);
            }
        }
        xs = row_sum16(xs);
        if (tx == 0) sm.x[t] = xs;
    }
    // dk[s][n] = sum_t D[t][s] q[t][n] + exp(T - cum_s) sum_p v[s][p] G[n][p]
    zero(acc);
    tile_mma(acc, Lc, sm.st, [&](int s, int t) { return sm.m[t][s]; }, false,
             [&](int t, int n) {
                 return n0 + n < p.N ? ld(p.q, qb + t * p.sq[1] + n0 + n, p.q_dt) : 0.f;
             }, false);
    zero(acc2);
    tile_mma(acc2, p.P, sm.st,
             [&](int s, int pp) {
                 return s < Lc ? ld(p.v, vb + s * p.sv[1] + pp, p.v_dt) : 0.f;
             }, true,
             [&](int pp, int n) {
                 return n0 + n < p.N ? gn[(long long)(n0 + n) * p.P + pp] : 0.f;
             }, true);
    float* part = p.part + (((long long)bh * p.nc + c) * p.n_nt + nt) * SB_L;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
        float xs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = tx + 16 * j;
            const float d = fmaf(sm.cc.erev[s], acc2[i][j], acc[i][j]);
            if (s < Lc && n0 + n < p.N) {
                st(p.dk, ob + s * os + n, p.k_dt, d);
                xs = fmaf(ld(p.k, kb + s * p.sk[1] + n0 + n, p.k_dt), d, xs);
            }
        }
        xs = row_sum16(xs);
        if (tx == 0) part[s] = sm.x[s] - xs;
    }
}

// ---------------------------------------------------------------------------
// 4. dv of one P-tile: a block per (P-tile, chunk, b h)
// ---------------------------------------------------------------------------

struct VSmem {
    Stage st;
    ChunkCum cc;
    float m[SB_L][SB_AS];       // the gated Q.K^T tile, (t, s)
};

__global__ void __launch_bounds__(SB_THREADS)
ssm_bwd_v_kernel(const BwdParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    VSmem& sm = *reinterpret_cast<VSmem*>(smem_raw);
    const int pt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
    const int b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0), p0 = pt * SB_T;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    chunk_cum(sm.cc, p, b, h, c0, Lc);
    const long long qb = b * p.sq[0] + h * p.sq[2] + (long long)c0 * p.sq[1];
    const long long kb = b * p.sk[0] + h * p.sk[2] + (long long)c0 * p.sk[1];
    const long long yb = b * p.sdy[0] + h * p.sdy[2] + (long long)c0 * p.sdy[1];
    const float* gn = p.g + ((long long)bh * p.nc + c) * p.N * p.P;      // G(c+1)
    auto kv = [&](int s, int n) {
        return s < Lc ? ld(p.k, kb + s * p.sk[1] + n, p.k_dt) : 0.f;
    };
    // Sc[t][s] = q_t . k_s, gated
    float acc[4][4];
    zero(acc);
    tile_mma(acc, p.N, sm.st,
             [&](int t, int n) {
                 return t < Lc ? ld(p.q, qb + t * p.sq[1] + n, p.q_dt) : 0.f;
             }, true, [&](int n, int s) { return kv(s, n); }, true);
    gate_tile(sm.m, acc, sm.cc, Lc);
    __syncthreads();
    // dv[s][p] = sum_t Sc[t][s] dy[t][p] + exp(T - cum_s) sum_n k[s][n] G[n][p]
    zero(acc);
    tile_mma(acc, Lc, sm.st, [&](int s, int t) { return sm.m[t][s]; }, false,
             [&](int t, int pp) {
                 return p0 + pp < p.P ? ld(p.dy, yb + t * p.sdy[1] + p0 + pp, p.v_dt) : 0.f;
             }, false);
    float acc2[4][4];
    zero(acc2);
    tile_mma(acc2, p.N, sm.st, kv, true,
             [&](int n, int pp) {
                 return p0 + pp < p.P ? gn[(long long)n * p.P + p0 + pp] : 0.f;
             }, false);
    const long long ob = (((long long)b * p.S + c0) * p.H + h) * p.P + p0;
    const long long os = (long long)p.H * p.P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int pp = tx + 16 * j;
            if (s < Lc && p0 + pp < p.P)
                st(p.dv, ob + s * os + pp, p.v_dt, fmaf(sm.cc.erev[s], acc2[i][j], acc[i][j]));
        }
    }
}

// ---------------------------------------------------------------------------
// 5. dlog_a: a block of 64 threads per (chunk, b h)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SB_L)
ssm_bwd_dla_kernel(const BwdParams p) {
    __shared__ float x[SB_L];
    __shared__ float tail;
    const int c = blockIdx.x, bh = blockIdx.y, t = threadIdx.x;
    const int b = bh / p.H, h = bh % p.H;
    const int c0 = c * SB_L, Lc = min(SB_L, p.S - c0);
    const float* part = p.part + ((long long)bh * p.nc + c) * p.n_nt * SB_L;
    float s = 0.f;
    for (int nt = 0; nt < p.n_nt; ++nt) s += part[nt * SB_L + t];
    x[t] = t < Lc ? s : 0.f;
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

#define SB_MAX_DEVICES 64

template <typename K>
static int raise_smem_once(K kernel, size_t smem, bool (&done)[SB_MAX_DEVICES]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= SB_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!done[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        done[dev] = true;
    }
    return 0;
}

static void sizes(int B, int H, int S, int N, int P, int& nc, int& n_nt, int& n_pt,
                  int& n_pass) {
    nc = (S + SB_L - 1) / SB_L;
    n_nt = (N + SB_T - 1) / SB_T;
    n_pt = (P + SB_T - 1) / SB_T;
    n_pass = (int)(((long long)N * P + SB_PASS_THREADS - 1) / SB_PASS_THREADS);
}

extern "C" {

// fp32 elements of the backward's workspace: G and the states (B, H, nc,
// N, P) each, the chunk totals (B, H, nc), the boundary parts (B, H, nc,
// n_pass), then the step parts (B, H, nc, n_nt, 64)
// (kernels/ssm_scan.py bwd_workspace_numel).
long long ssm_scan_bwd_workspace_floats(int B, int H, int S, int N, int P) {
    int nc, n_nt, n_pt, n_pass;
    sizes(B, H, S, N, P, nc, n_nt, n_pt, n_pass);
    const long long bhc = (long long)B * H * nc;
    return bhc * (2LL * N * P + 1 + n_pass + (long long)n_nt * SB_L);
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
    sizes(B, H, S, N, P, nc, n_nt, n_pt, n_pass);
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
    static bool set_u[SB_MAX_DEVICES] = {}, set_qk[SB_MAX_DEVICES] = {},
                set_v[SB_MAX_DEVICES] = {};
    int err = raise_smem_once(ssm_bwd_u_kernel, sizeof(USmem), set_u);
    if (!err) err = raise_smem_once(ssm_bwd_qk_kernel, sizeof(QKSmem), set_qk);
    if (!err) err = raise_smem_once(ssm_bwd_v_kernel, sizeof(VSmem), set_v);
    if (err) return err;
    const unsigned BH = (unsigned)(B * H);
    ssm_bwd_u_kernel<<<dim3(2 * n_nt * n_pt, nc, BH), SB_THREADS, sizeof(USmem), s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_pass_kernel<<<dim3(n_pass, BH), SB_PASS_THREADS, 0, s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_qk_kernel<<<dim3(n_nt, nc, BH), SB_THREADS, sizeof(QKSmem), s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_v_kernel<<<dim3(n_pt, nc, BH), SB_THREADS, sizeof(VSmem), s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_dla_kernel<<<dim3(nc, BH), SB_L, 0, s>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
