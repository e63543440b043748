// Flash attention backward for Hopper: dq, dk and dv of the forward in
// csrc/flash_attention.cu (causal, the sliding window kpos > qpos - window,
// KV heads read in place: query head h reads KV head h / (H / KV)), from q,
// k, v, o, dO and the forward's log-sum-exp lse = m + log(l) (B, H, Sq).
//
// It replaces no TPU kernel: the Pallas kernel has no VJP, and the JAX
// package trains through its jnp attention; the port's training path on the
// card runs the forward kernel, so its gradient is a kernel too.  The
// algorithm is FlashAttention-2's: D = rowsum(dO * O), P = exp(S * scale -
// lse), dP = dO V^T, dS = P * (dP - D), dV = P^T dO, dQ = scale dS K, dK =
// scale dS^T Q.  Three routes, picked by the wrapper from the dtype and the
// head dim alone (each raises on what it does not take):
//
// * bf16, hd <= 128: wgmma and TMA (flash_attention_bwd_bf16_launch).
// * fp32, hd <= 64: mma.sync on the tensor cores, every product as three
//   TF32 passes (flash_attention_bwd_tf32_launch, route "tf32x3").  One
//   TF32 pass keeps ~3 digits and would break the fp32 tolerances; the
//   split a = a_b + a_s (a_b = tf32(a), a_s = tf32(a - a_b)) and a b ~ a_s
//   b_b + a_b b_s + a_b b_b keeps fp32's accuracy (CUTLASS's 3xTF32).
// * fp32 at hd 96 to 192, and bf16 at hd 192: the CUDA cores
//   (flash_attention_bwd_launch).  The tf32x3 kernel's dK and dV
//   accumulators beside S^T and dP^T spill past hd 64 (255 registers a
//   thread); at hd 192, split over the two consumer warpgroups as hd 128
//   is below, one wgmma warpgroup would hold two 64-column panels of dK and
//   dV (128 fp32 a thread) beside S^T, dP^T (64) and their bf16 fragments
//   (32), past the 240 registers a consumer thread has.
//
// What bounds it: at qwen2-0.5b's training shape (B=4, S=1024, H=14, KV=2,
// hd=64, bf16, causal) it must read q, o, dO (at 14 heads), k, v (at 2) and
// lse and write dq, dk, dv: 33.8 MB, 10.1 us at 3.35 TB/s; its five
// products on the unmasked pairs (S = QK^T again, dP, dV, dQ, dK) are 18.8
// GFLOP, 19.0 us on the bf16 tensor cores, so the tensor cores' rate sets
// the least time and the products must run on them.  In fp32 the same
// operations take 0.114 ms at three TF32 passes (494.7 / 3 TFLOP/s), 0.28
// ms on the CUDA cores (67 TFLOP/s).
//
// Tensor-core design (bf16).  Two launches for one count on the wrapper's
// counter:
//
//   prep     8 lanes a row: D = rowsum(dO * O) and lse * log2(e), fp32, into
//            the workspace at rows padded to a 64-row tile (zeros past Sq),
//            so a tile's 64 values are one 256-byte bulk copy.
//   main     one grid of 384-thread blocks (two consumer warpgroups and a
//            producer warpgroup, one thread of which issues every TMA load
//            into mbarrier rings, 128-byte-swizzled 64-column panels as in
//            the forward; setmaxnreg moves the producer's registers to the
//            consumers, 240 a thread), in two roles:
//     dK/dV  the first B * KV * ceil(Skv / 64) blocks, key tile 0 first (it
//            sees the most query tiles under causal): a block owns 64 keys
//            of one (batch, KV head), keeps its K and V tiles in shared
//            memory, and streams Q, dO (and the tile's lse, D rows) of 64
//            query rows for each query head of the KV head's group and each
//            query tile the keys see, through a 4-stage ring.  A warpgroup
//            computes S^T = K Q^T and dP^T = V dO^T with wgmma m64n64k16
//            (both operands in shared memory, K-major), P^T = exp2(S^T
//            scale log2(e) - lse log2(e)) masked to 0 and dS^T = P^T (dP^T
//            - D) in the accumulator registers, packs both to bf16 A
//            fragments in place (the forward's P), and adds dV += P^T dO and
//            dK += dS^T Q with wgmma m64n64k16 (A from registers, dO and Q
//            as MN-major B operands through the transpose bit); P^T is
//            formed while dP^T's product runs, and dS^T while dV's does.
//            dK and dV stay in fp32 registers, 64 x 64 a warpgroup.  At hd
//            <= 64 the two warpgroups take the query tiles in turn, and at
//            the end warpgroup 1 hands its sums to warpgroup 0 through
//            shared memory, which adds them (a fixed order) and stores; at
//            hd 96 and 128 both take every tile, each for its own 64
//            columns of dK and dV (both accumulators at full width would
//            not fit a thread's registers beside S^T and dP^T), so the
//            score products run twice.  GQA's sum over the group happens
//            in the block.
//     dQ     the remaining B * H * ceil(Sq / 128) blocks, the query tiles
//            with the most key tiles first: as the forward, two warpgroups
//            of 64 query rows keep Q and dO resident and stream K and V
//            tiles; S = Q K^T and dP = dO V^T (SS), dS in registers, dQ +=
//            dS K (RS, K through the transpose bit).
//   Recomputing S and dP in the dQ role makes 7 products where the function
//   has 5, but nothing is summed across blocks: there are no atomics and
//   every run gives the same bits.  The dK/dV blocks start first and the
//   dQ blocks fill the SMs as the light key tiles finish, so the causal
//   imbalance of the dK/dV blocks (key tile 0 sees 16 query tiles a head,
//   the last one 1) is spread over the card.  Rows past Sq and keys past Skv
//   arrive as zeros from TMA and are masked; dq rows past Sq and dk, dv rows
//   past Skv are not stored.  P and dS are rounded to bf16 for the second
//   products, as FlashAttention-2 and -3 do.
//
// TF32 design (fp32, hd <= 64), two launches for one count: the CUDA-core
// route's D kernel, then one grid of 256-thread blocks in the tensor-core
// route's two roles (dK/dV blocks of 64 keys first, key tile 0 first; then
// dQ blocks of 64 query rows, the rows with the most key tiles first).  A
// block keeps its pair of 64-row fp32 tiles (K, V or Q, dO) in shared
// memory; its two halves of four warps take the other side's tiles in turn,
// each loading its own pair (and the rows' lse and D) with cp.async, and
// add their sums at the end in a fixed order (no atomics).  A warp owns 16
// rows of the block's tile: S and dP as m16n8k8 products over hd with both
// fragments read from shared memory (row stride hd + 4 floats: 32 distinct
// banks), P and dS in the accumulators, then the second products with P
// and dS as A fragments straight from the accumulator registers: the
// k-step j reduces over the other tile's rows 8 j + 2 t and + 1 in the
// order a thread holds them, and the B fragment is read in that order.
// Each tile's sum over its 64 rows is formed from 0 and added to the
// running dK, dV or dQ with one rounded fp32 add: the tensor cores'
// accumulation rounds with a bias that over the thousands of k-steps of
// dK (7 heads x 1,024 queries) came to ~2e-4 of the running sum.  The dQ
// role recomputes S and dP (7 products where the function has 5), as the
// bf16 route does.
//
// CUDA-core design (fp32 at hd > 64, bf16 hd 192), three kernels for one
// count:
//
//   D        a warp per row: D = rowsum(dO * O) in fp32 (the workspace).
//   dK, dV   a block per (batch, KV head, 64-key tile) loops over the query
//            heads that read that KV head and over their query tiles whose
//            rows see the tile (causal and window bounds), recomputing
//            P = exp(S * scale - lse) and dS = P * (dO V^T - D), and carrying
//            dV += P^T dO and dK += dS^T Q in registers.
//   dQ       a block per (batch, query head, query tile) loops over the key
//            tiles its rows see and carries dQ += dS K in registers.
//   Tiles of Q, dO, K and V are staged in shared memory as fp32 (rows padded
//   by one float); the score tile's owner map is the fp32 forward's.
//
// Outputs are in q's dtype; the masks, the scale 1/sqrt(hd) and the -1e30
// convention are the forward's.
//
// Plain C interface, loaded with ctypes.  A launch goes to the caller's
// stream, does not synchronise and allocates nothing (the workspace comes
// from the wrapper); the return value is cudaGetLastError() after the
// launches (or the error of a setup step).

#include "flash_tc.cuh"

// ---------------------------------------------------------------------------
// the CUDA cores (fp32; bf16 at hd 192)
// ---------------------------------------------------------------------------

#define FB_BK 64             // keys a tile
#define FB_THREADS 256

struct FlashBwdParams {
    const void* q;
    const void* k;
    const void* v;
    const void* o;
    const void* dout;
    void* dq;
    void* dk;
    void* dv;
    const float* lse;        // (B, H, Sq)
    float* dd;               // (B, H, Sq) workspace: rowsum(dO * O)
    long long st[8][3];      // strides: q, k, v, o, dO, dq, dk, dv
    int B, H, KV, group, Sq, Skv, causal, window;
    float scale;
};

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void st_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void st_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

// query tile rows and shared memory of the two main kernels at head dim HD
template <int HD>
struct FbShape {
    static constexpr int BQ = HD > 128 ? 32 : 64;
    static constexpr int RQ = BQ / 16;          // query rows a thread
    static constexpr int QS = HD + 1;           // padded row of a Q/dO/K/V tile
    static constexpr int PS = FB_BK + 1;        // padded row of a P/dS tile
    static constexpr size_t SMEM = sizeof(float) *
        ((size_t)2 * BQ * QS + (size_t)2 * FB_BK * QS + (size_t)2 * BQ * PS
         + 2 * BQ);
};

__device__ __forceinline__ bool fb_keep(const FlashBwdParams& p, int qpos,
                                        int kpos) {
    bool keep = qpos < p.Sq && kpos < p.Skv;
    if (p.causal) keep = keep && kpos <= qpos;
    if (p.window > 0) keep = keep && kpos > qpos - p.window;
    return keep;
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], a warp per row
template <typename T>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dot_kernel(const FlashBwdParams p, int hd) {
    const long long row = (long long)blockIdx.x * (FB_THREADS / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= (long long)p.B * p.H * p.Sq) return;
    const int i = (int)(row % p.Sq);
    const int h = (int)((row / p.Sq) % p.H);
    const int b = (int)(row / ((long long)p.Sq * p.H));
    const T* o = static_cast<const T*>(p.o) + b * p.st[3][0] + i * p.st[3][1] + h * p.st[3][2];
    const T* g = static_cast<const T*>(p.dout) + b * p.st[4][0] + i * p.st[4][1] + h * p.st[4][2];
    float acc = 0.f;
    for (int c = lane; c < hd; c += 32) acc = fmaf(ld_f(g + c), ld_f(o + c), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) p.dd[row] = acc;
}

// The tensor-core route's prep: dd[(b H + h) ld + i] = rowsum(dO * O) and
// lp[...] = lse * log2(e) for i < Sq, zeros for Sq <= i < ld (ld: Sq rounded
// up to a key tile), 8 lanes a row reading 16-byte packs of bf16 o and dO
// (the launcher checks their alignment)
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_prep_kernel(const FlashBwdParams p, int hd, int ld, float* lp) {
    const long long row = ((long long)blockIdx.x * FB_THREADS + threadIdx.x) / 8;
    const int l8 = threadIdx.x % 8;
    const bool live = row < (long long)p.B * p.H * ld;
    const int i = live ? (int)(row % ld) : 0;
    const long long bh = live ? row / ld : 0;
    float acc = 0.f;
    if (live && i < p.Sq) {
        const int h = (int)(bh % p.H);
        const int b = (int)(bh / p.H);
        const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o)
            + b * p.st[3][0] + i * p.st[3][1] + h * p.st[3][2];
        const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.dout)
            + b * p.st[4][0] + i * p.st[4][1] + h * p.st[4][2];
        for (int c = 8 * l8; c < hd; c += 64) {
            const int4 a = *reinterpret_cast<const int4*>(o + c);
            const int4 d = *reinterpret_cast<const int4*>(g + c);
            const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 fa = __bfloat1622float2(a2[e]);
                const float2 fd = __bfloat1622float2(d2[e]);
                acc = fmaf(fd.x, fa.x, acc);
                acc = fmaf(fd.y, fa.y, acc);
            }
        }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && l8 == 0) {
        const bool in = i < p.Sq;
        p.dd[row] = in ? acc : 0.f;
        lp[row] = in ? p.lse[bh * p.Sq + i] * 1.4426950408889634f : 0.f;
    }
}

// rows [r0, r0 + R) of a (B, S, heads, hd) tensor at (b, head) into an R x QS
// fp32 tile, zeros past S
template <typename T, int HD, int R>
__device__ __forceinline__ void fb_load(float* dst, const T* base,
                                        const long long* st, int b, int head,
                                        int r0, int S) {
    constexpr int QS = HD + 1;
    const T* g = base + b * st[0] + head * st[2];
    for (int e = threadIdx.x; e < R * HD; e += FB_THREADS) {
        const int r = e / HD;
        const int c = e % HD;
        const int s = r0 + r;
        dst[r * QS + c] = s < S ? ld_f(g + (long long)s * st[1] + c) : 0.f;
    }
}

// the (RQ x 4) P and dS of this thread for the staged tiles: query rows
// ty + 16 i, keys tx + 16 j; writes them to the P and dS tiles
template <int HD>
__device__ __forceinline__ void fb_scores(const FlashBwdParams& p,
                                          const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          const float* lse_s, const float* dd_s,
                                          float* Ps, float* dSs, int q0,
                                          int k0) {
    using Sh = FbShape<HD>;
    constexpr int RQ = Sh::RQ;
    constexpr int QS = Sh::QS;
    constexpr int PS = Sh::PS;
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    float sc[RQ][4], dp[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
        float a[RQ], g[RQ], kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            a[i] = Qs[(ty + 16 * i) * QS + d];
            g[i] = dOs[(ty + 16 * i) * QS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            kk[j] = Ks[(tx + 16 * j) * QS + d];
            vv[j] = Vs[(tx + 16 * j) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
                dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
            }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            const float pr = fb_keep(p, q0 + r, k0 + c)
                ? expf(sc[i][j] * p.scale - lse_s[r]) : 0.f;
            Ps[r * PS + c] = pr;
            dSs[r * PS + c] = pr * (dp[i][j] - dd_s[r]);
        }
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dkdv_kernel(const FlashBwdParams p) {
    using Sh = FbShape<HD>;
    constexpr int BQ = Sh::BQ;
    constexpr int QS = Sh::QS;
    constexpr int PS = Sh::PS;
    constexpr int NC = HD / 16;
    extern __shared__ float smem[];
    float* Ks = smem;
    float* Vs = Ks + FB_BK * QS;
    float* Qs = Vs + FB_BK * QS;
    float* dOs = Qs + BQ * QS;
    float* Ps = dOs + BQ * QS;
    float* dSs = Ps + BQ * PS;
    float* lse_s = dSs + BQ * PS;
    float* dd_s = lse_s + BQ;

    const int b = blockIdx.y / p.KV;
    const int kvh = blockIdx.y % p.KV;
    const int k0 = blockIdx.x * FB_BK;
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    fb_load<T, HD, FB_BK>(Ks, static_cast<const T*>(p.k), p.st[1], b, kvh, k0, p.Skv);
    fb_load<T, HD, FB_BK>(Vs, static_cast<const T*>(p.v), p.st[2], b, kvh, k0, p.Skv);

    float dk[4][NC], dv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

    // query tiles whose rows see a key of this tile
    const int k_last = min(k0 + FB_BK, p.Skv) - 1;
    const int nqt = (p.Sq + BQ - 1) / BQ;
    const int qt_begin = p.causal ? k0 / BQ : 0;
    int qt_end = nqt;
    if (p.window > 0) qt_end = min(qt_end, (k_last + p.window - 1) / BQ + 1);

    for (int gi = 0; gi < p.group; ++gi) {
        const int h = kvh * p.group + gi;
        const long long bh = (long long)b * p.H + h;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();          // the last tile's readers are done
            fb_load<T, HD, BQ>(Qs, static_cast<const T*>(p.q), p.st[0], b, h, q0, p.Sq);
            fb_load<T, HD, BQ>(dOs, static_cast<const T*>(p.dout), p.st[4], b, h, q0, p.Sq);
            for (int r = threadIdx.x; r < BQ; r += FB_THREADS) {
                const bool in = q0 + r < p.Sq;
                lse_s[r] = in ? p.lse[bh * p.Sq + q0 + r] : 0.f;
                dd_s[r] = in ? p.dd[bh * p.Sq + q0 + r] : 0.f;
            }
            __syncthreads();
            fb_scores<HD>(p, Qs, dOs, Ks, Vs, lse_s, dd_s, Ps, dSs, q0, k0);
            __syncthreads();
            // dV += P^T dO and dK += dS^T Q: keys ty + 16 i, columns tx + 16 c
#pragma unroll 2
            for (int r = 0; r < BQ; ++r) {
                float pr[4], ds[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    pr[i] = Ps[r * PS + ty + 16 * i];
                    ds[i] = dSs[r * PS + ty + 16 * i];
                }
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    const float g = dOs[r * QS + tx + 16 * c];
                    const float qv = Qs[r * QS + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        dv[i][c] = fmaf(pr[i], g, dv[i][c]);
                        dk[i][c] = fmaf(ds[i], qv, dk[i][c]);
                    }
                }
            }
        }
    }

    T* dkg = static_cast<T*>(p.dk) + b * p.st[6][0] + kvh * p.st[6][2];
    T* dvg = static_cast<T*>(p.dv) + b * p.st[7][0] + kvh * p.st[7][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
        if (key >= p.Skv) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            st_f(dkg + (long long)key * p.st[6][1] + tx + 16 * c, dk[i][c] * p.scale);
            st_f(dvg + (long long)key * p.st[7][1] + tx + 16 * c, dv[i][c]);
        }
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dq_kernel(const FlashBwdParams p) {
    using Sh = FbShape<HD>;
    constexpr int BQ = Sh::BQ;
    constexpr int RQ = Sh::RQ;
    constexpr int QS = Sh::QS;
    constexpr int PS = Sh::PS;
    constexpr int NC = HD / 16;
    extern __shared__ float smem[];
    float* Ks = smem;
    float* Vs = Ks + FB_BK * QS;
    float* Qs = Vs + FB_BK * QS;
    float* dOs = Qs + BQ * QS;
    float* Ps = dOs + BQ * QS;
    float* dSs = Ps + BQ * PS;
    float* lse_s = dSs + BQ * PS;
    float* dd_s = lse_s + BQ;

    const int b = blockIdx.y / p.H;
    const int h = blockIdx.y % p.H;
    const int kvh = h / p.group;
    const long long bh = blockIdx.y;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;    // heavy tiles first
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    fb_load<T, HD, BQ>(Qs, static_cast<const T*>(p.q), p.st[0], b, h, q0, p.Sq);
    fb_load<T, HD, BQ>(dOs, static_cast<const T*>(p.dout), p.st[4], b, h, q0, p.Sq);
    for (int r = threadIdx.x; r < BQ; r += FB_THREADS) {
        const bool in = q0 + r < p.Sq;
        lse_s[r] = in ? p.lse[bh * p.Sq + q0 + r] : 0.f;
        dd_s[r] = in ? p.dd[bh * p.Sq + q0 + r] : 0.f;
    }

    float dq[RQ][NC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

    // key tiles that hold a key some row of this tile sees
    const int q_last = min(q0 + BQ, p.Sq) - 1;
    int kt_end = (p.Skv + FB_BK - 1) / FB_BK;
    if (p.causal) kt_end = min(kt_end, q_last / FB_BK + 1);
    const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / FB_BK : 0;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * FB_BK;
        __syncthreads();              // the last tile's readers are done
        fb_load<T, HD, FB_BK>(Ks, static_cast<const T*>(p.k), p.st[1], b, kvh, k0, p.Skv);
        fb_load<T, HD, FB_BK>(Vs, static_cast<const T*>(p.v), p.st[2], b, kvh, k0, p.Skv);
        __syncthreads();
        fb_scores<HD>(p, Qs, dOs, Ks, Vs, lse_s, dd_s, Ps, dSs, q0, k0);
        __syncthreads();
        // dQ += dS K: rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
        for (int kk = 0; kk < FB_BK; ++kk) {
            float ds[RQ];
#pragma unroll
            for (int i = 0; i < RQ; ++i) ds[i] = dSs[(ty + 16 * i) * PS + kk];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float kv = Ks[kk * QS + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < RQ; ++i) dq[i][c] = fmaf(ds[i], kv, dq[i][c]);
            }
        }
    }

    T* dqg = static_cast<T*>(p.dq) + b * p.st[5][0] + h * p.st[5][2];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= p.Sq) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c)
            st_f(dqg + (long long)row * p.st[5][1] + tx + 16 * c, dq[i][c] * p.scale);
    }
}

template <typename T, int HD>
static int launch_bwd(const FlashBwdParams& p, cudaStream_t stream) {
    using Sh = FbShape<HD>;
    static bool set_dkdv[FA_MAX_DEVICES] = {};
    static bool set_dq[FA_MAX_DEVICES] = {};
    int err = raise_smem_once(flash_bwd_dkdv_kernel<T, HD>, Sh::SMEM, set_dkdv);
    if (!err) err = raise_smem_once(flash_bwd_dq_kernel<T, HD>, Sh::SMEM, set_dq);
    if (err) return err;
    const long long rows = (long long)p.B * p.H * p.Sq;
    const long long dot_blocks = (rows + FB_THREADS / 32 - 1) / (FB_THREADS / 32);
    if (dot_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    flash_bwd_dot_kernel<T><<<(unsigned)dot_blocks, FB_THREADS, 0, stream>>>(p, HD);
    const dim3 kv_grid((p.Skv + FB_BK - 1) / FB_BK, p.B * p.KV);
    flash_bwd_dkdv_kernel<T, HD><<<kv_grid, FB_THREADS, Sh::SMEM, stream>>>(p);
    const dim3 q_grid((p.Sq + Sh::BQ - 1) / Sh::BQ, p.B * p.H);
    flash_bwd_dq_kernel<T, HD><<<q_grid, FB_THREADS, Sh::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd_hd(const FlashBwdParams& p, int hd, cudaStream_t s) {
    switch (hd) {
        case 16: return launch_bwd<T, 16>(p, s);
        case 32: return launch_bwd<T, 32>(p, s);
        case 64: return launch_bwd<T, 64>(p, s);
        case 96: return launch_bwd<T, 96>(p, s);
        case 128: return launch_bwd<T, 128>(p, s);
        case 192: return launch_bwd<T, 192>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// fp32 on the tensor cores: every product as three TF32 passes
// ---------------------------------------------------------------------------

#define TF_THREADS 256       // two halves of four warps
#define TF_TILE 64           // keys a key tile, query rows a query tile
#define TF_GROUP 4           // n-tiles of 8 columns a rounded partial sum

struct Tf32Params {
    const float* q;
    const float* k;
    const float* v;
    const float* dout;
    float* dq;
    float* dk;
    float* dv;
    const float* lse;        // (B, H, Sq)
    const float* dd;         // (B, H, Sq): rowsum(dO * O)
    long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
    int B, H, KV, group, Sq, Skv, causal, window;
    int n_kv_blocks;         // the grid's first blocks take the dK/dV role
    int vq, vk, vv, vdo;     // whether the tensor loads in 16-byte copies
    float scale;
};

template <int HD>
struct TfShape {
    // a 64-row fp32 tile's row stride: 4 mod 32 floats, so the fragment
    // loads of both layouts below hit 32 distinct banks
    static constexpr int RS = HD + 4;
    static constexpr int TILE = TF_TILE * RS;
    // each tile as its two TF32 terms, big then small (TILE apart): the
    // resident pair, each half's streamed pair; then the resident rows' lse
    // and D and each half's
    static constexpr size_t SMEM = sizeof(float) * (12 * (size_t)TILE + 6 * TF_TILE);
};

// the TF32 value nearest x (round to nearest, ties away), as mma reads it
__device__ __forceinline__ uint32_t tf32_rn(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = big + small + (x's last ~2^-22 of itself): two TF32 terms
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = tf32_rn(x);
    small = tf32_rn(x - __uint_as_float(big));
}

// d (16 x 8) += a (16 x 8, row) . b (8 x 8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at fp32's accuracy: the two cross terms first, then the big
// one (CUTLASS's 3xTF32); the small x small term is below fp32's rounding
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t b0b,
                                           uint32_t b1b, uint32_t b0s, uint32_t b1s) {
    mma_tf32(d, as, b0b, b1b);
    mma_tf32(d, ab, b0s, b1s);
    mma_tf32(d, ab, b0b, b1b);
}

// rows [r0, r0 + 64) of a (B, S, heads, HD) fp32 tensor at (b, head) into
// a 64 x RS tile, zeros past S, by nthr threads from tid; 16-byte copies
// where the layout allows (vec), else 4-byte ones
template <int HD>
__device__ __forceinline__ void tf_load(float* dst, const float* base,
                                        const long long* st, int b, int head,
                                        int r0, int S, int tid, int nthr,
                                        int vec) {
    constexpr int RS = TfShape<HD>::RS;
    const float* g = base + b * st[0] + head * st[2];
    if (vec) {
        constexpr int C4 = HD / 4;
        for (int e = tid; e < TF_TILE * C4; e += nthr) {
            const int r = e / C4, c = e % C4 * 4, s = r0 + r;
            cp_async16(dst + r * RS + c, g + (long long)min(s, S - 1) * st[1] + c,
                       s < S ? 16 : 0);
        }
    } else {
        for (int e = tid; e < TF_TILE * HD; e += nthr) {
            const int r = e / HD, c = e % HD, s = r0 + r;
            cp_async4(dst + r * RS + c, g + (long long)min(s, S - 1) * st[1] + c,
                      s < S ? 4 : 0);
        }
    }
}

// a loaded tile's fp32 values (at big) as their TF32 terms: big, and small
// TILE floats on; by nthr threads from tid.  Each element is split once a
// load, not at each of its uses
template <int HD>
__device__ __forceinline__ void tf_split(float* big, int tid, int nthr) {
    constexpr int RS = TfShape<HD>::RS;
    constexpr int TILE = TfShape<HD>::TILE;
    for (int e = tid; e < TF_TILE * HD; e += nthr) {
        float* x = big + e / HD * RS + e % HD;
        uint32_t b, sm;
        split_tf32(*x, b, sm);
        x[0] = __uint_as_float(b);
        x[TILE] = __uint_as_float(sm);
    }
}

// acc (16 x 64, fp32) = X[r0 .. r0 + 15] . Y^T over the head dim, X and Y
// 64-row tiles held as their TF32 terms; acc[j][e] is (row r0 + g + 8 (e /
// 2), Y row 8 j + 2 t + e % 2)
__device__ __forceinline__ uint32_t f2u(float x) { return __float_as_uint(x); }

template <int HD>
__device__ __forceinline__ void tf_scores(float (&acc)[8][4], const float* X,
                                          const float* Y, int r0, int g, int t) {
    constexpr int RS = TfShape<HD>::RS;
    constexpr int TILE = TfShape<HD>::TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < HD / 8; ++kk) {
        const float* xa = X + (r0 + g) * RS + 8 * kk + t;
        const uint32_t ab[4] = {f2u(xa[0]), f2u(xa[8 * RS]), f2u(xa[4]),
                                f2u(xa[8 * RS + 4])};
        const uint32_t as[4] = {f2u(xa[TILE]), f2u(xa[TILE + 8 * RS]),
                                f2u(xa[TILE + 4]), f2u(xa[TILE + 8 * RS + 4])};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float* yb = Y + (8 * j + g) * RS + 8 * kk + t;
            mma_3xtf32(acc[j], ab, as, f2u(yb[0]), f2u(yb[4]), f2u(yb[TILE]),
                       f2u(yb[TILE + 4]));
        }
    }
}

// acc (16 x HD) += M (16 x 64, held as tf_scores' accumulator) . Z, Z a
// 64-row tile held as its TF32 terms.  k-step j reduces over Z's rows 8 j .. 8 j + 7 in the order
// the accumulator holds them: the thread's columns 8 j + 2 t and + 1 are
// its A fragment's k = t and t + 4, and its B fragment reads Z's rows 8 j
// + 2 t and + 1 to match, so M needs no shuffle.  The tile's sum over its
// 64 rows is formed from 0 in GW n-tiles at a time and added to acc with
// one rounded fp32 add: the tensor cores' accumulation rounds with a bias,
// which over the thousands of k-steps of a long sum (dK over 7 heads x
// 1,024 queries) came to ~2e-4 of the running sum
template <int HD>
__device__ __forceinline__ void tf_accumulate(float (&acc)[HD / 8][4],
                                              const float (&m)[8][4],
                                              const float* Z, int g, int t) {
    constexpr int RS = TfShape<HD>::RS;
    constexpr int TILE = TfShape<HD>::TILE;
    constexpr int NC = HD / 8;
    constexpr int GW = NC < TF_GROUP ? NC : TF_GROUP;
#pragma unroll
    for (int n0 = 0; n0 < NC; n0 += GW) {
        float tmp[GW][4];
#pragma unroll
        for (int nn = 0; nn < GW; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) tmp[nn][e] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint32_t ab[4], as[4];
            split_tf32(m[j][0], ab[0], as[0]);
            split_tf32(m[j][2], ab[1], as[1]);
            split_tf32(m[j][1], ab[2], as[2]);
            split_tf32(m[j][3], ab[3], as[3]);
            const float* z = Z + (8 * j + 2 * t) * RS + g;
#pragma unroll
            for (int nn = 0; nn < GW; ++nn) {
                if (n0 + nn >= NC) continue;
                const float* zn = z + 8 * (n0 + nn);
                mma_3xtf32(tmp[nn], ab, as, f2u(zn[0]), f2u(zn[RS]), f2u(zn[TILE]),
                           f2u(zn[TILE + RS]));
            }
        }
#pragma unroll
        for (int nn = 0; nn < GW; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (n0 + nn < NC) acc[n0 + nn][e] += tmp[nn][e];
    }
}

__device__ __forceinline__ bool tf_keep(const Tf32Params& p, int qpos, int kpos) {
    bool keep = qpos < p.Sq && kpos < p.Skv;
    if (p.causal) keep = keep && kpos <= qpos;
    if (p.window > 0) keep = keep && kpos > qpos - p.window;
    return keep;
}

__device__ __forceinline__ bool tf_need_mask(const Tf32Params& p, int q0, int k0) {
    return q0 + TF_TILE > p.Sq || k0 + TF_TILE > p.Skv
        || (p.causal && k0 + TF_TILE - 1 > q0)
        || (p.window > 0 && k0 <= q0 + TF_TILE - 1 - p.window);
}

// the second half's accumulators to the first through shared memory (free
// once both halves have left their loops), added in a fixed order; returns
// false in the second half, which is then done
template <int NC>
__device__ __forceinline__ bool tf_fold_halves(float (&a)[NC][4], float (&c)[NC][4],
                                               float* xfer, int hf, int ht) {
    __syncthreads();
    if (hf == 1) {
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                xfer[((2 * n) * 4 + e) * 128 + ht] = a[n][e];
                xfer[((2 * n + 1) * 4 + e) * 128 + ht] = c[n][e];
            }
    }
    __syncthreads();
    if (hf == 1) return false;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            a[n][e] += xfer[((2 * n) * 4 + e) * 128 + ht];
            c[n][e] += xfer[((2 * n + 1) * 4 + e) * 128 + ht];
        }
    return true;
}

// rows row0 and row0 + 8 of a 16 x HD accumulator (times mul) to an fp32
// tensor with row stride rs, rows below n_rows
template <int NC>
__device__ __forceinline__ void tf_store(float* g, long long rs, const float (&acc)[NC][4],
                                         float mul, int row0, int n_rows, int t) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1);
            if (row < n_rows)
                g[(long long)row * rs + 8 * n + 2 * t + (e & 1)] = acc[n][e] * mul;
        }
}

// One grid, two roles, as the bf16 kernel: the first n_kv_blocks blocks own
// 64 keys of a (batch, KV head) each, key tile 0 first, the rest 64 query
// rows of a (batch, query head) each, the rows with the most key tiles
// first.  A block keeps its pair of 64-row tiles (K, V or Q, dO) in shared
// memory; its two halves of four warps take the other side's tiles in turn,
// each loading its own pair with cp.async, and add their sums at the end.
// A warp owns 16 rows of the block's tile.
template <int HD>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_bwd_tf32_kernel(const Tf32Params p) {
    using Sh = TfShape<HD>;
    constexpr int NC = HD / 8;
    extern __shared__ float4 tf_smem[];
    float* sm = reinterpret_cast<float*>(tf_smem);
    // tile i's big terms at sm + 2 i TILE, its small ones TILE on
    float* X = sm;                                   // resident: K or Q
    float* Y = X + 2 * Sh::TILE;                     // resident: V or dO
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int hf = warp / 4, ht = threadIdx.x % 128;
    const int r0 = 16 * (warp % 4), g = lane >> 2, t = lane & 3;
    float* A = sm + (4 + 4 * hf) * Sh::TILE;         // this half's: Q or K
    float* Bt = A + 2 * Sh::TILE;                    // and dO or V
    float* rrows = sm + 12 * Sh::TILE;               // resident rows' lse, D
    float* hrows = rrows + 2 * TF_TILE + 2 * TF_TILE * hf;   // this half's
    float* xfer = sm + 4 * Sh::TILE;
    float c1[NC][4], c2[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c1[n][e] = c2[n][e] = 0.f;

    if ((int)blockIdx.x < p.n_kv_blocks) {
        // dK (c1) and dV (c2) of 64 keys of one (batch, KV head)
        const int bkv = blockIdx.x % (p.B * p.KV);
        const int b = bkv / p.KV, kvh = bkv % p.KV;
        const int k0 = blockIdx.x / (p.B * p.KV) * TF_TILE;
        tf_load<HD>(X, p.k, p.sk, b, kvh, k0, p.Skv, threadIdx.x, TF_THREADS, p.vk);
        tf_load<HD>(Y, p.v, p.sv, b, kvh, k0, p.Skv, threadIdx.x, TF_THREADS, p.vv);
        // query tiles whose rows see a key of this tile, for each head of
        // the group: iteration it reads head kvh group + it / nq
        const int k_last = min(k0 + TF_TILE, p.Skv) - 1;
        const int qt_begin = p.causal ? k0 / TF_TILE : 0;
        int qt_end = (p.Sq + TF_TILE - 1) / TF_TILE;
        if (p.window > 0) qt_end = min(qt_end, (k_last + p.window - 1) / TF_TILE + 1);
        const int nq = max(qt_end - qt_begin, 0);
        const int n_it = p.group * nq;
        cp_async_wait_all();
        __syncthreads();
        tf_split<HD>(X, threadIdx.x, TF_THREADS);
        tf_split<HD>(Y, threadIdx.x, TF_THREADS);
        __syncthreads();
        for (int it = hf; it < n_it; it += 2) {
            const int h = kvh * p.group + it / nq;
            const int q0 = (qt_begin + it % nq) * TF_TILE;
            const long long bh = (long long)b * p.H + h;
            tf_load<HD>(A, p.q, p.sq, b, h, q0, p.Sq, ht, 128, p.vq);
            tf_load<HD>(Bt, p.dout, p.sdo, b, h, q0, p.Sq, ht, 128, p.vdo);
            if (ht < TF_TILE) {
                const bool in = q0 + ht < p.Sq;
                hrows[ht] = in ? p.lse[bh * p.Sq + q0 + ht] : 0.f;
                hrows[TF_TILE + ht] = in ? p.dd[bh * p.Sq + q0 + ht] : 0.f;
            }
            cp_async_wait_all();
            asm volatile("bar.sync %0, 128;\n" :: "r"(1 + hf) : "memory");
            tf_split<HD>(A, ht, 128);
            tf_split<HD>(Bt, ht, 128);
            asm volatile("bar.sync %0, 128;\n" :: "r"(1 + hf) : "memory");
            // S^T = K Q^T and dP^T = V dO^T: keys x queries
            float s[8][4], dp[8][4];
            tf_scores<HD>(s, X, A, r0, g, t);
            tf_scores<HD>(dp, Y, Bt, r0, g, t);
            const bool need_mask = tf_need_mask(p, q0, k0);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qc = 8 * j + 2 * t + (e & 1);
                    float pr = expf(s[j][e] * p.scale - hrows[qc]);
                    if (need_mask && !tf_keep(p, q0 + qc, k0 + r0 + g + 8 * (e >> 1)))
                        pr = 0.f;
                    s[j][e] = pr;
                    dp[j][e] = pr * (dp[j][e] - hrows[TF_TILE + qc]);
                }
            // dV += P^T dO, dK += dS^T Q
            tf_accumulate<HD>(c2, s, Bt, g, t);
            tf_accumulate<HD>(c1, dp, A, g, t);
            asm volatile("bar.sync %0, 128;\n" :: "r"(1 + hf) : "memory");
        }
        if (!tf_fold_halves<NC>(c1, c2, xfer, hf, ht)) return;
        const int row0 = k0 + r0 + g;
        tf_store<NC>(p.dk + b * p.sdk[0] + kvh * p.sdk[2], p.sdk[1], c1, p.scale,
                     row0, p.Skv, t);
        tf_store<NC>(p.dv + b * p.sdv[0] + kvh * p.sdv[2], p.sdv[1], c2, 1.f,
                     row0, p.Skv, t);
        return;
    }

    // dQ (c1) of 64 query rows of one (batch, query head)
    const int idx = blockIdx.x - p.n_kv_blocks;
    const int BH = p.B * p.H;
    const int nqt = (p.Sq + TF_TILE - 1) / TF_TILE;
    const int bh = idx % BH, b = bh / p.H, h = bh % p.H, kvh = h / p.group;
    const int q0 = (nqt - 1 - idx / BH) * TF_TILE;          // heavy tiles first
    tf_load<HD>(X, p.q, p.sq, b, h, q0, p.Sq, threadIdx.x, TF_THREADS, p.vq);
    tf_load<HD>(Y, p.dout, p.sdo, b, h, q0, p.Sq, threadIdx.x, TF_THREADS, p.vdo);
    if (threadIdx.x < TF_TILE) {
        const bool in = q0 + threadIdx.x < p.Sq;
        rrows[threadIdx.x] = in ? p.lse[(long long)bh * p.Sq + q0 + threadIdx.x] : 0.f;
        rrows[TF_TILE + threadIdx.x] =
            in ? p.dd[(long long)bh * p.Sq + q0 + threadIdx.x] : 0.f;
    }
    // key tiles that hold a key some row of this tile sees
    const int q_last = min(q0 + TF_TILE, p.Sq) - 1;
    int kt_end = (p.Skv + TF_TILE - 1) / TF_TILE;
    if (p.causal) kt_end = min(kt_end, q_last / TF_TILE + 1);
    const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / TF_TILE : 0;
    const int n_tiles = max(kt_end - kt_begin, 0);
    cp_async_wait_all();
    __syncthreads();
    tf_split<HD>(X, threadIdx.x, TF_THREADS);
    tf_split<HD>(Y, threadIdx.x, TF_THREADS);
    __syncthreads();
    const int qr = r0 + g;                           // this thread's rows qr, qr + 8
    const float l0 = rrows[qr], l1 = rrows[qr + 8];
    const float d0 = rrows[TF_TILE + qr], d1 = rrows[TF_TILE + qr + 8];
    for (int i = hf; i < n_tiles; i += 2) {
        const int k0 = (kt_begin + i) * TF_TILE;
        tf_load<HD>(A, p.k, p.sk, b, kvh, k0, p.Skv, ht, 128, p.vk);
        tf_load<HD>(Bt, p.v, p.sv, b, kvh, k0, p.Skv, ht, 128, p.vv);
        cp_async_wait_all();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + hf) : "memory");
        tf_split<HD>(A, ht, 128);
        tf_split<HD>(Bt, ht, 128);
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + hf) : "memory");
        // S = Q K^T and dP = dO V^T: queries x keys
        float s[8][4], dp[8][4];
        tf_scores<HD>(s, X, A, r0, g, t);
        tf_scores<HD>(dp, Y, Bt, r0, g, t);
        const bool need_mask = tf_need_mask(p, q0, k0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool lo = e < 2;
                float pr = expf(s[j][e] * p.scale - (lo ? l0 : l1));
                if (need_mask && !tf_keep(p, q0 + qr + (lo ? 0 : 8),
                                          k0 + 8 * j + 2 * t + (e & 1)))
                    pr = 0.f;
                s[j][e] = pr * (dp[j][e] - (lo ? d0 : d1));
            }
        // dQ += dS K
        tf_accumulate<HD>(c1, s, A, g, t);
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + hf) : "memory");
    }
    if (!tf_fold_halves<NC>(c1, c2, xfer, hf, ht)) return;
    tf_store<NC>(p.dq + b * p.sdq[0] + h * p.sdq[2], p.sdq[1], c1, p.scale,
                 q0 + qr, p.Sq, t);
}

template <int HD>
static int launch_bwd_tf32(const Tf32Params& p, cudaStream_t stream) {
    constexpr size_t smem = TfShape<HD>::SMEM;
    static bool smem_set[FA_MAX_DEVICES] = {};
    const int err = raise_smem_once(flash_bwd_tf32_kernel<HD>, smem, smem_set);
    if (err) return err;
    const long long blocks = (long long)p.n_kv_blocks
        + (long long)p.B * p.H * ((p.Sq + TF_TILE - 1) / TF_TILE);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    flash_bwd_tf32_kernel<HD><<<(unsigned)blocks, TF_THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

#define BT_TILE 64           // keys a key tile; query rows a stage or a warpgroup
#define BT_THREADS 384       // 2 consumer warpgroups + 1 producer warpgroup
#define BT_PRODUCER_REGS 24  // registers a producer thread keeps (setmaxnreg)
#define BT_CONSUMER_REGS 240 // and a consumer thread takes
#define BT_STAGES 4          // ring stages

struct BwdTcParams {
    __nv_bfloat16* dq;
    __nv_bfloat16* dk;
    __nv_bfloat16* dv;
    const float* lp;         // (B H, Sq_pad): lse * log2(e), 0 past Sq
    const float* dp;         // (B H, Sq_pad): rowsum(dO * O), 0 past Sq
    long long sdq[3], sdk[3], sdv[3];
    int B, H, KV, group, Sq, Skv, Sq_pad, hd, causal, window;
    int n_kv_blocks;         // the grid's first blocks take the dK/dV role
    float scale_log2;        // log2(e) / sqrt(hd)
    float scale;             // 1 / sqrt(hd)
};

template <int NP>            // 64-column panels of the head dim
struct BtShape {
    static constexpr size_t TILE = NP * TC_PANEL;        // 64 rows at hd
    // dK/dV role: K and V resident, then the ring (stage s: Q, dO), then the
    // stages' lse and D rows
    static constexpr size_t KV_RING = 2 * TILE;
    static constexpr size_t KV_ROWS = KV_RING + BT_STAGES * 2 * TILE;
    static constexpr size_t KV_END = KV_ROWS + BT_STAGES * 2 * BT_TILE * 4;
    // dQ role: Q and dO of both warpgroups resident, then the ring (K, V)
    static constexpr size_t Q_RING = 4 * TILE;
    static constexpr size_t Q_END = Q_RING + BT_STAGES * 2 * TILE;
    static constexpr size_t BARS = KV_END > Q_END ? KV_END : Q_END;
    // 1 KB of slack to align the tiles to the 1 KB swizzle period
    static constexpr size_t SMEM = 1024 + BARS + 8 * (2 * BT_STAGES + 1);
};

__device__ __forceinline__ bool bt_keep(const BwdTcParams& p, int qpos,
                                        int kpos) {
    bool keep = qpos < p.Sq && kpos < p.Skv;
    if (p.causal) keep = keep && kpos <= qpos;
    if (p.window > 0) keep = keep && kpos > qpos - p.window;
    return keep;
}

// whether the 64 x 64 tile of queries q0.. and keys k0.. holds a masked pair
__device__ __forceinline__ bool bt_need_mask(const BwdTcParams& p, int q0,
                                             int k0) {
    return q0 + BT_TILE > p.Sq || k0 + BT_TILE > p.Skv
        || (p.causal && k0 + BT_TILE - 1 > q0)
        || (p.window > 0 && k0 <= q0 + BT_TILE - 1 - p.window);
}

// acc (fp32, 64 x 64) = A B^T over the head dim: both 64-row tiles of NP
// K-major panels
template <int NP>
__device__ __forceinline__ void bt_scores(float (&acc)[32], const uint8_t* a,
                                          const uint8_t* b) {
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_m64n64(acc,
                            sw128_desc(a + pn * TC_PANEL + 32 * kk, 16, 1024),
                            sw128_desc(b + pn * TC_PANEL + 32 * kk, 16, 1024),
                            (pn | kk) != 0);
}

// acc (fp32, 64 x hd) += A (64 x 64, four k-steps of bf16 fragments) B, B a
// 64-row tile read MN-major
template <int NP>
__device__ __forceinline__ void bt_accumulate(float (&acc)[32 * NP],
                                              const uint32_t (&a)[4][4],
                                              const uint8_t* b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<NP>(acc, a[kk], sw128_desc(b + 2048 * kk, TC_PANEL, 1024));
}

// the rows [row0, row0 + 8] of a 64 x hd fp32 accumulator (times mul) to a
// bf16 tensor with row stride rs, rows below n_rows, columns below hd
template <int NP>
__device__ __forceinline__ void bt_store(__nv_bfloat16* g, long long rs,
                                         const float (&acc)[32 * NP], float mul,
                                         int row0, int n_rows, int hd, int cq) {
#pragma unroll
    for (int j = 0; j < 8 * NP; ++j) {
        const int col = 8 * j + cq;
        if (col >= hd) continue;
        if (row0 < n_rows)
            *reinterpret_cast<__nv_bfloat162*>(g + (long long)row0 * rs + col) =
                __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
        if (row0 + 8 < n_rows)
            *reinterpret_cast<__nv_bfloat162*>(g + (long long)(row0 + 8) * rs + col) =
                __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
}

// the dK/dV role: 64 keys of one (batch, KV head)
template <int NP>
__device__ __forceinline__ void bt_dkdv(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const CUtensorMap& tdo,
                                        const BwdTcParams& p, uint8_t* base,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* kvbar) {
    using Sh = BtShape<NP>;
    constexpr int ST = BT_STAGES;
    uint8_t* Ks = base;
    uint8_t* Vs = base + Sh::TILE;
    uint8_t* ring = base + Sh::KV_RING;          // stage s: Q, then dO
    float* rows = reinterpret_cast<float*>(base + Sh::KV_ROWS);   // s: lse, D

    const int bkv = blockIdx.x % (p.B * p.KV);
    const int b = bkv / p.KV;
    const int kvh = bkv % p.KV;
    const int k0 = blockIdx.x / (p.B * p.KV) * BT_TILE;   // key tile 0 first
    // query tiles whose rows see a key of this tile, for each head of the
    // group: iteration it reads head kvh group + it / nq, tile qt_begin + it % nq
    const int k_last = min(k0 + BT_TILE, p.Skv) - 1;
    const int qt_begin = p.causal ? k0 / BT_TILE : 0;
    int qt_end = (p.Sq + BT_TILE - 1) / BT_TILE;
    if (p.window > 0) qt_end = min(qt_end, (k_last + p.window - 1) / BT_TILE + 1);
    const int nq = max(qt_end - qt_begin, 0);
    const int n_it = p.group * nq;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp >= 8) {                              // the producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(BT_PRODUCER_REGS));
        if (warp == 8 && lane == 0) {
            mbar_expect_tx(kvbar, (uint32_t)(2 * Sh::TILE));
            for (int pn = 0; pn < NP; ++pn) {
                tma_load(Ks + pn * TC_PANEL, &tk, kvbar, 64 * pn, k0, kvh, b);
                tma_load(Vs + pn * TC_PANEL, &tv, kvbar, 64 * pn, k0, kvh, b);
            }
            for (int it = 0; it < n_it; ++it) {
                const int s = it % ST;
                const int h = kvh * p.group + it / nq;
                const int q0 = (qt_begin + it % nq) * BT_TILE;
                mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
                mbar_expect_tx(&full[s], (uint32_t)(2 * Sh::TILE + 2 * BT_TILE * 4));
                uint8_t* st = ring + 2 * s * Sh::TILE;
                for (int pn = 0; pn < NP; ++pn) {
                    tma_load(st + pn * TC_PANEL, &tq, &full[s], 64 * pn, q0, h, b);
                    tma_load(st + Sh::TILE + pn * TC_PANEL, &tdo, &full[s],
                             64 * pn, q0, h, b);
                }
                const long long off = (long long)(b * p.H + h) * p.Sq_pad + q0;
                bulk_load(rows + 2 * BT_TILE * s, p.lp + off, BT_TILE * 4, &full[s]);
                bulk_load(rows + 2 * BT_TILE * s + BT_TILE, p.dp + off,
                          BT_TILE * 4, &full[s]);
            }
        }
        return;
    }

    // At one panel the consumer warpgroups take the iterations in turn
    // (wg, wg + 2, ...) and add their sums at the end; at two, both take
    // every iteration, each for its own 64 columns of dK and dV (so a
    // thread's accumulators stay 64 x 64: two panels of both would not fit
    // its registers beside S^T and dP^T).  This thread holds key rows kr0
    // and kr0 + 8 of the tile, query columns 8 j + cq + {0, 1}.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(BT_CONSUMER_REGS));
    constexpr bool SPLIT = NP > 1;
    const int wg = warp / 4;
    const int kr0 = 16 * (warp % 4) + lane / 4;
    const int cq = 2 * (lane % 4);
    const int col0 = SPLIT ? 64 * wg : 0;      // this warpgroup's dK, dV columns
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int it = SPLIT ? 0 : wg; it < n_it; it += SPLIT ? 1 : 2) {
        const int s = it % ST;
        const int q0 = (qt_begin + it % nq) * BT_TILE;
        const uint8_t* Qst = ring + 2 * s * Sh::TILE;
        const uint8_t* dOst = Qst + Sh::TILE;
        const float* lr = rows + 2 * BT_TILE * s;
        const float* dr = lr + BT_TILE;
        mbar_wait(&full[s], (it / ST) & 1);

        // S^T = K Q^T and dP^T = V dO^T: keys x queries, one group each,
        // so P^T is computed while dP^T is still in flight
        float sacc[32], pacc[32];
        wgmma_fence();
        bt_scores<NP>(sacc, Ks, Qst);
        wgmma_commit();
        bt_scores<NP>(pacc, Vs, dOst);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sacc);

        // P^T (fp32, in place) and its bf16 A fragments of 4 k-steps of 16
        // queries: sacc[4 j + e] is (key kr0 + 8 (e / 2), query q0 + 8 j +
        // cq + e % 2)
        const bool need_mask = bt_need_mask(p, q0, k0);
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + cq;
            const float2 l2 = *reinterpret_cast<const float2*>(lr + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float pr = ex2_approx(sacc[4 * j + e] * p.scale_log2
                                 - ((e & 1) ? l2.y : l2.x));
                if (need_mask && !bt_keep(p, q0 + col + (e & 1),
                                          k0 + kr0 + 8 * (e >> 1)))
                    pr = 0.f;
                sacc[4 * j + e] = pr;
            }
            pa[j / 2][2 * (j % 2) + 0] = pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
            pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
        }
        wgmma_wait<0>();
        fence_regs(pacc);

        // dV += P^T dO (16 queries a step) runs while dS^T = P^T (dP^T - D)
        // is formed; then dK += dS^T Q
        wgmma_fence();
        bt_accumulate<1>(dv, pa, dOst + col0 / 64 * TC_PANEL);
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float2 d2 = *reinterpret_cast<const float2*>(dr + 8 * j + cq);
            float de[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                de[e] = sacc[4 * j + e] * (pacc[4 * j + e] - ((e & 1) ? d2.y : d2.x));
            da[j / 2][2 * (j % 2) + 0] = pack_bf16(de[0], de[1]);
            da[j / 2][2 * (j % 2) + 1] = pack_bf16(de[2], de[3]);
        }
        wgmma_fence();
        bt_accumulate<1>(dk, da, Qst + col0 / 64 * TC_PANEL);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        if (lane == 0) mbar_arrive(&empty[s]);
    }

    // warpgroup 1 hands its sums to warpgroup 0 through the ring, whose
    // loads have all been consumed once both warpgroups have left the loop;
    // warpgroup 0 adds them, a fixed order, and stores
    if constexpr (!SPLIT) {
        float* xfer = reinterpret_cast<float*>(ring);
        const int t = threadIdx.x % 128;
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (wg == 1) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                xfer[i * 128 + t] = dk[i];
                xfer[(32 + i) * 128 + t] = dv[i];
            }
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (wg == 1) return;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            dk[i] += xfer[i * 128 + t];
            dv[i] += xfer[(32 + i) * 128 + t];
        }
    }
    bt_store<1>(p.dk + b * p.sdk[0] + kvh * p.sdk[2] + col0, p.sdk[1], dk,
                p.scale, k0 + kr0, p.Skv, p.hd - col0, cq);
    bt_store<1>(p.dv + b * p.sdv[0] + kvh * p.sdv[2] + col0, p.sdv[1], dv, 1.f,
                k0 + kr0, p.Skv, p.hd - col0, cq);
}

// the dQ role: 128 query rows of one (batch, query head)
template <int NP>
__device__ __forceinline__ void bt_dq(const CUtensorMap& tq,
                                      const CUtensorMap& tk,
                                      const CUtensorMap& tv,
                                      const CUtensorMap& tdo,
                                      const BwdTcParams& p, uint8_t* base,
                                      uint64_t* full, uint64_t* empty,
                                      uint64_t* qbar) {
    using Sh = BtShape<NP>;
    constexpr int ST = BT_STAGES;
    uint8_t* Qs = base;                          // [warpgroup][panel]
    uint8_t* dOs = base + 2 * Sh::TILE;          // [warpgroup][panel]
    uint8_t* ring = base + Sh::Q_RING;           // stage s: K, then V

    const int idx = blockIdx.x - p.n_kv_blocks;
    const int BH = p.B * p.H;
    const int nqt = (p.Sq + 2 * BT_TILE - 1) / (2 * BT_TILE);
    const int bh = idx % BH;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int q0 = (nqt - 1 - idx / BH) * 2 * BT_TILE;   // heavy tiles first
    // key tiles that hold a key some row of this tile sees
    const int q_last = min(q0 + 2 * BT_TILE, p.Sq) - 1;
    int kt_end = (p.Skv + BT_TILE - 1) / BT_TILE;
    if (p.causal) kt_end = min(kt_end, q_last / BT_TILE + 1);
    const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BT_TILE : 0;
    const int n_tiles = max(kt_end - kt_begin, 0);

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp >= 8) {                              // the producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(BT_PRODUCER_REGS));
        if (warp == 8 && lane == 0) {
            const int kvh = h / p.group;
            mbar_expect_tx(qbar, (uint32_t)(4 * Sh::TILE));
            for (int g = 0; g < 2; ++g)
                for (int pn = 0; pn < NP; ++pn) {
                    tma_load(Qs + (g * NP + pn) * TC_PANEL, &tq, qbar, 64 * pn,
                             q0 + BT_TILE * g, h, b);
                    tma_load(dOs + (g * NP + pn) * TC_PANEL, &tdo, qbar,
                             64 * pn, q0 + BT_TILE * g, h, b);
                }
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % ST;
                const int k0 = (kt_begin + i) * BT_TILE;
                mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
                mbar_expect_tx(&full[s], (uint32_t)(2 * Sh::TILE));
                uint8_t* st = ring + 2 * s * Sh::TILE;
                for (int pn = 0; pn < NP; ++pn) {
                    tma_load(st + pn * TC_PANEL, &tk, &full[s], 64 * pn, k0, kvh, b);
                    tma_load(st + Sh::TILE + pn * TC_PANEL, &tv, &full[s],
                             64 * pn, k0, kvh, b);
                }
            }
        }
        return;
    }

    // a consumer warpgroup: rows r_min .. r_min + 63; this thread holds rows
    // row0 and row0 + 8 of the accumulators
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(BT_CONSUMER_REGS));
    const int wg = warp / 4;
    const int r_min = q0 + BT_TILE * wg;
    const int r_max = min(r_min + BT_TILE - 1, p.Sq - 1);   // < r_min: no row
    const int row0 = r_min + 16 * (warp % 4) + lane / 4;
    const int row1 = row0 + 8;
    const int cq = 2 * (lane % 4);
    const float* lrow = p.lp + (long long)bh * p.Sq_pad;
    const float* drow = p.dp + (long long)bh * p.Sq_pad;
    const float l0 = row0 < p.Sq ? lrow[row0] : 0.f;
    const float l1 = row1 < p.Sq ? lrow[row1] : 0.f;
    const float d0 = row0 < p.Sq ? drow[row0] : 0.f;
    const float d1 = row1 < p.Sq ? drow[row1] : 0.f;
    const uint8_t* Qw = Qs + wg * NP * TC_PANEL;
    const uint8_t* dOw = dOs + wg * NP * TC_PANEL;

    float dq[32 * NP];
#pragma unroll
    for (int i = 0; i < 32 * NP; ++i) dq[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        const int k0 = (kt_begin + i) * BT_TILE;
        const uint8_t* Kst = ring + 2 * s * Sh::TILE;
        const uint8_t* Vst = Kst + Sh::TILE;
        mbar_wait(&full[s], (i / ST) & 1);
        bool active = r_max >= r_min;
        if (p.causal) active = active && k0 <= r_max;
        if (p.window > 0) active = active && k0 + BT_TILE - 1 > r_min - p.window;
        if (active) {
            // S = Q K^T and dP = dO V^T: queries x keys
            float sacc[32], pacc[32];
            wgmma_fence();
            bt_scores<NP>(sacc, Qw, Kst);
            wgmma_commit();
            bt_scores<NP>(pacc, dOw, Vst);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(sacc);

            // P in place while dP is in flight: sacc[4 j + e] is (row0 + 8
            // (e / 2), key k0 + 8 j + cq + e % 2)
            const bool need_mask = bt_need_mask(p, r_min, k0);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool lo = e < 2;
                    float pr = ex2_approx(sacc[4 * j + e] * p.scale_log2
                                     - (lo ? l0 : l1));
                    if (need_mask && !bt_keep(p, lo ? row0 : row1,
                                              k0 + 8 * j + cq + (e & 1)))
                        pr = 0.f;
                    sacc[4 * j + e] = pr;
                }
            wgmma_wait<0>();
            fence_regs(pacc);

            // dS as bf16 A fragments of 4 k-steps of 16 keys
            uint32_t da[4][4];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float de[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    de[e] = sacc[4 * j + e] * (pacc[4 * j + e] - (e < 2 ? d0 : d1));
                da[j / 2][2 * (j % 2) + 0] = pack_bf16(de[0], de[1]);
                da[j / 2][2 * (j % 2) + 1] = pack_bf16(de[2], de[3]);
            }

            // dQ += dS K, 16 keys a step, K read MN-major
            wgmma_fence();
            bt_accumulate<NP>(dq, da, Kst);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dq);
        }
        if (lane == 0) mbar_arrive(&empty[s]);
    }

    bt_store<NP>(p.dq + b * p.sdq[0] + h * p.sdq[2], p.sdq[1], dq, p.scale,
                 row0, p.Sq, p.hd, cq);
}

// both roles in one grid: the dK/dV blocks first, then the dQ blocks
template <int NP>
__global__ void __launch_bounds__(BT_THREADS, 1)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const BwdTcParams p) {
    using Sh = BtShape<NP>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(base + Sh::BARS);
    uint64_t* empty = full + BT_STAGES;
    uint64_t* once = empty + BT_STAGES;           // the resident tiles
    const bool kv_role = (int)blockIdx.x < p.n_kv_blocks;
    if (threadIdx.x == 0) {
        for (int s = 0; s < BT_STAGES; ++s) {
            mbar_init(&full[s], 1);
            // lane 0 of each warp of the warpgroup that takes the stage
            // (dK/dV at one panel), or of both warpgroups
            mbar_init(&empty[s], kv_role && NP == 1 ? 4 : 8);
        }
        mbar_init(once, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (kv_role) bt_dkdv<NP>(tq, tk, tv, tdo, p, base, full, empty, once);
    else bt_dq<NP>(tq, tk, tv, tdo, p, base, full, empty, once);
}

template <int NP>
static int launch_bwd_tc(const CUtensorMap& tq, const CUtensorMap& tk,
                         const CUtensorMap& tv, const CUtensorMap& tdo,
                         const BwdTcParams& p, cudaStream_t stream) {
    constexpr size_t smem = BtShape<NP>::SMEM;
    static bool smem_set[FA_MAX_DEVICES] = {};
    const int err = raise_smem_once(flash_bwd_tc_kernel<NP>, smem, smem_set);
    if (err) return err;
    const long long blocks = (long long)p.n_kv_blocks
        + (long long)p.B * p.H * ((p.Sq + 2 * BT_TILE - 1) / (2 * BT_TILE));
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    flash_bwd_tc_kernel<NP><<<(unsigned)blocks, BT_THREADS, smem, stream>>>(
        tq, tk, tv, tdo, p);
    return (int)cudaGetLastError();
}

extern "C" {

// The backward of either forward: q, o, dout, dq (B, Sq, H, hd); k, v, dk,
// dv (B, Skv, KV, hd); lse the forward's (B, H, Sq) fp32.  strides: 24
// element strides, (batch, seq, head) for q, k, v, o, dout, dq, dk, dv in
// that order, each with a unit stride along hd.  Returns 0 or a
// cudaError_t.

// On the CUDA cores: ws (B, H, Sq) fp32 scratch; dtype 0 = fp32, 1 = bf16,
// all eight tensors alike.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, void* dq, void* dk, void* dv,
                               float* ws, const long long* strides, int B,
                               int H, int KV, int Sq, int Skv, int hd,
                               int causal, int window, float scale, int dtype,
                               void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0
            || (long long)B * H > 65535)
        return (int)cudaErrorInvalidValue;
    FlashBwdParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.dout = dout;
    p.dq = dq;
    p.dk = dk;
    p.dv = dv;
    p.lse = lse;
    p.dd = ws;
    for (int t = 0; t < 8; ++t)
        for (int a = 0; a < 3; ++a) p.st[t][a] = strides[3 * t + a];
    p.B = B;
    p.H = H;
    p.KV = KV;
    p.group = H / KV;
    p.Sq = Sq;
    p.Skv = Skv;
    p.causal = causal;
    p.window = window;
    p.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_bwd_hd<float>(p, hd, s);
    if (dtype == 1) return launch_bwd_hd<__nv_bfloat16>(p, hd, s);
    return (int)cudaErrorInvalidValue;
}

// fp32 on the tensor cores (three TF32 passes a product), hd <= 64: ws
// holds B H Sq fp32 (D).
int flash_attention_bwd_tf32_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const float* lse,
                                    void* dq, void* dk, void* dv, float* ws,
                                    const long long* strides, int B, int H,
                                    int KV, int Sq, int Skv, int hd,
                                    int causal, int window, float scale,
                                    void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0)
        return (int)cudaErrorInvalidValue;
    const long long n_kv = (long long)B * KV * ((Skv + TF_TILE - 1) / TF_TILE);
    const long long rows = (long long)B * H * Sq;
    const long long dot_blocks = (rows + FB_THREADS / 32 - 1) / (FB_THREADS / 32);
    if (n_kv > 2147483647LL || dot_blocks > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    FlashBwdParams fp;
    fp.o = o;
    fp.dout = dout;
    fp.dd = ws;
    for (int t = 0; t < 8; ++t)
        for (int a = 0; a < 3; ++a) fp.st[t][a] = strides[3 * t + a];
    fp.B = B;
    fp.H = H;
    fp.Sq = Sq;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    flash_bwd_dot_kernel<float><<<(unsigned)dot_blocks, FB_THREADS, 0, s>>>(fp, hd);

    Tf32Params p;
    p.q = static_cast<const float*>(q);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.dout = static_cast<const float*>(dout);
    p.dq = static_cast<float*>(dq);
    p.dk = static_cast<float*>(dk);
    p.dv = static_cast<float*>(dv);
    p.lse = lse;
    p.dd = ws;
    // a tensor loads in 16-byte copies when its address and the strides of
    // its dimensions longer than 1 are multiples of 4 floats
    const void* ptrs[4] = {q, k, v, dout};
    const int which[4] = {0, 1, 2, 4};
    const int sizes[3][2] = {{B, B}, {Sq, Skv}, {H, KV}};
    int vec[4];
    for (int i = 0; i < 4; ++i) {
        const long long* st = strides + 3 * which[i];
        const bool kv = i == 1 || i == 2;
        bool ok = ((uintptr_t)ptrs[i] & 15) == 0;
        for (int a = 0; a < 3; ++a)
            if (sizes[a][kv] > 1 && (st[a] & 3)) ok = false;
        vec[i] = ok;
    }
    p.vq = vec[0];
    p.vk = vec[1];
    p.vv = vec[2];
    p.vdo = vec[3];
    for (int a = 0; a < 3; ++a) {
        p.sq[a] = strides[a];
        p.sk[a] = strides[3 + a];
        p.sv[a] = strides[6 + a];
        p.sdo[a] = strides[12 + a];
        p.sdq[a] = strides[15 + a];
        p.sdk[a] = strides[18 + a];
        p.sdv[a] = strides[21 + a];
    }
    p.B = B;
    p.H = H;
    p.KV = KV;
    p.group = H / KV;
    p.Sq = Sq;
    p.Skv = Skv;
    p.causal = causal;
    p.window = window;
    p.n_kv_blocks = (int)n_kv;
    p.scale = scale;
    switch (hd) {
        case 16: return launch_bwd_tf32<16>(p, s);
        case 32: return launch_bwd_tf32<32>(p, s);
        case 64: return launch_bwd_tf32<64>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// bf16 on the tensor cores, hd <= 128: ws holds 2 B H Sq_pad fp32 (Sq_pad
// = Sq rounded up to 64); q, k, v and dout need 16-byte aligned addresses
// and (batch, seq, head) strides that are multiples of 8 elements (TMA).
int flash_attention_bwd_bf16_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const float* lse,
                                    void* dq, void* dk, void* dv, float* ws,
                                    const long long* strides, int B, int H,
                                    int KV, int Sq, int Skv, int hd,
                                    int causal, int window, float scale,
                                    void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0
            || hd <= 0 || hd > 128 || hd % 8 != 0)
        return (int)cudaErrorInvalidValue;
    const int Sq_pad = (Sq + BT_TILE - 1) / BT_TILE * BT_TILE;
    const long long n_kv = (long long)B * KV * ((Skv + BT_TILE - 1) / BT_TILE);
    const long long rows = (long long)B * H * Sq_pad;
    const long long prep_blocks = (rows + FB_THREADS / 8 - 1) / (FB_THREADS / 8);
    if (n_kv > 2147483647LL || prep_blocks > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv, tdo;
    int err = make_map(&tq, q, B, Sq, H, hd, strides);
    if (!err) err = make_map(&tk, k, B, Skv, KV, hd, strides + 3);
    if (!err) err = make_map(&tv, v, B, Skv, KV, hd, strides + 6);
    if (!err) err = make_map(&tdo, dout, B, Sq, H, hd, strides + 12);
    if (err) return err;

    // the prep kernel reads o and dout in 16-byte packs (dout's layout is
    // TMA's, checked above)
    if (((uintptr_t)o & 15) || ((strides[9] | strides[10] | strides[11]) & 7))
        return (int)cudaErrorMisalignedAddress;
    FlashBwdParams fp;
    fp.o = o;
    fp.dout = dout;
    fp.lse = lse;
    fp.dd = ws + rows;
    for (int t = 0; t < 8; ++t)
        for (int a = 0; a < 3; ++a) fp.st[t][a] = strides[3 * t + a];
    fp.B = B;
    fp.H = H;
    fp.Sq = Sq;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    flash_bwd_prep_kernel<<<(unsigned)prep_blocks, FB_THREADS, 0, s>>>(
        fp, hd, Sq_pad, ws);

    BwdTcParams p;
    p.dq = static_cast<__nv_bfloat16*>(dq);
    p.dk = static_cast<__nv_bfloat16*>(dk);
    p.dv = static_cast<__nv_bfloat16*>(dv);
    p.lp = ws;
    p.dp = ws + rows;
    for (int a = 0; a < 3; ++a) {
        p.sdq[a] = strides[15 + a];
        p.sdk[a] = strides[18 + a];
        p.sdv[a] = strides[21 + a];
    }
    p.B = B;
    p.H = H;
    p.KV = KV;
    p.group = H / KV;
    p.Sq = Sq;
    p.Skv = Skv;
    p.Sq_pad = Sq_pad;
    p.hd = hd;
    p.causal = causal;
    p.window = window;
    p.n_kv_blocks = (int)n_kv;
    p.scale_log2 = scale * 1.4426950408889634f;
    p.scale = scale;
    if (hd <= 64) return launch_bwd_tc<1>(tq, tk, tv, tdo, p, s);
    return launch_bwd_tc<2>(tq, tk, tv, tdo, p, s);
}

}  // extern "C"
