// Flash attention forward for Hopper: online softmax over KV tiles, with a
// causal mask and an optional sliding window (kpos > qpos - window), and the
// KV heads read in place (query head h reads KV head h / (H / KV), the order
// of jnp.repeat, so grouped-query attention needs no repeated copy of K, V).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_flash_kernel
// (launched by flash_attention_bhsd, reached through repro/kernels/ops.py
// flash_attention from the attention layer when attention_impl="pallas").
// It computes what that kernel computes: scores scaled by 1/sqrt(hd) in fp32,
// masked scores -1e30 (not -inf, so a row whose tile is wholly masked stays
// finite), the running max m, normaliser l and accumulator fp32, l clamped at
// 1e-30, the output in q's dtype.
//
// Two instantiations, picked by the input dtype (a dispatch on the input, not
// a fallback: each raises on what it does not take):
//
// * bf16: flash_tc_kernel, the products on the tensor cores (wgmma).
// * fp32: flash_fp32_kernel, the products in fp32 on the CUDA cores.  One
//   TF32 pass would keep ~3 decimal digits and break the fp32 tolerances
//   (2e-5 against the plain version, 1e-4 on model logits); three passes a
//   product, as the fp32 backward runs them (flash_attention_bwd.cu), keep
//   fp32's accuracy and are this kernel's next redesign.
//
// What bounds it.  At the qwen2-0.5b serving shape (B=4, S=1024, H=14, KV=2,
// hd=64, bf16, causal) one call must read q (at H heads), k and v (at KV
// heads) and write o: 16.8 MB, or 5.0 us at 3.35 TB/s; its causal products
// are 7.52 GFLOP, or 7.6 us at the 989 TFLOP/s of the bf16 tensor cores (H100
// SXM data sheet).  So the tensor cores' rate sets the least time, and the
// products must run on them; the softmax between the two products (an exp
// per score) is the next limit, as in FlashAttention-3.
//
// Tensor-core design (bf16).  A block of 288 threads owns a 128-row q-tile of
// one (b, q-head): two consumer warpgroups of 64 rows each and one producer
// warp.  The producer loads the q-tile once and then K and V tiles of 64 keys
// into a ring of 2-3 stages in shared memory with TMA (cp.async.bulk.tensor,
// 128-byte swizzle), each stage signalled on an mbarrier ("full") and handed
// back by the consumers on another ("empty").  The tensor maps are 4-D (hd, S,
// heads, B) over the caller's strides, so q, k, v are read in place and the
// KV head is a coordinate.  The head dim is cut into 64-column panels (8 KB of
// 64 rows, one 128-byte swizzle row each); hd 16 and 32 fill one panel and hd
// 96 two, the columns past hd filled with zeros by TMA (they add nothing to a
// score, and the matching output columns are not stored).  A consumer
// warpgroup computes S = Q K^T with wgmma m64n64k16 (both operands from shared
// memory, K-major), scales and masks S in its fp32 accumulator registers,
// runs the online softmax there (a row's max and sum across the 4 threads
// that hold it), turns P into bf16 register fragments in place (the
// accumulator layout of S is the A-operand layout of the next product), and
// computes O += P V with wgmma m64n{64,128,192}k16, A from registers and V as
// the MN-major B operand through the transpose bit (no transposed copy).  O
// is written from registers in q's dtype.  At hd <= 64 two blocks share an
// SM.  KV tiles wholly above the diagonal
// or wholly before every row's window are not loaded; a warpgroup whose rows
// have nothing in a loaded tile skips it.  Ragged Sq and Skv: rows past Sq
// read zeros and are not stored, keys past Skv read zeros and are masked.
// The q-tiles with the most KV tiles of every (b, h) are launched first.
//
// CUDA-core design (fp32).  A block of 256 threads owns one (b, h, 64-row
// q-tile) and loops over 64-key KV tiles, carrying m, l and acc in
// registers: thread (ty, tx) = (tid / 16, tid % 16) owns the q rows ty + 16 i
// (i < 4), the 4 x 4 scores of those rows at the keys tx + 16 j, and the
// output columns tx + 16 c of the same rows, so the per-row rescale factor
// never leaves the thread; row max and sum are four xor-shuffles.  Q, K and V
// tiles are staged in shared memory (66 KB at hd 64, 161 KB at hd 192).
//
// Both forward kernels write the row's log-sum-exp of the scaled scores,
// lse = m + log(l) in fp32 (B, H, Sq), when the caller passes a buffer for
// it (training: the backward reads it); serving passes null and nothing
// more is stored.
//
// The backward of both kernels is csrc/flash_attention_bwd.cu; the Hopper
// helpers both use (mbarriers, TMA loads and tensor maps, wgmma) are in
// csrc/flash_tc.cuh.
//
// Plain C interface, loaded with ctypes.  A launch goes to the caller's
// stream, does not synchronise and allocates nothing; the return value is
// cudaGetLastError() after the launch (or the error of a setup step).

#include "flash_tc.cuh"

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores
// ---------------------------------------------------------------------------

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256

struct FlashParams {
    const float* q;
    const float* k;
    const float* v;
    float* o;
    float* lse;        // (B, H, Sq) or null
    long long sq[3];   // strides in elements: batch, seq, head
    long long sk[3];
    long long sv[3];
    long long so[3];
    int H;
    int group;         // query heads a KV head serves
    int Sq;
    int Skv;
    int causal;
    int window;
    float scale;
};

template <int HD>
constexpr size_t flash_smem_bytes() {
    return sizeof(float) * ((size_t)FA_BQ * (HD + 1) + (size_t)FA_BK * (HD + 1)
                            + (size_t)FA_BK * HD + (size_t)FA_BQ * (FA_BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_fp32_kernel(const FlashParams p) {
    constexpr int QS = HD + 1;        // padded row stride of the Q and K tiles
    constexpr int PS = FA_BK + 1;     // padded row stride of the P tile
    constexpr int NC = HD / 16;       // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;                 // FA_BQ x QS, scaled q
    float* Ks = Qs + FA_BQ * QS;      // FA_BK x QS
    float* Vs = Ks + FA_BK * QS;      // FA_BK x HD
    float* Ps = Vs + FA_BK * HD;      // FA_BQ x PS, probabilities of the tile

    const int bh = blockIdx.y;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int kvh = h / p.group;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;   // heavy tiles first
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;

    const float* qg = p.q + b * p.sq[0] + h * p.sq[2];
    const float* kg = p.k + b * p.sk[0] + kvh * p.sk[2];
    const float* vg = p.v + b * p.sv[0] + kvh * p.sv[2];
    float* og = p.o + b * p.so[0] + h * p.so[2];

    for (int i = tid; i < FA_BQ * HD; i += FA_THREADS) {
        const int r = i / HD;
        const int c = i % HD;
        const int s = q0 + r;
        Qs[r * QS + c] = s < p.Sq ? qg[(long long)s * p.sq[1] + c] * p.scale : 0.f;
    }

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = FA_NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    // KV tiles that hold an unmasked key for some row of this q-tile
    const int q_last = min(q0 + FA_BQ, p.Sq) - 1;
    int kt_end = (p.Skv + FA_BK - 1) / FA_BK;
    if (p.causal) kt_end = min(kt_end, q_last / FA_BK + 1);
    const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / FA_BK : 0;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * FA_BK;
        __syncthreads();              // the last tile's readers are done
        for (int i = tid; i < FA_BK * HD; i += FA_THREADS) {
            const int r = i / HD;
            const int c = i % HD;
            const int s = k0 + r;
            const bool in = s < p.Skv;
            Ks[r * QS + c] = in ? kg[(long long)s * p.sk[1] + c] : 0.f;
            Vs[r * HD + c] = in ? vg[(long long)s * p.sv[1] + c] : 0.f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float a[4], bk[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
        }

        float corr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty + 16 * i;
            float mx = FA_NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                bool keep = kpos < p.Skv;
                if (p.causal) keep = keep && kpos <= qpos;
                if (p.window > 0) keep = keep && kpos > qpos - p.window;
                if (!keep) sc[i][j] = FA_NEG_INF;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float pij = expf(sc[i][j] - m_new);
                Ps[(ty + 16 * i) * PS + tx + 16 * j] = pij;
                sum += pij;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            corr[i] = expf(m[i] - m_new);
            l[i] = l[i] * corr[i] + sum;
            m[i] = m_new;
        }
        // a row of P is written and read by the one half-warp that owns it
        __syncwarp();

#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= corr[i];
#pragma unroll 4
        for (int kk = 0; kk < FA_BK; ++kk) {
            float pr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float vv = Vs[kk * HD + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= p.Sq) continue;
        const float denom = fmaxf(l[i], 1e-30f);
        float* orow = og + (long long)row * p.so[1];
#pragma unroll
        for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
        if (p.lse != nullptr && tx == 0)
            p.lse[(long long)bh * p.Sq + row] = m[i] + logf(denom);
    }
}

template <int HD>
static int launch_fp32(const FlashParams& p, int BH, cudaStream_t stream) {
    constexpr size_t smem = flash_smem_bytes<HD>();
    static bool smem_set[FA_MAX_DEVICES] = {};
    const int err = raise_smem_once(flash_fp32_kernel<HD>, smem, smem_set);
    if (err) return err;
    const dim3 grid((p.Sq + FA_BQ - 1) / FA_BQ, BH);
    flash_fp32_kernel<HD><<<grid, FA_THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores
// ---------------------------------------------------------------------------

#define TC_BQ 128            // q rows a block: two consumer warpgroups of 64
#define TC_BK 64             // keys a KV tile
#define TC_THREADS 288       // 2 consumer warpgroups + 1 producer warp

struct TcParams {
    __nv_bfloat16* o;
    float* lse;              // (B, H, Sq) or null
    long long so[3];         // o's strides in elements: batch, seq, head
    int H;
    int group;
    int Sq;
    int Skv;
    int hd;
    int causal;
    int window;
    float scale_log2;        // log2(e) / sqrt(hd): scores in the exp2 domain
};

template <int NP>            // 64-column panels of the head dim
struct TcShape {
    static constexpr int STAGES = NP == 3 ? 2 : 3;
    static constexpr size_t Q_BYTES = 2 * NP * TC_PANEL;
    static constexpr size_t KV_BYTES = NP * TC_PANEL;     // one K or V tile
    static constexpr size_t BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
    // 1 KB of slack to align the tiles to the 1 KB swizzle period
    static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
};

// at one panel (hd <= 64) two blocks share an SM: registers capped at 112
// a thread (66 KB of shared memory a block), so one block's softmax overlaps
// the other's products and loads
template <int NP>
__global__ void __launch_bounds__(TC_THREADS, NP == 1 ? 2 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const TcParams p) {
    using Shape = TcShape<NP>;
    constexpr int ST = Shape::STAGES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* Qs = base;                              // [warpgroup][panel]
    uint8_t* Ks = Qs + Shape::Q_BYTES;               // [stage][panel]
    uint8_t* Vs = Ks + ST * Shape::KV_BYTES;         // [stage][panel]
    uint64_t* full = reinterpret_cast<uint64_t*>(base + Shape::BAR_OFF);
    uint64_t* empty = full + ST;
    uint64_t* qbar = empty + ST;

    const int bh = blockIdx.x;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;   // heavy tiles first
    // KV tiles that hold an unmasked key for some row of this q-tile
    const int q_last = min(q0 + TC_BQ, p.Sq) - 1;
    int kt_end = (p.Skv + TC_BK - 1) / TC_BK;
    if (p.causal) kt_end = min(kt_end, q_last / TC_BK + 1);
    const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / TC_BK : 0;
    const int n_tiles = kt_end - kt_begin;

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    if (tid == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);      // lane 0 of each consumer warp
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 8) {                      // the producer warp
        if (lane == 0) {
            const int kvh = h / p.group;
            mbar_expect_tx(qbar, (uint32_t)Shape::Q_BYTES);
            for (int g = 0; g < 2; ++g)
                for (int pn = 0; pn < NP; ++pn)
                    tma_load(Qs + (g * NP + pn) * TC_PANEL, &tq, qbar, 64 * pn,
                             q0 + 64 * g, h, b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % ST;
                mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
                mbar_expect_tx(&full[s], (uint32_t)(2 * Shape::KV_BYTES));
                const int k0 = (kt_begin + i) * TC_BK;
                for (int pn = 0; pn < NP; ++pn) {
                    tma_load(Ks + (s * NP + pn) * TC_PANEL, &tk, &full[s],
                             64 * pn, k0, kvh, b);
                    tma_load(Vs + (s * NP + pn) * TC_PANEL, &tv, &full[s],
                             64 * pn, k0, kvh, b);
                }
            }
        }
        return;
    }

    // a consumer warpgroup: rows r_min .. r_min + 63 of the q-tile; this
    // thread holds rows row0 and row0 + 8 of the accumulators
    const int wg = warp / 4;
    const int r_min = q0 + 64 * wg;
    const int r_max = min(r_min + 63, p.Sq - 1);   // < r_min: no valid row
    const int row0 = r_min + 16 * (warp % 4) + lane / 4;
    const int row1 = row0 + 8;
    const int cq = 2 * (lane % 4);                  // first column of a pair

    float oacc[32 * NP];
#pragma unroll
    for (int i = 0; i < 32 * NP; ++i) oacc[i] = 0.f;
    float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;

    mbar_wait(qbar, 0);
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        const int k0 = (kt_begin + i) * TC_BK;
        mbar_wait(&full[s], (i / ST) & 1);
        bool active = r_max >= r_min;
        if (p.causal) active = active && k0 <= r_max;
        if (p.window > 0) active = active && k0 + TC_BK - 1 > r_min - p.window;
        if (active) {
            // S = Q K^T over the head dim, 16 columns a step
            float sacc[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) sacc[j] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int pn = 0; pn < NP; ++pn)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss_m64n64(
                        sacc,
                        sw128_desc(Qs + (wg * NP + pn) * TC_PANEL + 32 * kk, 16, 1024),
                        sw128_desc(Ks + (s * NP + pn) * TC_PANEL + 32 * kk, 16, 1024),
                        (pn | kk) != 0);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(sacc);

            // scale to the exp2 domain, mask, online softmax on the registers:
            // sacc[4j + e] is (row0 + 8 (e / 2), k0 + 8 j + cq + e % 2)
            const bool need_mask =
                (p.causal && k0 + TC_BK - 1 > r_min) || k0 + TC_BK > p.Skv
                || (p.window > 0 && k0 <= r_max - p.window);
            float mx0 = FA_NEG_INF, mx1 = FA_NEG_INF;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = sacc[4 * j + e] * p.scale_log2;
                    if (need_mask) {
                        const int kpos = k0 + 8 * j + cq + (e & 1);
                        const int qpos = e < 2 ? row0 : row1;
                        bool keep = kpos < p.Skv;
                        if (p.causal) keep = keep && kpos <= qpos;
                        if (p.window > 0) keep = keep && kpos > qpos - p.window;
                        if (!keep) x = FA_NEG_INF;
                    }
                    sacc[4 * j + e] = x;
                    if (e < 2) mx0 = fmaxf(mx0, x);
                    else mx1 = fmaxf(mx1, x);
                }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
            }
            const float mn0 = fmaxf(m0, mx0);
            const float mn1 = fmaxf(m1, mx1);
            const float c0 = exp2f(m0 - mn0);
            const float c1 = exp2f(m1 - mn1);
            m0 = mn0;
            m1 = mn1;
            // P in bf16 as the A fragments of 4 k-steps of 16 keys: the
            // accumulator pairs of columns 16 kk + (0..7, 8..15)
            uint32_t pa[4][4];
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int j = 2 * kk + half;
                    const float p00 = exp2f(sacc[4 * j + 0] - mn0);
                    const float p01 = exp2f(sacc[4 * j + 1] - mn0);
                    const float p10 = exp2f(sacc[4 * j + 2] - mn1);
                    const float p11 = exp2f(sacc[4 * j + 3] - mn1);
                    s0 += p00 + p01;
                    s1 += p10 + p11;
                    pa[kk][2 * half + 0] = pack_bf16(p00, p01);
                    pa[kk][2 * half + 1] = pack_bf16(p10, p11);
                }
            l0 = l0 * c0 + s0;                 // this thread's columns only
            l1 = l1 * c1 + s1;
#pragma unroll
            for (int j = 0; j < 8 * NP; ++j) {
                oacc[4 * j + 0] *= c0;
                oacc[4 * j + 1] *= c0;
                oacc[4 * j + 2] *= c1;
                oacc[4 * j + 3] *= c1;
            }

            // O += P V, 16 keys a step; V is MN-major: 8-key groups 1 KB
            // apart (sbo), 64-column panels TC_PANEL apart (lbo)
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_pv<NP>(oacc, pa[kk],
                             sw128_desc(Vs + s * NP * TC_PANEL + 2048 * kk,
                                        TC_PANEL, 1024));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(oacc);
        }
        if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the row sums across the 4 threads that share a row, then O / l
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (p.lse != nullptr && lane % 4 == 0) {
        // m is in the exp2 domain: lse = (m + log2 l) ln 2
        float* lr = p.lse + (long long)bh * p.Sq;
        if (row0 < p.Sq) lr[row0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * 0.6931471805599453f;
        if (row1 < p.Sq) lr[row1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * 0.6931471805599453f;
    }
    __nv_bfloat16* og = p.o + b * p.so[0] + h * p.so[2];
#pragma unroll
    for (int j = 0; j < 8 * NP; ++j) {
        const int col = 8 * j + cq;
        if (col >= p.hd) continue;
        if (row0 < p.Sq)
            *reinterpret_cast<__nv_bfloat162*>(og + (long long)row0 * p.so[1] + col) =
                __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
        if (row1 < p.Sq)
            *reinterpret_cast<__nv_bfloat162*>(og + (long long)row1 * p.so[1] + col) =
                __floats2bfloat162_rn(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    }
}

template <int NP>
static int launch_tc(const CUtensorMap& tq, const CUtensorMap& tk,
                     const CUtensorMap& tv, const TcParams& p, int BH,
                     cudaStream_t stream) {
    constexpr size_t smem = TcShape<NP>::SMEM;
    static bool smem_set[FA_MAX_DEVICES] = {};
    const int err = raise_smem_once(flash_tc_kernel<NP>, smem, smem_set);
    if (err) return err;
    const dim3 grid(BH, (p.Sq + TC_BQ - 1) / TC_BQ);
    flash_tc_kernel<NP><<<grid, TC_THREADS, smem, stream>>>(tq, tk, tv, p);
    return (int)cudaGetLastError();
}


extern "C" {

// q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H % KV == 0; device
// pointers; lse: (B, H, Sq) fp32 contiguous, or null.  strides: 12 element
// strides, (batch, seq, head) for q, k, v and o in that order, with a unit
// stride along hd.  Returns 0 or a cudaError_t.

// fp32, on the CUDA cores
int flash_attention_fp32_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, const long long* strides,
                                int B,
                                int H, int KV, int Sq, int Skv, int hd,
                                int causal, int window, float scale,
                                void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0
            || (long long)B * H > 65535)
        return (int)cudaErrorInvalidValue;
    FlashParams p;
    p.q = static_cast<const float*>(q);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.o = static_cast<float*>(o);
    p.lse = lse;
    for (int a = 0; a < 3; ++a) {
        p.sq[a] = strides[a];
        p.sk[a] = strides[3 + a];
        p.sv[a] = strides[6 + a];
        p.so[a] = strides[9 + a];
    }
    p.H = H;
    p.group = H / KV;
    p.Sq = Sq;
    p.Skv = Skv;
    p.causal = causal;
    p.window = window;
    p.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 16: return launch_fp32<16>(p, B * H, s);
        case 32: return launch_fp32<32>(p, B * H, s);
        case 64: return launch_fp32<64>(p, B * H, s);
        case 96: return launch_fp32<96>(p, B * H, s);
        case 128: return launch_fp32<128>(p, B * H, s);
        case 192: return launch_fp32<192>(p, B * H, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// bf16, on the tensor cores; q, k, v need 16-byte aligned addresses and
// (batch, seq, head) strides that are multiples of 8 elements (TMA)
int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, const long long* strides,
                                int B,
                                int H, int KV, int Sq, int Skv, int hd,
                                int causal, int window, float scale,
                                void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0
            || hd <= 0 || hd > 192 || hd % 8 != 0
            || (Sq + TC_BQ - 1) / TC_BQ > 65535)
        return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    int err = make_map(&tq, q, B, Sq, H, hd, strides);
    if (!err) err = make_map(&tk, k, B, Skv, KV, hd, strides + 3);
    if (!err) err = make_map(&tv, v, B, Skv, KV, hd, strides + 6);
    if (err) return err;
    TcParams p;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = lse;
    for (int a = 0; a < 3; ++a) p.so[a] = strides[9 + a];
    p.H = H;
    p.group = H / KV;
    p.Sq = Sq;
    p.Skv = Skv;
    p.hd = hd;
    p.causal = causal;
    p.window = window;
    p.scale_log2 = scale * 1.4426950408889634f;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (hd <= 64) return launch_tc<1>(tq, tk, tv, p, B * H, s);
    if (hd <= 128) return launch_tc<2>(tq, tk, tv, p, B * H, s);
    return launch_tc<3>(tq, tk, tv, p, B * H, s);
}

}  // extern "C"
