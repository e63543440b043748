// Flash attention forward for Hopper: online softmax over KV tiles, with a
// causal mask and an optional sliding window (kpos > qpos - window).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_flash_kernel
// (launched by flash_attention_bhsd, reached through repro/kernels/ops.py
// flash_attention from the attention layer when attention_impl="pallas").
// It computes what that kernel computes: q is scaled by 1/sqrt(hd) in fp32,
// masked scores are -1e30 (not -inf, so a row whose tile is wholly masked
// stays finite), the running max m, normaliser l and accumulator acc are
// fp32, l is clamped at 1e-30, and the output is in q's dtype.
//
// What bounds it.  At the qwen2-0.5b serving shape (B=4, S=1024, H=14,
// hd=64, bf16, causal) one call must read q, k, v and write o: 29.36 MB, or
// 8.76 us at 3.35 TB/s; its causal products are 7.52 GFLOP, or 7.61 us at the
// 989 TFLOP/s of the bf16 tensor cores (H100 SXM data sheet).  So the least
// time is set by bytes.  This first kernel does its products on the CUDA
// cores in fp32, where the same FLOPs need at least 112 us at 67 TFLOP/s: it
// is bound by operations, far above the bound.  Tensor cores (mma.sync or
// wgmma), TMA loads and indexing KV heads in place of the repeated copy are
// later work.
//
// Design.  The TPU grid walks the KV blocks of one (bh, q-block) in order,
// carrying m, l and acc in VMEM scratch.  Here one block of 256 threads owns
// one (bh, 64-row q-tile) and loops over 64-key KV tiles itself, carrying m,
// l and acc in registers.  Thread (ty, tx) = (tid / 16, tid % 16) owns the
// q rows ty + 16 i (i < 4): it computes the 4 x 4 scores of those rows at the
// keys tx + 16 j, and the output columns tx + 16 c (c < hd / 16) of the same
// rows, so the per-row rescale factor never leaves the thread.  The 16
// threads that share a row sit in one half-warp, so row max and row sum are
// four xor-shuffles.  Q, K and V tiles are staged in shared memory as fp32
// (rows of Q and K padded to hd + 1 words, so the 16 key rows a half-warp
// reads fall in distinct banks); P goes through shared memory to the P.V
// product.  Shared memory is 66 KB at hd = 64 and 161 KB at hd = 192, taken
// as dynamic shared memory.  KV tiles wholly above the diagonal, or wholly
// before every row's window, are skipped: in the TPU kernel their
// contribution is rescaled by exp(-1e30 - m) = 0 once a real score arrives,
// so the result is the same.  The kernel masks its own ragged edges (rows of
// q past Sq, keys past Skv read as zero), and the largest q-tiles of each bh
// are launched first, as they have the most KV tiles to walk.
//
// q, k, v and o are read and written in place through (batch, seq, head)
// strides with a unit stride along hd, so the (B, S, H, hd) layout of the
// attention layer needs no transpose copies.
//
// Plain C interface, loaded with ctypes.  The launch goes to the caller's
// stream, does not synchronise and allocates nothing; the return value is
// cudaGetLastError() after the launch (or the error of setting the shared
// memory limit).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG_INF (-1e30f)

struct FlashParams {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long sq[3];   // strides in elements: batch, seq, head
    long long sk[3];
    long long sv[3];
    long long so[3];
    int H;
    int Sq;
    int Skv;
    int causal;
    int window;
    float scale;
};

template <typename T> struct Elem;

template <> struct Elem<float> {
    __device__ static inline float load(const float* p) { return *p; }
    __device__ static inline void store(float* p, float x) { *p = x; }
};

template <> struct Elem<__nv_bfloat16> {
    __device__ static inline float load(const __nv_bfloat16* p) {
        return __bfloat162float(*p);
    }
    __device__ static inline void store(__nv_bfloat16* p, float x) {
        *p = __float2bfloat16(x);   // round to nearest even, as astype does
    }
};

template <int HD>
constexpr size_t flash_smem_bytes() {
    return sizeof(float) * ((size_t)FA_BQ * (HD + 1) + (size_t)FA_BK * (HD + 1)
                            + (size_t)FA_BK * HD + (size_t)FA_BQ * (FA_BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const FlashParams p) {
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
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;   // heavy tiles first
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;

    const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
    const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
    const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
    T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2];

    for (int i = tid; i < FA_BQ * HD; i += FA_THREADS) {
        const int r = i / HD;
        const int c = i % HD;
        const int s = q0 + r;
        Qs[r * QS + c] = s < p.Sq
            ? Elem<T>::load(qg + (long long)s * p.sq[1] + c) * p.scale : 0.f;
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
            Ks[r * QS + c] = in ? Elem<T>::load(kg + (long long)s * p.sk[1] + c) : 0.f;
            Vs[r * HD + c] = in ? Elem<T>::load(vg + (long long)s * p.sv[1] + c) : 0.f;
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
        T* orow = og + (long long)row * p.so[1];
#pragma unroll
        for (int c = 0; c < NC; ++c)
            Elem<T>::store(orow + tx + 16 * c, acc[i][c] / denom);
    }
}

#define FA_MAX_DEVICES 64

// The shared-memory limit is raised once for each instantiation on each
// device, at its first launch there, not at every call.
template <typename T, int HD>
static int launch(const FlashParams& p, int BH, cudaStream_t stream) {
    constexpr size_t smem = flash_smem_bytes<HD>();
    static bool smem_set[FA_MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= FA_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!smem_set[dev]) {
        err = cudaFuncSetAttribute(
            flash_attention_kernel<T, HD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set[dev] = true;
    }
    const dim3 grid((p.Sq + FA_BQ - 1) / FA_BQ, BH);
    flash_attention_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_hd(const FlashParams& p, int BH, int hd, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(p, BH, stream);
        case 32: return launch<T, 32>(p, BH, stream);
        case 64: return launch<T, 64>(p, BH, stream);
        case 96: return launch<T, 96>(p, BH, stream);
        case 128: return launch<T, 128>(p, BH, stream);
        case 192: return launch<T, 192>(p, BH, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// q, k, v, o: device pointers; strides: 12 element strides, (batch, seq,
// head) for q, k, v and o in that order, with a unit stride along hd.
// dtype 0 = fp32, 1 = bf16.  Returns 0 or a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int B, int H,
                           int Sq, int Skv, int hd, int dtype, int causal,
                           int window, float scale, void* stream) {
    if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || (long long)B * H > 65535)
        return (int)cudaErrorInvalidValue;
    FlashParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    for (int a = 0; a < 3; ++a) {
        p.sq[a] = strides[a];
        p.sk[a] = strides[3 + a];
        p.sv[a] = strides[6 + a];
        p.so[a] = strides[9 + a];
    }
    p.H = H;
    p.Sq = Sq;
    p.Skv = Skv;
    p.causal = causal;
    p.window = window;
    p.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_hd<float>(p, B * H, hd, s);
    if (dtype == 1) return launch_hd<__nv_bfloat16>(p, B * H, hd, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
