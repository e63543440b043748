// Flash attention backward for Hopper: dq, dk and dv of the forward in
// csrc/flash_attention.cu (causal, the sliding window kpos > qpos - window,
// KV heads read in place: query head h reads KV head h / (H / KV)), from q,
// k, v, o, dO and the forward's log-sum-exp lse = m + log(l) (B, H, Sq).
//
// It replaces no TPU kernel: the Pallas kernel has no VJP, and the JAX
// package trains through its jnp attention; the port's training path on the
// card runs the forward kernel, so its gradient is a kernel too.
// FlashAttention-2's algorithm, on the CUDA cores in fp32 for both dtypes (a
// first design; the tensor cores are later work), three kernels for one
// launch on the wrapper's counter:
//
//   D        a warp per row: D = rowsum(dO * O) in fp32 (the workspace).
//   dK, dV   a block per (batch, KV head, 64-key tile) loops over the query
//            heads that read that KV head and over their query tiles whose
//            rows see the tile (causal and window bounds), recomputing
//            P = exp(S * scale - lse) and dS = P * (dO V^T - D), and carrying
//            dV += P^T dO and dK += dS^T Q in registers: GQA's sum over the
//            group happens in the block, K and V read in place at their KV
//            head.
//   dQ       a block per (batch, query head, query tile) loops over the key
//            tiles its rows see and carries dQ += dS K in registers.
//
// No atomics: every output element is written once by one thread, so the
// result is the same on every run.  Tiles of Q, dO, K and V are staged in
// shared memory as fp32 (rows padded by one float); the score tile's owner
// map is the fp32 forward's.  Outputs are in q's dtype; the masks, the scale
// 1/sqrt(hd) and the -1e30 convention are the forward's.
//
// What bounds the backward: at qwen2-0.5b's training shape (B=4, S=1024,
// H=14, KV=2, hd=64, bf16, causal) it must read q, o, dO (at 14 heads), k, v
// (at 2) and lse and write dq, dk, dv: 33.8 MB, 10.1 us at 3.35 TB/s; its
// five products on the unmasked pairs (S = QK^T again, dP, dV, dQ, dK) are
// 18.8 GFLOP, 19.0 us on the bf16 tensor cores, so the tensor cores' rate
// sets the least time.  This first design computes in fp32 on the CUDA cores
// (67 TFLOP/s) and recomputes S and dP in both the dK/dV and the dQ kernel.
//
// Plain C interface, loaded with ctypes.  A launch goes to the caller's
// stream, does not synchronise and allocates nothing (the D workspace comes
// from the wrapper); the return value is cudaGetLastError() after the
// launches (or the error of a setup step).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define FB_MAX_DEVICES 64

// The shared-memory limit is raised once for each instantiation on each
// device, at its first launch there, not at every call.
template <typename K>
static int raise_smem_once(K kernel, size_t smem, bool (&done)[FB_MAX_DEVICES]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= FB_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!done[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        done[dev] = true;
    }
    return 0;
}

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
    static bool set_dkdv[FB_MAX_DEVICES] = {};
    static bool set_dq[FB_MAX_DEVICES] = {};
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

extern "C" {

// The backward of either forward: q, o, dout, dq (B, Sq, H, hd); k, v, dk,
// dv (B, Skv, KV, hd); lse the forward's (B, H, Sq) fp32; ws (B, H, Sq) fp32
// scratch.  strides: 24 element strides, (batch, seq, head) for q, k, v, o,
// dout, dq, dk, dv in that order, each with a unit stride along hd.  dtype:
// 0 = fp32, 1 = bf16, all eight tensors alike.  Returns 0 or a cudaError_t.
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

}  // extern "C"
