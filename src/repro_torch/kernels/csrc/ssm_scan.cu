// Chunked scalar-decay linear scan (the SSD form of Mamba-2, and the mLSTM
// core) for Hopper:
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
// N = 16, P = 400, bf16; q and k shared by the heads) one call must read v,
// q, k and log_a and write y and h: 53.6 MB, or 16.0 us at 3.35 TB/s; the
// chunked form's ~7.8 GFLOP take 7.9 us at the bf16 tensor-core rate, so the
// least time is set by bytes.  At the xlstm-125m shape (B = 4, S = 512, 4
// heads, N = 384, P = 385) the state is wide and the operations set it.  This
// first kernel does its products in fp32 on the CUDA cores from shared
// memory, so it is bound by operations, far above both bounds: tensor cores
// (mma.sync or wgmma on the L x L and L x N tiles) and TMA loads are later
// work.
//
// Design.  The TPU grid walks the chunks of one (b, h) in order, carrying h
// in VMEM scratch.  The card has no sequential grid: here one block of 256
// threads owns one (b, h, 64-column P-tile) and walks the chunks itself,
// with the (N x 64) fp32 state in shared memory.  The chunk length L = 32 is
// the kernel's own (the model's chunk, 256, only sets the plain version's
// summation order): the work a step is N*L + 64*L + 2*N*64 multiply-adds, so
// a short chunk costs least, and at N = 384 the fp32 q and k tiles of 32 rows
// (49 KB each) fit beside the state (98 KB) in 227 KB.  A chunk is four
// steps, each a barrier apart:
//   1. load q, k (L x N), v (L x 64) as fp32, zero past the ragged end of the
//      sequence and of P; one warp takes the inclusive prefix sum cum of
//      log_a by shuffles (log_a = 0 past the end, so cum[L-1] is the chunk's
//      total);
//   2. the causal score tile M[t][s] = (q_t . k_s) exp(cum_t - cum_s), s <= t
//      (every exponent <= 0; the mask is applied by not computing s > t);
//   3. y_t = sum_s M[t][s] v_s + exp(cum_t) q_t . h, written to y, while the
//      k rows are scaled in place by exp(total - cum_s);
//   4. h = exp(total) h + k^T v.
// Thread (ty, tx) = (tid / 64, tid % 64) owns column tx of the tile: the 8
// output rows ty + 4i in step 3 and the state rows ty + 4j in step 4, so the
// shared-memory reads of M, q and k are warp broadcasts and those of v and h
// are consecutive.  q and k rows are padded to an odd stride, so the 8 k rows
// a warp reads in step 2 fall in distinct banks.
//
// q, k, v and log_a are read in place through (batch, seq, head) strides
// with a unit stride along N or P; a stride of 0 along the heads is allowed
// (the Mamba heads share one q and one k).  q, k and v are each fp32 or bf16
// (the mLSTM's k is fp32 beside a bf16 q and v, as JAX promotes it); log_a is
// fp32.
//
// Plain C interface, loaded with ctypes.  The launch goes to the caller's
// stream, does not synchronise and allocates nothing; the return value is
// cudaGetLastError() after the launch (or the error of setting the shared
// memory limit).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SC_L 32
#define SC_PT 64
#define SC_THREADS 256
#define SC_TY (SC_THREADS / SC_PT)       // 4 row groups
#define SC_YROWS (SC_L / SC_TY)          // 8 output rows a thread
#define SC_HROWS 8                       // state rows a thread takes at once
#define SC_MAX_SMEM 232448               // a block's dynamic shared memory

struct ScanParams {
    const void* q;
    const void* k;
    const void* v;
    const float* la;
    void* y;
    float* h;
    long long sq[3];   // strides in elements: batch, seq, head
    long long sk[3];
    long long sv[3];
    long long sla[3];
    long long sy[3];
    int H;
    int S;
    int N;
    int P;
    int q_dt;          // 0 = fp32, 1 = bf16; y is in v's dtype
    int k_dt;
    int v_dt;
};

__device__ inline float load(const void* base, long long i, int dt) {
    return dt == 0 ? static_cast<const float*>(base)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
}

__device__ inline void store(void* base, long long i, int dt, float x) {
    if (dt == 0)
        static_cast<float*>(base)[i] = x;
    else   // round to nearest even, as astype does
        static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
}

__host__ __device__ inline int padded(int n) { return n % 2 == 0 ? n + 1 : n; }

// dynamic shared memory of a block at state width N (smem_bytes in
// ssm_scan.py computes the same, so the wrapper refuses an N that does not fit)
__host__ __device__ inline size_t scan_smem_bytes(int N) {
    return sizeof(float) * ((size_t)2 * SC_L * padded(N) + (size_t)SC_L * SC_PT
                            + (size_t)N * SC_PT + (size_t)SC_L * (SC_L + 1)
                            + SC_L);
}

__global__ void __launch_bounds__(SC_THREADS)
ssm_scan_kernel(const ScanParams p) {
    extern __shared__ float smem[];
    const int N = p.N;
    const int NP = padded(N);
    float* Qs = smem;                    // SC_L x NP
    float* Ks = Qs + SC_L * NP;          // SC_L x NP
    float* Vs = Ks + SC_L * NP;          // SC_L x SC_PT
    float* Hs = Vs + SC_L * SC_PT;       // N x SC_PT, the state
    float* Ms = Hs + N * SC_PT;          // SC_L x (SC_L + 1)
    float* cum = Ms + SC_L * (SC_L + 1); // SC_L

    const int bh = blockIdx.y;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int p0 = blockIdx.x * SC_PT;
    const int tid = threadIdx.x;
    const int tx = tid % SC_PT;
    const int ty = tid / SC_PT;
    const bool col_in = p0 + tx < p.P;

    const long long qo = b * p.sq[0] + h * p.sq[2];
    const long long ko = b * p.sk[0] + h * p.sk[2];
    const long long vo = b * p.sv[0] + h * p.sv[2] + p0;
    const long long lo = b * p.sla[0] + h * p.sla[2];
    const long long yo = b * p.sy[0] + h * p.sy[2] + p0;

    for (int i = tid; i < N * SC_PT; i += SC_THREADS) Hs[i] = 0.f;

    for (int c0 = 0; c0 < p.S; c0 += SC_L) {
        const int Lc = min(SC_L, p.S - c0);
        __syncthreads();              // the last chunk's readers are done

        // 1. the chunk's tiles, zero past the ends; cum = prefix of log_a
        for (int i = tid; i < SC_L * N; i += SC_THREADS) {
            const int t = i / N;
            const int n = i % N;
            float qv = 0.f, kv = 0.f;
            if (t < Lc) {
                const long long s = c0 + t;
                qv = load(p.q, qo + s * p.sq[1] + n, p.q_dt);
                kv = load(p.k, ko + s * p.sk[1] + n, p.k_dt);
            }
            Qs[t * NP + n] = qv;
            Ks[t * NP + n] = kv;
        }
        for (int i = tid; i < SC_L * SC_PT; i += SC_THREADS) {
            const int t = i / SC_PT;
            const int c = i % SC_PT;
            Vs[i] = (t < Lc && p0 + c < p.P)
                ? load(p.v, vo + (long long)(c0 + t) * p.sv[1] + c, p.v_dt) : 0.f;
        }
        if (tid < 32) {               // SC_L == 32: one warp, one row a lane
            float a = tid < Lc ? p.la[lo + (long long)(c0 + tid) * p.sla[1]] : 0.f;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float o = __shfl_up_sync(0xffffffffu, a, off);
                if (tid >= off) a += o;
            }
            cum[tid] = a;
        }
        __syncthreads();
        const float total = cum[SC_L - 1];

        // 2. causal score tile with its decay gate
        {
            const int t = tid / 8;
#pragma unroll
            for (int j = 0; j < SC_L / 8; ++j) {
                const int s = tid % 8 + 8 * j;
                float acc = 0.f;
                if (s <= t) {
                    for (int n = 0; n < N; ++n)
                        acc = fmaf(Qs[t * NP + n], Ks[s * NP + n], acc);
                    acc *= expf(cum[t] - cum[s]);
                }
                Ms[t * (SC_L + 1) + s] = acc;
            }
        }
        __syncthreads();

        // 3. y = M v + exp(cum) (q h); k rows scaled for the state update
        {
            float yi[SC_YROWS], ye[SC_YROWS];
#pragma unroll
            for (int i = 0; i < SC_YROWS; ++i) {
                yi[i] = 0.f;
                ye[i] = 0.f;
            }
#pragma unroll 4
            for (int s = 0; s < SC_L; ++s) {
                const float vv = Vs[s * SC_PT + tx];
#pragma unroll
                for (int i = 0; i < SC_YROWS; ++i)
                    yi[i] = fmaf(Ms[(ty + SC_TY * i) * (SC_L + 1) + s], vv, yi[i]);
            }
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                const float hh = Hs[n * SC_PT + tx];
#pragma unroll
                for (int i = 0; i < SC_YROWS; ++i)
                    ye[i] = fmaf(Qs[(ty + SC_TY * i) * NP + n], hh, ye[i]);
            }
            if (col_in) {
#pragma unroll
                for (int i = 0; i < SC_YROWS; ++i) {
                    const int t = ty + SC_TY * i;
                    if (t < Lc)
                        store(p.y, yo + (long long)(c0 + t) * p.sy[1] + tx,
                              p.v_dt, yi[i] + expf(cum[t]) * ye[i]);
                }
            }
            for (int i = tid; i < SC_L * N; i += SC_THREADS) {
                const int s = i / N;
                Ks[s * NP + i % N] *= expf(total - cum[s]);
            }
        }
        __syncthreads();

        // 4. h = exp(total) h + k^T v, the state rows ty + 4j of column tx
        {
            const float et = expf(total);
            for (int n0 = ty; n0 < N; n0 += SC_TY * SC_HROWS) {
                float acc[SC_HROWS];
#pragma unroll
                for (int j = 0; j < SC_HROWS; ++j) acc[j] = 0.f;
#pragma unroll 4
                for (int s = 0; s < SC_L; ++s) {
                    const float vv = Vs[s * SC_PT + tx];
#pragma unroll
                    for (int j = 0; j < SC_HROWS; ++j) {
                        const int n = n0 + SC_TY * j;
                        if (n < N) acc[j] = fmaf(Ks[s * NP + n], vv, acc[j]);
                    }
                }
#pragma unroll
                for (int j = 0; j < SC_HROWS; ++j) {
                    const int n = n0 + SC_TY * j;
                    if (n < N) Hs[n * SC_PT + tx] = fmaf(et, Hs[n * SC_PT + tx], acc[j]);
                }
            }
        }
    }
    __syncthreads();
    float* hout = p.h + (long long)bh * N * p.P + p0;
    for (int i = tid; i < N * SC_PT; i += SC_THREADS) {
        const int c = i % SC_PT;
        if (p0 + c < p.P) hout[(long long)(i / SC_PT) * p.P + c] = Hs[i];
    }
}

#define SC_MAX_DEVICES 64

extern "C" {

// q, k: (B, S, H, N); v, y: (B, S, H, P); log_a: (B, S, H) fp32; h: (B, H,
// N, P) fp32 contiguous.  strides: 15 element strides, (batch, seq, head)
// for q, k, v, log_a and y in that order, with a unit stride along N and P.
// dtypes: 0 = fp32, 1 = bf16.  Returns 0 or a cudaError_t.
int ssm_scan_launch(const void* q, const void* k, const void* v,
                    const float* log_a, void* y, float* h,
                    const long long* strides, int B, int S, int H, int N,
                    int P, int q_dt, int k_dt, int v_dt, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || P <= 0
            || (long long)B * H > 65535)
        return (int)cudaErrorInvalidValue;
    const size_t smem = scan_smem_bytes(N);
    if (smem > SC_MAX_SMEM) return (int)cudaErrorInvalidValue;
    // the shared-memory limit is raised once on each device, at its first
    // launch there, to the most a block may take
    static bool smem_set[SC_MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= SC_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!smem_set[dev]) {
        err = cudaFuncSetAttribute(ssm_scan_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SC_MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        smem_set[dev] = true;
    }
    ScanParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.la = log_a;
    p.y = y;
    p.h = h;
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
    p.q_dt = q_dt;
    p.k_dt = k_dt;
    p.v_dt = v_dt;
    const dim3 grid((P + SC_PT - 1) / SC_PT, B * H);
    ssm_scan_kernel<<<grid, SC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
