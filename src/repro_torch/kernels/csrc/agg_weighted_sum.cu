// Hierarchical-aggregation fold for Hopper: out = acc + sum_c w_c * D_c.
//
// Replaces the Pallas TPU kernel repro/kernels/agg_weighted_sum.py:_agg_kernel
// (the fold LocalAggregator runs for every micro-batch and client block).
//
// What bounds it: every byte is touched once and each element costs C fused
// multiply-adds, about 0.5 FLOP per byte, so it is bound by device memory:
// (C * itemsize + 8) * n bytes (C rows read, acc read, out written) at
// 3.35 TB/s on an H100 SXM.
//
// What the design does about that bound: one pass over the rows, each thread
// keeps its VEC fp32 partial sums in registers across all C rows, and acc is
// read once and out written once.  Rows are loaded 16 bytes at a time (4 fp32
// or 8 bf16 values) when every pointer is 16-byte aligned; the ragged tail,
// and everything when a pointer is not aligned, takes the scalar loop.
//
// The C rows arrive as device pointers with their weights passed by value in
// the kernel's parameter block, so one kernel serves a contiguous (C, n)
// block and C separately allocated buffers alike, with no stack copy and no
// host-to-device copy of the weights.  Clients are summed in index order with
// fp32 accumulation; out may alias acc (the in-place fold, each element is
// read and written by the same thread).
//
// Plain C interface, loaded with ctypes.  The launch goes to the caller's
// stream, does not synchronise and allocates nothing; the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define AGG_MAX_ROWS 64

struct AggParams {
    const void* rows[AGG_MAX_ROWS];
    float w[AGG_MAX_ROWS];
    const float* acc;
    float* out;
    long long n;
    long long nvec;   // elements covered by vector loads: nvec * VEC
    int C;
};

template <typename T> struct RowVec;

template <> struct RowVec<float> {
    static constexpr int VEC = 4;
    __device__ static inline void load(const float* p, float* f) {
        float4 v = *reinterpret_cast<const float4*>(p);
        f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    }
    __device__ static inline float scalar(const float* p) { return *p; }
};

template <> struct RowVec<__nv_bfloat16> {
    static constexpr int VEC = 8;
    __device__ static inline void load(const __nv_bfloat16* p, float* f) {
        uint4 raw = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float2 t = __bfloat1622float2(h[k]);
            f[2 * k] = t.x;
            f[2 * k + 1] = t.y;
        }
    }
    __device__ static inline float scalar(const __nv_bfloat16* p) {
        return __bfloat162float(*p);
    }
};

template <typename T>
__global__ void agg_weighted_sum_kernel(const AggParams p) {
    constexpr int VEC = RowVec<T>::VEC;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;

    for (long long v = tid; v < p.nvec; v += stride) {
        const long long i = v * VEC;
        float a[VEC];
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
            float4 t = *reinterpret_cast<const float4*>(p.acc + i + k);
            a[k] = t.x; a[k + 1] = t.y; a[k + 2] = t.z; a[k + 3] = t.w;
        }
#pragma unroll 4
        for (int c = 0; c < p.C; ++c) {
            float d[VEC];
            RowVec<T>::load(static_cast<const T*>(p.rows[c]) + i, d);
            const float wc = p.w[c];
#pragma unroll
            for (int k = 0; k < VEC; ++k) a[k] = fmaf(wc, d[k], a[k]);
        }
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
            *reinterpret_cast<float4*>(p.out + i + k) =
                make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]);
        }
    }

    for (long long i = p.nvec * VEC + tid; i < p.n; i += stride) {
        float a = p.acc[i];
        for (int c = 0; c < p.C; ++c) {
            a = fmaf(p.w[c], RowVec<T>::scalar(static_cast<const T*>(p.rows[c]) + i), a);
        }
        p.out[i] = a;
    }
}

static inline bool aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T>
static int launch(AggParams& p, cudaStream_t stream) {
    constexpr int VEC = RowVec<T>::VEC;
    bool vec_ok = aligned16(p.acc) && aligned16(p.out);
    for (int c = 0; c < p.C && vec_ok; ++c) vec_ok = aligned16(p.rows[c]);
    p.nvec = vec_ok ? p.n / VEC : 0;
    const long long work = p.nvec + (p.n - p.nvec * VEC);
    const int threads = 256;
    long long blocks = (work + threads - 1) / threads;
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) {
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const long long cap = (long long)sms * 8;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    agg_weighted_sum_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

// rows: C device pointers; w: C host floats; dtype: 0 = fp32 rows, 1 = bf16.
// Returns a cudaError_t value (0 on success); -1 for arguments out of range.
extern "C" int agg_weighted_sum_launch(const void* const* rows, const float* w,
                                       int C, const float* acc, float* out,
                                       long long n, int dtype, void* stream) {
    if (C < 1 || C > AGG_MAX_ROWS || n < 0 || (dtype != 0 && dtype != 1)) {
        return -1;
    }
    if (n == 0) return 0;
    AggParams p;
    for (int c = 0; c < C; ++c) {
        p.rows[c] = rows[c];
        p.w[c] = w[c];
    }
    for (int c = C; c < AGG_MAX_ROWS; ++c) {
        p.rows[c] = nullptr;
        p.w[c] = 0.0f;
    }
    p.acc = acc;
    p.out = out;
    p.n = n;
    p.nvec = 0;
    p.C = C;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
}
