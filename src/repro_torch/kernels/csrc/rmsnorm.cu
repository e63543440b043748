// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * g over the last axis,
// computed in fp32, written in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py:_rmsnorm_kernel
// (launched by rmsnorm, reached through repro/kernels/ops.py rmsnorm).  The
// TPU kernel walks blocks of 256 rows and pads the tail rows with 1.0 only to
// fill its last block; this kernel has no row blocks (a warp owns a row and
// masks nothing but the ragged end of that row), so it needs no padding.
//
// What bounds it.  One call must read x and g and write y: at the hymba-1.5b
// prefill shape (T = 4096 rows, d = 1600, bf16) that is 26.2 MB, or 7.8 us at
// 3.35 TB/s; its 4 operations an element are 0.03 GFLOP, far below any
// arithmetic limit.  So it is bound by bytes, and the design is to read each
// element from device memory once and move it in 16-byte vectors.
//
// Design.  One warp per row, eight rows a block of 256 threads.  Each lane
// loads 16-byte packs (8 bf16 or 4 fp32 values) at a 512-byte stride along
// the row, sums their squares in fp32, and the warp adds its 32 partial sums
// with xor-shuffles.  The scale is 1 / sqrtf(mean + eps) (IEEE square root
// and division, as the CPU's rsqrt rounds), then a second pass over the same
// row (from L1/L2, where the first pass left it) multiplies by the scale and
// by g in fp32 and rounds once to x's dtype.  Rows whose length or base is
// not a multiple of 16 bytes take the same loop one element at a time.  g may
// be fp32 or bf16 whatever x is.
//
// Plain C interface, loaded with ctypes.  The launch goes to the caller's
// stream, does not synchronise and allocates nothing; the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define RN_THREADS 256
#define RN_ROWS (RN_THREADS / 32)

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void from_f(float* p, float x) { *p = x; }
__device__ inline void from_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);   // round to nearest even, as astype does
}

// VEC: elements of a 16-byte pack, or 1 for the scalar path
template <typename TX, typename TG, int VEC>
__global__ void __launch_bounds__(RN_THREADS)
rmsnorm_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
               TX* __restrict__ y, long long T, int d, long long sx,
               float eps) {
    const int lane = threadIdx.x % 32;
    const long long row = (long long)blockIdx.x * RN_ROWS + threadIdx.x / 32;
    if (row >= T) return;
    const TX* xr = x + row * sx;
    TX* yr = y + row * (long long)d;

    float ss = 0.f;
    for (int i = lane * VEC; i < d; i += 32 * VEC) {
        alignas(16) TX buf[VEC];
        if constexpr (VEC > 1) {
            *reinterpret_cast<int4*>(buf) = *reinterpret_cast<const int4*>(xr + i);
        } else {
            buf[0] = xr[i];
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const float v = to_f(buf[j]);
            ss = fmaf(v, v, ss);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = 1.0f / sqrtf(ss / (float)d + eps);

    for (int i = lane * VEC; i < d; i += 32 * VEC) {
        alignas(16) TX buf[VEC];
        if constexpr (VEC > 1) {
            *reinterpret_cast<int4*>(buf) = *reinterpret_cast<const int4*>(xr + i);
        } else {
            buf[0] = xr[i];
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j)
            from_f(&buf[j], to_f(buf[j]) * r * to_f(g[i + j]));
        if constexpr (VEC > 1) {
            *reinterpret_cast<int4*>(yr + i) = *reinterpret_cast<const int4*>(buf);
        } else {
            yr[i] = buf[0];
        }
    }
}

template <typename TX, typename TG>
static int launch(const void* x, const void* g, void* y, long long T, int d,
                  long long sx, float eps, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(TX);
    const bool vec = d % VEC == 0 && sx % VEC == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0
        && reinterpret_cast<uintptr_t>(y) % 16 == 0;
    const dim3 grid((unsigned)((T + RN_ROWS - 1) / RN_ROWS));
    const TX* xp = static_cast<const TX*>(x);
    const TG* gp = static_cast<const TG*>(g);
    TX* yp = static_cast<TX*>(y);
    if (vec)
        rmsnorm_kernel<TX, TG, VEC><<<grid, RN_THREADS, 0, stream>>>(
            xp, gp, yp, T, d, sx, eps);
    else
        rmsnorm_kernel<TX, TG, 1><<<grid, RN_THREADS, 0, stream>>>(
            xp, gp, yp, T, d, sx, eps);
    return (int)cudaGetLastError();
}

extern "C" {

// x: T rows of d elements, row stride sx elements, unit stride along d;
// g: d elements; y: T x d contiguous.  x_dtype / g_dtype: 0 = fp32,
// 1 = bf16.  Returns 0 or a cudaError_t.
int rmsnorm_launch(const void* x, const void* g, void* y, long long T, int d,
                   long long sx, int x_dtype, int g_dtype, float eps,
                   void* stream) {
    if (T <= 0 || d <= 0 || T > 2147483647LL * RN_ROWS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_dtype == 0 && g_dtype == 0)
        return launch<float, float>(x, g, y, T, d, sx, eps, s);
    if (x_dtype == 0 && g_dtype == 1)
        return launch<float, __nv_bfloat16>(x, g, y, T, d, sx, eps, s);
    if (x_dtype == 1 && g_dtype == 0)
        return launch<__nv_bfloat16, float>(x, g, y, T, d, sx, eps, s);
    if (x_dtype == 1 && g_dtype == 1)
        return launch<__nv_bfloat16, __nv_bfloat16>(x, g, y, T, d, sx, eps, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
