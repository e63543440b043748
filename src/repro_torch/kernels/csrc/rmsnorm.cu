// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * g over the last axis,
// computed in fp32, written in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py:_rmsnorm_kernel
// (launched by rmsnorm, reached through repro/kernels/ops.py rmsnorm).  The
// TPU kernel walks blocks of 256 rows and pads the tail rows with 1.0 only to
// fill its last block; here a group of threads owns a row and masks nothing
// but the ragged end of that row, so nothing is padded.
//
// What bounds it.  One call must read x and g and write y: at the hymba-1.5b
// prefill shape (T = 4096 rows, d = 1600, bf16) that is 26.2 MB, or 7.8 us at
// 3.35 TB/s; its 4 operations an element are 0.03 GFLOP, far below any
// arithmetic limit.  So it is bound by bytes, and at the decode shape (T = 4,
// 12.8 KB) by one round trip to device memory and the launch.  The design is
// to read each element of x once, in 16-byte packs, and to have every load
// of a row in flight before any of them is used.
//
// Routes, picked by the launcher from T, d, the dtypes and the alignment:
//
//   rows      (T > RN_FEW_ROWS, d up to RN_MAX_PACKS packs a lane of a warp
//              group).  A row belongs to a group of 1, 2, 4 or 8 warps, the
//              fewest that hold it in at most RN_MAX_PACKS 16-byte packs a
//              lane; a block of 256 threads holds 8, 4, 2 or 1 rows.  Each
//              lane issues all its packs of x and of g before it uses any,
//              sums squares in fp32, the group adds its partial sums (xor
//              shuffles, then shared memory across its warps), and the lane
//              writes y from the packs it still holds: x is read once.
//   few rows  (T <= RN_FEW_ROWS: the decode's 4 rows).  The same kernel with
//              one row a block of up to 512 threads, the fewest packs a
//              thread, so that a call of 4 rows spreads over 4 SMs and every
//              load of the call is in flight at once: one round trip.
//   looped    (rows longer than either route holds in registers).  A block
//              per row walks it twice, four packs a thread in flight per
//              step; the second walk finds the row in L2.
//   scalar    (d, the row stride or a base not a multiple of 16 bytes, or g
//              not aligned to its pack).  A warp per row, one element at a
//              time, two walks, as the first port of this kernel did.
//
// g is read in packs at the same positions as x (16 bytes of x's dtype are
// 8 or 4 elements: 16, 32 or 8 bytes of g's), held in registers beside x.
// The scale is 1 / sqrtf(mean + eps) (IEEE square root and division, as the
// CPU's rsqrt rounds), then y = (x * scale) * g in fp32, rounded once to x's
// dtype.  g may be fp32 or bf16 whatever x is.
//
// g is a table of rows (one row for a plain call): row t of x reads g row
// t / rpg, gs elements apart (gs = 0 shares one row, and skips the division).  A vmapped call -- each
// client with its own g, or all sharing one -- is then one launch over the
// folded rows.
//
// The backward (rmsnorm_bwd_launch; it replaces no TPU kernel: the JAX package
// trains through its jnp norm, and this port's forward is the kernel on the
// card, so its gradient is one too).  With xh = x * r, r = rsqrt(mean(x^2) +
// eps): dx = r * dy * g - x * r^3 * sum(dy * g * x) / d and dg = sum over the
// rows of dy * xh, all in fp32, dx in x's dtype and dg in g's.  What bounds
// it: it must read x and dy and write dx (plus g and dg, one row each): at
// qwen2-0.5b's training rows (T = 4096, d = 896, bf16) 22.0 MB, or 6.6 us at
// 3.35 TB/s, far above its 8 operations an element.  So x and dy are read
// once.  Two routes, picked by the launcher from d, the dtypes and the
// alignment; each is two kernels, one launch on the wrapper's counter:
//
//   one pass  (rows in 16-byte packs, at most RN_BWD_MAX_PACKS a lane of
//              one warp: d <= 1,792 bf16, 896 fp32).  A block of 8 warps
//              owns a chunk of RN_BWD_CHUNK rows of one g row's segment; a
//              warp holds a row of x and dy in registers (and the segment's
//              g row, read once), with its next row's loads in flight, takes
//              both row sums, writes dx from the packs it holds, and adds
//              dy * x * r into its lanes' column partials.  The block adds
//              its warps' partials in warp order in shared memory and writes
//              one fp32 partial row per chunk.
//   two pass  (rows not in packs, or longer than a warp holds).  dx a warp a
//              row, walking it twice, r of each row into the workspace; then
//              a thread per column and a block per chunk sums the chunk's dy
//              * x * r into its partial row, reading x and dy again.
//
// Then the partial rows of each g row are summed in a fixed order (chunk by
// chunk within 8 interleaved groups, then the groups in order): no atomics,
// the same bits on every run.
//
// Plain C interface, loaded with ctypes.  The launch goes to the caller's
// stream, does not synchronise and allocates nothing (the backward's
// workspace comes from the wrapper: rmsnorm_bwd_workspace gives its size);
// the return value is cudaGetLastError() after the launch.  rmsnorm_route
// says which route a call takes, for the tests.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define RN_THREADS 256          // rows route: threads a block
#define RN_FEW_THREADS 512      // few-rows route: most threads a row
#define RN_LOOP_THREADS 512     // looped route: threads a row
#define RN_MAX_PACKS 8          // most 16-byte packs of x a lane holds
#define RN_FEW_ROWS 128         // T at or below this takes the few-rows route
#define RN_LOOP_UNROLL 4        // packs in flight a thread, looped route
#define RN_BWD_CHUNK 32         // rows a chunk: a block of the backward
#define RN_BWD_MAX_PACKS 7      // most packs of x a lane of the one pass holds
                                // (with dy's and the next row's: 8 spills)

enum { ROUTE_SCALAR = 0, ROUTE_ROWS = 1, ROUTE_FEW_ROWS = 2, ROUTE_LOOPED = 3 };

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void from_f(float* p, float x) { *p = x; }
__device__ inline void from_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);   // round to nearest even, as astype does
}

// One pack of x (16 bytes, VEC elements) and the VEC elements of g beside it
// (16, 32 or 8 bytes), loaded whole.
template <typename TX>
struct XPack {
    static constexpr int VEC = 16 / sizeof(TX);
    alignas(16) TX v[VEC];
    __device__ inline void load(const TX* p) {
        *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(p);
    }
    __device__ inline void store(TX* p) const {
        *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(v);
    }
};

template <typename TG, int VEC>
struct GPack {
    static constexpr int BYTES = VEC * (int)sizeof(TG);
    alignas(16) TG v[VEC];
    __device__ inline void load(const TG* p) {
        if constexpr (BYTES == 32) {
            reinterpret_cast<int4*>(v)[0] = __ldg(reinterpret_cast<const int4*>(p));
            reinterpret_cast<int4*>(v)[1] = __ldg(reinterpret_cast<const int4*>(p) + 1);
        } else if constexpr (BYTES == 16) {
            *reinterpret_cast<int4*>(v) = __ldg(reinterpret_cast<const int4*>(p));
        } else {
            static_assert(BYTES == 8, "g pack of 8, 16 or 32 bytes");
            *reinterpret_cast<int2*>(v) = __ldg(reinterpret_cast<const int2*>(p));
        }
    }
};

// Rows and few-rows routes.  A row belongs to tpr = 32 * wpr threads (wpr
// warps); a block holds blockDim.x / tpr rows.  Lane t of a row holds packs
// t, t + tpr, ..., t + (P - 1) * tpr.
template <typename TX, typename TG, int P>
__global__ void __launch_bounds__(RN_FEW_THREADS)
rms_reg_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
               TX* __restrict__ y, long long T, int d, long long sx,
               long long gs, long long rpg, float eps, int wpr) {
    constexpr int VEC = XPack<TX>::VEC;
    __shared__ float part[RN_FEW_THREADS / 32];
    const int tpr = 32 * wpr;
    const int t = threadIdx.x % tpr;
    const int rib = threadIdx.x / tpr;
    const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + rib;
    // no early return: a row of several warps meets at __syncthreads
    const bool live = row < T;
    const int packs = d / VEC;
    const TX* xr = x + (live ? row : 0LL) * sx;
    const TG* gr = gs ? g + (live ? row / rpg : 0LL) * gs : g;
    TX* yr = y + (live ? row : 0LL) * (long long)d;

    XPack<TX> xp[P];
    GPack<TG, VEC> gp[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        const int j = t + i * tpr;
        if (live && j < packs) xp[i].load(xr + (long long)j * VEC);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
        const int j = t + i * tpr;
        if (live && j < packs) gp[i].load(gr + j * VEC);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
        if (live && t + i * tpr < packs) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const float v = to_f(xp[i].v[e]);
                ss = fmaf(v, v, ss);
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (wpr > 1) {
        if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
        __syncthreads();
        ss = 0.f;
        for (int w = 0; w < wpr; ++w) ss += part[rib * wpr + w];
    }
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
#pragma unroll
    for (int i = 0; i < P; ++i) {
        const int j = t + i * tpr;
        if (live && j < packs) {
            XPack<TX> out;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                from_f(&out.v[e], to_f(xp[i].v[e]) * r * to_f(gp[i].v[e]));
            out.store(yr + (long long)j * VEC);
        }
    }
}

// Looped route: a block of RN_LOOP_THREADS per row, RN_LOOP_UNROLL packs a
// thread in flight per step, two walks.
template <typename TX, typename TG>
__global__ void __launch_bounds__(RN_LOOP_THREADS)
rms_loop_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                TX* __restrict__ y, int d, long long sx, long long gs,
                long long rpg, float eps) {
    constexpr int VEC = XPack<TX>::VEC;
    constexpr int U = RN_LOOP_UNROLL;
    __shared__ float part[RN_LOOP_THREADS / 32];
    const int t = threadIdx.x;
    const int nt = blockDim.x;
    const long long row = blockIdx.x;
    const TX* xr = x + row * sx;
    const TG* gr = gs ? g + (row / rpg) * gs : g;
    TX* yr = y + row * (long long)d;
    const int packs = d / VEC;

    float ss = 0.f;
    for (int base = t; base < packs; base += U * nt) {
        XPack<TX> xp[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (base + u * nt < packs) xp[u].load(xr + (long long)(base + u * nt) * VEC);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (base + u * nt < packs) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    const float v = to_f(xp[u].v[e]);
                    ss = fmaf(v, v, ss);
                }
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (t % 32 == 0) part[t / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < nt / 32; ++w) ss += part[w];
    const float r = 1.0f / sqrtf(ss / (float)d + eps);

    for (int base = t; base < packs; base += U * nt) {
        XPack<TX> xp[U];
        GPack<TG, VEC> gp[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = base + u * nt;
            if (j < packs) {
                xp[u].load(xr + (long long)j * VEC);
                gp[u].load(gr + j * VEC);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = base + u * nt;
            if (j < packs) {
                XPack<TX> out;
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    from_f(&out.v[e], to_f(xp[u].v[e]) * r * to_f(gp[u].v[e]));
                out.store(yr + (long long)j * VEC);
            }
        }
    }
}

// Scalar route: a warp per row, one element at a time, two walks.
template <typename TX, typename TG>
__global__ void __launch_bounds__(RN_THREADS)
rms_scalar_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                  TX* __restrict__ y, long long T, int d, long long sx,
                  long long gs, long long rpg, float eps) {
    const int lane = threadIdx.x % 32;
    const long long row = (long long)blockIdx.x * (RN_THREADS / 32)
        + threadIdx.x / 32;
    if (row >= T) return;
    const TX* xr = x + row * sx;
    const TG* gr = gs ? g + (row / rpg) * gs : g;
    TX* yr = y + row * (long long)d;
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
        const float v = to_f(xr[i]);
        ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    for (int i = lane; i < d; i += 32)
        from_f(&yr[i], to_f(xr[i]) * r * to_f(gr[i]));
}

// How a call is laid out: route, warps a row and packs a lane (register
// routes), blocks and threads a block.
struct Plan {
    int route, wpr, P;
    long long blocks;
    int threads;
};

static inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// whether rows of x and y (row strides sx and d) and g's rows can be read
// and written in 16-byte packs of x (g's beside them)
template <typename TX, typename TG>
static bool in_packs(const void* x, const void* g, const void* y, int d,
                     long long sx, long long gs) {
    constexpr int VEC = 16 / sizeof(TX);
    constexpr int GBYTES = VEC * (int)sizeof(TG);
    const int galign = GBYTES < 16 ? GBYTES : 16;
    return d % VEC == 0 && sx % VEC == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0
        && reinterpret_cast<uintptr_t>(y) % 16 == 0
        && reinterpret_cast<uintptr_t>(g) % galign == 0
        && (gs * (long long)sizeof(TG)) % galign == 0;
}

template <typename TX, typename TG>
static Plan plan(const void* x, const void* g, const void* y, long long T,
                 int d, long long sx, long long gs) {
    constexpr int VEC = 16 / sizeof(TX);
    Plan p{ROUTE_SCALAR, 1, 1, (T + RN_THREADS / 32 - 1) / (RN_THREADS / 32),
           RN_THREADS};
    if (!in_packs<TX, TG>(x, g, y, d, sx, gs)) return p;
    const int packs = d / VEC;
    if (T <= RN_FEW_ROWS && packs <= RN_FEW_THREADS * RN_MAX_PACKS) {
        int tpr = (packs + 31) / 32 * 32;
        if (tpr > RN_FEW_THREADS) tpr = RN_FEW_THREADS;
        return Plan{ROUTE_FEW_ROWS, tpr / 32, cdiv(packs, tpr), T, tpr};
    }
    if (packs <= RN_THREADS * RN_MAX_PACKS) {
        int wpr = 1;
        while (cdiv(packs, 32 * wpr) > RN_MAX_PACKS) wpr *= 2;
        const int rpb = RN_THREADS / (32 * wpr);
        return Plan{ROUTE_ROWS, wpr, cdiv(packs, 32 * wpr),
                    (T + rpb - 1) / rpb, RN_THREADS};
    }
    return Plan{ROUTE_LOOPED, RN_LOOP_THREADS / 32, RN_LOOP_UNROLL, T,
                RN_LOOP_THREADS};
}

template <typename TX, typename TG, int P>
static void launch_reg(const Plan& p, const TX* x, const TG* g, TX* y,
                       long long T, int d, long long sx, long long gs,
                       long long rpg, float eps, cudaStream_t s) {
    rms_reg_kernel<TX, TG, P><<<(unsigned)p.blocks, p.threads, 0, s>>>(
        x, g, y, T, d, sx, gs, rpg, eps, p.wpr);
}

template <typename TX, typename TG>
static int launch(const void* xv, const void* gv, void* yv, long long T,
                  int d, long long sx, long long gs, long long rpg, float eps,
                  cudaStream_t s) {
    const Plan p = plan<TX, TG>(xv, gv, yv, T, d, sx, gs);
    if (p.blocks < 1 || p.blocks > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    const TX* x = static_cast<const TX*>(xv);
    const TG* g = static_cast<const TG*>(gv);
    TX* y = static_cast<TX*>(yv);
    switch (p.route) {
    case ROUTE_SCALAR:
        rms_scalar_kernel<TX, TG><<<(unsigned)p.blocks, p.threads, 0, s>>>(
            x, g, y, T, d, sx, gs, rpg, eps);
        break;
    case ROUTE_LOOPED:
        rms_loop_kernel<TX, TG><<<(unsigned)p.blocks, p.threads, 0, s>>>(
            x, g, y, d, sx, gs, rpg, eps);
        break;
    default:
        switch (p.P) {
        case 1: launch_reg<TX, TG, 1>(p, x, g, y, T, d, sx, gs, rpg, eps, s); break;
        case 2: launch_reg<TX, TG, 2>(p, x, g, y, T, d, sx, gs, rpg, eps, s); break;
        case 3: launch_reg<TX, TG, 3>(p, x, g, y, T, d, sx, gs, rpg, eps, s); break;
        case 4: launch_reg<TX, TG, 4>(p, x, g, y, T, d, sx, gs, rpg, eps, s); break;
        case 5: launch_reg<TX, TG, 5>(p, x, g, y, T, d, sx, gs, rpg, eps, s); break;
        case 6: launch_reg<TX, TG, 6>(p, x, g, y, T, d, sx, gs, rpg, eps, s); break;
        case 7: launch_reg<TX, TG, 7>(p, x, g, y, T, d, sx, gs, rpg, eps, s); break;
        case 8: launch_reg<TX, TG, 8>(p, x, g, y, T, d, sx, gs, rpg, eps, s); break;
        default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}

template <typename TX, typename TG>
static int route_of(const void* x, const void* g, const void* y, long long T,
                    int d, long long sx, long long gs) {
    return plan<TX, TG>(x, g, y, T, d, sx, gs).route;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// One pass: block (segment * nch + chunk) of RN_THREADS / 32 warps, a row a
// warp at a time (lane t holds packs t, t + 32, ...), its next row in flight
template <typename TX, typename TG, int P>
__global__ void __launch_bounds__(RN_THREADS, 1)
rms_bwd_rows_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
                    const TG* __restrict__ g, TX* __restrict__ dx,
                    float* __restrict__ part, int d, long long sx,
                    long long gs, long long rpg, int nch, float eps) {
    constexpr int VEC = XPack<TX>::VEC;
    constexpr int WARPS = RN_THREADS / 32;
    extern __shared__ float colsum[];              // d floats
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const long long seg = blockIdx.x / nch;
    const long long r0 = seg * rpg + (long long)(blockIdx.x % nch) * RN_BWD_CHUNK;
    const long long r1 = min(r0 + RN_BWD_CHUNK, (seg + 1) * rpg);
    const int packs = d / VEC;
    const TG* gr = gs ? g + seg * gs : g;

    GPack<TG, VEC> gp[P];
    float acc[P][VEC];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        if (lane + 32 * i < packs) gp[i].load(gr + (lane + 32 * i) * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
    }
    XPack<TX> xp[P], yp[P];
    long long row = r0 + warp;
#pragma unroll
    for (int i = 0; i < P; ++i) {
        const int j = lane + 32 * i;
        if (row < r1 && j < packs) {
            xp[i].load(x + row * sx + (long long)j * VEC);
            yp[i].load(dy + row * (long long)d + (long long)j * VEC);
        }
    }
    for (; row < r1; row += WARPS) {
        const long long next = row + WARPS;
        XPack<TX> xn[P], yn[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int j = lane + 32 * i;
            if (next < r1 && j < packs) {
                xn[i].load(x + next * sx + (long long)j * VEC);
                yn[i].load(dy + next * (long long)d + (long long)j * VEC);
            }
        }
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < P; ++i) {
            if (lane + 32 * i < packs) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    const float xv = to_f(xp[i].v[e]);
                    s1 = fmaf(xv, xv, s1);
                    s2 = fmaf(to_f(yp[i].v[e]) * to_f(gp[i].v[e]), xv, s2);
                }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        const float r = 1.0f / sqrtf(s1 / (float)d + eps);
        const float c = r * r * r * (s2 / (float)d);
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int j = lane + 32 * i;
            if (j < packs) {
                XPack<TX> out;
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    const float xv = to_f(xp[i].v[e]);
                    const float dyv = to_f(yp[i].v[e]);
                    from_f(&out.v[e], r * (dyv * to_f(gp[i].v[e])) - xv * c);
                    acc[i][e] = fmaf(dyv, xv * r, acc[i][e]);
                }
                out.store(dx + row * (long long)d + (long long)j * VEC);
            }
        }
#pragma unroll
        for (int i = 0; i < P; ++i) {
            xp[i] = xn[i];
            yp[i] = yn[i];
        }
    }
    // the warps' column partials, added in warp order
    for (int w = 0; w < WARPS; ++w) {
        if (warp == w) {
#pragma unroll
            for (int i = 0; i < P; ++i) {
                const int j = lane + 32 * i;
                if (j < packs) {
#pragma unroll
                    for (int e = 0; e < VEC; ++e) {
                        const int col = j * VEC + e;
                        colsum[col] = (w ? colsum[col] : 0.f) + acc[i][e];
                    }
                }
            }
        }
        __syncthreads();
    }
    for (int col = threadIdx.x; col < d; col += RN_THREADS)
        part[(long long)blockIdx.x * d + col] = colsum[col];
}

// Two pass, dx: a warp per row; r of each row into rr for the dg kernel
template <typename TX, typename TG>
__global__ void __launch_bounds__(RN_THREADS)
rms_bwd_dx_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
                  const TG* __restrict__ g, TX* __restrict__ dx,
                  float* __restrict__ rr, long long T, int d, long long sx,
                  long long gs, long long rpg, float eps) {
    const int lane = threadIdx.x % 32;
    const long long row = (long long)blockIdx.x * (RN_THREADS / 32)
        + threadIdx.x / 32;
    if (row >= T) return;
    const TX* xr = x + row * sx;
    const TX* dyr = dy + row * (long long)d;
    const TG* gr = gs ? g + (row / rpg) * gs : g;
    TX* dxr = dx + row * (long long)d;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < d; i += 32) {
        const float xv = to_f(xr[i]);
        s1 = fmaf(xv, xv, s1);
        s2 = fmaf(to_f(dyr[i]) * to_f(gr[i]), xv, s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float r = 1.0f / sqrtf(s1 / (float)d + eps);
    const float c = r * r * r * (s2 / (float)d);
    if (lane == 0) rr[row] = r;
    for (int i = lane; i < d; i += 32)
        from_f(&dxr[i], r * (to_f(dyr[i]) * to_f(gr[i])) - to_f(xr[i]) * c);
}

// Two pass, dg partials: block (column block, segment * nch + chunk) sums its
// chunk's rows of dy * (x * r) for its columns into its own row of part
template <typename TX>
__global__ void __launch_bounds__(RN_THREADS)
rms_bwd_dg_part_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
                       const float* __restrict__ rr, float* __restrict__ part,
                       int d, long long sx, long long rpg, int nch) {
    const int col = blockIdx.x * RN_THREADS + threadIdx.x;
    if (col >= d) return;
    const long long seg = blockIdx.y / nch;
    const long long ch = blockIdx.y % nch;
    const long long r0 = seg * rpg + ch * RN_BWD_CHUNK;
    const long long r1 = min(r0 + RN_BWD_CHUNK, (seg + 1) * rpg);
    float acc = 0.f;
    for (long long row = r0; row < r1; ++row)
        acc = fmaf(to_f(dy[row * d + col]), to_f(x[row * sx + col]) * rr[row],
                   acc);
    part[(long long)blockIdx.y * d + col] = acc;
}

// dg: block (32-column block, g row); warp k sums chunks k, k + 8, ... of
// its 32 columns in order, then the 8 sums are added in warp order
template <typename TG>
__global__ void __launch_bounds__(RN_THREADS)
rms_bwd_dg_reduce_kernel(const float* __restrict__ part, TG* __restrict__ dg,
                         int d, int nch) {
    constexpr int WARPS = RN_THREADS / 32;
    __shared__ float red[WARPS][33];
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int col = blockIdx.x * 32 + lane;
    const long long v = blockIdx.y;
    float acc = 0.f;
    if (col < d)
        for (int ch = warp; ch < nch; ch += WARPS)
            acc += part[(v * nch + ch) * d + col];
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && col < d) {
        float t = 0.f;
        for (int w = 0; w < WARPS; ++w) t += red[w][lane];
        from_f(&dg[v * d + col], t);
    }
}

static long long bwd_chunks(long long rpg) {
    return (rpg + RN_BWD_CHUNK - 1) / RN_BWD_CHUNK;
}

enum { BWD_TWO_PASS = 0, BWD_ONE_PASS = 1 };

// the backward's route and, for the one pass, packs a lane
template <typename TX, typename TG>
static int bwd_plan(const void* x, const void* dy, const void* g,
                    const void* dx, int d, long long sx, long long gs,
                    int* P) {
    *P = (d / (16 / (int)sizeof(TX)) + 31) / 32;
    const bool one = in_packs<TX, TG>(x, g, dx, d, sx, gs)
        && reinterpret_cast<uintptr_t>(dy) % 16 == 0 && *P <= RN_BWD_MAX_PACKS;
    return one ? BWD_ONE_PASS : BWD_TWO_PASS;
}

template <typename TX, typename TG, int P>
static void launch_bwd_rows(const TX* x, const TX* dy, const TG* g, TX* dx,
                            float* part, long long blocks, int d, long long sx,
                            long long gs, long long rpg, int nch, float eps,
                            cudaStream_t s) {
    rms_bwd_rows_kernel<TX, TG, P><<<(unsigned)blocks, RN_THREADS,
                                      d * sizeof(float), s>>>(
        x, dy, g, dx, part, d, sx, gs, rpg, nch, eps);
}

template <typename TX, typename TG>
static int launch_bwd(const void* xv, const void* dyv, const void* gv,
                      void* dxv, void* dgv, float* ws, long long T, int d,
                      long long sx, long long gs, long long rpg, float eps,
                      cudaStream_t s) {
    const TX* x = static_cast<const TX*>(xv);
    const TX* dy = static_cast<const TX*>(dyv);
    const TG* g = static_cast<const TG*>(gv);
    TX* dx = static_cast<TX*>(dxv);
    const long long V = T / rpg;
    const long long nch = bwd_chunks(rpg);
    const long long dx_blocks = (T + RN_THREADS / 32 - 1) / (RN_THREADS / 32);
    if (dx_blocks > 2147483647LL || V * nch > 2147483647LL || V > 65535)
        return (int)cudaErrorInvalidValue;
    float* rr = ws;
    float* part = ws + T;
    int P = 1;
    if (bwd_plan<TX, TG>(xv, dyv, gv, dxv, d, sx, gs, &P) == BWD_ONE_PASS) {
        const long long nb = V * nch;
        switch (P) {
        case 1: launch_bwd_rows<TX, TG, 1>(x, dy, g, dx, part, nb, d, sx, gs, rpg, (int)nch, eps, s); break;
        case 2: launch_bwd_rows<TX, TG, 2>(x, dy, g, dx, part, nb, d, sx, gs, rpg, (int)nch, eps, s); break;
        case 3: launch_bwd_rows<TX, TG, 3>(x, dy, g, dx, part, nb, d, sx, gs, rpg, (int)nch, eps, s); break;
        case 4: launch_bwd_rows<TX, TG, 4>(x, dy, g, dx, part, nb, d, sx, gs, rpg, (int)nch, eps, s); break;
        case 5: launch_bwd_rows<TX, TG, 5>(x, dy, g, dx, part, nb, d, sx, gs, rpg, (int)nch, eps, s); break;
        case 6: launch_bwd_rows<TX, TG, 6>(x, dy, g, dx, part, nb, d, sx, gs, rpg, (int)nch, eps, s); break;
        case 7: launch_bwd_rows<TX, TG, 7>(x, dy, g, dx, part, nb, d, sx, gs, rpg, (int)nch, eps, s); break;
        default: return (int)cudaErrorInvalidValue;
        }
    } else {
        if (V * nch > 65535) return (int)cudaErrorInvalidValue;
        rms_bwd_dx_kernel<TX, TG><<<(unsigned)dx_blocks, RN_THREADS, 0, s>>>(
            x, dy, g, dx, rr, T, d, sx, gs, rpg, eps);
        const dim3 pgrid((d + RN_THREADS - 1) / RN_THREADS, (unsigned)(V * nch));
        rms_bwd_dg_part_kernel<TX><<<pgrid, RN_THREADS, 0, s>>>(
            x, dy, rr, part, d, sx, rpg, (int)nch);
    }
    const dim3 rgrid((d + 31) / 32, (unsigned)V);
    rms_bwd_dg_reduce_kernel<TG><<<rgrid, RN_THREADS, 0, s>>>(
        part, static_cast<TG*>(dgv), d, (int)nch);
    return (int)cudaGetLastError();
}

template <typename TX, typename TG>
static int bwd_route_of(const void* x, const void* dy, const void* g,
                        const void* dx, int d, long long sx, long long gs) {
    int P = 1;
    return bwd_plan<TX, TG>(x, dy, g, dx, d, sx, gs, &P);
}

extern "C" {

// x: T rows of d elements, row stride sx elements, unit stride along d;
// g: rows of d elements, gs elements apart (0: one shared row), row t of x
// reading g row t / rpg (rpg >= 1); y: T x d contiguous.  x_dtype /
// g_dtype: 0 = fp32, 1 = bf16.  Returns 0 or a cudaError_t.
int rmsnorm_launch(const void* x, const void* g, void* y, long long T, int d,
                   long long sx, long long gs, long long rpg, int x_dtype,
                   int g_dtype, float eps, void* stream) {
    if (T <= 0 || d <= 0 || rpg <= 0 || gs < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_dtype == 0 && g_dtype == 0)
        return launch<float, float>(x, g, y, T, d, sx, gs, rpg, eps, s);
    if (x_dtype == 0 && g_dtype == 1)
        return launch<float, __nv_bfloat16>(x, g, y, T, d, sx, gs, rpg, eps, s);
    if (x_dtype == 1 && g_dtype == 0)
        return launch<__nv_bfloat16, float>(x, g, y, T, d, sx, gs, rpg, eps, s);
    if (x_dtype == 1 && g_dtype == 1)
        return launch<__nv_bfloat16, __nv_bfloat16>(x, g, y, T, d, sx, gs, rpg,
                                                    eps, s);
    return (int)cudaErrorInvalidValue;
}

// The route rmsnorm_launch takes for these arguments: 0 scalar, 1 rows,
// 2 few rows, 3 looped; -1 for dtypes it does not take.
int rmsnorm_route(const void* x, const void* g, const void* y, long long T,
                  int d, long long sx, long long gs, int x_dtype,
                  int g_dtype) {
    if (x_dtype == 0 && g_dtype == 0)
        return route_of<float, float>(x, g, y, T, d, sx, gs);
    if (x_dtype == 0 && g_dtype == 1)
        return route_of<float, __nv_bfloat16>(x, g, y, T, d, sx, gs);
    if (x_dtype == 1 && g_dtype == 0)
        return route_of<__nv_bfloat16, float>(x, g, y, T, d, sx, gs);
    if (x_dtype == 1 && g_dtype == 1)
        return route_of<__nv_bfloat16, __nv_bfloat16>(x, g, y, T, d, sx, gs);
    return -1;
}

// fp32 elements of the backward's workspace: r for each of the T rows (the
// two-pass route's), then d partials for each RN_BWD_CHUNK-row chunk of each
// of the T / rpg segments (both routes)
long long rmsnorm_bwd_workspace(long long T, int d, long long rpg) {
    if (T <= 0 || d <= 0 || rpg <= 0 || T % rpg) return -1;
    return T + (T / rpg) * bwd_chunks(rpg) * (long long)d;
}

// The route rmsnorm_bwd_launch takes for these arguments: 0 two pass, 1 one
// pass; -1 for dtypes it does not take.
int rmsnorm_bwd_route(const void* x, const void* dy, const void* g,
                      const void* dx, int d, long long sx, long long gs,
                      int x_dtype, int g_dtype) {
    if (x_dtype == 0 && g_dtype == 0)
        return bwd_route_of<float, float>(x, dy, g, dx, d, sx, gs);
    if (x_dtype == 0 && g_dtype == 1)
        return bwd_route_of<float, __nv_bfloat16>(x, dy, g, dx, d, sx, gs);
    if (x_dtype == 1 && g_dtype == 0)
        return bwd_route_of<__nv_bfloat16, float>(x, dy, g, dx, d, sx, gs);
    if (x_dtype == 1 && g_dtype == 1)
        return bwd_route_of<__nv_bfloat16, __nv_bfloat16>(x, dy, g, dx, d, sx,
                                                          gs);
    return -1;
}

// The backward of rmsnorm_launch for the same x, g (gs, rpg; T % rpg == 0):
// dy and dx T x d contiguous in x's dtype, dg (T / rpg) x d contiguous in
// g's dtype; ws holds rmsnorm_bwd_workspace(T, d, rpg) floats.  Returns 0 or
// a cudaError_t.
int rmsnorm_bwd_launch(const void* x, const void* dy, const void* g, void* dx,
                       void* dg, float* ws, long long T, int d, long long sx,
                       long long gs, long long rpg, int x_dtype, int g_dtype,
                       float eps, void* stream) {
    if (T <= 0 || d <= 0 || rpg <= 0 || gs < 0 || T % rpg)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_dtype == 0 && g_dtype == 0)
        return launch_bwd<float, float>(x, dy, g, dx, dg, ws, T, d, sx, gs,
                                        rpg, eps, s);
    if (x_dtype == 0 && g_dtype == 1)
        return launch_bwd<float, __nv_bfloat16>(x, dy, g, dx, dg, ws, T, d,
                                                sx, gs, rpg, eps, s);
    if (x_dtype == 1 && g_dtype == 0)
        return launch_bwd<__nv_bfloat16, float>(x, dy, g, dx, dg, ws, T, d,
                                                sx, gs, rpg, eps, s);
    if (x_dtype == 1 && g_dtype == 1)
        return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, dy, g, dx, dg, ws,
                                                        T, d, sx, gs, rpg,
                                                        eps, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
