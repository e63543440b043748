// Hierarchical-aggregation fold for Hopper: out = acc + sum_c w_c * D_c.
//
// Replaces the Pallas TPU kernel repro/kernels/agg_weighted_sum.py:_agg_kernel
// (the fold LocalAggregator runs for every micro-batch and client block).
//
// Two forms share one streaming body:
//
// * leaves: a client block read where it lies, as a table of segments -- one
//   a stacked parameter leaf, or one for a whole (C, n) block: its base
//   pointer, its row stride in elements, its dtype and its offset in the flat
//   buffer.  The segments tile the launch's range [lo, hi) of the flat buffer
//   in order, so the (C, n) block the TPU path concatenates is never built.
//   Up to MAX_SEGS segments ride in one launch's parameter block (6 KB: the
//   32 KB parameter space of CUDA 12.1 and later); a longer table is folded
//   by several launches over disjoint ranges.
// * rows: C separately staged buffers of one dtype, a device pointer each
//   (the micro-batch flush).
//
// What bounds it: every byte is touched once and each element costs C fused
// multiply-adds, about 0.5 FLOP per byte, so it is bound by device memory:
// (C * itemsize + 8) * n bytes (C rows read, acc read, out written) at
// 3.35 TB/s on an H100 SXM.
//
// What the design does about that bound:
// * one resident wave: the grid is at most SMs x the kernel's occupancy
//   (queried once a device and cached) blocks of 128 threads; a thread takes
//   one 8-element unit (32 B of acc) a trip, and each trip of the grid covers
//   one window of adjacent units.  The leaves kernels fit 56 registers (the
//   fp32 build), so 9 blocks an SM cover the main path's 150,930 units in
//   one trip;
// * a thread issues the 16-byte loads of acc first, before it looks up its
//   unit's segment, and then those of a batch of up to 4 rows before its
//   first FMA;
// * no search stands between a thread and its rows: the launcher puts the
//   segment of each block's first element in the parameters, and a thread
//   steps from there to its own unit's segment;
// * every load keeps the default cache policy: an evict-first hint on the
//   rows made the cold fold faster at the main path's shape but pushed the
//   rows out of L2 before the call after, which then ran slower than the
//   kernel this one replaced (PERF.md);
// * a unit that is ragged, crosses a segment's edge, or whose rows are not
//   16-byte aligned in the same phase as acc takes the scalar edge, element
//   by element.  Nothing reads or writes a misaligned vector;
// * the leaves kernel is built for all-fp32, all-bf16 and mixed segment
//   tables: reading each segment's dtype bit costs the mixed build 61
//   registers against the fp32 build's 56 and made the main path's
//   all-fp32 fold 15 % slower (PERF.md).
//
// Every element is acc + w_0 d_0 + w_1 d_1 + ... with fmaf, in client order
// and in fp32, on every path (vector, scalar edge, either form), so the two
// forms agree bit for bit.  out may alias acc (the in-place fold: each
// element is read and written by one thread).
//
// Plain C interface, loaded with ctypes.  The launches go to the caller's
// stream, do not synchronise and allocate nothing; the return value is
// cudaGetLastError() after the last launch, or -1 for arguments out of
// range.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#define THREADS 128                  // threads a block
#define ROW_BATCH 4                  // rows a thread loads before its FMAs
#define MAX_ROWS 64
#define MAX_SEGS 150
#define MAX_BLOCKS 2048              // blocks a leaves launch
#define UNIT 8                       // elements a unit: 32 B of acc

#define SEG_STRIDE_MASK ((1LL << 60) - 1)
#define SEG_VEC (1LL << 61)          // rows in acc's 16-byte phase
#define SEG_BF16 (1LL << 62)

struct Seg {
    const char* base;     // row 0, element 0 of the leaf
    long long meta;       // row stride in elements | SEG_BF16 | SEG_VEC
    long long off;        // flat offset of element 0
};

struct LeavesParams {
    float w[MAX_ROWS];
    const float* acc;
    float* out;
    long long lo, hi;     // this launch's flat range
    long long unit0;      // first unit: lo / UNIT
    long long units;      // units from unit0 that reach into [lo, hi)
    int C;
    int nseg;
    int vec;              // acc and out 16-byte aligned
    Seg seg[MAX_SEGS + 1];   // seg[nseg].off == hi
    unsigned char first_seg[MAX_BLOCKS];   // the segment of a block's first
                                           // element
};

static_assert(sizeof(LeavesParams) <= 32764, "kernel parameter space");

struct RowsParams {
    const char* rows[MAX_ROWS];
    float w[MAX_ROWS];
    const float* acc;
    float* out;
    long long n;
    long long units;
    int C;
    int vec;              // acc, out and every row 16-byte aligned
};

// Where a vector unit's rows start.
struct UnitRef {
    const char* r0;       // leaves: row 0 at the unit's first element
    long long cs;         // leaves: bytes from one row to the next
    long long i0;         // the unit's first flat element
    bool bf16;
};

__device__ __forceinline__ uint4 ld16(const char* p) {
    return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void widen(const uint4 (&r)[2], bool bf16,
                                      float (&f)[UNIT]) {
    if (bf16) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[0]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float2 t = __bfloat1622float2(h[k]);
            f[2 * k] = t.x;
            f[2 * k + 1] = t.y;
        }
    } else {
        f[0] = __uint_as_float(r[0].x); f[1] = __uint_as_float(r[0].y);
        f[2] = __uint_as_float(r[0].z); f[3] = __uint_as_float(r[0].w);
        f[4] = __uint_as_float(r[1].x); f[5] = __uint_as_float(r[1].y);
        f[6] = __uint_as_float(r[1].z); f[7] = __uint_as_float(r[1].w);
    }
}

__device__ __forceinline__ float load_scalar(const char* p, bool bf16) {
    return bf16 ? __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p))
                : *reinterpret_cast<const float*>(p);
}

// Segment dtypes of a leaves launch: all fp32, all bf16, or mixed (read
// from each segment's dtype bit).
enum { LEAVES_FP32 = 0, LEAVES_BF16 = 1, LEAVES_MIXED = 2 };

// The leaves form's rows.  A thread's units rise from one trip to the next
// and its elements within a unit, so one segment cursor serves the vector
// units and the scalar edge and only moves forward.
template <int MODE>
struct LeafSource {
    const LeavesParams& p;
    int s;                // the segment of the last unit or element located

    // the last segment at or after `from` that starts at or before i
    __device__ int find(int from, long long i) const {
        int lo = from, hi = p.nseg - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (p.seg[mid].off <= i) lo = mid; else hi = mid - 1;
        }
        return lo;
    }
    // a step or two within a block's window, a search past it
    __device__ void seek(long long i) {
        if (p.seg[s + 1].off > i) return;
        ++s;
        if (p.seg[s + 1].off <= i) s = find(s + 1, i);
    }
    __device__ static bool is_bf16(long long meta) {
        return MODE == LEAVES_MIXED ? (meta & SEG_BF16) != 0
                                    : MODE == LEAVES_BF16;
    }
    // acc and out hold the unit as two aligned 16-byte vectors
    __device__ bool full_unit(long long i0) const {
        return p.vec && i0 >= p.lo && i0 + UNIT <= p.hi;
    }
    // the rows of a full unit, if they can be read as vectors
    __device__ bool vector_unit(long long i0, UnitRef& u) {
        seek(i0);
        const Seg& g = p.seg[s];
        if (i0 + UNIT > p.seg[s + 1].off || !(g.meta & SEG_VEC)) return false;
        u.bf16 = is_bf16(g.meta);
        const int isz = u.bf16 ? 2 : 4;
        u.r0 = g.base + (i0 - g.off) * isz;
        u.cs = (g.meta & SEG_STRIDE_MASK) * isz;
        u.i0 = i0;
        return true;
    }
    __device__ const char* row(const UnitRef& u, int c) const {
        return u.r0 + c * u.cs;
    }
    __device__ bool owns(long long i) const { return i >= p.lo && i < p.hi; }
    __device__ float value(long long i, int c) {
        seek(i);
        const Seg& g = p.seg[s];
        const bool bf = is_bf16(g.meta);
        const long long j = c * (g.meta & SEG_STRIDE_MASK) + (i - g.off);
        return load_scalar(g.base + j * (bf ? 2 : 4), bf);
    }
};

template <bool BF16>
struct RowSource {
    const RowsParams& p;

    __device__ bool full_unit(long long i0) const {
        return p.vec && i0 + UNIT <= p.n;
    }
    __device__ bool vector_unit(long long i0, UnitRef& u) const {
        u.i0 = i0;
        u.bf16 = BF16;
        return true;
    }
    __device__ const char* row(const UnitRef& u, int c) const {
        return p.rows[c] + u.i0 * (BF16 ? 2 : 4);
    }
    __device__ bool owns(long long i) const { return i < p.n; }
    __device__ float value(long long i, int c) const {
        return load_scalar(p.rows[c] + i * (BF16 ? 2 : 4), BF16);
    }
};

// The scalar edge: the same operations as a vector unit, element by
// element.
template <class Src>
__device__ __forceinline__ void fold_scalar_unit(Src& src, const float* w,
                                                 int C, const float* acc,
                                                 float* out, long long q) {
    for (int e = 0; e < UNIT; ++e) {
        const long long i = q * UNIT + e;
        if (!src.owns(i)) continue;
        float s = acc[i];
        for (int c = 0; c < C; ++c) s = fmaf(w[c], src.value(i, c), s);
        out[i] = s;
    }
}

// a[] += w_c * row c of a vector unit, c in [0, C) in order: the loads of
// a batch of ROW_BATCH rows are issued before its FMAs.
template <class Src>
__device__ __forceinline__ void fold_rows(const Src& src, const UnitRef& u,
                                          const float* w, int C,
                                          float (&a)[UNIT]) {
    for (int c0 = 0; c0 < C; c0 += ROW_BATCH) {
        uint4 raw[ROW_BATCH][2];
#pragma unroll
        for (int r = 0; r < ROW_BATCH; ++r) {
            if (c0 + r < C) {
                const char* pr = src.row(u, c0 + r);
                raw[r][0] = ld16(pr);
                raw[r][1] = u.bf16 ? raw[r][0] : ld16(pr + 16);
            }
        }
#pragma unroll
        for (int r = 0; r < ROW_BATCH; ++r) {
            if (c0 + r < C) {
                float f[UNIT];
                widen(raw[r], u.bf16, f);
                const float wc = w[c0 + r];
#pragma unroll
                for (int e = 0; e < UNIT; ++e) a[e] = fmaf(wc, f[e], a[e]);
            }
        }
    }
}

// The streaming body: this thread's units q, q + step, ... below q_end.
template <class Src>
__device__ __forceinline__ void fold_units(Src& src, const float* w, int C,
                                           const float* acc, float* out,
                                           long long q, long long step,
                                           long long q_end) {
    for (; q < q_end; q += step) {
        const long long i0 = q * UNIT;
        const bool full = src.full_unit(i0);
        float a[UNIT];
        if (full) {
            const float4* pa = reinterpret_cast<const float4*>(acc + i0);
            const float4 x = pa[0], y = pa[1];
            a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
            a[4] = y.x; a[5] = y.y; a[6] = y.z; a[7] = y.w;
        }
        UnitRef u;
        if (!full || !src.vector_unit(i0, u)) {
            fold_scalar_unit(src, w, C, acc, out, q);
            continue;
        }
        fold_rows(src, u, w, C, a);
        float4* po = reinterpret_cast<float4*>(out + i0);
        po[0] = make_float4(a[0], a[1], a[2], a[3]);
        po[1] = make_float4(a[4], a[5], a[6], a[7]);
    }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
agg_leaves_kernel(const __grid_constant__ LeavesParams p) {
    LeafSource<MODE> src{p, p.first_seg[blockIdx.x]};
    fold_units(src, p.w, p.C, p.acc, p.out,
               p.unit0 + (long long)blockIdx.x * THREADS + threadIdx.x,
               (long long)gridDim.x * THREADS, p.unit0 + p.units);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
agg_rows_kernel(const __grid_constant__ RowsParams p) {
    RowSource<BF16> src{p};
    fold_units(src, p.w, p.C, p.acc, p.out,
               (long long)blockIdx.x * THREADS + threadIdx.x,
               (long long)gridDim.x * THREADS, p.units);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

#define MAX_DEVICES 64

struct DevInfo {
    std::atomic<bool> ready{false};
    int sms = 132;
    int occ[5] = {1, 1, 1, 1, 1};   // leaves fp32, bf16, mixed; rows fp32, bf16
};

static DevInfo g_dev[MAX_DEVICES];

template <class K>
static cudaError_t occupancy(K kernel, int* out) {
    int o = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o, kernel, THREADS, 0);
    *out = o > 0 ? o : 1;
    return e;
}

// SM count and the kernels' occupancy for the current device, queried on
// its first launch only.  Concurrent first calls write the same values.
static int device_info(const DevInfo** out) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    DevInfo& d = g_dev[dev];
    if (!d.ready.load(std::memory_order_acquire)) {
        int sms = 0;
        if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
            (e = occupancy(agg_leaves_kernel<LEAVES_FP32>, &d.occ[0])) != cudaSuccess ||
            (e = occupancy(agg_leaves_kernel<LEAVES_BF16>, &d.occ[1])) != cudaSuccess ||
            (e = occupancy(agg_leaves_kernel<LEAVES_MIXED>, &d.occ[2])) != cudaSuccess ||
            (e = occupancy(agg_rows_kernel<false>, &d.occ[3])) != cudaSuccess ||
            (e = occupancy(agg_rows_kernel<true>, &d.occ[4])) != cudaSuccess) {
            return (int)e;
        }
        d.sms = sms > 0 ? sms : 1;
        d.ready.store(true, std::memory_order_release);
    }
    *out = &d;
    return 0;
}

// One resident wave at most (and at most `cap` blocks); fewer blocks when
// one trip of the grid covers every unit.
static unsigned grid_for(long long units, int sms, int occ, long long cap) {
    long long wave = (long long)sms * occ;
    if (wave > cap) wave = cap;
    const long long g = (units + THREADS - 1) / THREADS;
    return (unsigned)(g < 1 ? 1 : g > wave ? wave : g);
}

static inline bool aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// The rows form.  rows: C device pointers; w: C host floats; dtype: 0 =
// fp32 rows, 1 = bf16.
extern "C" int agg_weighted_sum_launch(const void* const* rows, int C,
                                       const float* w, const float* acc,
                                       float* out, long long n, int dtype,
                                       void* stream) {
    if (C < 1 || C > MAX_ROWS || n < 0 || (dtype != 0 && dtype != 1) ||
        rows == nullptr) {
        return -1;
    }
    if (n == 0) return 0;
    const DevInfo* d = nullptr;
    const int rc = device_info(&d);
    if (rc != 0) return rc;
    RowsParams p;
    bool vec = aligned16(acc) && aligned16(out);
    for (int c = 0; c < MAX_ROWS; ++c) {
        const char* r = c < C ? static_cast<const char*>(rows[c]) : nullptr;
        vec = vec && (c >= C || aligned16(r));
        p.rows[c] = r;
        p.w[c] = c < C ? w[c] : 0.0f;
    }
    p.acc = acc;
    p.out = out;
    p.n = n;
    p.units = (n + UNIT - 1) / UNIT;
    p.C = C;
    p.vec = vec;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = grid_for(p.units, d->sms, d->occ[3 + dtype],
                                     1LL << 30);
    if (dtype == 0) {
        agg_rows_kernel<false><<<blocks, THREADS, 0, s>>>(p);
    } else {
        agg_rows_kernel<true><<<blocks, THREADS, 0, s>>>(p);
    }
    return (int)cudaGetLastError();
}

// The leaves form.  table: nseg triples (base pointer, row stride in
// elements | 1 << 62 for bf16, flat offset), then the end offset; the
// segments tile [table[2], end) in order, each non-empty.  *launches gets
// the number of kernels launched: one for every MAX_SEGS segments.
extern "C" int agg_fold_leaves_launch(const long long* table, int nseg, int C,
                                      const float* w, const float* acc,
                                      float* out, void* stream,
                                      int* launches) {
    *launches = 0;
    if (C < 1 || C > MAX_ROWS || nseg < 1) return -1;
    const DevInfo* d = nullptr;
    const int rc = device_info(&d);
    if (rc != 0) return rc;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    LeavesParams p;
    for (int c = 0; c < MAX_ROWS; ++c) p.w[c] = c < C ? w[c] : 0.0f;
    p.acc = acc;
    p.out = out;
    p.C = C;
    p.vec = aligned16(acc) && aligned16(out);
    for (int s0 = 0; s0 < nseg; s0 += MAX_SEGS) {
        const int m = nseg - s0 < MAX_SEGS ? nseg - s0 : MAX_SEGS;
        int any_bf16 = 0, all_bf16 = 1;
        for (int k = 0; k < m; ++k) {
            const long long* e = table + 3 * (s0 + k);
            const long long meta = e[1] & (SEG_STRIDE_MASK | SEG_BF16);
            const bool bf16 = (meta & SEG_BF16) != 0;
            const int isz = bf16 ? 2 : 4;
            const uintptr_t base = (uintptr_t)e[0];
            const uintptr_t stride_b = (uintptr_t)(meta & SEG_STRIDE_MASK) * isz;
            const bool vec = ((base - (uintptr_t)e[2] * isz) & 15u) == 0 &&
                             (C == 1 || (stride_b & 15u) == 0);
            p.seg[k].base = reinterpret_cast<const char*>(base);
            p.seg[k].meta = meta | (vec ? SEG_VEC : 0);
            p.seg[k].off = e[2];
            any_bf16 |= bf16;
            all_bf16 &= bf16;
        }
        p.nseg = m;
        const int mode = all_bf16 ? LEAVES_BF16
                                  : any_bf16 ? LEAVES_MIXED : LEAVES_FP32;
        p.lo = table[3 * s0 + 2];
        p.hi = s0 + m < nseg ? table[3 * (s0 + m) + 2] : table[3 * nseg];
        p.seg[m].base = nullptr;
        p.seg[m].meta = 0;
        p.seg[m].off = p.hi;
        p.unit0 = p.lo / UNIT;
        p.units = (p.hi + UNIT - 1) / UNIT - p.unit0;
        const unsigned blocks = grid_for(p.units, d->sms, d->occ[mode],
                                         MAX_BLOCKS);
        for (unsigned b = 0, k = 0; b < blocks; ++b) {
            long long i = (p.unit0 + (long long)b * THREADS) * UNIT;
            if (i < p.lo) i = p.lo;
            while (k + 1 < (unsigned)m && p.seg[k + 1].off <= i) ++k;
            p.first_seg[b] = (unsigned char)k;
        }
        if (mode == LEAVES_FP32) {
            agg_leaves_kernel<LEAVES_FP32><<<blocks, THREADS, 0, s>>>(p);
        } else if (mode == LEAVES_BF16) {
            agg_leaves_kernel<LEAVES_BF16><<<blocks, THREADS, 0, s>>>(p);
        } else {
            agg_leaves_kernel<LEAVES_MIXED><<<blocks, THREADS, 0, s>>>(p);
        }
        ++*launches;
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
