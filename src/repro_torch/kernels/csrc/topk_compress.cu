// Fused error-feedback top-k for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/topk_compress.py:_topk_kernel
// (the codec TopKCompressor runs on every targeted span of an executor's
// partial before it crosses the wire).
//
// What it computes, for one span of n fp32 values x and its residual r:
//   f = x + r                      (one fp32 add, as the plain version does)
//   idx  = the k indices of largest |f|, exact ties to the LOWER index,
//          written in ascending order (int32)
//   vals = f[idx]
//   new_res = f with idx zeroed    (may be written over r: the in-place
//                                   residual update of the error feedback)
//
// The ranking key is key(f) = bits(f) & 0x7fffffff compared as an unsigned
// integer: the magnitude order for finite values and infinities, -0.0 ties
// +0.0, and NaNs rank above +inf ordered by their payload bits -- the order
// lax.top_k gives |f| on the JAX side, and the order the plain PyTorch
// version (a stable descending sort of the same key) gives.
//
// What bounds it: each input is read and each output written once at least,
// (12 n + 8 k) bytes, against a handful of integer operations per element,
// so device memory bounds it: 4.4 us at the main path's n = 1.2M.  At that
// size the first design was bound by its launches instead: a memset and 11
// kernels a span, two of them one block wide.  This one is bound by its
// grid-wide syncs and the latency of the small scans between them.
//
// The design: ONE cooperative launch a span, a persistent grid of one block
// of 512 threads an SM, each block owning a contiguous chunk of the span,
// with grid-wide syncs between six phases.  Nothing returns to the host and
// no phase runs on one block: every block redoes the small scans from the
// merged global counts and gets the same answer.
//   1. Zero the global histograms (their words are first touched after the
//      next sync).  Read the chunk once from device memory, keep f = x + r in
//      shared memory when the chunk fits (TK_CACHE values, every span up to
//      SMs x TK_CACHE; longer spans read x and r again in phases 3 and 6),
//      and build the chunk's histogram of digit 0 -- key bits 30..20, the
//      exponent and 3 mantissa bits -- with shared-memory atomics.
//   2. Merge the block histograms into the global one (one atomic per
//      non-empty bin).
//   3. Pick digit 0 of the k-th largest key T (a block-wide scan of the
//      2048 bins from the top) and how many keys of its bin are still to be
//      taken.  Count the chunk's keys above that bin, and compact the keys
//      IN it (the candidates) into the block's region of a candidate buffer
//      (n words in all: every key of a span may share one bin), building
//      the histogram of digit 1 (bits 19..10) of the candidates.
//   4. Pick digit 1; histogram digit 2 (bits 9..0) of the candidates that
//      match it.  Only the candidates are read.
//   5. Pick digit 2: T and take_eq, the number of keys equal to T that are
//      taken.  Each block counts its keys > T and == T (from its count of
//      phase 3 and its candidates) into per-block slots.
//   6. Each block takes its exclusive offsets from the counts of the blocks
//      before it and walks its chunk in index order, writing every key > T
//      and the first take_eq keys == T: idx ascending, vals, and new_res for
//      every element.  A cached chunk is walked by each thread over its own
//      run of consecutive elements, after one block scan of their counts;
//      an uncached one tile by tile, a scan of warp ballots a tile.
//
// Plain C interface, loaded with ctypes.  The launch goes to the caller's
// stream; nothing synchronises and nothing is allocated here (the caller
// passes topk_compress_scratch_words(n) words of device scratch, which need
// no zeroing).  The return value is the CUDA error of the launch, 0 on
// success, -1 for arguments out of range.  A grid that cannot be resident
// at once is refused by the cooperative launch, and that error is returned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define TK_THREADS 512
#define TK_WARPS (TK_THREADS / 32)
#define TK_UNROLL 8               // loads in flight a thread, phases 1 and 3
#define TK_WUNROLL 4              // elements a thread a tile, phase 6
#define TK_CHUNK_ALIGN 128        // chunks are whole 512-byte lines
#define TK_CACHE 16384            // f values a block keeps in shared memory
#define TK_BINS0 2048             // digit 0: key bits 30..20
#define TK_BINS12 1024            // digits 1 and 2: bits 19..10, 9..0
#define TK_H0 0                   // scratch words: digit-0 histogram
#define TK_H1 (TK_H0 + TK_BINS0)  //                digit-1 histogram
#define TK_H2 (TK_H1 + TK_BINS12) //                digit-2 histogram
#define TK_COUNTS (TK_H2 + TK_BINS12)   // then G counts key > T, G == T,
                                        // then G regions of chunk candidates

// Phase timestamps, compiled in only with -DTOPK_PHASE_STAMPS (for
// scripts/topk_phase_probe.py): thread 0 of block b writes %globaltimer
// into topk_stamps[b][p] at the start (p = 0), before and after each grid
// sync (p = 2s-1, 2s for sync s = 1..5) and at the end (p = 11).
#ifdef TOPK_PHASE_STAMPS
#define TK_STAMPS 12
__device__ unsigned long long topk_stamps[4096 * TK_STAMPS];
#define TK_STAMP(p)                                                      \
    do {                                                                 \
        if (threadIdx.x == 0) {                                          \
            unsigned long long t_;                                       \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));       \
            topk_stamps[blockIdx.x * TK_STAMPS + (p)] = t_;              \
        }                                                                \
    } while (0)
extern "C" int topk_compress_stamps(unsigned long long* host, int words) {
    return (int)cudaMemcpyFromSymbol(host, topk_stamps,
                                     words * sizeof(unsigned long long));
}
#else
#define TK_STAMP(p) do { } while (0)
#endif
#define TK_SYNC(s)                                                       \
    do {                                                                 \
        TK_STAMP(2 * (s) - 1);                                           \
        grid.sync();                                                     \
        TK_STAMP(2 * (s));                                               \
    } while (0)

__device__ __forceinline__ unsigned topk_key(float f) {
    return __float_as_uint(f) & 0x7fffffffu;
}

// Block-wide sums of two values; sh holds 2 * TK_WARPS words.
__device__ __forceinline__ void block_sum2(unsigned& a, unsigned& b,
                                           unsigned* sh) {
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, o);
        b += __shfl_down_sync(0xffffffffu, b, o);
    }
    if ((threadIdx.x & 31) == 0) {
        sh[threadIdx.x >> 5] = a;
        sh[TK_WARPS + (threadIdx.x >> 5)] = b;
    }
    __syncthreads();
    a = b = 0u;
#pragma unroll
    for (int w = 0; w < TK_WARPS; ++w) {
        a += sh[w];
        b += sh[TK_WARPS + w];
    }
    __syncthreads();
}

// Block-wide exclusive prefix sums of two values, in thread order; sh holds
// 2 * TK_WARPS words.
__device__ __forceinline__ void block_excl2(unsigned& a, unsigned& b,
                                            unsigned* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned ia = a, ib = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned va = __shfl_up_sync(0xffffffffu, ia, o);
        const unsigned vb = __shfl_up_sync(0xffffffffu, ib, o);
        if (lane >= o) {
            ia += va;
            ib += vb;
        }
    }
    if (lane == 31) {
        sh[warp] = ia;
        sh[TK_WARPS + warp] = ib;
    }
    __syncthreads();
    a = ia - a;
    b = ib - b;
    for (int w = 0; w < warp; ++w) {
        a += sh[w];
        b += sh[TK_WARPS + w];
    }
    __syncthreads();
}

// The bin of a global histogram of NB bins that holds the krem-th largest
// key, counting from the top bin, and how many keys of that bin are still
// to be taken (krem less the keys of the bins above it).  Thread t holds
// bins NB-1-t*PER .. NB-PER-t*PER; the block scans their sums.
template <int NB>
__device__ void block_pick(const unsigned* hist, unsigned krem,
                           unsigned* sh_w, unsigned* sh_out,
                           unsigned& bin, unsigned& krem_out) {
    constexpr int PER = NB / TK_THREADS;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    unsigned c[PER];
    unsigned s = 0u;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        c[q] = __ldcg(hist + (NB - 1 - (t * PER + q)));
        s += c[q];
    }
    unsigned inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
    }
    if (lane == 31) sh_w[warp] = inc;
    __syncthreads();
    unsigned before = inc - s;
    for (int w = 0; w < warp; ++w) before += sh_w[w];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        if (before < krem && krem <= before + c[q]) {
            sh_out[0] = (unsigned)(NB - 1 - (t * PER + q));
            sh_out[1] = krem - before;
        }
        before += c[q];
    }
    __syncthreads();
    bin = sh_out[0];
    krem_out = sh_out[1];
    __syncthreads();
}

__global__ void __launch_bounds__(TK_THREADS, 1)
topk_kernel(const float* __restrict__ x, const float* r, long long n,
            unsigned k, long long chunk, int* __restrict__ idx,
            float* __restrict__ vals, float* new_res,
            unsigned* __restrict__ scratch) {
    cg::grid_group grid = cg::this_grid();
    TK_STAMP(0);
    extern __shared__ float fc[];          // the chunk's f, when it fits
    __shared__ unsigned sh_hist[TK_BINS0];
    __shared__ unsigned sh_w[2 * TK_WARPS];
    __shared__ unsigned sh_out[2];
    __shared__ unsigned sh_ncand;
    __shared__ unsigned cnt_g[TK_WUNROLL * TK_WARPS], cnt_e[TK_WUNROLL * TK_WARPS];
    __shared__ unsigned pre_g[TK_WUNROLL * TK_WARPS], pre_e[TK_WUNROLL * TK_WARPS];
    __shared__ unsigned tile_g, tile_e;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const unsigned G = gridDim.x;
    const long long lo = (long long)blockIdx.x * chunk;
    const long long hi = lo + chunk < n ? lo + chunk : n;
    const bool cached = chunk <= TK_CACHE;
    unsigned* hist0 = scratch + TK_H0;
    unsigned* hist1 = scratch + TK_H1;
    unsigned* hist2 = scratch + TK_H2;
    unsigned* cnt_gt = scratch + TK_COUNTS;
    unsigned* cnt_eq = cnt_gt + G;
    unsigned* cand = cnt_eq + G + (long long)blockIdx.x * chunk;
    // f of element i of this chunk (hi > i >= lo), after phase 1
    auto f_at = [&](long long i) -> float {
        return cached ? fc[i - lo] : x[i] + r[i];
    };

    // 1. zero the global histograms; read the chunk, keep f; digit-0
    // histogram of the chunk
    for (long long w = (long long)blockIdx.x * TK_THREADS + tid; w < TK_COUNTS;
         w += (long long)G * TK_THREADS)
        scratch[w] = 0u;
    for (int b = tid; b < TK_BINS0; b += TK_THREADS) sh_hist[b] = 0u;
    __syncthreads();
    for (long long base = lo; base < hi; base += TK_THREADS * TK_UNROLL) {
        float f[TK_UNROLL];
#pragma unroll
        for (int u = 0; u < TK_UNROLL; ++u) {
            const long long i = base + u * TK_THREADS + tid;
            f[u] = i < hi ? x[i] + r[i] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < TK_UNROLL; ++u) {
            const long long i = base + u * TK_THREADS + tid;
            if (i < hi) {
                if (cached) fc[i - lo] = f[u];
                atomicAdd(&sh_hist[topk_key(f[u]) >> 20], 1u);
            }
        }
    }
    __syncthreads();
    TK_SYNC(1);

    // 2. merge into the global digit-0 histogram
    for (int b = tid; b < TK_BINS0; b += TK_THREADS)
        if (sh_hist[b]) atomicAdd(&hist0[b], sh_hist[b]);
    TK_SYNC(2);

    // 3. digit 0; candidates and their digit-1 histogram
    unsigned d0, krem;
    block_pick<TK_BINS0>(hist0, k, sh_w, sh_out, d0, krem);
    for (int b = tid; b < TK_BINS12; b += TK_THREADS) sh_hist[b] = 0u;
    if (tid == 0) sh_ncand = 0u;
    __syncthreads();
    unsigned ngt = 0u;
    for (long long base = lo; base < hi; base += TK_THREADS * TK_UNROLL) {
        unsigned key[TK_UNROLL];
#pragma unroll
        for (int u = 0; u < TK_UNROLL; ++u) {
            const long long i = base + u * TK_THREADS + tid;
            key[u] = i < hi ? topk_key(f_at(i)) : 0u;
        }
#pragma unroll
        for (int u = 0; u < TK_UNROLL; ++u) {
            if (base + u * TK_THREADS + tid >= hi) continue;
            const unsigned dg = key[u] >> 20;
            ngt += dg > d0;
            if (dg == d0) {
                cand[atomicAdd(&sh_ncand, 1u)] = key[u];
                atomicAdd(&sh_hist[(key[u] >> 10) & (TK_BINS12 - 1)], 1u);
            }
        }
    }
    __syncthreads();
    const unsigned ncand = sh_ncand;
    for (int b = tid; b < TK_BINS12; b += TK_THREADS)
        if (sh_hist[b]) atomicAdd(&hist1[b], sh_hist[b]);
    unsigned unused = 0u;
    block_sum2(ngt, unused, sh_w);
    TK_SYNC(3);

    // 4. digit 1; digit-2 histogram of the candidates that match it
    unsigned d1;
    block_pick<TK_BINS12>(hist1, krem, sh_w, sh_out, d1, krem);
    for (int b = tid; b < TK_BINS12; b += TK_THREADS) sh_hist[b] = 0u;
    __syncthreads();
    for (unsigned j = tid; j < ncand; j += TK_THREADS) {
        const unsigned key = cand[j];
        if (((key >> 10) & (TK_BINS12 - 1)) == d1)
            atomicAdd(&sh_hist[key & (TK_BINS12 - 1)], 1u);
    }
    __syncthreads();
    for (int b = tid; b < TK_BINS12; b += TK_THREADS)
        if (sh_hist[b]) atomicAdd(&hist2[b], sh_hist[b]);
    TK_SYNC(4);

    // 5. digit 2: T and take_eq; this block's counts of key > T and == T
    unsigned d2, take_eq;
    block_pick<TK_BINS12>(hist2, krem, sh_w, sh_out, d2, take_eq);
    const unsigned T = (d0 << 20) | (d1 << 10) | d2;
    unsigned gt = 0u, eq = 0u;
    for (unsigned j = tid; j < ncand; j += TK_THREADS) {
        const unsigned key = cand[j];
        gt += key > T;
        eq += key == T;
    }
    block_sum2(gt, eq, sh_w);
    if (tid == 0) {
        cnt_gt[blockIdx.x] = ngt + gt;
        cnt_eq[blockIdx.x] = eq;
    }
    TK_SYNC(5);

    // 6. offsets from the blocks before this one; stable write in index
    // order.
    unsigned g_base = 0u, e_base = 0u;
    for (unsigned b = tid; b < blockIdx.x; b += TK_THREADS) {
        g_base += __ldcg(cnt_gt + b);
        e_base += __ldcg(cnt_eq + b);
    }
    block_sum2(g_base, e_base, sh_w);
    if (cached) {
        // Thread t walks its own run of S consecutive elements of the cached
        // chunk: counts, one block scan for its offsets, the selected
        // entries written and zeroed in the cache, then new_res in one
        // coalesced pass.
        const int len = (int)(hi - lo);
        const int S = (len + TK_THREADS - 1) / TK_THREADS;
        const int a = tid * S < len ? tid * S : len;
        const int z = a + S < len ? a + S : len;
        unsigned cg_ = 0u, ce = 0u;
#pragma unroll 4
        for (int j = a; j < z; ++j) {
            const unsigned key = topk_key(fc[j]);
            cg_ += key > T;
            ce += key == T;
        }
        block_excl2(cg_, ce, sh_w);
        unsigned gb = g_base + cg_, eb = e_base + ce;
#pragma unroll 4
        for (int j = a; j < z; ++j) {
            const float f = fc[j];
            const unsigned key = topk_key(f);
            const bool g = key > T, e = key == T;
            if (g || (e && eb < take_eq)) {
                const unsigned pos = gb + (eb < take_eq ? eb : take_eq);
                idx[pos] = (int)(lo + j);
                vals[pos] = f;
                fc[j] = 0.0f;
            }
            gb += g;
            eb += e;
        }
        __syncthreads();
#pragma unroll 4
        for (int j = tid; j < len; j += TK_THREADS) new_res[lo + j] = fc[j];
        TK_STAMP(11);
        return;
    }
    // Element (u, t) of a tile is base + u*TK_THREADS + t, so the tile's
    // order is u, then warp, then lane.
    for (long long base = lo; base < hi; base += TK_THREADS * TK_WUNROLL) {
        float f[TK_WUNROLL];
        bool g[TK_WUNROLL], e[TK_WUNROLL];
        unsigned bg[TK_WUNROLL], be[TK_WUNROLL];
#pragma unroll
        for (int u = 0; u < TK_WUNROLL; ++u) {
            const long long i = base + u * TK_THREADS + tid;
            f[u] = i < hi ? f_at(i) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < TK_WUNROLL; ++u) {
            const bool in = base + u * TK_THREADS + tid < hi;
            const unsigned key = topk_key(f[u]);
            g[u] = in && key > T;
            e[u] = in && key == T;
            bg[u] = __ballot_sync(0xffffffffu, g[u]);
            be[u] = __ballot_sync(0xffffffffu, e[u]);
            if (lane == 0) {
                cnt_g[u * TK_WARPS + warp] = __popc(bg[u]);
                cnt_e[u * TK_WARPS + warp] = __popc(be[u]);
            }
        }
        __syncthreads();
        if (warp == 0) {
            // exclusive scan of the TK_WUNROLL * TK_WARPS warp counts, PER
            // entries a lane
            constexpr int PER = TK_WUNROLL * TK_WARPS / 32;
            unsigned sg = 0u, se = 0u;
#pragma unroll
            for (int q = 0; q < PER; ++q) {
                sg += cnt_g[lane * PER + q];
                se += cnt_e[lane * PER + q];
            }
            unsigned ig = sg, ie = se;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned vg = __shfl_up_sync(0xffffffffu, ig, o);
                const unsigned ve = __shfl_up_sync(0xffffffffu, ie, o);
                if (lane >= o) {
                    ig += vg;
                    ie += ve;
                }
            }
            unsigned pg = ig - sg, pe = ie - se;
#pragma unroll
            for (int q = 0; q < PER; ++q) {
                pre_g[lane * PER + q] = pg;
                pre_e[lane * PER + q] = pe;
                pg += cnt_g[lane * PER + q];
                pe += cnt_e[lane * PER + q];
            }
            if (lane == 31) {
                tile_g = ig;
                tile_e = ie;
            }
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < TK_WUNROLL; ++u) {
            const long long i = base + u * TK_THREADS + tid;
            if (i >= hi) continue;
            const unsigned g_before =
                g_base + pre_g[u * TK_WARPS + warp] + __popc(bg[u] & lt);
            const unsigned e_before =
                e_base + pre_e[u * TK_WARPS + warp] + __popc(be[u] & lt);
            const bool sel = g[u] || (e[u] && e_before < take_eq);
            if (sel) {
                const unsigned pos =
                    g_before + (e_before < take_eq ? e_before : take_eq);
                idx[pos] = (int)i;
                vals[pos] = f[u];
            }
            new_res[i] = sel ? 0.0f : f[u];
        }
        g_base += tile_g;
        e_base += tile_e;
    }
    TK_STAMP(11);
}

// Co-resident blocks of topk_kernel on the current device (one an SM, with
// its shared-memory cache), cached per device; 0 on an error.
static long long max_blocks(void) {
    static long long cache[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (cache[dev] == 0) {
        const int smem = TK_CACHE * (int)sizeof(float);
        int sms = 0, per_sm = 0;
        if (cudaFuncSetAttribute(topk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem) != cudaSuccess
            || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
                != cudaSuccess
            || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, topk_kernel, TK_THREADS, smem) != cudaSuccess
            || per_sm < 1)
            return 0;
        cache[dev] = sms;
    }
    return cache[dev];
}

// Blocks and chunk length of a span of n; false on an error.
static bool plan(long long n, long long* G, long long* chunk) {
    const long long most = max_blocks();
    if (most < 1) return false;
    long long c = (n + most - 1) / most;
    c = (c + TK_CHUNK_ALIGN - 1) / TK_CHUNK_ALIGN * TK_CHUNK_ALIGN;
    *chunk = c;
    *G = (n + c - 1) / c;
    return true;
}

// Device scratch a span of n needs, in 32-bit words: the histograms, two
// counts a block, and a candidate region of one chunk a block (at least n
// words in all).  -1 on an error.
extern "C" long long topk_compress_scratch_words(long long n) {
    long long G, chunk;
    if (n < 1 || !plan(n, &G, &chunk)) return -1;
    return TK_COUNTS + 2 * G + G * chunk;
}

// The number of blocks of the launch for a span of n (for the record).
extern "C" long long topk_compress_blocks(long long n) {
    long long G, chunk;
    if (n < 1 || !plan(n, &G, &chunk)) return -1;
    return G;
}

// x, r: n device floats (r may be new_res); idx: k ints; vals: k floats;
// new_res: n floats; scratch: topk_compress_scratch_words(n) device words.
extern "C" int topk_compress_launch(const float* x, const float* r,
                                    long long n, int k, int* idx,
                                    float* vals, float* new_res,
                                    unsigned* scratch, void* stream) {
    if (n < 1 || n > INT_MAX || k < 1 || (long long)k > n) return -1;
    long long G, chunk;
    if (!plan(n, &G, &chunk)) {
        const cudaError_t err = cudaGetLastError();
        return err != cudaSuccess ? (int)err : (int)cudaErrorUnknown;
    }
    unsigned ku = (unsigned)k;
    void* args[] = {(void*)&x, (void*)&r, (void*)&n, (void*)&ku,
                    (void*)&chunk, (void*)&idx, (void*)&vals,
                    (void*)&new_res, (void*)&scratch};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)topk_kernel, dim3((unsigned)G), dim3(TK_THREADS), args,
        TK_CACHE * sizeof(float), static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) {
        cudaGetLastError();       // clear it; the caller raises
        return (int)err;
    }
    return (int)cudaGetLastError();
}
