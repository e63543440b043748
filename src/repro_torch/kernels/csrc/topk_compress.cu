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
// so device memory bounds it.  This first design reads x and r six times
// (four radix passes, a count pass and a write pass); at the main path's
// n = 1.2M the 9.7 MB of x and r stay in the 50 MB L2 after the first pass.
//
// The design, without sorting anything:
//   1. Radix select of the k-th largest key T, 8 bits a pass from the top:
//      each pass builds a 256-bin histogram of the keys that match the
//      prefix chosen so far (shared-memory atomics, merged into device
//      memory with global atomics), then a one-block step scans the bins
//      from the top and fixes the next 8 bits of T and how many of the keys
//      equal to the prefix are still to be taken.  No value returns to the
//      host: every output size is known there from k.
//   2. Stable compaction in index order: per-block counts of key > T and
//      key == T over contiguous chunks, an exclusive scan over the blocks,
//      then a write pass that emits every key > T and the first
//      (k - count(key > T)) keys == T, so idx comes out ascending; the same
//      pass writes vals and new_res.
//
// Plain C interface, loaded with ctypes.  Every launch goes to the caller's
// stream; nothing synchronises and nothing is allocated here (the caller
// passes TOPK_SCRATCH_WORDS words of device scratch).  The return value is
// the first CUDA error of the launch sequence, 0 on success, -1 for
// arguments out of range.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TOPK_THREADS 256
#define TOPK_MAX_BLOCKS 1024           // compaction blocks (one scan block)
#define TOPK_PREFIX 1024               // scratch word: the key bits chosen
#define TOPK_KREM 1025                 // scratch word: keys == T to take
#define TOPK_GT 1026                   // scratch: per-block count key > T
#define TOPK_EQ (TOPK_GT + TOPK_MAX_BLOCKS)   // per-block count key == T
#define TOPK_SCRATCH_WORDS (TOPK_EQ + TOPK_MAX_BLOCKS)

__device__ __forceinline__ unsigned topk_key(float f) {
    return __float_as_uint(f) & 0x7fffffffu;
}

// Pass p in 0..3 counts digit (key >> (24 - 8p)) & 255 over the keys whose
// higher bits equal the prefix chosen by passes 0..p-1.
__global__ void topk_hist(const float* __restrict__ x, const float* r,
                          long long n, unsigned* __restrict__ scratch,
                          int pass) {
    __shared__ unsigned sh[256];
    for (int b = threadIdx.x; b < 256; b += blockDim.x) sh[b] = 0u;
    __syncthreads();
    const int shift = 24 - 8 * pass;
    const unsigned mask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
    const unsigned prefix = scratch[TOPK_PREFIX];
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const unsigned key = topk_key(x[i] + r[i]);
        if ((key & mask) == prefix) atomicAdd(&sh[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    unsigned* hist = scratch + 256 * pass;
    for (int b = threadIdx.x; b < 256; b += blockDim.x) {
        if (sh[b]) atomicAdd(&hist[b], sh[b]);
    }
}

// One block of 256 threads: thread t holds bin 255 - t (descending digit
// order); an inclusive scan gives how many keys rank at or above each bin,
// and the one thread whose bin holds the krem-th key fixes the digit.
__global__ void topk_pick(unsigned* scratch, int pass, unsigned k) {
    __shared__ unsigned s[256];
    __shared__ unsigned krem_sh;
    const int t = threadIdx.x;
    const unsigned h = scratch[256 * pass + 255 - t];
    s[t] = h;
    if (t == 0) krem_sh = pass == 0 ? k : scratch[TOPK_KREM];
    __syncthreads();
    for (int off = 1; off < 256; off <<= 1) {
        const unsigned v = t >= off ? s[t - off] : 0u;
        __syncthreads();
        s[t] += v;
        __syncthreads();
    }
    const unsigned krem = krem_sh;
    const unsigned before = s[t] - h;
    if (before < krem && krem <= s[t]) {
        scratch[TOPK_KREM] = krem - before;
        scratch[TOPK_PREFIX] |= (unsigned)(255 - t) << (24 - 8 * pass);
    }
}

__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* sh) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) sh[warp] = v;
    __syncthreads();
    unsigned tot = 0u;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += sh[w];
    __syncthreads();
    return tot;
}

// Block b counts key > T and key == T over its chunk [b*chunk, (b+1)*chunk).
__global__ void topk_count(const float* __restrict__ x, const float* r,
                           long long n, long long chunk,
                           unsigned* __restrict__ scratch) {
    __shared__ unsigned sh[TOPK_THREADS / 32];
    const unsigned T = scratch[TOPK_PREFIX];
    const long long lo = (long long)blockIdx.x * chunk;
    const long long hi = lo + chunk < n ? lo + chunk : n;
    unsigned gt = 0u, eq = 0u;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const unsigned key = topk_key(x[i] + r[i]);
        gt += key > T;
        eq += key == T;
    }
    gt = block_sum(gt, sh);
    eq = block_sum(eq, sh);
    if (threadIdx.x == 0) {
        scratch[TOPK_GT + blockIdx.x] = gt;
        scratch[TOPK_EQ + blockIdx.x] = eq;
    }
}

// One block of TOPK_MAX_BLOCKS threads: exclusive scans of the per-block
// counts, in place.
__global__ void topk_scan(unsigned* scratch, int nb) {
    __shared__ unsigned sg[TOPK_MAX_BLOCKS], se[TOPK_MAX_BLOCKS];
    const int t = threadIdx.x;
    const unsigned g = t < nb ? scratch[TOPK_GT + t] : 0u;
    const unsigned e = t < nb ? scratch[TOPK_EQ + t] : 0u;
    sg[t] = g;
    se[t] = e;
    __syncthreads();
    for (int off = 1; off < TOPK_MAX_BLOCKS; off <<= 1) {
        const unsigned vg = t >= off ? sg[t - off] : 0u;
        const unsigned ve = t >= off ? se[t - off] : 0u;
        __syncthreads();
        sg[t] += vg;
        se[t] += ve;
        __syncthreads();
    }
    if (t < nb) {
        scratch[TOPK_GT + t] = sg[t] - g;
        scratch[TOPK_EQ + t] = se[t] - e;
    }
}

// Block b walks its chunk in index order, a tile of blockDim elements at a
// time.  An element's output slot is the number of selected elements before
// it: (keys > T before it) + min(keys == T before it, krem).  Each r[i] is
// read and new_res[i] written by the same thread, so new_res may be r.
__global__ void topk_write(const float* __restrict__ x, const float* r,
                           long long n, long long chunk,
                           const unsigned* __restrict__ scratch,
                           int* __restrict__ idx, float* __restrict__ vals,
                           float* new_res) {
    __shared__ unsigned wg[TOPK_THREADS / 32], we[TOPK_THREADS / 32];
    const unsigned T = scratch[TOPK_PREFIX];
    const unsigned take_eq = scratch[TOPK_KREM];
    unsigned g_base = scratch[TOPK_GT + blockIdx.x];
    unsigned e_base = scratch[TOPK_EQ + blockIdx.x];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const long long lo = (long long)blockIdx.x * chunk;
    const long long hi = lo + chunk < n ? lo + chunk : n;
    for (long long base = lo; base < hi; base += blockDim.x) {
        const long long i = base + threadIdx.x;
        const bool in = i < hi;
        float f = 0.0f;
        unsigned key = 0u;
        if (in) {
            f = x[i] + r[i];
            key = topk_key(f);
        }
        const bool g = in && key > T;
        const bool e = in && key == T;
        const unsigned bg = __ballot_sync(0xffffffffu, g);
        const unsigned be = __ballot_sync(0xffffffffu, e);
        if (lane == 0) {
            wg[warp] = __popc(bg);
            we[warp] = __popc(be);
        }
        __syncthreads();
        unsigned pg = 0u, pe = 0u, tg = 0u, te = 0u;
        for (int w = 0; w < nwarps; ++w) {
            if (w < warp) {
                pg += wg[w];
                pe += we[w];
            }
            tg += wg[w];
            te += we[w];
        }
        const unsigned g_before = g_base + pg + __popc(bg & lt);
        const unsigned e_before = e_base + pe + __popc(be & lt);
        const bool sel = g || (e && e_before < take_eq);
        if (in) {
            if (sel) {
                const unsigned pos =
                    g_before + (e_before < take_eq ? e_before : take_eq);
                idx[pos] = (int)i;
                vals[pos] = f;
            }
            new_res[i] = sel ? 0.0f : f;
        }
        g_base += tg;
        e_base += te;
        __syncthreads();      // the warp counts are rewritten next tile
    }
}

extern "C" int topk_compress_scratch_words(void) { return TOPK_SCRATCH_WORDS; }

// x, r: n device floats (r may be new_res); idx: k ints; vals: k floats;
// new_res: n floats; scratch: TOPK_SCRATCH_WORDS device words.
extern "C" int topk_compress_launch(const float* x, const float* r,
                                    long long n, int k, int* idx,
                                    float* vals, float* new_res,
                                    unsigned* scratch, void* stream) {
    if (n < 1 || n > INT_MAX || k < 1 || (long long)k > n) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(
        scratch, 0, TOPK_SCRATCH_WORDS * sizeof(unsigned), s);
    if (err != cudaSuccess) return (int)err;

    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) {
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    long long hist_blocks = (n + TOPK_THREADS - 1) / TOPK_THREADS;
    if (hist_blocks > (long long)sms * 8) hist_blocks = (long long)sms * 8;
    for (int pass = 0; pass < 4; ++pass) {
        topk_hist<<<(unsigned)hist_blocks, TOPK_THREADS, 0, s>>>(
            x, r, n, scratch, pass);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        topk_pick<<<1, 256, 0, s>>>(scratch, pass, (unsigned)k);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }

    // chunks of whole tiles, at most TOPK_MAX_BLOCKS of them
    long long nb = (n + TOPK_THREADS - 1) / TOPK_THREADS;
    if (nb > TOPK_MAX_BLOCKS) nb = TOPK_MAX_BLOCKS;
    long long chunk = (n + nb - 1) / nb;
    chunk = (chunk + TOPK_THREADS - 1) / TOPK_THREADS * TOPK_THREADS;
    nb = (n + chunk - 1) / chunk;
    topk_count<<<(unsigned)nb, TOPK_THREADS, 0, s>>>(x, r, n, chunk, scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    topk_scan<<<1, TOPK_MAX_BLOCKS, 0, s>>>(scratch, (int)nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    topk_write<<<(unsigned)nb, TOPK_THREADS, 0, s>>>(
        x, r, n, chunk, scratch, idx, vals, new_res);
    return (int)cudaGetLastError();
}
