// Stable LSD radix sort of (u64 key, int32 row) pairs over up to k integer
// keys. Its clients left: packed_merge.cu (kernel D) sorts through it, and
// compact.cuh takes its tile helpers and its one-block scan of the tile
// counts. (Every other sort goes through onesweep.cuh: grouped_stats.cu,
// sample_sort_merge.cu, and keychain.cuh's chain for index_merge.cu,
// scan.cu and sort_perm.cu.)
//
// Keys arrive as int64 whose signed order is the desired order (u64 lanes
// are mapped by flipping bit 63 on the host); (key - lo) taken as u64 is
// then an order-preserving unsigned digit source, and only the 8-bit
// digits below the bit length of (max - lo) are sorted.
//
// Each pass: a per-tile digit histogram, one exclusive scan over the
// (digit, tile) counts in digit-major order, and a stable scatter in which
// every element's rank inside its tile follows input order (warp match for
// ranks inside a warp, per-warp digit counts for the warps before it, a
// running count for the earlier sub-tiles). Stability of every pass makes
// the LSD chain lexicographic, and the initial order of `perm` breaks ties.
//
// The row count may live on the device (`len_dev`, written by an earlier
// kernel such as a partition): every kernel reads min(*len_dev, n), so no
// host synchronisation is needed between the partition and the sort.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int RADIX = 256;
constexpr int SCAN_THREADS = 1024;
static_assert(RADIX == THREADS, "one thread per digit in hist and scatter");

__device__ inline int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// rows in play: n, or fewer when a device-side count is given
__device__ inline int64_t rows(int64_t n, const int32_t* len_dev) {
    return len_dev ? imin((int64_t)*len_dev, n) : n;
}

inline unsigned blocks_for(int64_t n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

inline int64_t tiles_for(int64_t n) { return n > 0 ? (n + TILE - 1) / TILE : 1; }

// u[i] = key[perm[i]] - lo, as u64
__global__ void gather_kernel(const int64_t* __restrict__ key, uint64_t lo,
                              const int32_t* __restrict__ perm,
                              uint64_t* __restrict__ u, int64_t n,
                              const int32_t* __restrict__ len_dev) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < rows(n, len_dev)) u[i] = (uint64_t)key[perm[i]] - lo;
}

// hist[d * num_tiles + tile] = count of digit d in the tile
__global__ void __launch_bounds__(THREADS)
hist_kernel(const uint64_t* __restrict__ u, int64_t n, const int32_t* __restrict__ len_dev,
            int shift, int64_t num_tiles, int32_t* __restrict__ hist) {
    __shared__ int32_t h[RADIX];
    const int t = threadIdx.x;
    h[t] = 0;
    __syncthreads();
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int64_t te = imin(ts + TILE, rows(n, len_dev));
    for (int64_t i = ts + t; i < te; i += THREADS) {
        atomicAdd(&h[(u[i] >> shift) & (RADIX - 1)], 1);
    }
    __syncthreads();
    hist[(int64_t)t * num_tiles + blockIdx.x] = h[t];
}

// in-place exclusive scan of data[0, m), one block
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int32_t* __restrict__ data, int64_t m) {
    __shared__ int32_t sums[SCAN_THREADS];
    const int t = threadIdx.x;
    const int64_t chunk = (m + SCAN_THREADS - 1) / SCAN_THREADS;
    const int64_t lo = imin((int64_t)t * chunk, m);
    const int64_t hi = imin(lo + chunk, m);
    int32_t s = 0;
    for (int64_t i = lo; i < hi; ++i) s += data[i];
    sums[t] = s;
    __syncthreads();
    for (int d = 1; d < SCAN_THREADS; d <<= 1) {
        const int32_t x = t >= d ? sums[t - d] : 0;
        __syncthreads();
        sums[t] += x;
        __syncthreads();
    }
    int32_t run = sums[t] - s;
    for (int64_t i = lo; i < hi; ++i) {
        const int32_t x = data[i];
        data[i] = run;
        run += x;
    }
}

// stable scatter of one digit pass; offs = scanned hist
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const uint64_t* __restrict__ u_in, const int32_t* __restrict__ p_in,
               uint64_t* __restrict__ u_out, int32_t* __restrict__ p_out,
               const int32_t* __restrict__ offs, int64_t n,
               const int32_t* __restrict__ len_dev, int shift, int64_t num_tiles) {
    __shared__ int32_t base[RADIX];
    __shared__ int32_t running[RADIX];
    __shared__ int32_t wc[WARPS][RADIX];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    base[t] = offs[(int64_t)t * num_tiles + blockIdx.x];
    running[t] = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) wc[w][t] = 0;
    __syncthreads();
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int64_t te = imin(ts + TILE, rows(n, len_dev));
    const unsigned lt_mask = (1u << lane) - 1u;
    for (int it = 0; it < ITEMS; ++it) {
        const int64_t row = ts + (int64_t)it * THREADS + t;
        const bool valid = row < te;
        uint64_t x = 0;
        int32_t p = 0;
        int d = RADIX;  // invalid lanes group on a digit no valid lane has
        if (valid) {
            x = u_in[row];
            p = p_in[row];
            d = (int)((x >> shift) & (RADIX - 1));
        }
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int rank = __popc(peers & lt_mask);
        if (valid && rank == 0) wc[warp][d] = __popc(peers);
        __syncthreads();
        if (valid) {
            int32_t pos = base[d] + running[d] + rank;
            for (int w = 0; w < warp; ++w) pos += wc[w][d];
            u_out[pos] = x;
            p_out[pos] = p;
        }
        __syncthreads();
        int32_t tot = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            tot += wc[w][t];
            wc[w][t] = 0;
        }
        running[t] += tot;
        __syncthreads();
    }
}

// Bytes of the hist scratch for n rows.
inline int64_t hist_bytes(int64_t n) {
    return (int64_t)RADIX * tiles_for(n) * (int64_t)sizeof(int32_t);
}

struct Sorted {
    int32_t* perm;  // buffer holding the final permutation
    uint64_t* u;    // buffer holding the last sorted key's (key - lo)
};

// Ping-pong buffers of the digit passes: (ua, pa) hold the current order.
struct Buffers {
    int32_t* pa;
    int32_t* pb;
    uint64_t* ua;
    uint64_t* ub;
};

// `digits` LSD passes over the u64 keys ua[0, rows), carrying pa along;
// afterwards (b.ua, b.pa) hold the stably sorted keys and rows. hist holds
// hist_bytes(n). All launches on `s`.
inline void passes(int digits, int64_t n, const int32_t* len_dev, Buffers& b, int32_t* hist,
                   cudaStream_t s) {
    const int64_t num_tiles = tiles_for(n);
    for (int dg = 0; dg < digits; ++dg) {
        const int shift = 8 * dg;
        hist_kernel<<<(unsigned)num_tiles, THREADS, 0, s>>>(b.ua, n, len_dev, shift, num_tiles,
                                                            hist);
        scan_kernel<<<1, SCAN_THREADS, 0, s>>>(hist, (int64_t)RADIX * num_tiles);
        scatter_kernel<<<(unsigned)num_tiles, THREADS, 0, s>>>(
            b.ua, b.pa, b.ub, b.pb, hist, n, len_dev, shift, num_tiles);
        uint64_t* tu = b.ua; b.ua = b.ub; b.ub = tu;
        int32_t* tp = b.pa; b.pa = b.pb; b.pb = tp;
    }
}

// LSD passes over keys[num_keys - 1] .. keys[0] (most significant first in
// the array), reordering perm[0, rows) in place of a stable sort. perm must
// be initialised by the caller (iota, or a partition); perm_tmp, ua and ub
// are n-row buffers; hist holds hist_bytes(n). The result lives in one of
// the two perm/u buffers, as returned. All launches on `s`.
inline Sorted sort(const void* const* keys, const int64_t* lo, const int32_t* digits,
                   int32_t num_keys, int64_t n, const int32_t* len_dev, int32_t* perm,
                   int32_t* perm_tmp, uint64_t* ua, uint64_t* ub, int32_t* hist,
                   cudaStream_t s) {
    Buffers b{perm, perm_tmp, ua, ub};
    if (n == 0) return {b.pa, b.ua};
    for (int ki = num_keys - 1; ki >= 0; --ki) {
        if (digits[ki] <= 0) continue;
        gather_kernel<<<blocks_for(n, 256), 256, 0, s>>>(
            static_cast<const int64_t*>(keys[ki]), (uint64_t)lo[ki], b.pa, b.ua, n, len_dev);
        passes(digits[ki], n, len_dev, b, hist, s);
    }
    return {b.pa, b.ua};
}

}  // namespace radix
