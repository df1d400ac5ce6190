// Stable compaction by a per-row flag: the partition and keep-last passes
// shared by packed_merge.cu (kernel D) and sample_sort_merge.cu (through
// packedsort.cuh), index_merge.cu (kernel F) and scan.cu.
//
// Three launches, no atomics, no host synchronisation:
//   count_kernel      one block per TILE rows counts its flagged rows;
//   tile_scan_kernel  one block turns the tile counts into exclusive
//                     offsets (the in-order carry across tiles: 3,700
//                     counts at 7.56M rows, 31,000 at 63M, 4 to 40 us of
//                     one block on an H100);
//   scatter_kernel    each block flags its rows again, ranks them with a
//                     block-wide exclusive scan (each thread owns ITEMS
//                     consecutive rows), and writes value(i) of every
//                     flagged row to out[offset + rank], so the output
//                     keeps input order; the last block writes the total.
// A Flag functor provides flag(i) and value(i) for rows i < its row count.
// The row count may sit on the device (written by an earlier compaction).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace compact {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int SCAN_THREADS = 1024;

__device__ inline int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// rows in play: n, or fewer when a device-side count is given
__device__ inline int64_t rows(int64_t n, const int32_t* len_dev) {
    return len_dev ? imin((int64_t)*len_dev, n) : n;
}

inline unsigned blocks_for(int64_t n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

inline int64_t tiles_for(int64_t n) { return n > 0 ? (n + TILE - 1) / TILE : 1; }

// in-place exclusive scan of data[0, m), one block
__global__ void __launch_bounds__(SCAN_THREADS)
tile_scan_kernel(int32_t* __restrict__ data, int64_t m) {
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

// exclusive prefix of x over the block's threads; *total gets the sum
__device__ inline int32_t block_exclusive_sum(int32_t x, int32_t* total) {
    __shared__ int32_t warp_sums[WARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int32_t inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int32_t w = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
        for (int d = 1; d < WARPS; d <<= 1) {
            const int32_t y = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += y;
        }
        if (lane < WARPS) warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int32_t before = warp > 0 ? warp_sums[warp - 1] : 0;
    *total = warp_sums[WARPS - 1];
    return before + inc - x;
}

template <class Flag>
__global__ void __launch_bounds__(THREADS)
count_kernel(Flag f, int64_t n, const int32_t* __restrict__ len_dev,
             int32_t* __restrict__ counts) {
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int64_t te = imin(ts + TILE, rows(n, len_dev));
    int32_t c = 0;
    for (int64_t i = ts + threadIdx.x; i < te; i += THREADS) c += f.flag(i) ? 1 : 0;
    int32_t total;
    block_exclusive_sum(c, &total);
    if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <class Flag>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(Flag f, int64_t n, const int32_t* __restrict__ len_dev,
               const int32_t* __restrict__ offs, int32_t* __restrict__ out,
               int32_t* __restrict__ total_out) {
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int64_t te = imin(ts + TILE, rows(n, len_dev));
    const int64_t first = ts + (int64_t)threadIdx.x * ITEMS;
    bool fl[ITEMS];
    int32_t c = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        fl[j] = first + j < te && f.flag(first + j);
        c += fl[j] ? 1 : 0;
    }
    int32_t tile_total;
    int32_t pos = offs[blockIdx.x] + block_exclusive_sum(c, &tile_total);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        if (fl[j]) out[pos++] = f.value(first + j);
    }
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
        *total_out = offs[blockIdx.x] + tile_total;
    }
}

// Scratch: tiles_for(n) int32 tile counts.
inline int64_t scratch_bytes(int64_t n) { return tiles_for(n) * (int64_t)sizeof(int32_t); }

// out[0, k) = value(i) of the flagged rows i < rows in order; *count = k.
template <class Flag>
void run(const Flag& f, int64_t n, const int32_t* len_dev, int32_t* tile_counts,
         int32_t* out, int32_t* count, cudaStream_t s) {
    const int64_t tiles = tiles_for(n);
    count_kernel<Flag><<<(unsigned)tiles, THREADS, 0, s>>>(f, n, len_dev, tile_counts);
    tile_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(tile_counts, tiles);
    scatter_kernel<Flag><<<(unsigned)tiles, THREADS, 0, s>>>(f, n, len_dev, tile_counts, out,
                                                             count);
}

// Row i of a partition: kept where mask[i] != 0.
struct MaskFlag {
    const uint8_t* mask;
    __device__ bool flag(int64_t i) const { return mask[i] != 0; }
    __device__ int32_t value(int64_t i) const { return (int32_t)i; }
};

// Every row is flagged: a copy of perm[0, rows) (the no-dedup output).
struct AllFlag {
    const int32_t* perm;
    __device__ bool flag(int64_t) const { return true; }
    __device__ int32_t value(int64_t i) const { return perm[i]; }
};

// Carve 256-byte aligned pieces out of one scratch allocation.
struct Arena {
    char* p;
    template <class T>
    T* take(int64_t count) {
        T* out = reinterpret_cast<T*>(p);
        p += ((count * (int64_t)sizeof(T) + 255) / 256) * 256;
        return out;
    }
    static int64_t size_of(int64_t bytes) { return ((bytes + 255) / 256) * 256; }
};

}  // namespace compact
