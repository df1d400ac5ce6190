// Segmented reduction over SORTED cell ids: the shared body of
// block_sum_count.cu, block_min_max.cu and grouped_stats.cu.
//
// Rows arrive sorted by cell id, so every cell is one contiguous run. Each
// block reduces one tile of TILE rows; each thread owns ITEMS consecutive
// rows of it. A thread first reduces its rows (restarting at every run
// head), a block-wide segmented scan over the thread aggregates then hands
// every thread the partial of the run that enters its first row, and a
// second walk over the rows finishes each run at its last row.
//
// A run that ends inside its tile writes its cell directly. A run that
// touches a tile edge AND continues past it (the neighbouring row outside
// the tile has the same id) goes to a per-tile carry instead: `head` for
// the tile's first run, `tail` for its last. A second small kernel
// (fold_kernel) joins the carries in tile order: the tile where a run
// starts owns it and adds the heads of the following tiles in turn.
//
// No atomics anywhere: each cell is written by exactly one thread, and
// every partial is combined in a fixed order, so a grid is bitwise equal
// from run to run. Ids outside [0, num_cells) are dropped. Rows that a
// mask excludes either keep their in-range id and only carry an identity
// element (weight 0, or +inf/-inf), so they never break a run, or carry an
// id >= num_cells and sort to the end.
//
// The reduction is generic over an Op, which owns its inputs and outputs:
//   using Acc;                      a plain struct (it lives in shared memory)
//   static Acc identity();
//   Acc load(int64_t pos) const;    the partial of sorted row `pos`
//   static Acc combine(Acc x, Acc y);   x holds the earlier rows
//   void store(int64_t cell, Acc a) const;
// and the ids are any integer type K (int32 for kernels B and C, the u64
// radix keys for grouped_stats).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace seg {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;

__device__ inline int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

struct Pair {
    double a;
    double b;
};

// min / max that propagate NaN, as jax.ops.segment_min / np.minimum do
// (CUDA's fmin / fmax drop it); of equal values the earlier row's wins.
__device__ inline double nan_min(double x, double y) {
    if (x != x) return x;
    if (y != y) return y;
    return y < x ? y : x;
}

__device__ inline double nan_max(double x, double y) {
    if (x != x) return x;
    if (y != y) return y;
    return y > x ? y : x;
}

template <class K>
__device__ inline bool in_range(K key, int64_t num_cells) {
    return (int64_t)key >= 0 && (int64_t)key < num_cells;
}

template <class Op, class K>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const K* __restrict__ k, int64_t n, int64_t num_cells, Op op,
            typename Op::Acc* __restrict__ head, typename Op::Acc* __restrict__ tail) {
    using Acc = typename Op::Acc;
    __shared__ int flag_buf[2][THREADS];
    __shared__ Acc agg_buf[2][THREADS];

    const int t = threadIdx.x;
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int64_t te = imin(ts + TILE, n);
    const int len = (int)(te - ts);
    const int first = t * ITEMS;
    const K key0 = k[ts];
    const bool cross_back = ts > 0 && k[ts - 1] == key0;
    const bool cross_fwd = te < n && k[te] == k[te - 1];

    K keys[ITEMS];
    Acc vals[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int r = first + j;
        if (r < len) {
            keys[j] = k[ts + r];
            vals[j] = op.load(ts + r);
        } else {
            keys[j] = 0;
            vals[j] = Op::identity();
        }
    }
    const K prev_key = (first > 0 && first < len) ? k[ts + first - 1] : K(0);

    // phase 1: aggregate of my rows after my last run head
    bool flag = false;
    bool have = false;
    Acc acc = Op::identity();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int r = first + j;
        if (r < len) {
            const bool h = r == 0 || keys[j] != (j == 0 ? prev_key : keys[j - 1]);
            acc = (h || !have) ? vals[j] : Op::combine(acc, vals[j]);
            have = true;
            flag = flag || h;
        }
    }

    // phase 2: inclusive segmented scan over threads (Hillis-Steele)
    flag_buf[0][t] = flag;
    agg_buf[0][t] = acc;
    __syncthreads();
    int src = 0;
    for (int d = 1; d < THREADS; d <<= 1) {
        int f = flag_buf[src][t];
        Acc x = agg_buf[src][t];
        if (t >= d) {
            if (!f) x = Op::combine(agg_buf[src][t - d], x);
            f = f || flag_buf[src][t - d];
        }
        flag_buf[src ^ 1][t] = f;
        agg_buf[src ^ 1][t] = x;
        __syncthreads();
        src ^= 1;
    }
    const Acc carry = t > 0 ? agg_buf[src][t - 1] : Op::identity();

    // phase 3: finish every run at its last row
    Acc run = Op::identity();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int r = first + j;
        if (r < len) {
            const bool h = r == 0 || keys[j] != (j == 0 ? prev_key : keys[j - 1]);
            if (h) {
                run = vals[j];
            } else {
                run = Op::combine(j == 0 ? carry : run, vals[j]);
            }
            const bool last = r == len - 1;
            const K next = last ? K(0) : (j + 1 < ITEMS ? keys[j + 1] : k[ts + r + 1]);
            if (last || next != keys[j]) {
                const K key = keys[j];
                const bool cb = cross_back && key == key0;
                const bool cf = cross_fwd && last;
                if (cb) head[blockIdx.x] = run;
                if (cf) tail[blockIdx.x] = run;
                if (!cb && !cf && in_range(key, num_cells)) op.store((int64_t)key, run);
            }
        }
    }
}

// One thread per tile: a tile whose last run continues into the next tile
// and started inside it owns that run and folds the following heads in
// tile order.
template <class Op, class K>
__global__ void fold_kernel(const K* __restrict__ k, int64_t n, int64_t num_cells,
                            int64_t num_tiles, Op op,
                            const typename Op::Acc* __restrict__ head,
                            const typename Op::Acc* __restrict__ tail) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= num_tiles) return;
    const int64_t ts = b * TILE;
    const int64_t te = imin(ts + TILE, n);
    if (!(te < n && k[te] == k[te - 1])) return;
    const K key = k[te - 1];
    if (k[ts] == key && ts > 0 && k[ts - 1] == key) return;  // started earlier
    typename Op::Acc acc = tail[b];
    for (int64_t c = b + 1; c < num_tiles; ++c) {
        acc = Op::combine(acc, head[c]);
        const int64_t cs = c * TILE;
        const int64_t ce = imin(cs + TILE, n);
        if (!(k[ce - 1] == key && ce < n && k[ce] == key)) break;
    }
    if (in_range(key, num_cells)) op.store((int64_t)key, acc);
}

template <class Op>
__global__ void fill_kernel(Op op, int64_t m) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) op.store(i, Op::identity());
}

// Bytes of `scratch` that launch() needs for n rows: 2 * ceil(n / TILE)
// accumulators (heads, then tails). Each kernel exports it, so the
// caller's allocation follows TILE.
template <class Acc>
inline int64_t scratch_bytes(int64_t n) {
    const int64_t tiles = n > 0 ? (n + TILE - 1) / TILE : 1;
    return 2 * tiles * (int64_t)sizeof(Acc);
}

// Fill, reduce, fold: all on `stream`, nothing synchronised. `scratch`
// holds scratch_bytes<Op::Acc>(n) bytes.
template <class Op, class K>
int launch(const K* k, int64_t n, int64_t num_cells, const Op& op,
           typename Op::Acc* scratch, cudaStream_t stream) {
    if (num_cells > 0) {
        const int64_t blocks = (num_cells + 255) / 256;
        fill_kernel<Op><<<(unsigned)blocks, 256, 0, stream>>>(op, num_cells);
    }
    if (n > 0 && num_cells > 0) {
        const int64_t tiles = (n + TILE - 1) / TILE;
        tile_kernel<Op, K><<<(unsigned)tiles, THREADS, 0, stream>>>(
            k, n, num_cells, op, scratch, scratch + tiles);
        fold_kernel<Op, K><<<(unsigned)((tiles + 255) / 256), 256, 0, stream>>>(
            k, n, num_cells, tiles, op, scratch, scratch + tiles);
    }
    return (int)cudaGetLastError();
}

}  // namespace seg
