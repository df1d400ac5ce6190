// Segmented reduction over SORTED cell ids: the shared body of
// block_sum_count.cu, block_min_max.cu and grouped_stats.cu.
//
// Rows arrive sorted by cell id, so every cell is one contiguous run. Each
// block takes one tile of TILE rows: its threads flag the run heads among
// the tile's rows and pack their positions into shared memory in row order
// (a ballot per warp and round). A run belongs to the block of the tile
// that holds its head; a run entering a tile from an earlier one is that
// tile's.
//
// A short run (at most LONG rows) is folded by one thread: thread j takes
// the tile's j-th run and folds it left to right, ((r0 + r1) + r2) + ...,
// up to the next head (the tile's last run continues past the tile while
// its id holds). A long run would serialise one thread for its whole
// length, so the block folds it instead, in chunks of CHUNK rows counted
// from the run's head: each thread folds one chunk left to right, the
// first lane of each warp folds its warp's 32 chunk partials left to right
// (a group of 32 * CHUNK rows), and thread 0 folds the group partials
// into the run's total left to right, round after round of THREADS chunks
// (ROUND rows) until the id changes.
//
// Either way the association of a cell's f64 sum depends on nothing but
// the run's own rows in row order (its length picks the scheme, its head
// places the chunks), never on where the run sits in the buffer. A query
// reduced alone and the same query stacked at another offset among others
// (the query batcher's stacked_downsample) give bitwise equal sums. For
// runs of up to LONG rows the order is the JAX package's CPU order (a
// sequential scatter-add in row order); longer runs differ from it in the
// last bits only. A tree over threads and tiles would associate a run's
// rows by their offset from thread and tile boundaries instead.
//
// No atomics anywhere: each cell is written by exactly one thread, so a
// grid is bitwise equal from run to run. Ids outside [0, num_cells) are
// dropped. Rows that a mask excludes either keep their in-range id and
// only carry an identity element (weight 0, or +inf/-inf), so they never
// break a run, or carry an id >= num_cells and sort to the end, where no
// thread walks them.
//
// Cost: each row is loaded once, by the thread of its run (short runs) or
// of its chunk (long runs). A short run takes up to LONG dependent steps in
// one thread. A long run takes CHUNK + 32 + WARPS dependent steps per
// ROUND rows in one block, so one cell of millions of rows keeps one block
// busy while the others finish.
//
// The reduction is generic over an Op, which owns its inputs and outputs:
//   using Acc;                      a plain struct
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
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int LONG = 256;             // longer runs are folded by the block
constexpr int SLOTS = TILE / LONG;    // long runs a tile can hold heads of
constexpr int CHUNK = 16;             // rows a thread folds of a long run
constexpr int ROUND = THREADS * CHUNK;  // rows the block folds of it at a time

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

// The block folds the long run whose head is `head` (see the header);
// thread 0 stores the cell. Every thread of the block calls it.
template <class Op, class K>
__device__ void fold_long(const K* __restrict__ k, int64_t n, int64_t head, const Op& op,
                          typename Op::Acc* part, typename Op::Acc* group, int8_t* has,
                          int8_t* more) {
    using Acc = typename Op::Acc;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int w = t >> 5;
    const K key = k[head];
    Acc acc = Op::identity();
    bool started = false;  // thread 0's: acc holds a group
    for (int64_t base = head;; base += ROUND) {
        // thread t folds chunk t of the round; rows past the run (another id,
        // or past n) are loaded clamped and left out. Not unrolled:
        // unrolling made step 2's short-run fold slower, presumably through
        // the registers the whole kernel then holds.
        const int64_t c0 = base + (int64_t)t * CHUNK;
        Acc p = Op::identity();
        bool hp = false;
#pragma unroll 1
        for (int j = 0; j < CHUNK; ++j) {
            const int64_t q = c0 + j;
            const int64_t qc = q < n ? q : n - 1;
            const bool in = q < n && k[qc] == key;
            const Acc x = op.load(qc);
            if (in) p = hp ? Op::combine(p, x) : x;
            hp = hp || in;
        }
        part[t] = p;
        has[t] = hp;
        __syncthreads();
        if (lane == 0) {
            Acc g = Op::identity();
            bool hg = false;
            for (int i = 0; i < 32; ++i) {
                if (!has[t + i]) break;  // the run ended in chunk t + i - 1
                g = hg ? Op::combine(g, part[t + i]) : part[t + i];
                hg = true;
            }
            group[w] = g;
            has[THREADS + w] = hg;
        }
        __syncthreads();
        if (t == 0) {
            for (int i = 0; i < WARPS; ++i) {
                if (!has[THREADS + i]) break;
                acc = started ? Op::combine(acc, group[i]) : group[i];
                started = true;
            }
            const int64_t next = base + ROUND;
            *more = next < n && k[next] == key;
        }
        __syncthreads();
        const bool go = *more;
        __syncthreads();  // part, has and more are reused next round
        if (!go) break;
    }
    if (t == 0) op.store((int64_t)key, acc);
}

template <class Op, class K>
__global__ void __launch_bounds__(THREADS)
run_kernel(const K* __restrict__ k, int64_t n, int64_t num_cells, Op op) {
    using Acc = typename Op::Acc;
    __shared__ int32_t heads[TILE];
    __shared__ int32_t warp_cnt[WARPS];
    __shared__ int32_t longs[SLOTS];
    __shared__ Acc part[THREADS];
    __shared__ Acc group[WARPS];
    __shared__ int8_t has[THREADS + WARPS];
    __shared__ int8_t more;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int w = t >> 5;
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int64_t rest = n - ts;
    const int len = rest < TILE ? (int)rest : TILE;
    if (t < SLOTS) longs[t] = -1;

    // 1. the tile's run heads, in row order: round r flags rows
    //    r * THREADS + t (coalesced), a ballot ranks them within the warp
    //    and the warp counts rank the warps
    int total = 0;
    for (int rnd = 0; rnd < ITEMS; ++rnd) {
        const int r = rnd * THREADS + t;
        bool head = false;
        if (r < len) {
            const int64_t row = ts + r;
            head = row == 0 || k[row - 1] != k[row];
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, head);
        if (lane == 0) warp_cnt[w] = __popc(ballot);
        __syncthreads();
        int at = total;
        for (int i = 0; i < WARPS; ++i) {
            const int c = warp_cnt[i];
            if (i < w) at += c;
            total += c;
        }
        if (head) heads[at + __popc(ballot & ((1u << lane) - 1u))] = r;
        __syncthreads();
    }

    // 2. thread h folds the tile's h-th run left to right: up to the next
    //    head, and for the tile's last run on past the tile while the id
    //    holds. A run of more than LONG rows is left to step 3 (two such
    //    runs' heads lie more than LONG rows apart, so each gets its own
    //    slot).
    for (int h = t; h < total; h += THREADS) {
        const int64_t row = ts + heads[h];
        const K key = k[row];
        if (!in_range(key, num_cells)) continue;
        int64_t end = h + 1 == total ? ts + len : ts + heads[h + 1];
        if (h + 1 == total) {
            while (end < n && end - row <= LONG && k[end] == key) ++end;
        }
        if (end - row > LONG) {
            longs[heads[h] / LONG] = heads[h];
            continue;
        }
        Acc acc = op.load(row);
        for (int64_t p = row + 1; p < end; ++p) acc = Op::combine(acc, op.load(p));
        op.store((int64_t)key, acc);
    }

    // 3. the block folds the tile's long runs, one after another
    __syncthreads();
    for (int s = 0; s < SLOTS; ++s) {
        const int hp = longs[s];
        if (hp >= 0) fold_long(k, n, ts + hp, op, part, group, has, &more);
    }
}

template <class Op>
__global__ void fill_kernel(Op op, int64_t m) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) op.store(i, Op::identity());
}

// Fill, then reduce: both on `stream`, nothing synchronised. The fill
// writes every cell before the runs overwrite theirs (same stream, in
// order), so empty cells read the identity.
template <class Op, class K>
int launch(const K* k, int64_t n, int64_t num_cells, const Op& op, cudaStream_t stream) {
    if (num_cells > 0) {
        const int64_t blocks = (num_cells + 255) / 256;
        fill_kernel<Op><<<(unsigned)blocks, 256, 0, stream>>>(op, num_cells);
    }
    if (n > 0 && num_cells > 0) {
        const int64_t blocks = (n + TILE - 1) / TILE;
        run_kernel<Op, K><<<(unsigned)blocks, THREADS, 0, stream>>>(k, n, num_cells, op);
    }
    return (int)cudaGetLastError();
}

}  // namespace seg
