// Segmented reduction over SORTED cell ids: the shared body of
// block_sum_count.cu, block_min_max.cu, grouped_stats.cu and
// sharded_downsample.cu.
//
// Rows arrive sorted by cell id, so every cell is one contiguous run. Each
// block takes one tile of TILE rows and first stages it in shared memory:
// one thread issues a 1-D bulk copy (TMA) per lane, the ids and every input
// lane its Op names, of the tile and the HALO rows after it, completing on
// one mbarrier; a lane whose base is not 16 B aligned, and the tail of the
// last tiles that is not a whole number of 16 B units, is copied by the
// block with plain loads. Every fold below then reads the staged rows.
//
// Thread t owns rows [t * ITEMS, (t + 1) * ITEMS) of the tile: it flags
// the run heads among them by comparing neighbouring staged ids, and folds
// every run whose head lies there. A run belongs to the tile that holds
// its head; a run entering a tile from an earlier one is that tile's. A
// run ends at the next head: the next flagged row of the same thread, else
// the first head of a later thread (each thread publishes its first), else
// the tile's last run goes on into the halo while its id holds.
//
// A short run (at most LONG rows) is folded by its thread left to right,
// ((r0 + r1) + r2) + ..., from shared memory (HALO = LONG staged rows past
// the tile hold the rest of a short run that crosses the tile's end, and
// tell a long one). A long run would serialise one thread for its whole
// length, so the block folds it instead, from device memory, in chunks of
// CHUNK rows counted from the run's head: each thread folds one chunk left
// to right, the first lane of each warp folds its warp's 32 chunk partials
// left to right (a group of 32 * CHUNK rows), and thread 0 folds the group
// partials into the run's total left to right, round after round of
// THREADS chunks (ROUND rows) until the id changes.
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
// thread folds them.
//
// Cost: each row is read from device memory once by the tile's bulk copy
// (the halo's rows once more, mostly from L2), so the reads are whole
// lines whatever the runs' lengths. ITEMS is odd, so the threads of a warp
// reading their own rows (the head flags, runs of one row) hit distinct
// banks; a warp folding runs of 30 rows (the main path's 5-minute buckets
// of 10 s scrapes) reads distinct banks too. Runs of a power-of-two length
// put their heads on one bank and fold with conflicts. A short run takes
// up to LONG dependent steps in one thread. A long run takes CHUNK + 32 +
// WARPS dependent steps per ROUND rows in one block, so one cell of
// millions of rows keeps one block busy while the others finish. Its rows
// come from device memory with little L1 beside the staged tiles' shared
// memory, so a chunk that is the run's throughout loads LOADS rows at once
// and reads no id but its last: CHUNK / LOADS round trips, not CHUNK.
//
// The reduction is generic over an Op, which owns its inputs and outputs:
//   using Acc;                      a plain struct
//   static constexpr int LANES;     its input lanes
//   Lanes<LANES> lanes;             their rows in device memory (null: absent)
//   static constexpr int bytes(int l);  lane l's element bytes (1, 4 or 8)
//   static Acc identity();
//   Acc load(const Lanes<LANES>& at, int64_t i) const;
//                                   the partial of row i of lanes `at` (an
//                                   absent lane's pointer is null there too)
//   static Acc combine(Acc x, Acc y);   x holds the earlier rows
//   void store(int64_t cell, Acc a) const;
// and the ids come from a key source `Keys`:
//   using Key;                      a 4-byte id: an integer type, or a struct
//                                   with ==, != and an explicit int64 cast
//   Key operator[](int64_t i) const;    row i's id, from device memory
//   static constexpr bool COMPUTED; false: the ids are a lane, `p`, staged
//                                   by bulk copy as every other lane; true:
//                                   the block computes each staged id
//                                   through operator[] while the copies run
// `IdLane` is the source of an id lane in device memory (int32 for kernels
// B and C, the u32 sort keys for grouped_stats); the mesh slot pass
// computes its ids from the raw ts and sid lanes. An Op that declares
// `static constexpr bool KEYED = true` loads a row with its id,
// load(at, i, id): its ids carry a flag besides the cell.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace seg {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 13;             // rows a thread owns; odd (see the header)
constexpr int TILE = THREADS * ITEMS;
constexpr int LONG = 256;             // longer runs are folded by the block
constexpr int HALO = LONG;            // rows staged past the tile
constexpr int ROWS = TILE + HALO;     // rows staged a block
constexpr int SLOTS = (TILE + LONG - 1) / LONG;  // long runs a tile can hold heads of
constexpr int CHUNK = 16;             // rows a thread folds of a long run
constexpr int ROUND = THREADS * CHUNK;  // rows the block folds of it at a time
constexpr int LOADS = 4;              // rows of a long run's chunk loaded at once
constexpr int NONE = 0x7fffffff;      // a thread that owns no head
static_assert(ITEMS % 2 == 1 && ITEMS <= 32, "ITEMS: odd, and a head mask in 32 bits");
static_assert(ROWS % 16 == 0, "every staged lane is a whole number of 16 B units");
static_assert(CHUNK % LOADS == 0, "a chunk loads LOADS rows at a time");

struct Pair {
    double a;
    double b;
};

template <int N>
struct Lanes {
    const void* p[N];
};

// min / max that propagate NaN, as jax.ops.segment_min / np.minimum do
// (CUDA's fmin / fmax drop it); of equal values the earlier row's wins. A
// NaN y fails y >= x (y <= x), so it wins unless x is NaN: two compares.
__device__ inline double nan_min(double x, double y) {
    return x != x || y >= x ? x : y;
}

__device__ inline double nan_max(double x, double y) {
    return x != x || y <= x ? x : y;
}

template <class K>
struct IdLane {
    using Key = K;
    static constexpr bool COMPUTED = false;
    const K* __restrict__ p;
    __device__ K operator[](int64_t i) const { return p[i]; }
};

template <class Op, class = void>
struct keyed {
    static constexpr bool value = false;
};

template <class Op>
struct keyed<Op, decltype(void(Op::KEYED))> {
    static constexpr bool value = Op::KEYED;
};

// row i's partial from lanes `at` (staged rows, or op.lanes in device
// memory); a keyed Op also takes the row's id
template <class Op, class K>
__device__ inline typename Op::Acc load(const Op& op, const Lanes<Op::LANES>& at, int64_t i,
                                        K key) {
    if constexpr (keyed<Op>::value) {
        return op.load(at, i, key);
    } else {
        return op.load(at, i);
    }
}

// row i's partial from device memory, its id read only by a keyed Op
template <class Op, class Keys>
__device__ inline typename Op::Acc load_row(const Op& op, const Keys& keys, int64_t i) {
    if constexpr (keyed<Op>::value) {
        return op.load(op.lanes, i, keys[i]);
    } else {
        return op.load(op.lanes, i);
    }
}

template <class K>
__device__ inline bool in_range(K key, int64_t num_cells) {
    return (int64_t)key >= 0 && (int64_t)key < num_cells;
}

// Dynamic shared bytes of a block: the ids and each present lane, ROWS rows
// each (every region a whole number of 16 B units, so each starts aligned).
template <class Op>
inline size_t smem_bytes(const Op& op) {
    size_t row = 4;
    for (int l = 0; l < Op::LANES; ++l) {
        if (op.lanes.p[l] != nullptr) row += Op::bytes(l);
    }
    return ROWS * row;
}

__device__ inline uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows [from, cnt) of a lane of `b`-byte elements, copied by the block.
__device__ inline void copy_rows(unsigned char* dst, const unsigned char* src, int b, int from,
                                 int cnt) {
    for (int r = from + (int)threadIdx.x; r < cnt; r += THREADS) {
        if (b == 8) {
            reinterpret_cast<uint64_t*>(dst)[r] = reinterpret_cast<const uint64_t*>(src)[r];
        } else if (b == 4) {
            reinterpret_cast<uint32_t*>(dst)[r] = reinterpret_cast<const uint32_t*>(src)[r];
        } else {
            dst[r] = src[r];
        }
    }
}

// Stage rows [ts, ts + cnt) of the ids and of every present lane into
// `smem` (layout of smem_bytes); `at` gets the staged lanes (null where
// absent). Ids without a lane are computed into their place. Every thread
// of the block calls it; all rows are visible to all threads on return.
template <class Op, class Keys>
__device__ void stage(const Keys& keys, const Op& op, int64_t ts, int cnt, unsigned char* smem,
                      uint64_t* bar, Lanes<Op::LANES>& at) {
    using K = typename Keys::Key;
    constexpr int N = Op::LANES + 1;
    const unsigned char* src[N];
    unsigned char* dst[N];
    int b[N];
    if constexpr (Keys::COMPUTED) {
        src[0] = nullptr;
    } else {
        src[0] = reinterpret_cast<const unsigned char*>(keys.p + ts);
    }
    dst[0] = smem;
    b[0] = 4;
    size_t off = (size_t)ROWS * 4;
#pragma unroll
    for (int l = 0; l < Op::LANES; ++l) {
        const unsigned char* p = static_cast<const unsigned char*>(op.lanes.p[l]);
        b[l + 1] = Op::bytes(l);
        src[l + 1] = p == nullptr ? nullptr : p + ts * b[l + 1];
        dst[l + 1] = p == nullptr ? nullptr : smem + off;
        at.p[l] = dst[l + 1];
        if (p != nullptr) off += (size_t)ROWS * b[l + 1];
    }
    // bulk: the 16 B-aligned lanes' whole 16 B units; the rest, plain
    uint32_t bulk[N];
    uint32_t tx = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const bool aligned =
            src[i] != nullptr && (reinterpret_cast<uintptr_t>(src[i]) & 15) == 0;
        bulk[i] = aligned ? ((uint32_t)cnt * b[i]) & ~15u : 0u;
        tx += bulk[i];
    }
    const uint32_t mb = smem_addr(bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mb) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
                     "r"(tx)
                     : "memory");
#pragma unroll
        for (int i = 0; i < N; ++i) {
            if (bulk[i] > 0) {
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                    "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst[i])),
                    "l"(src[i]), "r"(bulk[i]), "r"(mb)
                    : "memory");
            }
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
        if (src[i] != nullptr) copy_rows(dst[i], src[i], b[i], (int)(bulk[i] / b[i]), cnt);
    }
    if constexpr (Keys::COMPUTED) {
        // computed ids: every row's inputs loaded before the first store
        constexpr int PER = (ROWS + THREADS - 1) / THREADS;
        K* ks = reinterpret_cast<K*>(smem);
        K id[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const int r = (int)threadIdx.x + j * THREADS;
            if (r < cnt) id[j] = keys[ts + r];
        }
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const int r = (int)threadIdx.x + j * THREADS;
            if (r < cnt) ks[r] = id[j];
        }
    }
    __syncthreads();  // the plain copies, and the mbarrier's init before any wait
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(mb)
        : "memory");
}

// The block folds the long run whose head is `head` from device memory
// (see the header); thread 0 stores the cell. Every thread of the block
// calls it.
template <class Op, class Keys>
__device__ void fold_long(const Keys& k, int64_t n, int64_t head, const Op& op,
                          typename Op::Acc* part, typename Op::Acc* group, int8_t* has,
                          int8_t* more) {
    using Acc = typename Op::Acc;
    using K = typename Keys::Key;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int w = t >> 5;
    const K key = k[head];
    Acc acc = Op::identity();
    bool started = false;  // thread 0's: acc holds a group
    for (int64_t base = head;; base += ROUND) {
        // thread t folds chunk t of the round. A chunk whose last row holds
        // the run's id is the run's throughout (the ids are sorted): its rows
        // load LOADS at a time, with no id of their own read. Otherwise rows
        // past the run (another id, or past n) are loaded clamped and left
        // out. The loops are not unrolled further: the short-run fold beside
        // them keeps its registers.
        const int64_t c0 = base + (int64_t)t * CHUNK;
        const int64_t cl = c0 + CHUNK - 1;
        Acc p = Op::identity();
        bool hp = false;
        if (cl < n && k[cl] == key) {
            hp = true;
#pragma unroll 1
            for (int j = 0; j < CHUNK; j += LOADS) {
                Acc x[LOADS];
#pragma unroll
                for (int i = 0; i < LOADS; ++i) x[i] = load_row(op, k, c0 + j + i);
#pragma unroll
                for (int i = 0; i < LOADS; ++i) p = j + i == 0 ? x[0] : Op::combine(p, x[i]);
            }
        } else {
#pragma unroll 1
            for (int j = 0; j < CHUNK; ++j) {
                const int64_t q = c0 + j;
                const int64_t qc = q < n ? q : n - 1;
                const K kq = k[qc];
                const bool in = q < n && kq == key;
                const Acc x = load(op, op.lanes, qc, kq);
                if (in) p = hp ? Op::combine(p, x) : x;
                hp = hp || in;
            }
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

template <class Op, class Keys>
__global__ void __launch_bounds__(THREADS)
run_kernel(const Keys k, int64_t n, int64_t num_cells, Op op) {
    using K = typename Keys::Key;
    static_assert(sizeof(K) == 4, "ids are staged as 4-byte words");
    using Acc = typename Op::Acc;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t bar;
    __shared__ int32_t first[THREADS];
    __shared__ int32_t longs[SLOTS];
    const int t = threadIdx.x;
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int len = n - ts < TILE ? (int)(n - ts) : TILE;
    const int cnt = n - ts < ROWS ? (int)(n - ts) : ROWS;
    if (t < SLOTS) longs[t] = -1;
    // the id before the tile, read while the copies run (row 0 is a head)
    const K before = t == 0 && ts > 0 ? k[ts - 1] : K(0);
    Lanes<Op::LANES> at;
    stage(k, op, ts, cnt, smem, &bar, at);
    const K* ks = reinterpret_cast<const K*>(smem);

    // 1. flag the heads among the thread's rows; publish the first
    const int r0 = t * ITEMS;
    uint32_t heads = 0;
    if (r0 < len) {
        bool has_prev = t > 0 || ts > 0;
        K prev = t > 0 ? ks[r0 - 1] : before;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            if (r0 + j < len) {
                const K cur = ks[r0 + j];
                if (!has_prev || cur != prev) heads |= 1u << j;
                prev = cur;
                has_prev = true;
            }
        }
    }
    first[t] = heads != 0 ? r0 + __ffs(heads) - 1 : NONE;
    __syncthreads();

    // 2. fold each run whose head the thread owns, up to the next head; a
    //    run of more than LONG rows is left to step 3 (two such runs' heads
    //    lie more than LONG rows apart, so each gets its own slot)
    while (heads != 0) {
        const int h = r0 + __ffs(heads) - 1;
        heads &= heads - 1;
        const K key = ks[h];
        if (!in_range(key, num_cells)) continue;
        int end = NONE;
        bool is_long = false;
        if (heads != 0) {
            end = r0 + __ffs(heads) - 1;
        } else {
            for (int u = t + 1;; ++u) {
                const int lo = u * ITEMS;
                if (lo >= len) break;  // no later head in the tile
                if (lo - h > LONG) {   // rows [h, lo) are all this run's
                    is_long = true;
                    break;
                }
                if (first[u] != NONE) {
                    end = first[u];
                    break;
                }
            }
            if (end == NONE && !is_long) {  // the tile's last run: on into the halo
                end = len;
                while (end < cnt && end - h <= LONG && ks[end] == key) ++end;
            }
        }
        if (is_long || end - h > LONG) {
            longs[h / LONG] = h;
            continue;
        }
        Acc acc = load(op, at, h, ks[h]);
#pragma unroll 4
        for (int p = h + 1; p < end; ++p) acc = Op::combine(acc, load(op, at, p, ks[p]));
        op.store((int64_t)key, acc);
    }

    // 3. the block folds the tile's long runs, one after another, with its
    //    scratch in the staged rows' place (no thread reads them any more)
    __syncthreads();
    Acc* part = reinterpret_cast<Acc*>(smem);
    Acc* group = part + THREADS;
    int8_t* has = reinterpret_cast<int8_t*>(group + WARPS);
    int8_t* more = has + THREADS + WARPS;
    for (int s = 0; s < SLOTS; ++s) {
        const int hp = longs[s];
        if (hp >= 0) fold_long(k, n, ts + hp, op, part, group, has, more);
    }
}

template <class Op>
__global__ void fill_kernel(Op op, int64_t m) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) op.store(i, Op::identity());
}

// Fill, then reduce: both on `stream`, nothing synchronised. The fill
// writes every cell before the runs overwrite theirs (same stream, in
// order), so empty cells read the identity. `filled`: an earlier launch on
// the stream wrote the identity to every cell already, so no fill.
template <class Op, class Keys>
int launch_keys(const Keys& k, int64_t n, int64_t num_cells, const Op& op, cudaStream_t stream,
                bool filled = false) {
    if (num_cells > 0 && !filled) {
        const int64_t blocks = (num_cells + 255) / 256;
        fill_kernel<Op><<<(unsigned)blocks, 256, 0, stream>>>(op, num_cells);
    }
    if (n > 0 && num_cells > 0) {
        const size_t smem = smem_bytes(op);
        const cudaError_t e = cudaFuncSetAttribute(
            run_kernel<Op, Keys>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        const int64_t blocks = (n + TILE - 1) / TILE;
        run_kernel<Op, Keys><<<(unsigned)blocks, THREADS, smem, stream>>>(k, n, num_cells, op);
    }
    return (int)cudaGetLastError();
}

// launch_keys over an id lane in device memory
template <class Op, class K>
int launch(const K* k, int64_t n, int64_t num_cells, const Op& op, cudaStream_t stream,
           bool filled = false) {
    return launch_keys(IdLane<K>{k}, n, num_cells, op, stream, filled);
}

// run_kernel's occupancy for `op`'s lanes (only which are null matters)
// and key source: blocks an SM, registers a thread, static and dynamic
// shared bytes.
template <class Op, class Keys>
int occupancy_keys(const Op& op, int32_t* out) {
    const size_t smem = smem_bytes(op);
    cudaFuncAttributes a{};
    int blocks = 0;
    cudaError_t e = cudaFuncSetAttribute(run_kernel<Op, Keys>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, run_kernel<Op, Keys>);
    if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, run_kernel<Op, Keys>, THREADS,
                                                          smem);
    }
    out[0] = blocks;
    out[1] = a.numRegs;
    out[2] = (int32_t)a.sharedSizeBytes;
    out[3] = (int32_t)smem;
    return (int)e;
}

// occupancy_keys over an id lane of K
template <class Op, class K>
int occupancy(const Op& op, int32_t* out) {
    return occupancy_keys<Op, IdLane<K>>(op, out);
}

}  // namespace seg
