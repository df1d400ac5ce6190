// Stable LSD radix sort of unsigned keys carrying a payload, whose passes
// find their tiles' output offsets by decoupled look-back; with a key pass
// and an exact presorted shortcut. Two instantiations:
//   - u32 keys carrying a u64 payload (grouped_stats.cu: cell ids and the
//     8 B values), rows dropped by a sentinel key;
//   - u64 keys carrying an int32 payload (keychain.cuh's chain of packed
//     sort-key lanes and the row permutation, for index_merge.cu, scan.cu
//     and sort_perm.cu; sample_sort_merge.cu: raw packed keys and their
//     rows), with a row count that may stay on the device.
//
// Which rows take part (`Rows`): the first n, or the first *len when a
// device-side count is given (written by an earlier kernel, such as a
// partition); rows at or past it are absent: no kernel reads or writes
// them, and every block whose tile starts past it returns at once, so a
// pass costs the rows in play, not n. Of the rows in play, a caller may
// drop some by a sentinel key: such a row sorts last, in input order, and
// nothing reads its payload after the sort. The caller gives the digit
// count (1-8 8-bit digits of the key, from the key's span; a sentinel must
// lie within them). The output is the stable sort of the rows in play by
// their keys' ordering bits, with their keys whole and their payloads: a
// key source may declare `static constexpr K ORDER`, the bits that order a
// key (the others ride along: the mesh slot pass flags a masked row in its
// keys' top bit); by default every bit orders.
//
//   1. key_kernel, one block per TILE rows: each row's key from a source
//      functor (`Src::key(i)`, which may gather through a permutation),
//      written once; per tile its kept-row count, whether its kept keys are
//      non-decreasing, and its first and largest kept key; and the
//      histogram of every digit (shared-memory counts of runs, added to the
//      global histograms once per tile). A source may declare
//      `side(block, blocks)`: every block of the pass calls it once, first
//      (grouped_stats.cu fills its outputs there, spread over the blocks).
//   2. decide_kernel, one block: the rows are presorted when every tile is
//      and each tile's first kept key is at least every earlier kept key.
//      It writes that flag, each tile's offset among the kept rows, the
//      kept total, and the exclusive scan of every digit's histogram.
//   3. compact_kernel: presorted, a stable partition (kept rows in input
//      order, then one sentinel key per dropped row). A stable sort of such
//      keys is exactly this, so the output is the same, bit for bit.
//      Otherwise each block zeroes its tile's look-back status words for
//      the digit passes, and nothing else.
//   4. otherwise: one sweep_kernel per digit. A block takes the next tile
//      (an atomic tile counter, so every earlier tile is already running),
//      ranks its rows per digit in shared memory (warp w owns a contiguous
//      run of the tile's rows, __match_any_sync ranks equal digits within
//      the warp in lane order), publishes its per-digit counts, stages its
//      rows digit-grouped in shared memory, then looks back over the
//      earlier tiles' published counts, LOOK tiles a step, until it meets
//      an inclusive prefix (Merrill and Garland's single-pass scan, as in
//      the Onesweep sort).
//      Each digit's rows leave the tile as one contiguous, coalesced run.
//      Only tiles below the rows in play take part, so the look-back ends:
//      every earlier tile is a working block that publishes.
// A sort is one memset (the histograms, tile counters and flags), the key
// pass, decide_kernel, the partition and one launch a digit.
// Every kernel of the path not taken returns at once: the choice is read
// on the device and the host never waits. No float is touched by an
// atomic; the integer atomics (histograms, tile counter) fix no order.
//
// Bound on an H100: memory. Per pass a row is read and written once (12 B
// each way for either instantiation: key and payload); the key pass writes
// the key once; the presorted path replaces every pass by one partition.
// A sweep block stages TILE keys and payloads, 48 KB, in dynamic shared
// memory (sweep_smem, 59 KB in all), for both instantiations: three blocks
// an SM.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace onesweep {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARP_ROWS = 32 * ITEMS;
constexpr int RADIX = 256;
constexpr int MAX_DIGITS = 8;
constexpr int DECIDE_THREADS = 1024;
static_assert(RADIX == THREADS, "one thread per digit in the look-back");

// look-back status words: flag in the top two bits, a row count below
constexpr uint64_t AGGREGATE = 1ull << 62;
constexpr uint64_t INCLUSIVE = 2ull << 62;
constexpr uint64_t COUNT_MASK = (1ull << 62) - 1;
constexpr int LOOK = 8;  // status words a look-back step loads at once

template <class K>
struct TileInfo {
    int32_t kept;
    int32_t sorted;
    K first;  // first kept key (valid when kept > 0)
    K last;   // largest kept key (0 when none)
};

// The rows that take part, and which of them are kept.
template <class K>
struct Rows {
    int64_t n;
    const int32_t* len;  // device-side row count (rows in play: min(*len, n)), or null
    bool has_sentinel;
    K sentinel;          // with has_sentinel, the key of a dropped row
    __device__ int64_t count() const {
        return len != nullptr && (int64_t)*len < n ? (int64_t)*len : n;
    }
    __device__ bool kept(K k) const { return !has_sentinel || k != sentinel; }
};

inline int64_t tiles_for(int64_t n) { return n > 0 ? (n + TILE - 1) / TILE : 1; }

__device__ inline int64_t dev_tiles(int64_t m) { return m > 0 ? (m + TILE - 1) / TILE : 1; }

// 8-bit digits below the bit length of x: a u32 sentinel's rule
inline int digits_for(uint64_t x) {
    int bits = 0;
    while (bits < 64 && (x >> bits) != 0) ++bits;
    return (bits + 7) / 8;
}

struct Sum {
    __device__ int64_t operator()(int64_t a, int64_t b) const { return a + b; }
};

struct Max {
    __device__ uint64_t operator()(uint64_t a, uint64_t b) const { return a > b ? a : b; }
};

// Exclusive scan of x over the block's NT threads in thread order
// (`identity` for thread 0); *total gets the whole. `tmp` holds NT / 32
// values; the scan syncs before it touches them, so calls may follow one
// another.
template <int NT, class T, class Op>
__device__ T block_exclusive(T x, T identity, Op op, T* tmp, T* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc = op(y, inc);
    }
    __syncthreads();
    if (lane == 31) tmp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        T w = lane < NT / 32 ? tmp[lane] : identity;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const T y = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w = op(y, w);
        }
        if (lane < NT / 32) tmp[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    *total = tmp[NT / 32 - 1];
    const T before = warp > 0 ? tmp[warp - 1] : identity;
    const T up = __shfl_up_sync(0xffffffffu, inc, 1);
    return lane > 0 ? op(before, up) : before;
}

// shared index of tile row r: one pad word per 32 keeps both the striped
// store and the per-thread run of ITEMS rows free of bank conflicts
__device__ inline int pad(int r) { return r + (r >> 5); }

template <class K>
__device__ inline uint32_t digit_of(K k, int shift) {
    return (uint32_t)(k >> shift) & (RADIX - 1);
}

// the bits of a key that order it: Src::ORDER where the source declares it
template <class Src, class K, class = void>
struct order_of {
    static constexpr K value = ~K(0);
};

template <class Src, class K>
struct order_of<Src, K, decltype(void(Src::ORDER))> {
    static constexpr K value = (K)Src::ORDER;
};

// the optional per-block work of the key pass (see the header)
template <class Src, class = void>
struct has_side {
    static constexpr bool value = false;
};

template <class Src>
struct has_side<Src, decltype(void(&Src::side))> {
    static constexpr bool value = true;
};

template <class K, class Src>
__global__ void __launch_bounds__(THREADS)
key_kernel(Src src, Rows<K> rows, int digits, K* __restrict__ keys,
           TileInfo<K>* __restrict__ info, int32_t* __restrict__ hist) {
    constexpr int KD = (int)sizeof(K);  // digits a key can have
    __shared__ K sk[TILE + TILE / 32];
    __shared__ int32_t sh[KD * RADIX];
    __shared__ int64_t tmp_sum[WARPS];
    __shared__ uint64_t tmp_max[WARPS];
    __shared__ K first_sh;
    const int t = threadIdx.x;
    const int64_t m = rows.count();
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    if constexpr (has_side<Src>::value) src.side(blockIdx.x, gridDim.x);
    if (blockIdx.x > 0 && ts >= m) return;  // tile 0 always reports, empty or not
    const int len = m - ts < TILE ? (int)(m - ts) : TILE;
    for (int i = t; i < KD * RADIX; i += THREADS) sh[i] = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int r = j * THREADS + t;
        if (r < len) {
            const K k = src.key(ts + r);
            keys[ts + r] = k;
            sk[pad(r)] = k;
        }
    }
    __syncthreads();

    // thread t walks tile rows [t * ITEMS, t * ITEMS + ITEMS) in order
    int64_t cnt = 0;
    K mx = 0, first = 0;
    bool sorted = true;
    uint32_t cur[KD];
    int32_t run[KD];
#pragma unroll
    for (int dg = 0; dg < KD; ++dg) {
        cur[dg] = 0;
        run[dg] = 0;
    }
    for (int j = 0; j < ITEMS; ++j) {
        const int r = t * ITEMS + j;
        if (r >= len) break;
        const K k = sk[pad(r)] & order_of<Src, K>::value;
        if (rows.kept(sk[pad(r)])) {
            sorted = sorted && k >= mx;  // unsigned: the first kept key passes
            mx = k > mx ? k : mx;
            if (cnt == 0) first = k;
            ++cnt;
        }
#pragma unroll
        for (int dg = 0; dg < KD; ++dg) {
            if (dg >= digits) break;
            const uint32_t d = digit_of(k, 8 * dg);
            if (d != cur[dg]) {
                if (run[dg] > 0) atomicAdd(&sh[dg * RADIX + cur[dg]], run[dg]);
                cur[dg] = d;
                run[dg] = 0;
            }
            ++run[dg];
        }
    }
#pragma unroll
    for (int dg = 0; dg < KD; ++dg) {
        if (dg < digits && run[dg] > 0) atomicAdd(&sh[dg * RADIX + cur[dg]], run[dg]);
    }

    int64_t kept;
    const int64_t kept_before = block_exclusive<THREADS>(cnt, (int64_t)0, Sum(), tmp_sum, &kept);
    uint64_t tile_max;
    const uint64_t before = block_exclusive<THREADS>((uint64_t)mx, (uint64_t)0, Max(), tmp_max,
                                                     &tile_max);
    const bool ok = sorted && (cnt == 0 || (uint64_t)first >= before);
    if (cnt > 0 && kept_before == 0) first_sh = first;  // the tile's first kept row
    const int tile_sorted = __syncthreads_and(ok);      // syncs: first_sh is written
    if (t == 0) info[blockIdx.x] = {(int32_t)kept, tile_sorted, kept > 0 ? first_sh : (K)0,
                                    (K)tile_max};
    for (int i = t; i < digits * RADIX; i += THREADS) {
        if (sh[i] != 0) atomicAdd(&hist[i], sh[i]);
    }
}

// One block. flag[0]: presorted; flag[1]: kept rows. tile_off: each
// tile's offset among the kept rows. base[dg * RADIX + d]: where digit d of
// pass dg starts in the output.
template <class K>
__global__ void __launch_bounds__(DECIDE_THREADS)
decide_kernel(const TileInfo<K>* __restrict__ info, Rows<K> rows, int digits,
              const int32_t* __restrict__ hist, int32_t* __restrict__ base,
              int32_t* __restrict__ tile_off, int32_t* __restrict__ flag) {
    __shared__ int64_t tmp_sum[DECIDE_THREADS / 32];
    __shared__ uint64_t tmp_max[DECIDE_THREADS / 32];
    const int t = threadIdx.x;
    const int64_t tiles = dev_tiles(rows.count());
    const int64_t per = (tiles + DECIDE_THREADS - 1) / DECIDE_THREADS;
    const int64_t lo = (int64_t)t * per < tiles ? (int64_t)t * per : tiles;
    const int64_t hi = lo + per < tiles ? lo + per : tiles;
    int64_t cnt = 0, with_kept = 0;
    uint64_t mx = 0, first = 0;
    bool sorted = true;
    for (int64_t i = lo; i < hi; ++i) {
        const TileInfo<K> ti = info[i];
        if (ti.kept > 0) {
            sorted = sorted && ti.sorted && (uint64_t)ti.first >= mx;
            mx = (uint64_t)ti.last > mx ? (uint64_t)ti.last : mx;
            if (with_kept == 0) first = ti.first;
            ++with_kept;
        }
        cnt += ti.kept;
    }
    uint64_t all_max;
    const uint64_t before = block_exclusive<DECIDE_THREADS>(mx, (uint64_t)0, Max(), tmp_max,
                                                            &all_max);
    const int presorted = __syncthreads_and(sorted && (with_kept == 0 || first >= before));
    int64_t total;
    int64_t off = block_exclusive<DECIDE_THREADS>(cnt, (int64_t)0, Sum(), tmp_sum, &total);
    for (int64_t i = lo; i < hi; ++i) {
        tile_off[i] = (int32_t)off;
        off += info[i].kept;
    }
    if (t == 0) {
        flag[0] = presorted;
        flag[1] = (int32_t)total;
    }
    for (int dg = 0; dg < digits; ++dg) {
        int64_t all;
        const int64_t e = block_exclusive<DECIDE_THREADS>(
            (int64_t)(t < RADIX ? hist[dg * RADIX + t] : 0), (int64_t)0, Sum(), tmp_sum, &all);
        if (t < RADIX) base[dg * RADIX + t] = (int32_t)e;
    }
}

// Presorted: kept rows to [0, kept) in input order with their payloads,
// dropped rows to [kept, rows in play) as sentinel keys. Row j * THREADS +
// t of the tile is thread t's j-th (loads and stores coalesce); every key,
// then every kept payload, is loaded before the first store, and one scan
// over the (round, warp) counts of kept rows ranks them all. Otherwise the
// block zeroes its tile's look-back status words of every digit pass (pass
// p's words start at p * stride) for the sweeps, and nothing else.
template <class K, class V>
__global__ void __launch_bounds__(THREADS)
compact_kernel(const K* __restrict__ keys, const V* __restrict__ vals, Rows<K> rows,
               const int32_t* __restrict__ tile_off, const int32_t* __restrict__ flag,
               K* __restrict__ k_out, V* __restrict__ v_out, uint64_t* __restrict__ status,
               int digits, int64_t stride) {
    const int64_t m = rows.count();
    if ((int64_t)blockIdx.x * TILE >= m) return;  // no sweep reads this tile's words
    if (!flag[0]) {
        for (int dg = 0; dg < digits; ++dg) {
            status[dg * stride + (int64_t)blockIdx.x * RADIX + threadIdx.x] = 0;
        }
        return;
    }
    __shared__ int32_t off[ITEMS * WARPS];
    __shared__ int64_t tmp[WARPS];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int w = t >> 5;
    const int64_t ts = (int64_t)blockIdx.x * TILE + t;
    K kk[ITEMS];
    V vv[ITEMS];
    unsigned bal[ITEMS];
    uint32_t keep = 0;  // bit j: row j of this thread is in play and kept
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int64_t row = ts + (int64_t)j * THREADS;
        kk[j] = row < m ? keys[row] : (K)0;
        if (row < m && rows.kept(kk[j])) keep |= 1u << j;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const bool kj = (keep >> j) & 1u;
        vv[j] = kj ? vals[ts + (int64_t)j * THREADS] : (V)0;
        bal[j] = __ballot_sync(0xffffffffu, kj);
        if (lane == 0) off[j * WARPS + w] = __popc(bal[j]);
    }
    __syncthreads();
    int64_t all;
    const int64_t e = block_exclusive<THREADS>((int64_t)(t < ITEMS * WARPS ? off[t] : 0),
                                               (int64_t)0, Sum(), tmp, &all);
    if (t < ITEMS * WARPS) off[t] = (int32_t)e;  // block_exclusive synced after every read
    __syncthreads();
    const int64_t base = tile_off[blockIdx.x];
    const int64_t kept_total = flag[1];
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int64_t row = ts + (int64_t)j * THREADS;
        const int64_t at = base + off[j * WARPS + w] + __popc(bal[j] & lt);
        if ((keep >> j) & 1u) {
            k_out[at] = kk[j];
            v_out[at] = vv[j];
        } else if (row < m) {
            k_out[kept_total + (row - at)] = rows.sentinel;  // row - at: dropped rows before it
        }
    }
}

// shared memory of sweep_kernel: keys and payloads, warp digit counts, the
// tile's digit starts and the digits' output bases
template <class K, class V>
constexpr int sweep_smem() {
    return TILE * (int)(sizeof(K) + sizeof(V)) + WARPS * RADIX * 4 + 2 * RADIX * 4;
}

__device__ inline uint64_t load_status(const uint64_t* p) {
    return *reinterpret_cast<const volatile uint64_t*>(p);
}

__device__ inline void store_status(uint64_t* p, uint64_t x) {
    *reinterpret_cast<volatile uint64_t*>(p) = x;
}

// One stable digit pass (bits [shift, shift + 8) of k & ORDER) unless
// presorted.
template <class K, class V, K ORDER = ~K(0)>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const K* __restrict__ k_in, const V* __restrict__ v_in, K* __restrict__ k_out,
             V* __restrict__ v_out, Rows<K> rows, int shift, const int32_t* __restrict__ base,
             uint64_t* __restrict__ status, int32_t* __restrict__ counter,
             const int32_t* __restrict__ flag) {
    if (flag[0]) return;
    extern __shared__ __align__(16) unsigned char smem[];
    // the wider of key and payload first, so both stay aligned
    constexpr bool KEY_FIRST = sizeof(K) >= sizeof(V);
    K* sk = reinterpret_cast<K*>(smem + (KEY_FIRST ? 0 : TILE * sizeof(V)));
    V* sv = reinterpret_cast<V*>(smem + (KEY_FIRST ? TILE * sizeof(K) : 0));
    // [WARPS][RADIX] warp digit counts, then the digit starts and bases
    int32_t* wh = reinterpret_cast<int32_t*>(smem + TILE * (sizeof(K) + sizeof(V)));
    int32_t* start = wh + WARPS * RADIX;
    int32_t* gbase = start + RADIX;
    __shared__ int32_t tile_sh;
    __shared__ int64_t tmp[WARPS];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int w = t >> 5;
    const unsigned lt = (1u << lane) - 1u;
    if (t == 0) tile_sh = atomicAdd(counter, 1);
#pragma unroll
    for (int i = 0; i < WARPS; ++i) wh[i * RADIX + t] = 0;
    __syncthreads();
    const int64_t tile = tile_sh;
    const int64_t ts = tile * TILE;
    const int64_t m = rows.count();
    if (ts >= m) return;  // past the rows in play: the whole block leaves
    const int64_t wrow = ts + (int64_t)w * WARP_ROWS + lane;

    // 1. rank each row among the warp's rows of its digit, in row order
    K kk[ITEMS];
    int32_t rk[ITEMS];
    int32_t* own = wh + w * RADIX;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int64_t row = wrow + j * 32;
        const bool valid = row < m;
        const K k = valid ? k_in[row] : (K)0;
        const uint32_t d = valid ? digit_of(k & ORDER, shift) : RADIX;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int32_t b = valid ? own[d & (RADIX - 1)] : 0;  // d = RADIX: no row
        __syncwarp();
        if (valid && (peers & lt) == 0) own[d] = b + __popc(peers);
        __syncwarp();
        kk[j] = k;
        rk[j] = b + __popc(peers & lt);
    }
    __syncthreads();

    // 2. thread d: the warps' offsets within digit d and the tile's count
    //    of d, published at once, and where d's rows start in the tile
    const int d = t;
    int32_t cnt = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
        const int32_t x = wh[i * RADIX + d];
        wh[i * RADIX + d] = cnt;
        cnt += x;
    }
    uint64_t* st = status + tile * RADIX + d;
    store_status(st, (tile == 0 ? INCLUSIVE : AGGREGATE) | (uint64_t)cnt);
    int64_t all;
    const int32_t s0 = (int32_t)block_exclusive<THREADS>((int64_t)cnt, (int64_t)0, Sum(), tmp,
                                                         &all);
    start[d] = s0;
    __syncthreads();

    // 3. stage the tile digit-grouped (the payloads load while earlier
    //    tiles finish), then look back for the tile's offset in digit d
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int64_t row = wrow + j * 32;
        if (row < m) {
            const uint32_t dj = digit_of(kk[j] & ORDER, shift);
            const int s = start[dj] + wh[w * RADIX + dj] + rk[j];
            sk[s] = kk[j];
            sv[s] = v_in[row];
        }
    }
    int64_t excl = 0;
    if (tile > 0) {
        // LOOK words at a time, loaded together, then taken in order until
        // an inclusive prefix or a word not yet published (read again)
        for (int64_t p = tile - 1;;) {
            uint64_t w[LOOK];
#pragma unroll
            for (int q = 0; q < LOOK; ++q) {
                w[q] = p - q >= 0 ? load_status(status + (p - q) * RADIX + d) : INCLUSIVE;
            }
            int q = 0;
            bool done = false;
            for (; q < LOOK; ++q) {
                const uint64_t f = w[q] & ~COUNT_MASK;
                if (f == 0) break;  // not published yet
                excl += (int64_t)(w[q] & COUNT_MASK);
                if (f == INCLUSIVE) {
                    done = true;
                    break;
                }
            }
            if (done) break;
            p -= q;
        }
        store_status(st, INCLUSIVE | (uint64_t)(excl + cnt));
    }
    gbase[d] = (int32_t)(base[d] + excl - s0);
    __syncthreads();

    // 4. each digit's rows leave the tile as one contiguous run
    const int len = m - ts < TILE ? (int)(m - ts) : TILE;
    for (int i = t; i < len; i += THREADS) {
        const K k = sk[i];
        const int64_t pos = (int64_t)gbase[digit_of(k & ORDER, shift)] + i;
        k_out[pos] = k;
        v_out[pos] = sv[i];
    }
}

// The occupancy of sweep_kernel<K, V> with its dynamic shared memory, as
// the runtime reports it for the compiled kernel: out[0] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers a
// thread, out[2] static and out[3] dynamic shared bytes a block.
template <class K, class V>
inline int sweep_occupancy(int32_t* out) {
    constexpr int SMEM = sweep_smem<K, V>();
    cudaFuncAttributes a{};
    int blocks = 0;
    cudaError_t e = cudaFuncSetAttribute(sweep_kernel<K, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, sweep_kernel<K, V>);
    if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sweep_kernel<K, V>, THREADS,
                                                          SMEM);
    }
    out[0] = blocks;
    out[1] = a.numRegs;
    out[2] = (int32_t)a.sharedSizeBytes;
    out[3] = SMEM;
    return (int)e;
}

template <class K, class V>
struct Scratch {
    K* kc;             // the key pass's keys: the partition reads them and
                       // writes the last pass's buffer, k[0] or k[1]
    K* k[2];           // digit passes, ping-pong
    V* v[3];           // payload buffers: a sort writes the two that are not
                       // its input (v[2] is null unless chained sorts need it)
    TileInfo<K>* info;
    int32_t* tile_off;
    int32_t* hist;     // [MAX_DIGITS][RADIX], then the tile counters and flags
    int32_t* counters;
    int32_t* flag;
    int32_t* base;     // [MAX_DIGITS][RADIX]
    uint64_t* status;  // [digits][tiles][RADIX]
    int64_t tiles;
};

struct Carver {
    uintptr_t p;
    int64_t used = 0;
    template <class T>
    T* take(int64_t count) {
        T* out = reinterpret_cast<T*>(p + (uintptr_t)used);
        used += ((count * (int64_t)sizeof(T) + 255) / 256) * 256;
        return out;
    }
};

constexpr int HIST_WORDS = MAX_DIGITS * RADIX + MAX_DIGITS + 2;  // hist, counters, flags

// Lays out the scratch of sorts of up to n rows and `digits` digits, with
// `payloads` (2 or 3) payload buffers; with p null, only counts its bytes.
template <class K, class V>
inline Scratch<K, V> carve(void* p, int64_t n, int digits, int payloads, int64_t* bytes) {
    const int64_t m = n > 0 ? n : 1;
    const int64_t tiles = tiles_for(n);
    Carver c{reinterpret_cast<uintptr_t>(p)};
    Scratch<K, V> s;
    s.kc = c.take<K>(m);
    s.k[0] = c.take<K>(m);
    s.k[1] = c.take<K>(m);
    s.v[0] = c.take<V>(m);
    s.v[1] = c.take<V>(m);
    s.v[2] = payloads > 2 ? c.take<V>(m) : nullptr;
    s.info = c.take<TileInfo<K>>(tiles);
    s.tile_off = c.take<int32_t>(tiles);
    s.base = c.take<int32_t>(MAX_DIGITS * RADIX);
    s.hist = c.take<int32_t>(HIST_WORDS);  // zeroed together
    s.counters = s.hist + MAX_DIGITS * RADIX;
    s.flag = s.counters + MAX_DIGITS;
    s.status = c.take<uint64_t>((int64_t)digits * tiles * RADIX);
    s.tiles = tiles;
    if (bytes) *bytes = c.used;
    return s;
}

template <class K, class V>
inline int64_t scratch_bytes(int64_t n, int digits, int payloads) {
    int64_t bytes = 0;
    carve<K, V>(nullptr, n, digits, payloads, &bytes);
    return bytes;
}

template <class K, class V>
struct Sorted {
    const K* keys;
    V* vals;
};

// The stable sort of the rows in play of src's keys (n < 2^31; 1 <= digits
// <= sizeof(K), and at most the digits b was carved for) with payload
// vals[i], on a scratch laid out by carve for n rows. The sorted keys and payloads land in
// scratch buffers, never in vals' buffer, so the payloads of one sort may
// feed the next (a chain over key lanes needs the third payload buffer).
// All launches on `s`, nothing synchronised.
template <class K, class V, class Src>
inline Sorted<K, V> sort(const Src& src, const V* vals, Rows<K> rows, int digits,
                         const Scratch<K, V>& b, cudaStream_t s) {
    V* out[2];
    int j = 0;
    for (int i = 0; i < 3 && j < 2; ++i) {
        if (b.v[i] != nullptr && b.v[i] != vals) out[j++] = b.v[i];
    }
    const int64_t tiles = tiles_for(rows.n);
    const int last = (digits - 1) % 2;  // pass p writes buffers p % 2
    cudaMemsetAsync(b.hist, 0, HIST_WORDS * sizeof(int32_t), s);
    key_kernel<K, Src><<<(unsigned)tiles, THREADS, 0, s>>>(src, rows, digits, b.kc, b.info,
                                                           b.hist);
    decide_kernel<K><<<1, DECIDE_THREADS, 0, s>>>(b.info, rows, digits, b.hist, b.base,
                                                  b.tile_off, b.flag);
    const int64_t stride = b.tiles * RADIX;
    compact_kernel<K, V><<<(unsigned)tiles, THREADS, 0, s>>>(b.kc, vals, rows, b.tile_off,
                                                             b.flag, b.k[last], out[last],
                                                             b.status, digits, stride);
    constexpr int SMEM = sweep_smem<K, V>();
    constexpr K ORDER = order_of<Src, K>::value;
    cudaFuncSetAttribute(sweep_kernel<K, V, ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM);
    for (int p = 0; p < digits; ++p) {
        const K* k_in = p == 0 ? b.kc : b.k[(p - 1) % 2];
        const V* v_in = p == 0 ? vals : out[(p - 1) % 2];
        sweep_kernel<K, V, ORDER><<<(unsigned)tiles, THREADS, SMEM, s>>>(
            k_in, v_in, b.k[p % 2], out[p % 2], rows, 8 * p, b.base + p * RADIX,
            b.status + (int64_t)p * stride, b.counters + p, b.flag);
    }
    return {b.k[last], out[last]};
}

}  // namespace onesweep
