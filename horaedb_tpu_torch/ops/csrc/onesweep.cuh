// Stable sort of u32 keys carrying a 64-bit payload, for grouped_stats.cu:
// a key pass, an exact presorted shortcut, and LSD radix passes that each
// find their tiles' output offsets by decoupled look-back.
//
// Keys are at most `sentinel`, and a row whose key equals it is dropped:
// it sorts last, in input order, and nothing reads its payload after the
// sort. Only the 8-bit digits below the bit length of `sentinel` are
// sorted. The output is the stable sort of the keys with their payloads.
//
//   1. key_kernel, one block per TILE rows: each row's key from a source
//      functor (`Src::key(i)`), written once; per tile its kept-row count,
//      whether its kept keys are non-decreasing, and its first and largest
//      kept key; and the histogram of every digit (shared-memory counts of
//      runs, added to the global histograms once per tile).
//   2. decide_kernel, one block: the rows are presorted when every tile is
//      and each tile's first kept key is at least every earlier kept key.
//      It writes that flag, each tile's offset among the kept rows, the
//      kept total, and the exclusive scan of every digit's histogram.
//   3. presorted: compact_kernel, a stable partition (kept rows in input
//      order, then one sentinel key per dropped row). A stable sort of such
//      keys is exactly this, so the output is the same, bit for bit.
//   4. otherwise: one sweep_kernel per digit. A block takes the next tile
//      (an atomic tile counter, so every earlier tile is already running),
//      ranks its rows per digit in shared memory (warp w owns a contiguous
//      run of the tile's rows, __match_any_sync ranks equal digits within
//      the warp in lane order), publishes its per-digit counts, stages its
//      rows digit-grouped in shared memory, then looks back over the
//      earlier tiles' published counts until it meets an inclusive prefix
//      (Merrill and Garland's single-pass scan, as in the Onesweep sort).
//      Each digit's rows leave the tile as one contiguous, coalesced run.
// Every kernel of the path not taken returns at once: the choice is read
// on the device and the host never waits. No float is touched by an
// atomic; the integer atomics (histograms, tile counter) fix no order.
//
// Bound on an H100: memory. Per pass a row is read and written once (4 B
// key, 8 B payload each way); the key pass writes 4 B a row; the
// presorted path replaces every pass by one partition.
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
constexpr int MAX_DIGITS = 4;
constexpr int DECIDE_THREADS = 1024;
static_assert(RADIX == THREADS, "one thread per digit in the look-back");

// look-back status words: flag in the top two bits, a row count below
constexpr uint64_t AGGREGATE = 1ull << 62;
constexpr uint64_t INCLUSIVE = 2ull << 62;
constexpr uint64_t COUNT_MASK = (1ull << 62) - 1;

struct TileInfo {
    int32_t kept;
    int32_t sorted;
    uint32_t first;  // first kept key (valid when kept > 0)
    uint32_t last;   // largest kept key
};

inline int64_t tiles_for(int64_t n) { return n > 0 ? (n + TILE - 1) / TILE : 1; }

inline int digits_for(uint32_t sentinel) {
    int bits = 0;
    while (bits < 32 && (sentinel >> bits) != 0) ++bits;
    return (bits + 7) / 8;
}

struct Sum {
    __device__ int64_t operator()(int64_t a, int64_t b) const { return a + b; }
};

struct Max {
    __device__ int64_t operator()(int64_t a, int64_t b) const { return a > b ? a : b; }
};

// Exclusive scan of x over the block's NT threads in thread order
// (`identity` for thread 0); *total gets the whole. `tmp` holds NT / 32
// values; the scan syncs before it touches them, so calls may follow one
// another.
template <int NT, class Op>
__device__ int64_t block_exclusive(int64_t x, int64_t identity, Op op, int64_t* tmp,
                                   int64_t* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int64_t inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc = op(y, inc);
    }
    __syncthreads();
    if (lane == 31) tmp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int64_t w = lane < NT / 32 ? tmp[lane] : identity;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int64_t y = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w = op(y, w);
        }
        if (lane < NT / 32) tmp[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    *total = tmp[NT / 32 - 1];
    const int64_t before = warp > 0 ? tmp[warp - 1] : identity;
    const int64_t up = __shfl_up_sync(0xffffffffu, inc, 1);
    return lane > 0 ? op(before, up) : before;
}

// shared index of tile row r: one pad word per 32 keeps both the striped
// store and the per-thread run of ITEMS rows free of bank conflicts
__device__ inline int pad(int r) { return r + (r >> 5); }

template <class Src>
__global__ void __launch_bounds__(THREADS)
key_kernel(Src src, int64_t n, uint32_t sentinel, int digits, uint32_t* __restrict__ keys,
           TileInfo* __restrict__ info, int32_t* __restrict__ hist) {
    __shared__ uint32_t sk[TILE + TILE / 32];
    __shared__ int32_t sh[MAX_DIGITS * RADIX];
    __shared__ int64_t tmp[WARPS];
    __shared__ uint32_t first_sh;
    const int t = threadIdx.x;
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int len = n - ts < TILE ? (int)(n - ts) : TILE;
    for (int i = t; i < MAX_DIGITS * RADIX; i += THREADS) sh[i] = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int r = j * THREADS + t;
        if (r < len) {
            const uint32_t k = src.key(ts + r);
            keys[ts + r] = k;
            sk[pad(r)] = k;
        }
    }
    __syncthreads();

    // thread t walks tile rows [t * ITEMS, t * ITEMS + ITEMS) in order
    int64_t cnt = 0, mx = -1, first = -1;
    bool sorted = true;
    uint32_t cur[MAX_DIGITS];
    int32_t run[MAX_DIGITS];
#pragma unroll
    for (int dg = 0; dg < MAX_DIGITS; ++dg) {
        cur[dg] = 0;
        run[dg] = 0;
    }
    for (int j = 0; j < ITEMS; ++j) {
        const int r = t * ITEMS + j;
        if (r >= len) break;
        const uint32_t k = sk[pad(r)];
        if (k != sentinel) {
            sorted = sorted && (int64_t)k >= mx;
            mx = (int64_t)k > mx ? (int64_t)k : mx;
            if (first < 0) first = k;
            ++cnt;
        }
#pragma unroll
        for (int dg = 0; dg < MAX_DIGITS; ++dg) {
            if (dg >= digits) break;
            const uint32_t d = (k >> (8 * dg)) & (RADIX - 1);
            if (d != cur[dg]) {
                if (run[dg] > 0) atomicAdd(&sh[dg * RADIX + cur[dg]], run[dg]);
                cur[dg] = d;
                run[dg] = 0;
            }
            ++run[dg];
        }
    }
#pragma unroll
    for (int dg = 0; dg < MAX_DIGITS; ++dg) {
        if (dg < digits && run[dg] > 0) atomicAdd(&sh[dg * RADIX + cur[dg]], run[dg]);
    }

    int64_t tile_max, kept;
    const int64_t before = block_exclusive<THREADS>(mx, -1, Max(), tmp, &tile_max);
    const bool ok = sorted && (first < 0 || first >= before);
    if (first >= 0 && before < 0) first_sh = (uint32_t)first;  // the tile's first kept row
    const int tile_sorted = __syncthreads_and(ok);
    block_exclusive<THREADS>(cnt, 0, Sum(), tmp, &kept);  // syncs: first_sh is written
    if (t == 0) {
        info[blockIdx.x] = {(int32_t)kept, tile_sorted, kept > 0 ? first_sh : 0u,
                            (uint32_t)(tile_max < 0 ? 0 : tile_max)};
    }
    for (int i = t; i < digits * RADIX; i += THREADS) {
        if (sh[i] != 0) atomicAdd(&hist[i], sh[i]);
    }
}

// One block. flag[0]: presorted; flag[1]: kept rows. tile_off: each
// tile's offset among the kept rows. base[dg * RADIX + d]: where digit d of
// pass dg starts in the output.
__global__ void __launch_bounds__(DECIDE_THREADS)
decide_kernel(const TileInfo* __restrict__ info, int64_t tiles, int digits,
              const int32_t* __restrict__ hist, int32_t* __restrict__ base,
              int32_t* __restrict__ tile_off, int32_t* __restrict__ flag) {
    __shared__ int64_t tmp[DECIDE_THREADS / 32];
    const int t = threadIdx.x;
    const int64_t per = (tiles + DECIDE_THREADS - 1) / DECIDE_THREADS;
    const int64_t lo = (int64_t)t * per < tiles ? (int64_t)t * per : tiles;
    const int64_t hi = lo + per < tiles ? lo + per : tiles;
    int64_t cnt = 0, mx = -1, first = -1;
    bool sorted = true;
    for (int64_t i = lo; i < hi; ++i) {
        const TileInfo ti = info[i];
        if (ti.kept > 0) {
            sorted = sorted && ti.sorted && (int64_t)ti.first >= mx;
            mx = (int64_t)ti.last > mx ? (int64_t)ti.last : mx;
            if (first < 0) first = ti.first;
        }
        cnt += ti.kept;
    }
    int64_t all_max, total;
    const int64_t before = block_exclusive<DECIDE_THREADS>(mx, -1, Max(), tmp, &all_max);
    const int presorted = __syncthreads_and(sorted && (first < 0 || first >= before));
    int64_t off = block_exclusive<DECIDE_THREADS>(cnt, 0, Sum(), tmp, &total);
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
        const int64_t e = block_exclusive<DECIDE_THREADS>(t < RADIX ? hist[dg * RADIX + t] : 0, 0,
                                                          Sum(), tmp, &all);
        if (t < RADIX) base[dg * RADIX + t] = (int32_t)e;
    }
}

// Presorted: kept rows to [0, kept) in input order with their payloads,
// dropped rows to [kept, n) as sentinel keys. Row j * THREADS + t of the
// tile is thread t's j-th (loads and stores coalesce); every key, then
// every kept payload, is loaded before the first store, and one scan over
// the (round, warp) counts of kept rows ranks them all.
__global__ void __launch_bounds__(THREADS)
compact_kernel(const uint32_t* __restrict__ keys, const uint64_t* __restrict__ vals, int64_t n,
               uint32_t sentinel, const int32_t* __restrict__ tile_off,
               const int32_t* __restrict__ flag, uint32_t* __restrict__ k_out,
               uint64_t* __restrict__ v_out) {
    if (!flag[0]) return;
    __shared__ int32_t off[ITEMS * WARPS];
    __shared__ int64_t tmp[WARPS];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int w = t >> 5;
    const int64_t ts = (int64_t)blockIdx.x * TILE + t;
    uint32_t kk[ITEMS];
    uint64_t vv[ITEMS];
    unsigned bal[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int64_t row = ts + (int64_t)j * THREADS;
        kk[j] = row < n ? keys[row] : sentinel;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        vv[j] = kk[j] != sentinel ? vals[ts + (int64_t)j * THREADS] : 0;
        bal[j] = __ballot_sync(0xffffffffu, kk[j] != sentinel);
        if (lane == 0) off[j * WARPS + w] = __popc(bal[j]);
    }
    __syncthreads();
    int64_t all;
    const int64_t e = block_exclusive<THREADS>(t < ITEMS * WARPS ? off[t] : 0, 0, Sum(), tmp,
                                               &all);
    if (t < ITEMS * WARPS) off[t] = (int32_t)e;  // block_exclusive synced after every read
    __syncthreads();
    const int64_t base = tile_off[blockIdx.x];
    const int64_t kept_total = flag[1];
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int64_t row = ts + (int64_t)j * THREADS;
        const int64_t at = base + off[j * WARPS + w] + __popc(bal[j] & lt);
        if (kk[j] != sentinel) {
            k_out[at] = kk[j];
            v_out[at] = vv[j];
        } else if (row < n) {
            k_out[kept_total + (row - at)] = sentinel;  // row - at: dropped rows before it
        }
    }
}

// zero the look-back status words, unless the rows are presorted
__global__ void zero_kernel(uint64_t* __restrict__ p, int64_t count,
                            const int32_t* __restrict__ flag) {
    if (flag[0]) return;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
         i += (int64_t)gridDim.x * blockDim.x) {
        p[i] = 0;
    }
}

// shared memory of sweep_kernel: payloads, keys, warp digit counts, the
// tile's digit starts and the digits' output bases
constexpr int SWEEP_SMEM = TILE * 8 + TILE * 4 + WARPS * RADIX * 4 + 2 * RADIX * 4;

__device__ inline uint64_t load_status(const uint64_t* p) {
    return *reinterpret_cast<const volatile uint64_t*>(p);
}

__device__ inline void store_status(uint64_t* p, uint64_t x) {
    *reinterpret_cast<volatile uint64_t*>(p) = x;
}

// One stable digit pass (bits [shift, shift + 8)) unless presorted.
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const uint32_t* __restrict__ k_in, const uint64_t* __restrict__ v_in,
             uint32_t* __restrict__ k_out, uint64_t* __restrict__ v_out, int64_t n, int shift,
             const int32_t* __restrict__ base, uint64_t* __restrict__ status,
             int32_t* __restrict__ counter, const int32_t* __restrict__ flag) {
    if (flag[0]) return;
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* sv = reinterpret_cast<uint64_t*>(smem);
    uint32_t* sk = reinterpret_cast<uint32_t*>(sv + TILE);
    int32_t* wh = reinterpret_cast<int32_t*>(sk + TILE);  // [WARPS][RADIX]
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
    const int64_t wrow = ts + (int64_t)w * WARP_ROWS + lane;

    // 1. rank each row among the warp's rows of its digit, in row order
    uint32_t kk[ITEMS];
    int32_t rk[ITEMS];
    int32_t* own = wh + w * RADIX;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int64_t row = wrow + j * 32;
        const bool valid = row < n;
        const uint32_t k = valid ? k_in[row] : 0u;
        const uint32_t d = valid ? (k >> shift) & (RADIX - 1) : RADIX;
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
    const int32_t s0 = (int32_t)block_exclusive<THREADS>(cnt, 0, Sum(), tmp, &all);
    start[d] = s0;
    __syncthreads();

    // 3. stage the tile digit-grouped (the payloads load while earlier
    //    tiles finish), then look back for the tile's offset in digit d
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int64_t row = wrow + j * 32;
        if (row < n) {
            const uint32_t dj = (kk[j] >> shift) & (RADIX - 1);
            const int s = start[dj] + wh[w * RADIX + dj] + rk[j];
            sk[s] = kk[j];
            sv[s] = v_in[row];
        }
    }
    int64_t excl = 0;
    if (tile > 0) {
        for (int64_t p = tile - 1; p >= 0;) {
            const uint64_t s = load_status(status + p * RADIX + d);
            if ((s & ~COUNT_MASK) == 0) continue;  // not published yet
            excl += (int64_t)(s & COUNT_MASK);
            if ((s & ~COUNT_MASK) == INCLUSIVE) break;
            --p;
        }
        store_status(st, INCLUSIVE | (uint64_t)(excl + cnt));
    }
    gbase[d] = (int32_t)(base[d] + excl - s0);
    __syncthreads();

    // 4. each digit's rows leave the tile as one contiguous run
    const int len = n - ts < TILE ? (int)(n - ts) : TILE;
    for (int i = t; i < len; i += THREADS) {
        const uint32_t k = sk[i];
        const int64_t pos = (int64_t)gbase[(k >> shift) & (RADIX - 1)] + i;
        k_out[pos] = k;
        v_out[pos] = sv[i];
    }
}

struct Scratch {
    uint32_t* kc;      // the key pass's keys: the partition reads them and
                       // writes the last pass's buffer, k[0] or k[1]
    uint32_t* k[2];    // digit passes, ping-pong
    uint64_t* v[2];
    TileInfo* info;
    int32_t* tile_off;
    int32_t* hist;     // [MAX_DIGITS][RADIX], then the tile counters and flags
    int32_t* counters;
    int32_t* flag;
    int32_t* base;     // [MAX_DIGITS][RADIX]
    uint64_t* status;  // [MAX_DIGITS][tiles][RADIX]
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

// Lays the scratch out; with p null, only counts its bytes.
inline Scratch carve(void* p, int64_t n, int64_t* bytes) {
    const int64_t m = n > 0 ? n : 1;
    const int64_t tiles = tiles_for(n);
    Carver c{reinterpret_cast<uintptr_t>(p)};
    Scratch s;
    s.kc = c.take<uint32_t>(m);
    s.k[0] = c.take<uint32_t>(m);
    s.k[1] = c.take<uint32_t>(m);
    s.v[0] = c.take<uint64_t>(m);
    s.v[1] = c.take<uint64_t>(m);
    s.info = c.take<TileInfo>(tiles);
    s.tile_off = c.take<int32_t>(tiles);
    s.base = c.take<int32_t>(MAX_DIGITS * RADIX);
    s.hist = c.take<int32_t>(MAX_DIGITS * RADIX + MAX_DIGITS + 2);  // zeroed together
    s.counters = s.hist + MAX_DIGITS * RADIX;
    s.flag = s.counters + MAX_DIGITS;
    s.status = c.take<uint64_t>((int64_t)MAX_DIGITS * tiles * RADIX);
    if (bytes) *bytes = c.used;
    return s;
}

inline int64_t scratch_bytes(int64_t n) {
    int64_t bytes = 0;
    carve(nullptr, n, &bytes);
    return bytes;
}

// byte offset in the scratch of the int32 presorted flag (1: the rows
// took the partition, 0: the digit passes), once the sort has run
inline int64_t flag_offset(int64_t n) {
    return (int64_t)reinterpret_cast<uintptr_t>(carve(nullptr, n, nullptr).flag);
}

struct Sorted {
    const uint32_t* keys;
    const uint64_t* vals;
};

// The stable sort of src's n keys (1 <= n < 2^31, sentinel >= 1) with
// payload vals[i], into scratch laid out by carve(scratch, n). All
// launches on `s`, nothing synchronised.
template <class Src>
inline Sorted sort(const Src& src, const uint64_t* vals, int64_t n, uint32_t sentinel,
                   void* scratch, cudaStream_t s) {
    const Scratch b = carve(scratch, n, nullptr);
    const int digits = digits_for(sentinel);
    const int64_t tiles = tiles_for(n);
    const int last = (digits - 1) % 2;  // pass p writes buffers p % 2
    cudaMemsetAsync(b.hist, 0, (MAX_DIGITS * RADIX + MAX_DIGITS + 2) * sizeof(int32_t), s);
    key_kernel<Src><<<(unsigned)tiles, THREADS, 0, s>>>(src, n, sentinel, digits, b.kc, b.info,
                                                        b.hist);
    decide_kernel<<<1, DECIDE_THREADS, 0, s>>>(b.info, tiles, digits, b.hist, b.base,
                                               b.tile_off, b.flag);
    compact_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(b.kc, vals, n, sentinel, b.tile_off,
                                                       b.flag, b.k[last], b.v[last]);
    zero_kernel<<<132 * 8, 256, 0, s>>>(b.status, (int64_t)digits * tiles * RADIX, b.flag);
    cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SWEEP_SMEM);
    for (int p = 0; p < digits; ++p) {
        const uint32_t* k_in = p == 0 ? b.kc : b.k[(p - 1) % 2];
        const uint64_t* v_in = p == 0 ? vals : b.v[(p - 1) % 2];
        sweep_kernel<<<(unsigned)tiles, THREADS, SWEEP_SMEM, s>>>(
            k_in, v_in, b.k[p % 2], b.v[p % 2], n, 8 * p, b.base + p * RADIX,
            b.status + (int64_t)p * tiles * RADIX, b.counters + p, b.flag);
    }
    return {b.k[last], b.v[last]};
}

}  // namespace onesweep
