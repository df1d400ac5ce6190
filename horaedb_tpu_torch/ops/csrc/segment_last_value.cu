// segment_last_value: per segment, the value of the valid row with the
// largest seq (dedup as a reduction).
//
// Replaces the JAX package's ops/aggregate.py::segment_last_value (catalog
// name segment_last_value). Its function, kept here: a row takes part when
// it is valid and its index lies in [0, num_segments); a segment's winner is
// the row of largest int64 seq among them, ties going to the latest
// position; the output is the winner's value (its bits unchanged), NaN for a
// segment with no such row. The wrapper casts a u64 seq to int64 as the JAX
// function does (`astype(int64)`: 2^63 and above wrap negative).
//
// Bound on an H100: memory. Per row it reads the value (8 B), the seq
// (8 B), the index (4 B) and the mask (1 B); per segment it writes the
// value (8 B). At the dedup shape (7.56M shuffled rows into 7.2M segments)
// each row's update lands on a random slot, so the slots' sectors and the
// L2's atomic units, not the lanes, carry the time.
// Design: a row's claim on its segment is the pair (seq, position), and a
// segment's winner is the pair's max: the largest seq, ties to the latest
// position, the JAX function's winner. A zero slot is "no row", so one
// memset clears the slots; then three passes:
//   1. the min and max seq of the rows that take part (one atomic a block);
//   2. one row pass, on a route the data picks on the device:
//      - packed: when (max - min + 1) * n < 2^32 (or < 2^63), the pair is
//        one u32 (or u64), (seq - min) * n + position + 1, and the row
//        folds it into its segment's 4 B (8 B) slot with one atomic max
//        that returns nothing (red.global.max): at 3k's shape (seq 1..49)
//        the u32 slots are 29 MB and stay in the 50 MB L2;
//      - wide: otherwise the slot is 16 B, one unsigned 128-bit number
//        whose high word is the seq with its top bit flipped (so unsigned
//        order is int64 order) and whose low word is position + 1 (a row of
//        seq INT64_MIN at position 0 is (0, 1), above an empty slot), and
//        the row folds it in with a 16-byte atomic compare-and-swap
//        (atom.cas.b128, compute capability 9.x), starting from the guess
//        "empty": a segment reached by one row takes one atomic;
//   3. the gather writes each winner's value bits, or the quiet NaN.
// Max is order free, so the bits are the same on every run. The first
// version took the wide route always: 0.54 ms for its row pass at 3k's
// shape (NVIDIA H100 80GB HBM3, 700 W), each CAS a round trip to a random
// sector of 115 MB, most of them past the L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint64_t SIGN = 1ull << 63;

struct alignas(16) Slot {
    uint64_t lo;  // position + 1, 0 for an empty slot
    uint64_t hi;  // seq ^ SIGN
};

__device__ inline bool takes_part(const int32_t* index, const uint8_t* valid, int64_t i,
                                  int64_t num_segments, int64_t* seg) {
    *seg = index[i];
    return valid[i] != 0 && *seg >= 0 && *seg < num_segments;
}

__device__ inline uint64_t warp_max(uint64_t x) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        const uint64_t y = __shfl_xor_sync(0xffffffffu, x, d);
        x = y > x ? y : x;
    }
    return x;
}

// pass 1: words[0] = max(seq ^ SIGN), words[1] = max(~(seq ^ SIGN)) over
// the rows that take part (both 0 when none does)
__global__ void __launch_bounds__(THREADS)
slv_range_kernel(const int64_t* __restrict__ seq, const int32_t* __restrict__ index,
                 const uint8_t* __restrict__ valid, int64_t n, int64_t num_segments,
                 uint64_t* __restrict__ words) {
    __shared__ uint64_t part[2][THREADS / 32];
    uint64_t hi = 0, lo = 0;
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * THREADS) {
        int64_t seg;
        const uint64_t u = (uint64_t)seq[i] ^ SIGN;
        if (takes_part(index, valid, i, num_segments, &seg)) {
            hi = u > hi ? u : hi;
            lo = ~u > lo ? ~u : lo;
        }
    }
    hi = warp_max(hi);
    lo = warp_max(lo);
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        part[0][w] = hi;
        part[1][w] = lo;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
        hi = threadIdx.x < THREADS / 32 ? part[0][threadIdx.x] : 0;
        lo = threadIdx.x < THREADS / 32 ? part[1][threadIdx.x] : 0;
        hi = warp_max(hi);
        lo = warp_max(lo);
        if (threadIdx.x == 0) {
            if (hi != 0) atomicMax(reinterpret_cast<unsigned long long*>(words), hi);
            if (lo != 0) atomicMax(reinterpret_cast<unsigned long long*>(words + 1), lo);
        }
    }
}

// the slot bytes of the route the range allows: 4 or 8 when every kept
// (seq, position) packs into a u32 or a u64 key, else 16
__device__ inline int slot_bytes(const uint64_t* words, int64_t n) {
    const uint64_t span = words[0] - ~words[1];  // max - min of seq ^ SIGN
    return span < (uint64_t)UINT32_MAX / (uint64_t)n   ? 4
           : span < (uint64_t)INT64_MAX / (uint64_t)n ? 8
                                                        : 16;
}

__device__ inline bool above(Slot v, Slot s) {
    return v.hi > s.hi || (v.hi == s.hi && v.lo > s.lo);
}

// *p = v if *p == expect; returns the old *p, read atomically (16 bytes)
__device__ inline Slot cas128(Slot* p, Slot expect, Slot v) {
    Slot old;
    asm volatile(
        "{\n"
        ".reg .b128 c, v, d;\n"
        "mov.b128 c, {%2, %3};\n"
        "mov.b128 v, {%4, %5};\n"
        "atom.global.cas.b128 d, [%6], c, v;\n"
        "mov.b128 {%0, %1}, d;\n"
        "}\n"
        : "=l"(old.lo), "=l"(old.hi)
        : "l"(expect.lo), "l"(expect.hi), "l"(v.lo), "l"(v.hi), "l"(p)
        : "memory");
    return old;
}

// pass 2: each row's pair into its segment's slot, on the route the range
// allows
__global__ void __launch_bounds__(THREADS)
slv_rows_kernel(const int64_t* __restrict__ seq, const int32_t* __restrict__ index,
                const uint8_t* __restrict__ valid, int64_t n, int64_t num_segments,
                const uint64_t* __restrict__ words, Slot* __restrict__ slots) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    int64_t seg;
    const uint64_t u = (uint64_t)seq[i] ^ SIGN;
    if (!takes_part(index, valid, i, num_segments, &seg)) return;
    const int width = slot_bytes(words, n);
    if (width != 16) {
        const uint64_t key = (u - ~words[1]) * (uint64_t)n + (uint64_t)i + 1;
        if (width == 4) {
            uint32_t* slot = reinterpret_cast<uint32_t*>(slots) + seg;
            asm volatile("red.global.max.u32 [%0], %1;" ::"l"(slot), "r"((uint32_t)key) : "memory");
        } else {
            uint64_t* slot = reinterpret_cast<uint64_t*>(slots) + seg;
            asm volatile("red.global.max.u64 [%0], %1;" ::"l"(slot), "l"(key) : "memory");
        }
        return;
    }
    const Slot v{(uint64_t)i + 1, u};
    Slot cur{0, 0};
    while (above(v, cur)) {
        const Slot old = cas128(slots + seg, cur, v);
        if (old.lo == cur.lo && old.hi == cur.hi) break;  // v is in
        cur = old;
    }
}

// pass 3: the winners' values
__global__ void __launch_bounds__(THREADS)
slv_gather_kernel(const double* __restrict__ values, const uint64_t* __restrict__ words,
                  const Slot* __restrict__ slots, int64_t n, int64_t num_segments,
                  double* __restrict__ out) {
    const int64_t s = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (s >= num_segments) return;
    const int width = n > 0 ? slot_bytes(words, n) : 16;
    uint64_t at;  // position + 1, 0 for no row
    if (width == 16) {
        at = slots[s].lo;
    } else {
        const uint64_t key = width == 4 ? reinterpret_cast<const uint32_t*>(slots)[s]
                                        : reinterpret_cast<const uint64_t*>(slots)[s];
        at = key != 0 ? (key - 1) % (uint64_t)n + 1 : 0;
    }
    out[s] = at != 0 ? values[at - 1] : __longlong_as_double(0x7ff8000000000000LL);  // quiet NaN
}

}  // namespace

// Bytes of scratch a launch over num_segments segments needs: the two
// range words (16 B), then one 16 B slot a segment (16 B aligned, as every
// allocation of the card is).
extern "C" int64_t segment_last_value_scratch_bytes(int64_t num_segments) {
    return (int64_t)sizeof(Slot) + num_segments * (int64_t)sizeof(Slot);
}

// values: f64[n]; seq: int64[n]; index: int32[n]; valid: uint8[n];
// scratch: segment_last_value_scratch_bytes(num_segments) bytes; out:
// f64[num_segments]. n < 2^31.
extern "C" int segment_last_value_launch(const void* values, const void* seq, const void* index,
                                         const void* valid, int64_t n, int64_t num_segments,
                                         void* scratch, void* out, void* stream) {
    if (n < 0 || n >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    if (num_segments <= 0) return (int)cudaGetLastError();
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint64_t* words = static_cast<uint64_t*>(scratch);  // the range, in the first slot's place
    Slot* slots = static_cast<Slot*>(scratch) + 1;
    const cudaError_t e =
        cudaMemsetAsync(scratch, 0, (size_t)segment_last_value_scratch_bytes(num_segments), s);
    if (e != cudaSuccess) return (int)e;
    if (n > 0) {
        const int64_t blocks = (n + THREADS - 1) / THREADS;
        const int64_t* sq = static_cast<const int64_t*>(seq);
        const int32_t* ix = static_cast<const int32_t*>(index);
        const uint8_t* ok = static_cast<const uint8_t*>(valid);
        slv_range_kernel<<<(unsigned)(blocks < 132 * 8 ? blocks : 132 * 8), THREADS, 0, s>>>(
            sq, ix, ok, n, num_segments, words);
        slv_rows_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(sq, ix, ok, n, num_segments, words,
                                                             slots);
    }
    slv_gather_kernel<<<(unsigned)((num_segments + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        static_cast<const double*>(values), words, slots, n, num_segments,
        static_cast<double*>(out));
    return (int)cudaGetLastError();
}
