// bitunpack.cuh: what the four decode kernels share.
//
// - The page table. The wrapper (ops/decode.py) uploads one lane's kept
//   pages as one u32 word lane (each page starts on a word: pack_bits pads
//   to words, and an rle page holds 8- or 4-byte run values plus u32
//   lengths) with one zero guard word at the end, and one int64 row per
//   page: (out_off, rows, word_off, width, p0, p1). Each kernel runs one
//   block per page and writes the page's rows at out_off, so the output is
//   the kept pages' rows in page order, with no padding.
// - The two-word bit-window read of an LSB-first stream (width <= 32),
//   from global memory or (decode_dod so far) from a block's copy of a run
//   of words in shared memory (`Staged`), and the zigzag decode.
// - A block-wide inclusive scan over 64-bit words (add or xor), which wraps
//   mod 2^64 as the JAX package's uint64 arithmetic does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dec {

constexpr int kThreads = 256;  // a multiple of 32: the scan is warp by warp
constexpr int kPageFields = 6;

struct Page {
    int64_t out_off, rows, word_off, width, p0, p1;
};

__device__ __forceinline__ Page load_page(const int64_t* __restrict__ table, int64_t p) {
    const int64_t* t = table + p * kPageFields;
    return {t[0], t[1], t[2], t[3], t[4], t[5]};
}

// The `width`-bit value (0 <= width <= 32) at bit `bit` of the stream that
// starts at `words`: the two words its window can span, read as one u64,
// shifted and masked. A window in the last word of a page reads one word
// past it: the next page's first word or the guard word, masked off.
// Width 0 reads nothing (a page of width 0 may hold no words at all).
__device__ __forceinline__ uint64_t unpack_at(const uint32_t* __restrict__ words, int64_t bit,
                                              int64_t width) {
    if (width == 0) return 0;
    const int64_t wi = bit >> 5;
    const uint64_t pair = (uint64_t)words[wi] | ((uint64_t)words[wi + 1] << 32);
    return (pair >> (bit & 31)) & ((1ull << width) - 1);
}

__device__ __forceinline__ uint64_t unzigzag(uint64_t z) { return (z >> 1) ^ (0ull - (z & 1)); }

// A run of a page's words copied into shared memory, one pad word per
// `1 << pad_shift` words so that the windows a warp reads at once fall on
// distinct banks, or on two: threads that own 16 consecutive rows read
// words W/2 apart (W the width), and one pad per 32 words spreads those
// strides over the banks for every width but 31, whose two-thread stride
// of 31 words pads to 32; it takes one pad per 16.
struct Staged {
    uint32_t* sw;
    int pad_shift;
    int64_t bit0;  // stream bit of staged word 0

    __device__ __forceinline__ int at(int k) const { return k + (k >> pad_shift); }

    // the `width`-bit value at stream bit `bit` (inside the staged run)
    __device__ __forceinline__ uint64_t window(int64_t bit, int64_t width) const {
        const int64_t b = bit - bit0;
        const int k = (int)(b >> 5);
        const uint64_t pair = (uint64_t)sw[at(k)] | ((uint64_t)sw[at(k + 1)] << 32);
        return (pair >> (b & 31)) & ((1ull << width) - 1);
    }
};

__device__ __forceinline__ int stage_pad_shift(int64_t width) { return width == 31 ? 4 : 5; }

// Shared words a stage of `words` words takes with its pad words (at most
// one per 16).
constexpr int stage_capacity(int words) { return words + (words >> 4) + 1; }

// Copy words [first, first + count) of `w` into `st` (count <= NMAX): every
// load of a thread issued before its first store. Ends with a barrier.
template <int NMAX>
__device__ __forceinline__ void stage_words(const uint32_t* __restrict__ w, int64_t first,
                                            int count, const Staged& st) {
    constexpr int PER = (NMAX + kThreads - 1) / kThreads;
    uint32_t v[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int k = q * kThreads + threadIdx.x;
        v[q] = k < count ? __ldg(w + first + k) : 0u;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int k = q * kThreads + threadIdx.x;
        if (k < count) st.sw[st.at(k)] = v[q];
    }
    __syncthreads();
}

__device__ __forceinline__ void store(void* __restrict__ out, int64_t i, uint64_t v,
                                      int itemsize) {
    if (itemsize == 8) {
        static_cast<uint64_t*>(out)[i] = v;
    } else {
        static_cast<uint32_t*>(out)[i] = (uint32_t)v;  // the dtype's low bits
    }
}

struct Add {
    __device__ static uint64_t identity() { return 0; }
    __device__ uint64_t operator()(uint64_t a, uint64_t b) const { return a + b; }
};

struct Xor {
    __device__ static uint64_t identity() { return 0; }
    __device__ uint64_t operator()(uint64_t a, uint64_t b) const { return a ^ b; }
};

// Inclusive scan of one value per thread over the block (blockDim.x ==
// kThreads). Every thread of the block must call it. `warp_tot` is shared
// scratch of 32 words; the trailing barrier lets the next call reuse it.
template <typename Op>
__device__ uint64_t block_inclusive_scan(uint64_t x, uint64_t* warp_tot, Op op) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
        const uint64_t y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x = op(y, x);
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const int nw = blockDim.x >> 5;
        uint64_t t = lane < nw ? warp_tot[lane] : Op::identity();
        for (int d = 1; d < 32; d <<= 1) {
            const uint64_t y = __shfl_up_sync(0xffffffffu, t, d);
            if (lane >= d) t = op(y, t);
        }
        if (lane < nw) warp_tot[lane] = t;
    }
    __syncthreads();
    if (warp > 0) x = op(warp_tot[warp - 1], x);
    __syncthreads();
    return x;
}

}  // namespace dec
