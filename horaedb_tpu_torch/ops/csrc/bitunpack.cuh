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
//   from global memory or from a block's copy of a run of words in shared
//   memory (`Staged`), and the zigzag decode.
// - The staged-chunk pattern of the kernels that scan (decode_dod,
//   decode_xor) or expand (decode_rle) a page: the page is walked in chunks
//   of kTile = 4,096 rows, thread t owning the chunk's rows [16 t, 16 t +
//   16); `stage_chunk` copies the words a chunk's bit windows span into
//   shared memory, coalesced, and each thread stages its 16 rows at
//   `row_at` (one pad per 16 rows, so a warp's stores fall on distinct
//   banks) for `write_chunk` to store 256 consecutive rows a step.
// - A block-wide exclusive XOR scan over 64-bit words (decode_xor; dod
//   scans its pair of sums with its own).
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

// -- the staged chunk ----------------------------------------------------------

constexpr int kItems = 16;                // consecutive rows a thread
constexpr int kTile = kThreads * kItems;  // rows a chunk
constexpr int kWarps = kThreads / 32;
// the most words a chunk's windows span: kTile windows of 32 bits, the word
// a window straddles into and the one past the last window
constexpr int kMaxWords = kTile + 2;
constexpr int kRowSlots = kTile + kTile / 16;  // staged rows with their pads
static_assert(kRowSlots * sizeof(uint64_t) >= stage_capacity(kMaxWords) * sizeof(uint32_t),
              "a chunk's words fit its row stage");

__device__ __forceinline__ int row_at(int r) { return r + (r >> 4); }

// Stage the words of chunk rows [base, end) of a page whose row r >= lag
// holds the `width`-bit value at stream bit (r - lag) * width (dod: lag 2,
// xor: lag 1). The same for the whole block; a chunk with no stream rows
// (or width 0) stages nothing and does not wait.
__device__ __forceinline__ void stage_chunk(const uint32_t* __restrict__ w, int64_t base,
                                            int64_t end, int lag, int64_t width, Staged& st) {
    const int64_t s_lo = base >= lag ? base - lag : 0;
    const int64_t s_hi = end - lag;
    if (width > 0 && s_hi > s_lo) {
        const int64_t w0 = (s_lo * width) >> 5;
        const int64_t w1 = (((s_hi - 1) * width) >> 5) + 2;  // the last window's pair
        st.bit0 = w0 << 5;
        stage_words<kMaxWords>(w, w0, (int)(w1 - w0), st);
    }
}

// Store `len` staged rows (slots row_at(0 .. len - 1)) at out[0 .. len),
// 256 consecutive rows a step. The caller orders the row stage before it
// and the next chunk's stage after it with barriers.
template <class T>
__device__ __forceinline__ void write_chunk(T* __restrict__ out, const T* staged, int len) {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
        const int i = q * kThreads + (int)threadIdx.x;
        if (i < len) out[i] = staged[row_at(i)];
    }
}

// Exclusive XOR scan of one value per thread over the block (blockDim.x ==
// kThreads): returns the XOR over the threads before this one and sets
// `total` to the XOR over all. Every thread of the block must call it.
// `warp_tot` is shared scratch of kWarps words; two barriers, none at the
// end: the caller passes a barrier before the next call writes warp_tot.
__device__ __forceinline__ uint64_t block_exclusive_xor(uint64_t x, uint64_t* warp_tot,
                                                        uint64_t& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint64_t incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint64_t y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl ^= y;
    }
    const uint64_t excl = incl ^ x;
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        uint64_t t = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
        for (int d = 1; d < kWarps; d <<= 1) {
            const uint64_t y = __shfl_up_sync(0xffffffffu, t, d);
            if (lane >= d) t ^= y;
        }
        if (lane < kWarps) warp_tot[lane] = t;  // inclusive over the warps
    }
    __syncthreads();
    total = warp_tot[kWarps - 1];
    return warp > 0 ? warp_tot[warp - 1] ^ excl : excl;
}

}  // namespace dec
