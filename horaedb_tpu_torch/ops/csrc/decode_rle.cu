// decode_rle: the rows of a run-length-encoded integer lane.
//
// Replaces the JAX package's ops/decode.py::_rle_kernel (catalog name
// decode_rle): row i of a page takes the value of run
// searchsorted(cum, i, side="right"), where cum is the inclusive
// cumulative sum of the run lengths, i.e. the last run that starts at or
// before row i (a run of length 0 starts where the next one does, so the
// last of equal starts is the one that holds rows).
//
// Bound on an H100: memory. Per run it reads the value and its u32 length
// (12 B for 8-byte values), per row it writes the value (8 or 4 B): 1.8M
// rows of 8 B in 440 pages of ~23 runs are 4.3 us at 3.35 TB/s.
// What held the first version back: the host built an int64 `cum` lane per
// page (a numpy cumsum a page) and uploaded it, and each thread took every
// 256th row of its page and binary-searched `cum` in global memory for it:
// log2(runs) dependent loads a row, then the run's value from global
// memory again. Design: one block per page reads the page's run values
// and lengths straight from the word lane (the lengths follow the values)
// and walks the page's runs in batches of RB = 1,024:
//   1. warp w owns the batch's runs [128 w, 128 w + 128) and scans their
//      lengths 32 a round (coalesced loads, one warp scan a round, a
//      running total in a register), copying their values into a shared
//      value lane with the same loads' latency; one barrier shares the
//      eight warps' totals, and each thread writes its runs' start rows
//      (relative to the batch's first row, u32: stage_pages keeps a page
//      under 2^32 rows) into a shared start lane, with the batch's row
//      count behind them;
//   2. the batch's rows are expanded in chunks of 4,096 (bitunpack.cuh's
//      staged-chunk pattern): thread t owns the chunk's rows [16 t, 16 t +
//      16), finds the last run starting at or before its first row by one
//      binary search in the *shared* start lane, then walks forward (a
//      merge-path split: one search a thread, not one a row; a scatter of
//      run ids at their start rows and a max-scan would cost a cleared
//      chunk, a scatter and a block scan, where the main path's pages hold
//      ~23 runs, so the search is five shared reads), reading a run's value
//      from the shared value lane when its run changes; it stages its 16
//      values in shared memory;
//   3. the block writes the chunk's rows out, 256 consecutive rows a step.
// So a block waits on two dependent global reads (its table row, then its
// runs) before its stores: with the value read after the search as a
// third, the kernel took 0.0095 ms of device on the shape above, with it
// in shared memory 0.0075 (an H100 80GB HBM3 at 700 W, `chip_ab.py
// decode-pair`). RB is 1,024 so that the value lane, the start lane and
// the row stage fit 48 KB and four blocks an SM (440 pages in one wave). 8-byte values sit on 4-byte boundaries in the
// word lane, so they are read as two words.
#include "bitunpack.cuh"

namespace {

constexpr int ITEMS = dec::kItems;
constexpr int TILE = dec::kTile;
constexpr int RB = 1024;                         // runs a batch
constexpr int WARP_RUNS = RB / dec::kWarps;      // runs a warp scans
constexpr int ROUNDS = WARP_RUNS / 32;

template <class T>
__device__ __forceinline__ T run_value(const uint32_t* __restrict__ vals, int64_t k) {
    if (sizeof(T) == 8) {
        return (T)((uint64_t)__ldg(vals + 2 * k) | ((uint64_t)__ldg(vals + 2 * k + 1) << 32));
    }
    return (T)__ldg(vals + k);
}

template <class T>
__global__ void __launch_bounds__(dec::kThreads)
rle_kernel(const uint32_t* __restrict__ words, const int64_t* __restrict__ table,
           T* __restrict__ out) {
    __shared__ uint64_t buf[dec::kRowSlots];  // the chunk's staged rows
    __shared__ uint32_t start[RB + 1];         // the batch's run starts, then its rows
    __shared__ T run_val[RB];                  // the batch's run values
    __shared__ uint32_t warp_tot[dec::kWarps];
    T* staged_rows = reinterpret_cast<T*>(buf);
    const dec::Page pg = dec::load_page(table, blockIdx.x);
    const int64_t n_runs = pg.p0;
    const uint32_t* vals = words + pg.word_off;
    const uint32_t* lens = vals + n_runs * (int64_t)(sizeof(T) / 4);
    T* page_out = out + pg.out_off;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int first = (int)threadIdx.x * ITEMS;  // this thread's first row of a chunk
    int64_t row_lo = 0;                          // the batch's first row in the page
    for (int64_t rb = 0; rb < n_runs; rb += RB) {
        const int nb = n_runs - rb < RB ? (int)(n_runs - rb) : RB;
        // 1. the warp's runs k0 .. k0 + 127, 32 a round
        const int k0 = warp * WARP_RUNS;
        uint32_t local[ROUNDS];
        uint32_t wsum = 0;
#pragma unroll
        for (int q = 0; q < ROUNDS; ++q) {
            local[q] = 0;
            if (k0 + q * 32 < nb) {  // the same for the whole warp
                const int k = k0 + q * 32 + lane;
                const uint32_t x = k < nb ? __ldg(lens + rb + k) : 0u;
                if (k < nb) run_val[k] = run_value<T>(vals, rb + k);
                uint32_t incl = x;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, d);
                    if (lane >= d) incl += y;
                }
                local[q] = wsum + incl - x;
                wsum += __shfl_sync(0xffffffffu, incl, 31);
            }
        }
        if (lane == 0) warp_tot[warp] = wsum;
        __syncthreads();
        uint32_t off = 0, span = 0;
#pragma unroll
        for (int v = 0; v < dec::kWarps; ++v) {
            const uint32_t t = warp_tot[v];
            off += v < warp ? t : 0u;
            span += t;
        }
#pragma unroll
        for (int q = 0; q < ROUNDS; ++q) {
            const int k = k0 + q * 32 + lane;
            if (k < nb) start[k] = off + local[q];
        }
        if (threadIdx.x == 0) start[nb] = span;  // above every row: the walk's sentinel
        __syncthreads();
        // 2. the batch's rows [0, span), a chunk at a time
        for (uint32_t c0 = 0; c0 < span; c0 += TILE) {
            const int len = span - c0 < (uint32_t)TILE ? (int)(span - c0) : TILE;
            if (first < len) {
                const uint32_t r0 = c0 + (uint32_t)first;
                int lo = 0, hi = nb;  // start[lo] <= r0 < start[hi]
                while (hi - lo > 1) {
                    const int mid = (lo + hi) >> 1;
                    if (start[mid] <= r0) {
                        lo = mid;
                    } else {
                        hi = mid;
                    }
                }
                int k = lo;
                T v = run_val[k];
#pragma unroll
                for (int j = 0; j < ITEMS; ++j) {
                    if (first + j < len) {
                        const uint32_t r = r0 + j;
                        if (start[k + 1] <= r) {
                            do {
                                ++k;
                            } while (start[k + 1] <= r);
                            v = run_val[k];
                        }
                        staged_rows[dec::row_at(first + j)] = v;
                    }
                }
            }
            __syncthreads();
            // 3.
            dec::write_chunk(page_out + row_lo + c0, staged_rows, len);
            __syncthreads();  // the next chunk's rows, or batch's starts, overwrite these
        }
        row_lo += span;
    }
}

}  // namespace

// words: u32[total words + 1 guard]; table: int64[n_pages, 6] with p0 =
// the page's runs (its run values, then their u32 lengths, from word_off;
// the lengths add up to its rows, under 2^32); out: rows of `itemsize` (8
// or 4) bytes.
extern "C" int decode_rle_launch(const void* words, const void* table, int64_t n_pages,
                                 int itemsize, void* out, void* stream) {
    if ((itemsize != 8 && itemsize != 4) || n_pages < 0 || n_pages >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_pages > 0) {
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        const uint32_t* w = static_cast<const uint32_t*>(words);
        const int64_t* t = static_cast<const int64_t*>(table);
        if (itemsize == 8) {
            rle_kernel<uint64_t><<<(unsigned)n_pages, dec::kThreads, 0, s>>>(
                w, t, static_cast<uint64_t*>(out));
        } else {
            rle_kernel<uint32_t><<<(unsigned)n_pages, dec::kThreads, 0, s>>>(
                w, t, static_cast<uint32_t*>(out));
        }
    }
    return (int)cudaGetLastError();
}
