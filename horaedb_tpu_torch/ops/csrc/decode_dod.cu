// decode_dod: the rows of a delta-of-delta timestamp lane.
//
// Replaces the JAX package's ops/decode.py::_dod_kernel (catalog name
// decode_dod). Per page: row i >= 2 holds the zigzag second-order delta at
// bit (i - 2) * width; d[i] = first_delta * [i >= 1] + sum_{k <= i} dd[k]
// and v[i] = first + sum_{k <= i} d[k], all mod 2^64, written at the lane
// dtype's width (int64, or the low 32 bits for int32).
//
// Bound on an H100: memory. Per row it reads width/8 bytes and writes 8
// (or 4). The two prefix sums are one scan of a pair: with
// S0[i] = sum_{k <= i} dd[k] and S1[i] = sum_{k <= i} k * dd[k],
//   v[i] = first + i * first_delta + (i + 1) * S0[i] - S1[i],
// since sum_{m <= i} S0[m] = sum_{k <= i} (i - k + 1) * dd[k]. Every step is
// a u64 add or multiply, exact mod 2^64 as the JAX kernel's uint64 adds.
// Design: one block per page, walking it in chunks of TILE = 4,096 rows
// (the default page_rows; a longer page carries (S0, S1) from chunk to
// chunk). Per chunk:
//   1. the block copies the words the chunk's bit windows span into shared
//      memory, coalesced (bitunpack.cuh's stage_chunk);
//   2. thread t owns the chunk's rows [16 t, 16 t + 16): it reads their
//      windows, unzigzags them into dd and sums dd and k * dd in registers;
//   3. one block exclusive scan of the threads' (S0, S1) pairs gives each
//      thread the sums over every row before its own;
//   4. each thread forms its 16 values and stages them in shared memory
//      (one pad per 16 rows, so a warp's stores fall on distinct banks);
//   5. the block writes the chunk's rows out, 256 consecutive rows a step
//      (bitunpack.cuh's write_chunk).
// Five barriers a chunk, where a tile scan of each sum took seven barriers
// per 256 rows. No float arithmetic touches a value.
#include "bitunpack.cuh"

namespace {

constexpr int ITEMS = dec::kItems;
constexpr int TILE = dec::kTile;
constexpr int WARPS = dec::kWarps;
using dec::row_at;

// Exclusive scan of the pair (a, b) over the block's threads, sums mod
// 2^64: (ea, eb) the sums over the threads before, (ta, tb) the block's.
__device__ __forceinline__ void pair_scan(uint64_t a, uint64_t b, uint64_t (*tmp)[WARPS],
                                          uint64_t& ea, uint64_t& eb, uint64_t& ta,
                                          uint64_t& tb) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint64_t ia = a, ib = b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint64_t ya = __shfl_up_sync(0xffffffffu, ia, d);
        const uint64_t yb = __shfl_up_sync(0xffffffffu, ib, d);
        if (lane >= d) {
            ia += ya;
            ib += yb;
        }
    }
    if (lane == 31) {
        tmp[0][warp] = ia;
        tmp[1][warp] = ib;
    }
    __syncthreads();
    if (warp == 0) {
        uint64_t wa = lane < WARPS ? tmp[0][lane] : 0;
        uint64_t wb = lane < WARPS ? tmp[1][lane] : 0;
#pragma unroll
        for (int d = 1; d < WARPS; d <<= 1) {
            const uint64_t ya = __shfl_up_sync(0xffffffffu, wa, d);
            const uint64_t yb = __shfl_up_sync(0xffffffffu, wb, d);
            if (lane >= d) {
                wa += ya;
                wb += yb;
            }
        }
        if (lane < WARPS) {  // inclusive over the warps
            tmp[0][lane] = wa;
            tmp[1][lane] = wb;
        }
    }
    __syncthreads();
    ea = (warp > 0 ? tmp[0][warp - 1] : 0) + ia - a;
    eb = (warp > 0 ? tmp[1][warp - 1] : 0) + ib - b;
    ta = tmp[0][WARPS - 1];
    tb = tmp[1][WARPS - 1];
}

template <class T>
__global__ void __launch_bounds__(dec::kThreads)
dod_kernel(const uint32_t* __restrict__ words, const int64_t* __restrict__ table,
           T* __restrict__ out) {
    // the chunk's words, then (once every window is read) its staged rows
    __shared__ uint64_t buf[dec::kRowSlots];
    __shared__ uint64_t tmp[2][WARPS];
    T* staged_rows = reinterpret_cast<T*>(buf);
    const dec::Page pg = dec::load_page(table, blockIdx.x);
    const uint32_t* w = words + pg.word_off;
    const uint64_t first = (uint64_t)pg.p0;
    const uint64_t first_delta = (uint64_t)pg.p1;
    const int64_t width = pg.width;
    dec::Staged st{reinterpret_cast<uint32_t*>(buf), dec::stage_pad_shift(width), 0};
    uint64_t c0 = 0, c1 = 0;  // S0 and S1 over the earlier chunks
    for (int64_t base = 0; base < pg.rows; base += TILE) {
        const int64_t end = base + TILE < pg.rows ? base + TILE : pg.rows;
        // 1. the chunk's stream rows s = row - 2
        dec::stage_chunk(w, base, end, 2, width, st);
        // 2. this thread's rows r0 .. r0 + 15
        const int64_t r0 = base + (int64_t)threadIdx.x * ITEMS;
        uint64_t dd[ITEMS];
        uint64_t a0 = 0, a1 = 0;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const int64_t r = r0 + j;
            uint64_t x = 0;
            if (width > 0 && r >= 2 && r < end) {
                x = dec::unzigzag(st.window((r - 2) * width, width));
            }
            dd[j] = x;
            a0 += x;
            a1 += (uint64_t)r * x;
        }
        // 3. the scan's first barrier orders every window read before the
        //    row stores below, which overwrite the words
        uint64_t e0, e1, t0, t1;
        pair_scan(a0, a1, tmp, e0, e1, t0, t1);
        // 4.
        uint64_t s0 = c0 + e0, s1 = c1 + e1;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const uint64_t r = (uint64_t)(r0 + j);
            s0 += dd[j];
            s1 += r * dd[j];
            staged_rows[row_at((int)threadIdx.x * ITEMS + j)] =
                (T)(first + r * first_delta + (r + 1) * s0 - s1);
        }
        c0 += t0;
        c1 += t1;
        __syncthreads();
        // 5.
        dec::write_chunk(out + pg.out_off + base, staged_rows, (int)(end - base));
        __syncthreads();  // the next chunk's words overwrite the staged rows
    }
}

}  // namespace

// words: u32[total words + 1 guard]; table: int64[n_pages, 6] with p0 =
// first, p1 = first_delta; out: rows of `itemsize` (8 or 4) bytes.
extern "C" int decode_dod_launch(const void* words, const void* table, int64_t n_pages,
                                 int itemsize, void* out, void* stream) {
    if ((itemsize != 8 && itemsize != 4) || n_pages < 0 || n_pages >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_pages > 0) {
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        const uint32_t* w = static_cast<const uint32_t*>(words);
        const int64_t* t = static_cast<const int64_t*>(table);
        if (itemsize == 8) {
            dod_kernel<uint64_t><<<(unsigned)n_pages, dec::kThreads, 0, s>>>(
                w, t, static_cast<uint64_t*>(out));
        } else {
            dod_kernel<uint32_t><<<(unsigned)n_pages, dec::kThreads, 0, s>>>(
                w, t, static_cast<uint32_t*>(out));
        }
    }
    return (int)cudaGetLastError();
}
