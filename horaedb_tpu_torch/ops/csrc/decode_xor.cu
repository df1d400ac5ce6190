// decode_xor: the rows of a Gorilla-XOR float lane, as their bits.
//
// Replaces the JAX package's ops/decode.py::_xor_kernel (catalog name
// decode_xor). Per page: row 0 is the first value's bits (p0), row i >= 1
// the XOR delta at bit (i - 1) * width; the value's bits are the prefix XOR
// of the page's rows. An f64 lane writes the 64 bits, an f32 lane their low
// 32 bits; the wrapper views them as floats, so NaN payloads, -0.0 and
// +/-inf come back bit for bit.
//
// Bound on an H100: memory. Per row it reads width/8 bytes and writes 8
// (or 4): 1.8M f32 rows at width 31 are 1.8M x 7.9 B / 3.35 TB/s = 4.2 us;
// a width-0 page reads nothing and writes its rows. The XOR is one
// operation per row and step.
// What held the first version back: one block per page walked the page
// 256 rows at a time, each tile one block scan in XOR with a carry
// barrier, so a 4,096-row page was a serial chain of 16 tiles and about 64
// barriers, and every thread read its two window words from global
// memory. Design (decode_dod's, with XOR in place of the pair sum): one
// block per page, walking it in chunks of 4,096 rows (a longer page
// carries the XOR of the earlier chunks). Per chunk:
//   1. the block copies the words the chunk's bit windows span into shared
//      memory, coalesced (bitunpack.cuh's stage_chunk, lag 1);
//   2. thread t owns the chunk's rows [16 t, 16 t + 16): it reads their
//      windows and XORs them in registers;
//   3. one block exclusive XOR scan of the threads' totals gives each
//      thread the XOR of every row before its own, with the carry;
//   4. each thread forms its 16 values and stages them in shared memory;
//   5. the block writes the chunk's rows out, 256 consecutive rows a step.
// Five barriers a chunk, as in decode_dod. A page of width 0 holds no words: every row
// equals p0, so its block stores p0, coalesced, with no scan and no
// barrier. No float arithmetic touches a value.
#include "bitunpack.cuh"

namespace {

constexpr int ITEMS = dec::kItems;
constexpr int TILE = dec::kTile;

template <class T>
__global__ void __launch_bounds__(dec::kThreads)
xor_kernel(const uint32_t* __restrict__ words, const int64_t* __restrict__ table,
           T* __restrict__ out) {
    // the chunk's words, then (once every window is read) its staged rows
    __shared__ uint64_t buf[dec::kRowSlots];
    __shared__ uint64_t warp_tot[dec::kWarps];
    T* staged_rows = reinterpret_cast<T*>(buf);
    const dec::Page pg = dec::load_page(table, blockIdx.x);
    T* page_out = out + pg.out_off;
    const int64_t width = pg.width;
    if (width == 0) {
        for (int64_t i = threadIdx.x; i < pg.rows; i += dec::kThreads) page_out[i] = (T)pg.p0;
        return;
    }
    const uint32_t* w = words + pg.word_off;
    dec::Staged st{reinterpret_cast<uint32_t*>(buf), dec::stage_pad_shift(width), 0};
    uint64_t carry = 0;  // XOR of the earlier chunks' rows
    for (int64_t base = 0; base < pg.rows; base += TILE) {
        const int64_t end = base + TILE < pg.rows ? base + TILE : pg.rows;
        // 1. the chunk's stream rows s = row - 1
        dec::stage_chunk(w, base, end, 1, width, st);
        // 2. this thread's rows r0 .. r0 + 15
        const int64_t r0 = base + (int64_t)threadIdx.x * ITEMS;
        uint64_t x[ITEMS];
        uint64_t a = 0;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const int64_t r = r0 + j;
            uint64_t v = 0;
            if (r == 0) {
                v = (uint64_t)pg.p0;
            } else if (r < end) {
                v = st.window((r - 1) * width, width);
            }
            x[j] = v;
            a ^= v;
        }
        // 3. the scan's first barrier orders every window read before the
        //    row stores below, which overwrite the words
        uint64_t total;
        uint64_t s = carry ^ dec::block_exclusive_xor(a, warp_tot, total);
        // 4.
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            s ^= x[j];
            staged_rows[dec::row_at((int)threadIdx.x * ITEMS + j)] = (T)s;
        }
        carry ^= total;
        __syncthreads();
        // 5.
        dec::write_chunk(page_out + base, staged_rows, (int)(end - base));
        __syncthreads();  // the next chunk's words overwrite the staged rows
    }
}

}  // namespace

// words: u32[total words + 1 guard]; table: int64[n_pages, 6] with p0 =
// the first value's bits; out: rows of `itemsize` (8: f64, 4: f32) bytes.
extern "C" int decode_xor_launch(const void* words, const void* table, int64_t n_pages,
                                 int itemsize, void* out, void* stream) {
    if ((itemsize != 8 && itemsize != 4) || n_pages < 0 || n_pages >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_pages > 0) {
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        const uint32_t* w = static_cast<const uint32_t*>(words);
        const int64_t* t = static_cast<const int64_t*>(table);
        if (itemsize == 8) {
            xor_kernel<uint64_t><<<(unsigned)n_pages, dec::kThreads, 0, s>>>(
                w, t, static_cast<uint64_t*>(out));
        } else {
            xor_kernel<uint32_t><<<(unsigned)n_pages, dec::kThreads, 0, s>>>(
                w, t, static_cast<uint32_t*>(out));
        }
    }
    return (int)cudaGetLastError();
}
