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
// (or 4); the scan is one XOR per row and step. Design: one block per
// page, walking the page in tiles of kThreads rows with a running carry
// (page_rows is a knob and may exceed a block), each tile one block scan
// in XOR. No float arithmetic touches a value.
#include "bitunpack.cuh"

namespace {

__global__ void xor_kernel(const uint32_t* __restrict__ words, const int64_t* __restrict__ table,
                           int itemsize, void* __restrict__ out) {
    __shared__ uint64_t warp_tot[32];
    __shared__ uint64_t carry;  // XOR of the earlier tiles' rows
    const dec::Page pg = dec::load_page(table, blockIdx.x);
    const uint32_t* w = words + pg.word_off;
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (int64_t base = 0; base < pg.rows; base += blockDim.x) {
        const int64_t i = base + threadIdx.x;
        const bool in_page = i < pg.rows;
        // read before the scan: its barriers order this read before the
        // last thread's update below
        const uint64_t c = carry;
        uint64_t x = 0;
        if (in_page) x = i == 0 ? (uint64_t)pg.p0 : dec::unpack_at(w, (i - 1) * pg.width, pg.width);
        const uint64_t bits = dec::block_inclusive_scan(x, warp_tot, dec::Xor()) ^ c;
        if (in_page) dec::store(out, pg.out_off + i, bits, itemsize);
        if (threadIdx.x == blockDim.x - 1) carry = bits;
        __syncthreads();
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
        xor_kernel<<<(unsigned)n_pages, dec::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), static_cast<const int64_t*>(table), itemsize,
            out);
    }
    return (int)cudaGetLastError();
}
