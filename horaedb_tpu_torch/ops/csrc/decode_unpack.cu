// decode_unpack: the rows of a dict-encoded lane, from its bit-packed ids
// and its dictionary.
//
// Replaces the JAX package's ops/decode.py::_unpack_kernel (catalog name
// decode_unpack) and the dictionary gather after it in decode_page_device:
// id = the `width`-bit value (width <= 32) at bit i * width of the page's
// LSB-first stream, row = dict[id] in the lane's dtype (8 or 4 bytes).
//
// Bound on an H100: memory. Per row it reads width/8 bytes of ids and
// writes the value (8 or 4 B); the dictionary (at most max_dict values)
// stays in L1/L2. Design: one block per page of the page table
// (bitunpack.cuh), each thread takes every kThreads-th row of the page: one
// thread per output row, reading the two words its bit window can span.
// The JAX kernel ran once per page at a padded length; here every kept
// page of the lane is one launch. An id past the dictionary (a corrupt
// sidecar) writes 0 and is counted in `bad`, which the wrapper checks.
#include "bitunpack.cuh"

namespace {

__global__ void unpack_kernel(const uint32_t* __restrict__ words,
                              const int64_t* __restrict__ table,
                              const uint64_t* __restrict__ dict8,
                              const uint32_t* __restrict__ dict4, int64_t n_dict, int itemsize,
                              void* __restrict__ out, int* __restrict__ bad) {
    const dec::Page pg = dec::load_page(table, blockIdx.x);
    const uint32_t* w = words + pg.word_off;
    for (int64_t i = threadIdx.x; i < pg.rows; i += blockDim.x) {
        const uint64_t id = dec::unpack_at(w, i * pg.width, pg.width);
        uint64_t v = 0;
        if (id < (uint64_t)n_dict) {
            v = itemsize == 8 ? dict8[id] : (uint64_t)dict4[id];
        } else {
            atomicAdd(bad, 1);
        }
        dec::store(out, pg.out_off + i, v, itemsize);
    }
}

}  // namespace

// words: u32[total words + 1 guard]; table: int64[n_pages, 6]; dict:
// n_dict values of `itemsize` (8 or 4) bytes; out: n rows of `itemsize`
// bytes; bad: int32[1], zeroed by the caller.
extern "C" int decode_unpack_launch(const void* words, const void* table, int64_t n_pages,
                                    const void* dict, int64_t n_dict, int itemsize, void* out,
                                    void* bad, void* stream) {
    if ((itemsize != 8 && itemsize != 4) || n_pages < 0 || n_pages >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_pages > 0) {
        unpack_kernel<<<(unsigned)n_pages, dec::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), static_cast<const int64_t*>(table),
            static_cast<const uint64_t*>(dict), static_cast<const uint32_t*>(dict), n_dict,
            itemsize, out, static_cast<int*>(bad));
    }
    return (int)cudaGetLastError();
}
