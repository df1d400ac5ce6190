// decode_rle: the rows of a run-length-encoded integer lane.
//
// Replaces the JAX package's ops/decode.py::_rle_kernel (catalog name
// decode_rle): row i of a page takes the value of run
// searchsorted(cum, i, side="right"), clipped to the page's runs, where cum
// is the inclusive cumulative sum of the run lengths.
//
// Bound on an H100: memory. Per run it reads the value and its length (12
// B for 8-byte values), per row it writes the value (8 or 4 B); the binary
// search is log2(runs) reads of cum per row, served from L1/L2. Design:
// one block per page; each thread takes every kThreads-th row of the page
// and binary-searches the page's slice of `cum` (built on the host in
// int64, per page, as the JAX package does), then copies the run value's
// bytes from the page's payload words. 8-byte values sit on 4-byte
// boundaries there, so they are read as two words.
#include "bitunpack.cuh"

namespace {

__global__ void rle_kernel(const uint32_t* __restrict__ words, const int64_t* __restrict__ table,
                           const int64_t* __restrict__ cum, int itemsize,
                           void* __restrict__ out) {
    const dec::Page pg = dec::load_page(table, blockIdx.x);
    const int64_t n_runs = pg.p0;
    if (n_runs <= 0) return;
    const int64_t* c = cum + pg.p1;
    const uint32_t* vals = words + pg.word_off;
    for (int64_t i = threadIdx.x; i < pg.rows; i += blockDim.x) {
        int64_t lo = 0, hi = n_runs;  // first run whose end is past i
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (c[mid] <= i) {
                lo = mid + 1;
            } else {
                hi = mid;
            }
        }
        const int64_t r = lo < n_runs ? lo : n_runs - 1;
        const uint64_t v = itemsize == 8
            ? (uint64_t)vals[2 * r] | ((uint64_t)vals[2 * r + 1] << 32)
            : (uint64_t)vals[r];
        dec::store(out, pg.out_off + i, v, itemsize);
    }
}

}  // namespace

// words: u32[total words + 1 guard]; table: int64[n_pages, 6] with p0 =
// the page's runs, p1 = the offset of its slice of cum; cum: int64[total
// runs]; out: rows of `itemsize` (8 or 4) bytes.
extern "C" int decode_rle_launch(const void* words, const void* table, int64_t n_pages,
                                 const void* cum, int itemsize, void* out, void* stream) {
    if ((itemsize != 8 && itemsize != 4) || n_pages < 0 || n_pages >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_pages > 0) {
        rle_kernel<<<(unsigned)n_pages, dec::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), static_cast<const int64_t*>(table),
            static_cast<const int64_t*>(cum), itemsize, out);
    }
    return (int)cudaGetLastError();
}
