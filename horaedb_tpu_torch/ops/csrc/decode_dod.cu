// decode_dod: the rows of a delta-of-delta timestamp lane.
//
// Replaces the JAX package's ops/decode.py::_dod_kernel (catalog name
// decode_dod). Per page: row i >= 2 holds the zigzag second-order delta at
// bit (i - 2) * width; d[i] = first_delta * [i >= 1] + sum_{k <= i} dd[k]
// and v[i] = first + sum_{k <= i} d[k], all mod 2^64, written at the lane
// dtype's width (int64, or the low 32 bits for int32).
//
// Bound on an H100: memory. Per row it reads width/8 bytes and writes 8
// (or 4); two integer scans are a few operations per row. Design: one
// block per page, walking the page in tiles of kThreads rows with two
// running carries (page_rows is a knob and may exceed a block), each tile
// two block scans in unsigned 64-bit adds, which wrap exactly as the JAX
// kernel's uint64 adds. No float arithmetic touches a value.
#include "bitunpack.cuh"

namespace {

__global__ void dod_kernel(const uint32_t* __restrict__ words, const int64_t* __restrict__ table,
                           int itemsize, void* __restrict__ out) {
    __shared__ uint64_t warp_tot[32];
    __shared__ uint64_t carry[2];  // sums of dd and of d over the earlier tiles
    const dec::Page pg = dec::load_page(table, blockIdx.x);
    const uint32_t* w = words + pg.word_off;
    const uint64_t first = (uint64_t)pg.p0;
    const uint64_t first_delta = (uint64_t)pg.p1;
    if (threadIdx.x == 0) {
        carry[0] = 0;
        carry[1] = 0;
    }
    __syncthreads();
    for (int64_t base = 0; base < pg.rows; base += blockDim.x) {
        const int64_t i = base + threadIdx.x;
        const bool in_page = i < pg.rows;
        // read before the scans: their barriers order these reads before
        // the last thread's update below
        const uint64_t c_dd = carry[0];
        const uint64_t c_d = carry[1];
        uint64_t dd = 0;
        if (in_page && i >= 2) {
            const uint64_t z = dec::unpack_at(w, (i - 2) * pg.width, pg.width);
            dd = (z >> 1) ^ (0ull - (z & 1));  // unzigzag
        }
        const uint64_t sdd = dec::block_inclusive_scan(dd, warp_tot, dec::Add()) + c_dd;
        const uint64_t d = (in_page && i >= 1) ? first_delta + sdd : 0;
        const uint64_t sd = dec::block_inclusive_scan(d, warp_tot, dec::Add()) + c_d;
        if (in_page) dec::store(out, pg.out_off + i, first + sd, itemsize);
        if (threadIdx.x == blockDim.x - 1) {  // the tile's totals, carries included
            carry[0] = sdd;
            carry[1] = sd;
        }
        __syncthreads();
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
        dod_kernel<<<(unsigned)n_pages, dec::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), static_cast<const int64_t*>(table), itemsize,
            out);
    }
    return (int)cudaGetLastError();
}
