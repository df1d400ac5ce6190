// downsample: the flat (series, time bucket) cell id of every row, the
// first step of the per-cell stats; the wrapper (ops/aggregate.py::
// downsample) then reduces the ids with grouped_stats.cu.
//
// Replaces the JAX package's ops/aggregate.py::downsample (catalog name
// downsample): bucket = floor((ts - t0) / bucket_ms) as int32, a row is in
// the grid when valid, 0 <= bucket < num_buckets and 0 <= sid <
// num_series, and its cell is sid * num_buckets + bucket; grouped_stats
// drops every other row. Here those rows get the id num_series *
// num_buckets, which grouped_stats drops as out of range.
//
// Bound on an H100: memory. Per row it reads ts (8 B), sid (4 B) and the
// mask (1 B) and writes the id (4 B); the work is one 64-bit division.
// Design: one thread per row. CUDA's `/` truncates toward zero, so the
// quotient is floored by hand: a row 1 ms before t0 lands in bucket -1 and
// drops. The difference and the int32 cast wrap as the JAX int64 and
// astype(int32) arithmetic does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cells_kernel(const int64_t* __restrict__ ts, const int32_t* __restrict__ sid,
                             const uint8_t* __restrict__ valid, int64_t t0, int64_t bucket_ms,
                             int32_t num_series, int32_t num_buckets, int64_t n,
                             int32_t* __restrict__ cell) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t d = (int64_t)((uint64_t)ts[i] - (uint64_t)t0);
    int64_t q = d / bucket_ms;
    if (d % bucket_ms != 0 && d < 0) --q;  // floor; bucket_ms > 0
    const int32_t bucket = (int32_t)(uint32_t)(uint64_t)q;
    const int32_t s = sid[i];
    const bool ok = (valid == nullptr || valid[i] != 0) && bucket >= 0 && bucket < num_buckets &&
                    s >= 0 && s < num_series;
    cell[i] = ok ? s * num_buckets + bucket : num_series * num_buckets;
}

}  // namespace

// ts: int64[n]; sid: int32[n]; valid: uint8[n] or null; cell: int32[n]
// out. bucket_ms > 0 and num_series * num_buckets < 2^31.
extern "C" int downsample_cells_launch(const void* ts, const void* sid, const void* valid,
                                       int64_t t0, int64_t bucket_ms, int32_t num_series,
                                       int32_t num_buckets, int64_t n, void* cell, void* stream) {
    if (bucket_ms <= 0 || num_series < 0 || num_buckets < 0 ||
        (int64_t)num_series * num_buckets >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n > 0) {
        const unsigned blocks = (unsigned)((n + 255) / 256);
        cells_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(ts), static_cast<const int32_t*>(sid),
            static_cast<const uint8_t*>(valid), t0, bucket_ms, num_series, num_buckets, n,
            static_cast<int32_t*>(cell));
    }
    return (int)cudaGetLastError();
}
