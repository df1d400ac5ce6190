// stacked_downsample: the flat cell id of every row of a STACK of B
// coalesced downsample queries, the first step of their grids; the wrapper
// (ops/aggregate.py::stacked_downsample) then reduces the ids with
// grouped_stats.cu, so every query's grid comes out of one sort and one
// segmented reduction.
//
// Replaces the JAX package's ops/aggregate.py::stacked_downsample (catalog
// name stacked_downsample), the query batcher's device lane
// (server/batching.py): rows are [B, R] lanes (query `lane` owns row block
// lane * R .. lane * R + R - 1), each query has its own t0, and
//   bucket = floor((ts - t0[lane]) / bucket_ms) as int32,
//   a row is in its grid when valid, 0 <= bucket < T and 0 <= sid < S,
//   an in-grid row gets lane * S * T + sid * T + bucket,
//   any other row gets the sentinel B * S * T, which grouped_stats drops.
// Lanes own disjoint id ranges, and grouped_stats' radix sort is stable,
// so a cell's rows reach the reduction in their lane's row order and its
// sum is the left fold of segreduce.cuh over exactly the rows (in exactly
// the order) the query's solo reduction folds: stacked == solo, bitwise.
//
// Bound on an H100: memory. Per row it reads ts (8 B), sid (4 B) and the
// mask (1 B) and writes the id (4 B); the work is one 64-bit division.
// Design: one thread per row, as csrc/downsample.cu, with the lane's t0
// read through the row's lane index. CUDA's `/` truncates toward zero, so
// the quotient is floored by hand; the difference and the int32 cast wrap
// as the JAX int64 and astype(int32) arithmetic does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stacked_cells_kernel(const int64_t* __restrict__ ts,
                                     const int32_t* __restrict__ sid,
                                     const uint8_t* __restrict__ valid,
                                     const int64_t* __restrict__ t0, int64_t bucket_ms,
                                     int32_t num_series, int32_t num_buckets, int64_t rows,
                                     int64_t n, int32_t sentinel, int32_t* __restrict__ cell) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t lane = i / rows;
    const int64_t d = (int64_t)((uint64_t)ts[i] - (uint64_t)t0[lane]);
    int64_t q = d / bucket_ms;
    if (d % bucket_ms != 0 && d < 0) --q;  // floor; bucket_ms > 0
    const int32_t bucket = (int32_t)(uint32_t)(uint64_t)q;
    const int32_t s = sid[i];
    const bool ok = (valid == nullptr || valid[i] != 0) && bucket >= 0 && bucket < num_buckets &&
                    s >= 0 && s < num_series;
    cell[i] = ok ? (int32_t)(lane * num_series * num_buckets + (int64_t)s * num_buckets + bucket)
                 : sentinel;
}

}  // namespace

// ts: int64[B * R]; sid: int32[B * R]; valid: uint8[B * R] or null; t0:
// int64[B]; cell: int32[B * R] out. bucket_ms > 0, R > 0 and
// B * num_series * num_buckets < 2^31 (the sentinel is an int32 id).
extern "C" int stacked_downsample_cells_launch(const void* ts, const void* sid, const void* valid,
                                               const void* t0, int64_t bucket_ms,
                                               int32_t num_series, int32_t num_buckets,
                                               int64_t batch, int64_t rows, void* cell,
                                               void* stream) {
    if (bucket_ms <= 0 || num_series < 0 || num_buckets < 0 || batch < 0 || rows <= 0 ||
        batch * (int64_t)num_series * num_buckets >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    const int64_t n = batch * rows;
    if (n > 0) {
        const unsigned blocks = (unsigned)((n + 255) / 256);
        stacked_cells_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(ts), static_cast<const int32_t*>(sid),
            static_cast<const uint8_t*>(valid), static_cast<const int64_t*>(t0), bucket_ms,
            num_series, num_buckets, rows, n,
            (int32_t)(batch * (int64_t)num_series * num_buckets), static_cast<int32_t*>(cell));
    }
    return (int)cudaGetLastError();
}
