// block_sum_count: per-cell weighted (sum, count) over rows sorted by flat
// cell id (sid * num_buckets + bucket), in f64.
//
// Replaces the JAX package's ops/blockagg.py::_block_sum_count_xla
// (catalog name block_sum_count) and the f64 route it dispatches to,
// ops/blockagg.py::_scatter_sum_count (scatter_fused is the same function).
//
// Bound on an H100: memory. Per row it reads the id (4 B), the pre-masked
// value (8 B) and the weight (8 B), and per cell it writes sum and count
// (16 B); the work is one add per row per lane, far below the FP64 rate.
// Design: the segmented reduction of segreduce.cuh. Each row is read once,
// each cell written once, no atomics, and each cell's sum is the left fold
// of its rows in row order (the grid is bitwise repeatable and independent
// of where a run sits, as the partial-grid fold and stacked==solo depend
// on), and no density limit:
// the TPU form's one-hot rank budget and its scatter fallback do not carry
// over.
//
// The launch flag `round_bf16` serves the dispatcher's `block_bf16` lane:
// each value is rounded to bf16 on load (round to nearest even, as the JAX
// package's `astype(bfloat16)` rounds), then summed in f64 as above. The
// lane takes f32 values only, which the f64 lane holds exactly.
#include <cuda_bf16.h>

#include "segreduce.cuh"

namespace {

struct SumCount {
    using Acc = seg::Pair;
    const double* v;
    const double* w;
    double* out_sum;
    double* out_count;
    bool round_bf16;
    __host__ __device__ static Acc identity() { return {0.0, 0.0}; }
    __device__ Acc load(int64_t i) const {
        const double x = v[i];
        return {round_bf16 ? (double)__bfloat162float(__float2bfloat16_rn((float)x)) : x, w[i]};
    }
    __device__ static Acc combine(Acc x, Acc y) { return {x.a + y.a, x.b + y.b}; }
    __device__ void store(int64_t c, Acc x) const {
        out_sum[c] = x.a;
        out_count[c] = x.b;
    }
};

}  // namespace

// k: int32[n] sorted; v: f64[n] (0 on excluded rows); w: f64[n] count
// weight (0 on excluded rows); out_sum, out_count: f64[num_cells];
// round_bf16: 1 rounds each value to bf16 on load.
extern "C" int block_sum_count_launch(const void* k, const void* v, const void* w,
                                      int64_t n, int32_t num_cells, void* out_sum,
                                      void* out_count, int32_t round_bf16, void* stream) {
    const SumCount op{static_cast<const double*>(v), static_cast<const double*>(w),
                      static_cast<double*>(out_sum), static_cast<double*>(out_count),
                      round_bf16 != 0};
    return seg::launch(static_cast<const int32_t*>(k), n, (int64_t)num_cells, op,
                       static_cast<cudaStream_t>(stream));
}
