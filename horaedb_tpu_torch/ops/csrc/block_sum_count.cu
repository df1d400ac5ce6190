// block_sum_count: per-cell weighted (sum, count) over rows sorted by flat
// cell id (sid * num_buckets + bucket), in f64.
//
// Replaces the JAX package's ops/blockagg.py::_block_sum_count_xla
// (catalog name block_sum_count) and the f64 route it dispatches to,
// ops/blockagg.py::_scatter_sum_count (scatter_fused is the same function).
//
// Bound on an H100: memory. Per row it reads the id (4 B), the pre-masked
// value (8 B) and, when one is given, the weight (8 B), and per cell it
// writes sum and count (16 B); the work is one add per row per lane, far
// below the FP64 rate. With no weight lane (the main path's call, as the
// JAX kernel's w=None) each row weighs 1: the count is the run's length,
// folded from ones as a given lane of ones would be, so bitwise the same,
// without the 8 B a row of a lane of ones written and read back.
// Design: the segmented reduction of segreduce.cuh, which stages each tile
// of ids, values and weights in shared memory with bulk copies. Each row is
// read once, each cell written once, no atomics, and each cell's sum is the
// left fold of its rows in row order (the grid is bitwise repeatable and
// independent of where a run sits, as the partial-grid fold and
// stacked==solo depend on), and no density limit: the TPU form's one-hot
// rank budget and its scatter fallback do not carry over.
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
    static constexpr int LANES = 2;
    seg::Lanes<LANES> lanes;  // v f64; w f64, or null: every row weighs 1
    double* out_sum;
    double* out_count;
    bool round_bf16;
    __host__ __device__ static constexpr int bytes(int) { return 8; }
    __host__ __device__ static Acc identity() { return {0.0, 0.0}; }
    __device__ Acc load(const seg::Lanes<LANES>& at, int64_t i) const {
        const double x = static_cast<const double*>(at.p[0])[i];
        const double w = at.p[1] == nullptr ? 1.0 : static_cast<const double*>(at.p[1])[i];
        return {round_bf16 ? (double)__bfloat162float(__float2bfloat16_rn((float)x)) : x, w};
    }
    __device__ static Acc combine(Acc x, Acc y) { return {x.a + y.a, x.b + y.b}; }
    __device__ void store(int64_t c, Acc x) const {
        out_sum[c] = x.a;
        out_count[c] = x.b;
    }
};

}  // namespace

// k: int32[n] sorted; v: f64[n] (0 on excluded rows); w: f64[n] count
// weight (0 on excluded rows), or null (every row weighs 1); out_sum,
// out_count: f64[num_cells]; round_bf16: 1 rounds each value to bf16 on
// load.
extern "C" int block_sum_count_launch(const void* k, const void* v, const void* w,
                                      int64_t n, int32_t num_cells, void* out_sum,
                                      void* out_count, int32_t round_bf16, void* stream) {
    const SumCount op{{{v, w}}, static_cast<double*>(out_sum), static_cast<double*>(out_count),
                      round_bf16 != 0};
    return seg::launch(static_cast<const int32_t*>(k), n, (int64_t)num_cells, op,
                       static_cast<cudaStream_t>(stream));
}

// run_kernel's occupancy without (has_w = 0) or with a weight lane:
// blocks an SM, registers a thread, static and dynamic shared bytes.
extern "C" int block_sum_count_occupancy(int32_t* out, int32_t has_w) {
    static const double lane = 0.0;
    const SumCount op{{{&lane, has_w ? &lane : nullptr}}, nullptr, nullptr, false};
    return seg::occupancy<SumCount, int32_t>(op, out);
}
