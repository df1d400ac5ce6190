// block_min_max: per-cell (min, max) over rows sorted by flat cell id, with
// a `valid` mask; empty cells read +inf / -inf.
//
// Replaces the JAX package's ops/blockagg.py::_block_min_max_xla (catalog
// name block_min_max) and the f64 route it dispatches to,
// ops/blockagg.py::_scatter_min_max.
//
// Bound on an H100: memory. Per row it reads the id (4 B), the value
// (8 B) and the mask (1 B), and per cell it writes min and max (16 B).
// Design: the segmented reduction of segreduce.cuh (one read per row, one
// write per cell, no atomics). A NaN in a valid row makes its cell's min
// and max NaN, as jax.ops.segment_min / np.minimum do: CUDA's fmin/fmax
// drop NaN, so the compare is written out. Invalid rows keep their sorted
// id and load the identity (+inf, -inf), so they never break a run.
#include <math.h>

#include "segreduce.cuh"

namespace {

__device__ inline double nan_min(double x, double y) {
    if (x != x) return x;
    if (y != y) return y;
    return y < x ? y : x;
}

__device__ inline double nan_max(double x, double y) {
    if (x != x) return x;
    if (y != y) return y;
    return y > x ? y : x;
}

struct MinMax {
    using Aux = uint8_t;
    __host__ __device__ static seg::Pair identity() {
        return {(double)INFINITY, -(double)INFINITY};
    }
    __device__ static seg::Pair load(double v, uint8_t ok) {
        return ok ? seg::Pair{v, v} : identity();
    }
    __device__ static seg::Pair combine(seg::Pair x, seg::Pair y) {
        return {nan_min(x.a, y.a), nan_max(x.b, y.b)};
    }
};

}  // namespace

// k: int32[n] sorted; v: f64[n]; valid: bool/uint8[n]; out_min, out_max:
// f64[num_cells]; scratch: block_min_max_scratch_bytes(n) bytes.
extern "C" int block_min_max_launch(const void* k, const void* v, const void* valid,
                                    int64_t n, int32_t num_cells, void* out_min,
                                    void* out_max, void* scratch, void* stream) {
    return seg::launch<MinMax>(
        static_cast<const int32_t*>(k), static_cast<const double*>(v),
        static_cast<const uint8_t*>(valid), n, num_cells, static_cast<double*>(out_min),
        static_cast<double*>(out_max), static_cast<seg::Pair*>(scratch),
        static_cast<cudaStream_t>(stream));
}

extern "C" int64_t block_min_max_scratch_bytes(int64_t n) { return seg::scratch_bytes(n); }
