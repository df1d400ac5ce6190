// block_min_max: per-cell (min, max) over rows sorted by flat cell id, with
// an optional `valid` mask; empty cells read +inf / -inf.
//
// Replaces the JAX package's ops/blockagg.py::_block_min_max_xla (catalog
// name block_min_max) and the f64 route it dispatches to,
// ops/blockagg.py::_scatter_min_max.
//
// Bound on an H100: memory. Per row it reads the id (4 B), the value
// (8 B) and, when one is given, the mask (1 B), and per cell it writes min
// and max (16 B). With no mask (the main path's call) every row counts.
// Design: the segmented reduction of segreduce.cuh (each tile staged in
// shared memory by bulk copies, one read per row, one write per cell, no
// atomics). A NaN in a valid row makes its cell's min and max NaN, as
// jax.ops.segment_min / np.minimum do: CUDA's fmin/fmax drop NaN, so the
// compare is written out. Invalid rows keep their sorted id and load the
// identity (+inf, -inf), so they never break a run.
#include "segreduce.cuh"

namespace {

struct MinMax {
    using Acc = seg::Pair;
    static constexpr int LANES = 2;
    seg::Lanes<LANES> lanes;  // v f64; valid bool/uint8, or null: every row counts
    double* out_min;
    double* out_max;
    __host__ __device__ static constexpr int bytes(int l) { return l == 0 ? 8 : 1; }
    __host__ __device__ static Acc identity() { return {(double)INFINITY, -(double)INFINITY}; }
    __device__ Acc load(const seg::Lanes<LANES>& at, int64_t i) const {
        const double x = static_cast<const double*>(at.p[0])[i];
        const bool ok = at.p[1] == nullptr || static_cast<const uint8_t*>(at.p[1])[i] != 0;
        return ok ? Acc{x, x} : identity();
    }
    __device__ static Acc combine(Acc x, Acc y) {
        return {seg::nan_min(x.a, y.a), seg::nan_max(x.b, y.b)};
    }
    __device__ void store(int64_t c, Acc x) const {
        out_min[c] = x.a;
        out_max[c] = x.b;
    }
};

}  // namespace

// k: int32[n] sorted; v: f64[n]; valid: bool/uint8[n], or null (every row
// counts); out_min, out_max: f64[num_cells].
extern "C" int block_min_max_launch(const void* k, const void* v, const void* valid,
                                    int64_t n, int32_t num_cells, void* out_min,
                                    void* out_max, void* stream) {
    const MinMax op{{{v, valid}}, static_cast<double*>(out_min), static_cast<double*>(out_max)};
    return seg::launch(static_cast<const int32_t*>(k), n, (int64_t)num_cells, op,
                       static_cast<cudaStream_t>(stream));
}

// run_kernel's occupancy without (has_valid = 0) or with a mask: blocks an
// SM, registers a thread, static and dynamic shared bytes.
extern "C" int block_min_max_occupancy(int32_t* out, int32_t has_valid) {
    static const double lane = 0.0;
    const MinMax op{{{&lane, has_valid ? &lane : nullptr}}, nullptr, nullptr};
    return seg::occupancy<MinMax, int32_t>(op, out);
}
