// grid_fold: the left fold of k stacked partial grids, cell by cell.
//
// Replaces the JAX package's parallel/merge.py::_build_grid_fold (catalog
// name grid_fold): each device of the 1-D merge mesh folds its series
// slice of k aligned partial grids ([k, S, B] of sum, count, min, max,
// f64) left to right from the identity (0, 0, +inf, -inf). Its oracle is
// the coordinator's host fold (cluster/partial.py::merge_grids), which
// applies np.add.at / np.minimum.at / np.maximum.at partial by partial, and
// the port holds the kernel bitwise equal to that fold, NaN payloads,
// signed zeros and subnormals included. The same kernel combines the row
// shards' partial grids of a mesh downsample (psum / pmin / pmax over
// "rows" in the JAX package), in slot order.
//
// What numpy's ufunc.at does per element in the host fold's use (rows of
// a 2-D grid), derived on an x86 host (tests/test_torch_cluster.py holds
// it): acc = op(acc, part), and
//   add: a NaN operand wins, the partial's first, quieted (bit 51 set);
//        inf + -inf gives the default NaN 0xfff8000000000000;
//   minimum / maximum: (acc < part || acc is NaN) ? acc : part for the
//        minimum (> for the maximum): a NaN operand wins, the
//        accumulator's first, NOT quieted; of two equal values (+0.0 and
//        -0.0) the partial's wins.
// CUDA's fmin / fmax drop NaN and its add returns a canonical NaN, so both
// rules are written out. f64 arithmetic on the card never flushes
// subnormals (there is no FTZ mode for doubles) and the build has no fast
// math, so device_fold_safe's probe holds.
//
// Bound on an H100: memory. Each cell reads 4 * k doubles and writes 4;
// the work is 4 * k compares or adds. Design: one thread per cell of the
// slot's [S, B] slice, a loop over the k partials in order. Neighbouring
// threads read neighbouring cells of one partial, so every load is
// coalesced; no atomics, no reordering, so the grid is bitwise repeatable.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ inline double quieted(double x) {
    return __longlong_as_double(__double_as_longlong(x) | 0x0008000000000000LL);
}

__device__ inline double np_add(double acc, double x) {
    if (x != x) return quieted(x);
    if (acc != acc) return quieted(acc);
    if (isinf(acc) && isinf(x) && acc != x) {
        return __longlong_as_double((long long)0xfff8000000000000ULL);
    }
    return __dadd_rn(acc, x);
}

__device__ inline double np_min(double acc, double x) {
    return (acc < x || acc != acc) ? acc : x;
}

__device__ inline double np_max(double acc, double x) {
    return (acc > x || acc != acc) ? acc : x;
}

__global__ void fold_kernel(const double* __restrict__ s, const double* __restrict__ c,
                            const double* __restrict__ mn, const double* __restrict__ mx,
                            int32_t k, int64_t cells, double* __restrict__ out_s,
                            double* __restrict__ out_c, double* __restrict__ out_mn,
                            double* __restrict__ out_mx) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= cells) return;
    double a = 0.0, b = 0.0, lo = INFINITY, hi = -INFINITY;
    for (int32_t j = 0; j < k; ++j) {
        const int64_t at = (int64_t)j * cells + i;
        a = np_add(a, s[at]);
        b = np_add(b, c[at]);
        if (mn != nullptr) {
            lo = np_min(lo, mn[at]);
            hi = np_max(hi, mx[at]);
        }
    }
    out_s[i] = a;
    out_c[i] = b;
    if (mn != nullptr) {
        out_mn[i] = lo;
        out_mx[i] = hi;
    }
}

}  // namespace

// s, c, mn, mx: f64 [k, cells] (mn and mx null: sum and count only);
// out_*: f64 [cells]. k >= 1.
extern "C" int grid_fold_launch(const void* s, const void* c, const void* mn, const void* mx,
                                int32_t k, int64_t cells, void* out_s, void* out_c,
                                void* out_mn, void* out_mx, void* stream) {
    if (k < 1 || cells < 0 || (mn == nullptr) != (mx == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    if (cells > 0) {
        const unsigned blocks = (unsigned)((cells + 255) / 256);
        fold_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const double*>(s), static_cast<const double*>(c),
            static_cast<const double*>(mn), static_cast<const double*>(mx), k, cells,
            static_cast<double*>(out_s), static_cast<double*>(out_c),
            static_cast<double*>(out_mn), static_cast<double*>(out_mx));
    }
    return (int)cudaGetLastError();
}
