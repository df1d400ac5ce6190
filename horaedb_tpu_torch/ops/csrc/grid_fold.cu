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
// the work is 4 * k compares or adds. At the mesh's slot shape ([4, 2,500,
// 30], 12 MB) that is 3.6 us at 3.35 TB/s, less than one launch costs the
// host, so the wrapper makes one allocation and one launch for the four
// grids. Design: a thread folds a pair of neighbouring cells. For k <= 8
// (the mesh's partial counts) the fold is unrolled and the thread issues
// the loads of all k partials of every grid before the first dependent
// operation; past 8 a loop folds partial by partial. A pair moves as one
// 16-byte load or store (double2) where its address is 16-byte aligned;
// that is decided per grid and partial, the same for every pair of it, so
// an odd cell count (every other partial then starts 8 bytes off) or a
// misaligned view falls back to two 8-byte accesses there, and the last
// cell of an odd count is a scalar tail. Neighbouring threads take
// neighbouring pairs, so every access is coalesced; blocks of 128 threads,
// at most 16 an SM (a grid-stride loop past that), so the slot's 37,500
// pairs make 293 blocks, all resident at once on the 132 SMs. No atomics,
// no reordering: the grid is bitwise repeatable.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_BLOCKS = 132 * 16;  // an H100's SMs x resident blocks of 128
constexpr int UNROLL = 8;             // partial counts the fold unrolls for

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

__device__ inline bool aligned16(const double* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cells p[0] and, when `full`, p[1] (else 0.0)
__device__ inline double2 load_pair(const double* __restrict__ p, bool full) {
    if (full && aligned16(p)) return __ldg(reinterpret_cast<const double2*>(p));
    return make_double2(__ldg(p), full ? __ldg(p + 1) : 0.0);
}

__device__ inline void store_pair(double* __restrict__ p, double2 v, bool full) {
    if (full && aligned16(p)) {
        *reinterpret_cast<double2*>(p) = v;
        return;
    }
    p[0] = v.x;
    if (full) p[1] = v.y;
}

struct Acc {
    double2 s, c, lo, hi;
};

template <bool MINMAX>
__device__ inline void fold_in(Acc& a, double2 s, double2 c, double2 lo, double2 hi) {
    a.s = make_double2(np_add(a.s.x, s.x), np_add(a.s.y, s.y));
    a.c = make_double2(np_add(a.c.x, c.x), np_add(a.c.y, c.y));
    if (MINMAX) {
        a.lo = make_double2(np_min(a.lo.x, lo.x), np_min(a.lo.y, lo.y));
        a.hi = make_double2(np_max(a.hi.x, hi.x), np_max(a.hi.y, hi.y));
    }
}

// K > 0: k == K partials, unrolled, every load issued before the fold;
// K == 0: any k, partial by partial.
template <int K, bool MINMAX>
__global__ void __launch_bounds__(THREADS)
fold_kernel(const double* __restrict__ s, const double* __restrict__ c,
            const double* __restrict__ mn, const double* __restrict__ mx, int32_t k,
            int64_t cells, double* __restrict__ out) {
    const int64_t pairs = (cells + 1) / 2;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < pairs; p += stride) {
        const int64_t at = 2 * p;
        const bool full = at + 1 < cells;
        Acc a{make_double2(0.0, 0.0), make_double2(0.0, 0.0), make_double2(INFINITY, INFINITY),
              make_double2(-INFINITY, -INFINITY)};
        const double2 none = make_double2(0.0, 0.0);
        if constexpr (K > 0) {
            double2 vs[K], vc[K], vlo[K], vhi[K];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int64_t off = j * cells + at;
                vs[j] = load_pair(s + off, full);
                vc[j] = load_pair(c + off, full);
                vlo[j] = MINMAX ? load_pair(mn + off, full) : none;
                vhi[j] = MINMAX ? load_pair(mx + off, full) : none;
            }
#pragma unroll
            for (int j = 0; j < K; ++j) fold_in<MINMAX>(a, vs[j], vc[j], vlo[j], vhi[j]);
        } else {
            for (int32_t j = 0; j < k; ++j) {
                const int64_t off = j * cells + at;
                fold_in<MINMAX>(a, load_pair(s + off, full), load_pair(c + off, full),
                                MINMAX ? load_pair(mn + off, full) : none,
                                MINMAX ? load_pair(mx + off, full) : none);
            }
        }
        store_pair(out + at, a.s, full);
        store_pair(out + cells + at, a.c, full);
        if (MINMAX) {
            store_pair(out + 2 * cells + at, a.lo, full);
            store_pair(out + 3 * cells + at, a.hi, full);
        }
    }
}

template <bool MINMAX>
void launch_fold(const double* s, const double* c, const double* mn, const double* mx,
                 int32_t k, int64_t cells, double* out, unsigned blocks, cudaStream_t st) {
#define FOLD_CASE(K)                                                                          \
    case K:                                                                                   \
        fold_kernel<K, MINMAX><<<blocks, THREADS, 0, st>>>(s, c, mn, mx, k, cells, out);   \
        return;
    switch (k <= UNROLL ? k : 0) {
        FOLD_CASE(1)
        FOLD_CASE(2)
        FOLD_CASE(3)
        FOLD_CASE(4)
        FOLD_CASE(5)
        FOLD_CASE(6)
        FOLD_CASE(7)
        FOLD_CASE(8)
        default:
            fold_kernel<0, MINMAX><<<blocks, THREADS, 0, st>>>(s, c, mn, mx, k, cells, out);
    }
#undef FOLD_CASE
}

}  // namespace

// s, c, mn, mx: f64 [k, cells] (mn and mx null: sum and count only);
// out: f64 [4, cells] (sum, count, min, max), or [2, cells] without min and
// max. k >= 1.
extern "C" int grid_fold_launch(const void* s, const void* c, const void* mn, const void* mx,
                                int32_t k, int64_t cells, void* out, void* stream) {
    if (k < 1 || cells < 0 || (mn == nullptr) != (mx == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    if (cells > 0) {
        const int64_t pairs = (cells + 1) / 2;
        int64_t blocks = (pairs + THREADS - 1) / THREADS;
        if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
        const auto* ds = static_cast<const double*>(s);
        const auto* dc = static_cast<const double*>(c);
        const auto* dmn = static_cast<const double*>(mn);
        const auto* dmx = static_cast<const double*>(mx);
        auto* dout = static_cast<double*>(out);
        cudaStream_t st = static_cast<cudaStream_t>(stream);
        if (mn != nullptr) {
            launch_fold<true>(ds, dc, dmn, dmx, k, cells, dout, (unsigned)blocks, st);
        } else {
            launch_fold<false>(ds, dc, dmn, dmx, k, cells, dout, (unsigned)blocks, st);
        }
    }
    return (int)cudaGetLastError();
}
