// grouped_stats: sum, count, min, max and mean per segment over UNSORTED
// segment ids; ids outside [0, num_segments) and rows whose `valid` is
// false are dropped.
//
// Replaces the JAX package's ops/aggregate.py::grouped_stats (catalog name
// grouped_stats) and the scatter it reaches, masked_segment_stats /
// masked_minmax (:48-93): float values sum in f64, integer values sum
// exactly in 64 bits (signed in int64, unsigned in uint64, whose bits are
// int64's) with a count of the same type, and min / max come back as f64
// (the JAX function promotes through jnp.where(valid, values, inf)), with
// NaN propagated. Empty segments read sum 0, count 0, min +inf, max -inf
// and mean NaN.
//
// Bound on an H100: memory. The least traffic reads the id (4 B), the
// value (8 B) and the mask (1 B) once per row and writes 40 B per segment.
// Design: no atomics, so a grid is bitwise repeatable.
//   1. one elementwise pass writes each row's key (its id, or num_segments
//      for a dropped row) as u64 and its row index;
//   2. the LSD radix passes of radix.cuh over the digits of num_segments
//      only (3 passes at 10M segments), stable, carrying the row index;
//   3. the segmented reduction of segreduce.cuh over the sorted keys, each
//      row's value loaded through the carried index, each segment's sum the
//      left fold of its rows in input order (the sort is stable); the
//      dropped rows sort last and never reach a segment;
//   4. one elementwise pass over the segments writes the mean.
#include <type_traits>

#include "radix.cuh"
#include "segreduce.cuh"

namespace {

constexpr int KIND_F64 = 0, KIND_I64 = 1, KIND_U64 = 2;

template <class T>
struct Stats {
    T sum;
    T count;
    double mn;
    double mx;
};

template <int KIND, class T>
__device__ inline double to_f64(T x) {
    if constexpr (KIND == KIND_F64) {
        return x;
    } else if constexpr (KIND == KIND_I64) {
        return (double)x;
    } else {
        return (double)(uint64_t)x;
    }
}

// integer sums wrap modulo 2^64, as the JAX int64 / uint64 scatter does
template <class T>
__device__ inline T add(T x, T y) {
    if constexpr (std::is_integral<T>::value) {
        return (T)((uint64_t)x + (uint64_t)y);
    } else {
        return x + y;
    }
}

template <int KIND, class T>
struct GroupedOp {
    using Acc = Stats<T>;
    const T* v;
    const int32_t* perm;
    T* out_sum;
    T* out_count;
    double* out_min;
    double* out_max;
    __host__ __device__ static Acc identity() {
        return {(T)0, (T)0, (double)INFINITY, -(double)INFINITY};
    }
    __device__ Acc load(int64_t pos) const {
        const T x = v[perm[pos]];
        const double f = to_f64<KIND>(x);
        return {x, (T)1, f, f};
    }
    __device__ static Acc combine(Acc x, Acc y) {
        return {add(x.sum, y.sum), add(x.count, y.count), seg::nan_min(x.mn, y.mn),
                seg::nan_max(x.mx, y.mx)};
    }
    __device__ void store(int64_t c, Acc a) const {
        out_sum[c] = a.sum;
        out_count[c] = a.count;
        out_min[c] = a.mn;
        out_max[c] = a.mx;
    }
};

// key[i] = index[i] where valid and in range, else num_segments; perm = iota
template <class I>
__global__ void key_kernel(const I* __restrict__ index, const uint8_t* __restrict__ valid,
                           int64_t n, int64_t num_segments, uint64_t* __restrict__ key,
                           int32_t* __restrict__ perm) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t x = (int64_t)index[i];
    const bool ok = (valid == nullptr || valid[i] != 0) && x >= 0 && x < num_segments;
    key[i] = (uint64_t)(ok ? x : num_segments);
    perm[i] = (int32_t)i;
}

template <int KIND, class T>
__global__ void mean_kernel(const T* __restrict__ sum, const T* __restrict__ count,
                            double* __restrict__ mean, int64_t m) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c < m) mean[c] = to_f64<KIND>(sum[c]) / to_f64<KIND>(count[c]);
}

int digits_for(int64_t num_segments) {
    int bits = 0;
    while (bits < 63 && (num_segments >> bits) != 0) ++bits;
    return (bits + 7) / 8;
}

struct Scratch {
    int32_t* pa;
    int32_t* pb;
    uint64_t* ua;
    uint64_t* ub;
    int32_t* hist;
};

Scratch carve(void* p, int64_t n) {
    char* c = static_cast<char*>(p);
    auto take = [&c](int64_t bytes) {
        char* out = c;
        c += ((bytes + 255) / 256) * 256;
        return out;
    };
    const int64_t m = n > 0 ? n : 1;
    Scratch s;
    s.pa = reinterpret_cast<int32_t*>(take(4 * m));
    s.pb = reinterpret_cast<int32_t*>(take(4 * m));
    s.ua = reinterpret_cast<uint64_t*>(take(8 * m));
    s.ub = reinterpret_cast<uint64_t*>(take(8 * m));
    s.hist = reinterpret_cast<int32_t*>(take(radix::hist_bytes(n)));
    return s;
}

template <int KIND, class T>
int run(const void* values, int64_t n, int64_t num_segments, const Scratch& sc, void* out_sum,
        void* out_count, void* out_min, void* out_max, void* out_mean, cudaStream_t s) {
    radix::Buffers b{sc.pa, sc.pb, sc.ua, sc.ub};
    if (n > 0) radix::passes(digits_for(num_segments), n, nullptr, b, sc.hist, s);
    const GroupedOp<KIND, T> op{static_cast<const T*>(values), b.pa, static_cast<T*>(out_sum),
                                static_cast<T*>(out_count), static_cast<double*>(out_min),
                                static_cast<double*>(out_max)};
    const int rc = seg::launch(static_cast<const uint64_t*>(b.ua), n, num_segments, op, s);
    if (rc != 0) return rc;
    if (num_segments > 0) {
        mean_kernel<KIND, T><<<radix::blocks_for(num_segments, 256), 256, 0, s>>>(
            static_cast<const T*>(out_sum), static_cast<const T*>(out_count),
            static_cast<double*>(out_mean), num_segments);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int64_t grouped_stats_scratch_bytes(int64_t n) {
    const int64_t m = n > 0 ? n : 1;
    auto pad = [](int64_t bytes) { return ((bytes + 255) / 256) * 256; };
    return 2 * pad(4 * m) + 2 * pad(8 * m) + pad(radix::hist_bytes(n));
}

// values: n values of `kind` (0 f64, 1 int64, 2 uint64 bits in int64);
// index: int32[n] (index_is_64 = 0) or int64[n] segment ids; valid:
// uint8[n] or null (every row valid); out_sum, out_count: num_segments
// values of the accumulator type (f64 for kind 0, else int64); out_min,
// out_max, out_mean: f64[num_segments]; scratch:
// grouped_stats_scratch_bytes(n) bytes. num_segments < 2^62.
extern "C" int grouped_stats_launch(const void* values, int32_t kind, const void* index,
                                    int32_t index_is_64, const void* valid, int64_t n,
                                    int64_t num_segments, void* out_sum, void* out_count,
                                    void* out_min, void* out_max, void* out_mean,
                                    void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind < KIND_F64 || kind > KIND_U64 || num_segments < 0 ||
        num_segments >= ((int64_t)1 << 62) || n >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    const Scratch sc = carve(scratch, n);
    const uint8_t* ok = static_cast<const uint8_t*>(valid);
    if (n > 0) {
        const unsigned blocks = radix::blocks_for(n, 256);
        if (index_is_64) {
            key_kernel<int64_t><<<blocks, 256, 0, s>>>(static_cast<const int64_t*>(index), ok, n,
                                                       num_segments, sc.ua, sc.pa);
        } else {
            key_kernel<int32_t><<<blocks, 256, 0, s>>>(static_cast<const int32_t*>(index), ok, n,
                                                       num_segments, sc.ua, sc.pa);
        }
    }
    switch (kind) {
        case KIND_F64:
            return run<KIND_F64, double>(values, n, num_segments, sc, out_sum, out_count, out_min,
                                         out_max, out_mean, s);
        case KIND_I64:
            return run<KIND_I64, int64_t>(values, n, num_segments, sc, out_sum, out_count,
                                          out_min, out_max, out_mean, s);
        default:
            return run<KIND_U64, int64_t>(values, n, num_segments, sc, out_sum, out_count,
                                          out_min, out_max, out_mean, s);
    }
}
