// grouped_stats: sum, count, min, max and mean per segment over UNSORTED
// segment ids; ids outside [0, num_segments) and rows whose `valid` is
// false are dropped. Also the reduction of downsample and of
// stacked_downsample, whose cell ids it computes itself
// (grouped_stats_downsample_launch, grouped_stats_stacked_launch).
//
// Replaces the JAX package's ops/aggregate.py::grouped_stats (catalog name
// grouped_stats) and the scatter it reaches, masked_segment_stats /
// masked_minmax (:48-93): float values sum in f64, integer values sum
// exactly in 64 bits (signed in int64, unsigned in uint64, whose bits are
// int64's) with a count of the same type, and min / max come back as f64
// (the JAX function promotes through jnp.where(valid, values, inf)), with
// NaN propagated. Empty segments read sum 0, count 0, min +inf, max -inf
// and mean NaN. And ops/aggregate.py::downsample (catalog name
// downsample): bucket = floor((ts - t0) / bucket_ms) as int32, a row is in
// the grid when valid, 0 <= bucket < num_buckets and 0 <= sid <
// num_series, its cell is sid * num_buckets + bucket, and every other row
// drops. CUDA's `/` truncates toward zero, so the quotient is floored by
// hand (a row 1 ms before t0 lands in bucket -1 and drops); the difference
// and the int32 cast wrap as the JAX int64 and astype(int32) arithmetic
// does. And ops/aggregate.py::stacked_downsample (catalog name
// stacked_downsample, the query batcher's device lane): B queries' rows
// as [B, R] lanes (query `lane` owns rows lane * R .. lane * R + R - 1),
// each with its own t0; an in-grid row's cell is lane * S * T + its
// downsample cell, every other row drops (the sentinel B * S * T). Lanes
// own disjoint cell ranges and the sort is stable, so each cell folds
// exactly its query's in-grid rows in row order, as the query's solo
// reduction does (downsample_sorted drops out-of-grid rows first): stacked
// == solo, bitwise.
//
// Bound on an H100: memory. The least traffic reads the id (4 B), the
// value (8 B) and the mask (1 B) once per row (downsample and
// stacked_downsample: ts 8 B and sid 4 B in place of the id) and writes
// 40 B per segment.
// Design: no atomics on a float, so a grid is bitwise repeatable.
//   1. onesweep.cuh sorts the rows by cell, stably, carrying each value
//      (its u32-key, u64-payload instantiation, digits from num_segments):
//      its key pass computes each row's key (the cell, or num_segments for
//      a dropped row, the sentinel) as u32, from the id lane or from the
//      raw ts and sid lanes (no id lane is written); rows whose kept cells
//      are already in order (the fused scan's and the batcher's are) take
//      one stable partition instead of the digit passes, with the same
//      result. When there are no more segments than rows, the key pass's
//      blocks also write the empty value (sum 0, count 0, min +inf, max
//      -inf) to every segment, an equal share each (`Filling`): no fill
//      launch, and no block's share grows with how the rows fall; a
//      sparser grid takes segreduce.cuh's fill launch instead;
//   2. the segmented reduction of segreduce.cuh over the sorted keys and
//      values (each tile staged in shared memory by bulk copies), each
//      segment's sum the left fold of its rows in input order (the sort is
//      stable); the dropped rows sort last and never reach a segment;
//   3. one elementwise pass over the segments writes the mean: coalesced,
//      it costs less than a fifth scattered store in the fold's run heads.
// A call with rows is one memset, the key pass, onesweep's decide_kernel,
// the partition, one sweep a digit (each returns at once on presorted rows),
// the fold and the mean. Keys are u32, so num_segments < 2^32: 2^32
// segments of outputs (40 B each) would not fit on the card anyway.
#include <type_traits>

#include "onesweep.cuh"
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

// sum / count in f64; an empty segment's 0 / 0 is written as the NaN the
// card's division gives for it (0xfff8000000000000, x86's default NaN
// too), without the division's slow path, which 0 / 0 takes
template <int KIND, class T>
__device__ inline double mean_of(T sum, T count) {
    if (count == (T)0) return __longlong_as_double((long long)0xfff8000000000000ull);
    return to_f64<KIND>(sum) / to_f64<KIND>(count);
}

template <int KIND, class T>
struct GroupedOp {
    using Acc = Stats<T>;
    static constexpr int LANES = 1;
    seg::Lanes<LANES> lanes;  // the values in sorted order
    T* out_sum;
    T* out_count;
    double* out_min;
    double* out_max;
    __host__ __device__ static constexpr int bytes(int) { return 8; }
    __host__ __device__ static Acc identity() {
        return {(T)0, (T)0, (double)INFINITY, -(double)INFINITY};
    }
    __device__ Acc load(const seg::Lanes<LANES>& at, int64_t pos) const {
        const T x = static_cast<const T*>(at.p[0])[pos];
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

// key = index[i] where valid and in range, else num_segments
template <class I>
struct IndexKey {
    const I* index;
    const uint8_t* valid;
    int64_t num_segments;
    __device__ uint32_t key(int64_t i) const {
        const int64_t x = (int64_t)index[i];
        const bool ok = (valid == nullptr || valid[i] != 0) && x >= 0 && x < num_segments;
        return (uint32_t)(ok ? x : num_segments);
    }
};

// a row's downsample cell, or -1 when it drops
__device__ inline int64_t cell_of(int64_t ts, int32_t s, bool live, int64_t t0,
                                  int64_t bucket_ms, int32_t num_series, int32_t num_buckets) {
    const int64_t d = (int64_t)((uint64_t)ts - (uint64_t)t0);
    int64_t q;
    if ((uint64_t)d <= 0xffffffffull && (uint64_t)bucket_ms <= 0xffffffffull) {
        q = (int64_t)((uint32_t)d / (uint32_t)bucket_ms);  // the same quotient, cheaper
    } else {
        q = d / bucket_ms;
        if (d % bucket_ms != 0 && d < 0) --q;  // floor; bucket_ms > 0
    }
    const int32_t bucket = (int32_t)(uint32_t)(uint64_t)q;
    const bool ok = live && bucket >= 0 && bucket < num_buckets && s >= 0 && s < num_series;
    return ok ? (int64_t)(s * num_buckets + bucket) : -1;
}

// key = the row's downsample cell, else num_series * num_buckets
struct CellKey {
    const int64_t* ts;
    const int32_t* sid;
    const uint8_t* valid;
    int64_t t0;
    int64_t bucket_ms;
    int32_t num_series;
    int32_t num_buckets;
    __device__ uint32_t key(int64_t i) const {
        const int64_t c = cell_of(ts[i], sid[i], valid == nullptr || valid[i] != 0, t0,
                                  bucket_ms, num_series, num_buckets);
        return (uint32_t)(c >= 0 ? c : (int64_t)num_series * num_buckets);
    }
};

// key = lane * S * T + the row's downsample cell in its lane's grid (the
// lane's own t0), else the sentinel B * S * T; rows [B * R] (B * S * T <
// 2^31, B * R < 2^31)
struct StackedKey {
    const int64_t* ts;
    const int32_t* sid;
    const uint8_t* valid;
    const int64_t* t0;  // [B]
    int64_t bucket_ms;
    int32_t num_series;
    int32_t num_buckets;
    uint32_t rows;      // R, rows a lane
    uint32_t sentinel;  // B * S * T
    __device__ uint32_t key(int64_t i) const {
        const uint32_t lane = (uint32_t)i / rows;
        const int64_t c = cell_of(ts[i], sid[i], valid == nullptr || valid[i] != 0, t0[lane],
                                  bucket_ms, num_series, num_buckets);
        return c >= 0 ? lane * (uint32_t)(num_series * num_buckets) + (uint32_t)c : sentinel;
    }
};

// Src's keys; the key pass's block b of `blocks` writes the empty value to
// op's segments [b * per, b * per + per), per = ceil(cells / blocks)
// (cells 0: none)
template <class Src, class Op>
struct Filling : Src {
    Op op;
    int64_t cells;
    __device__ void side(int64_t b, int64_t blocks) const {
        const int64_t per = (cells + blocks - 1) / blocks;
        const int64_t lo = b * per;
        const int64_t hi = lo + per < cells ? lo + per : cells;
        for (int64_t c = lo + threadIdx.x; c < hi; c += blockDim.x) op.store(c, Op::identity());
    }
};

// u32 cell keys (at most 4 digits: num_segments < 2^32) carrying the 8 B
// values; with p null, only the layout (and its bytes)
onesweep::Scratch<uint32_t, uint64_t> carve(void* p, int64_t n, int64_t* bytes = nullptr) {
    return onesweep::carve<uint32_t, uint64_t>(p, n, 4, 2, bytes);
}

template <int KIND, class T>
__global__ void mean_kernel(const T* __restrict__ sum, const T* __restrict__ count,
                            double* __restrict__ mean, int64_t m) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c < m) mean[c] = mean_of<KIND>(sum[c], count[c]);
}

template <int KIND, class T, class Src>
int run(const Src& src, const void* values, int64_t n, int64_t num_segments, void* out_sum,
        void* out_count, void* out_min, void* out_max, void* out_mean, void* scratch,
        cudaStream_t s) {
    GroupedOp<KIND, T> op{{{nullptr}}, static_cast<T*>(out_sum), static_cast<T*>(out_count),
                          static_cast<double*>(out_min), static_cast<double*>(out_max)};
    const uint32_t* keys = nullptr;
    const bool filled = n > 0 && num_segments > 0 && num_segments <= n;
    if (n > 0 && num_segments > 0) {
        const onesweep::Rows<uint32_t> rows{n, nullptr, true, (uint32_t)num_segments};
        const Filling<Src, GroupedOp<KIND, T>> keyed{src, op, filled ? num_segments : 0};
        const auto o = onesweep::sort(keyed, static_cast<const uint64_t*>(values), rows,
                                      onesweep::digits_for((uint64_t)num_segments),
                                      carve(scratch, n), s);
        keys = o.keys;
        op.lanes.p[0] = o.vals;
    }
    const int rc = seg::launch(keys, n, num_segments, op, s, filled);
    if (rc != 0) return rc;
    if (num_segments > 0) {
        mean_kernel<KIND, T><<<(unsigned)((num_segments + 255) / 256), 256, 0, s>>>(
            static_cast<const T*>(out_sum), static_cast<const T*>(out_count),
            static_cast<double*>(out_mean), num_segments);
    }
    return (int)cudaGetLastError();
}

template <class Src>
int run_kind(int32_t kind, const Src& src, const void* values, int64_t n, int64_t num_segments,
             void* out_sum, void* out_count, void* out_min, void* out_max, void* out_mean,
             void* scratch, cudaStream_t s) {
    switch (kind) {
        case KIND_F64:
            return run<KIND_F64, double>(src, values, n, num_segments, out_sum, out_count,
                                         out_min, out_max, out_mean, scratch, s);
        case KIND_I64:
            return run<KIND_I64, int64_t>(src, values, n, num_segments, out_sum, out_count,
                                          out_min, out_max, out_mean, scratch, s);
        default:
            return run<KIND_U64, int64_t>(src, values, n, num_segments, out_sum, out_count,
                                          out_min, out_max, out_mean, scratch, s);
    }
}

}  // namespace

extern "C" int64_t grouped_stats_scratch_bytes(int64_t n) {
    int64_t bytes = 0;
    carve(nullptr, n, &bytes);
    return bytes;
}

// where a launch over n rows leaves its presorted flag in the scratch
extern "C" int64_t grouped_stats_flag_offset(int64_t n) {
    return (int64_t)reinterpret_cast<uintptr_t>(carve(nullptr, n).flag);
}

// values: n values of `kind` (0 f64, 1 int64, 2 uint64 bits in int64);
// index: int32[n] (index_is_64 = 0) or int64[n] segment ids; valid:
// uint8[n] or null (every row valid); out_sum, out_count: num_segments
// values of the accumulator type (f64 for kind 0, else int64); out_min,
// out_max, out_mean: f64[num_segments]; scratch:
// grouped_stats_scratch_bytes(n) bytes. num_segments < 2^32, n < 2^31.
extern "C" int grouped_stats_launch(const void* values, int32_t kind, const void* index,
                                    int32_t index_is_64, const void* valid, int64_t n,
                                    int64_t num_segments, void* out_sum, void* out_count,
                                    void* out_min, void* out_max, void* out_mean,
                                    void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind < KIND_F64 || kind > KIND_U64 || num_segments < 0 ||
        num_segments >= ((int64_t)1 << 32) || n < 0 || n >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    const uint8_t* ok = static_cast<const uint8_t*>(valid);
    if (index_is_64) {
        return run_kind(kind, IndexKey<int64_t>{static_cast<const int64_t*>(index), ok,
                                                num_segments},
                        values, n, num_segments, out_sum, out_count, out_min, out_max, out_mean,
                        scratch, s);
    }
    return run_kind(kind, IndexKey<int32_t>{static_cast<const int32_t*>(index), ok, num_segments},
                    values, n, num_segments, out_sum, out_count, out_min, out_max, out_mean,
                    scratch, s);
}

// downsample's grids, flat: ts int64[n], sid int32[n], valid uint8[n] or
// null; the outputs and scratch as grouped_stats_launch's with
// num_segments = num_series * num_buckets < 2^31; bucket_ms > 0.
extern "C" int grouped_stats_downsample_launch(const void* values, int32_t kind, const void* ts,
                                               const void* sid, const void* valid, int64_t t0,
                                               int64_t bucket_ms, int32_t num_series,
                                               int32_t num_buckets, int64_t n, void* out_sum,
                                               void* out_count, void* out_min, void* out_max,
                                               void* out_mean, void* scratch, void* stream) {
    const int64_t cells = (int64_t)num_series * num_buckets;
    if (kind < KIND_F64 || kind > KIND_U64 || bucket_ms <= 0 || num_series < 0 ||
        num_buckets < 0 || cells >= ((int64_t)1 << 31) || n < 0 || n >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    const CellKey src{static_cast<const int64_t*>(ts), static_cast<const int32_t*>(sid),
                      static_cast<const uint8_t*>(valid), t0, bucket_ms, num_series,
                      num_buckets};
    return run_kind(kind, src, values, n, cells, out_sum, out_count, out_min, out_max, out_mean,
                    scratch, static_cast<cudaStream_t>(stream));
}

// stacked_downsample's grids, flat [B * S * T]: ts int64[B * R], sid
// int32[B * R], valid uint8[B * R] or null, t0 int64[B]; the outputs and
// scratch as grouped_stats_launch's with num_segments = B * S * T < 2^31;
// bucket_ms > 0, R > 0, B * R < 2^31.
extern "C" int grouped_stats_stacked_launch(const void* values, int32_t kind, const void* ts,
                                            const void* sid, const void* valid, const void* t0,
                                            int64_t bucket_ms, int32_t num_series,
                                            int32_t num_buckets, int64_t batch, int64_t rows,
                                            void* out_sum, void* out_count, void* out_min,
                                            void* out_max, void* out_mean, void* scratch,
                                            void* stream) {
    const int64_t cells = batch * (int64_t)num_series * num_buckets;
    const int64_t n = batch * rows;
    if (kind < KIND_F64 || kind > KIND_U64 || bucket_ms <= 0 || num_series < 0 ||
        num_buckets < 0 || batch < 0 || rows <= 0 || cells >= ((int64_t)1 << 31) ||
        n >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    const StackedKey src{static_cast<const int64_t*>(ts), static_cast<const int32_t*>(sid),
                         static_cast<const uint8_t*>(valid), static_cast<const int64_t*>(t0),
                         bucket_ms, num_series, num_buckets, (uint32_t)rows, (uint32_t)cells};
    return run_kind(kind, src, values, n, cells, out_sum, out_count, out_min, out_max, out_mean,
                    scratch, static_cast<cudaStream_t>(stream));
}

// The u32-key instantiation's sweep (onesweep::sweep_occupancy): blocks an
// SM, registers a thread, static and dynamic shared bytes.
extern "C" int grouped_stats_sweep_occupancy(int32_t* out) {
    return onesweep::sweep_occupancy<uint32_t, uint64_t>(out);
}

// The f64 reduction's run_kernel (seg::occupancy), as the sweep's.
extern "C" int grouped_stats_run_occupancy(int32_t* out) {
    static const double lane = 0.0;
    const GroupedOp<KIND_F64, double> op{{{&lane}}, nullptr, nullptr, nullptr, nullptr};
    return seg::occupancy<GroupedOp<KIND_F64, double>, uint32_t>(op, out);
}
