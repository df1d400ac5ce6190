// sharded_downsample / multisegment_downsample: one mesh slot's partial
// grids (sum, count, min, max), in one pass from the raw lanes.
//
// Replaces the per-device body of the JAX package's parallel/scan.py
// step, `_local_grids` (catalog names sharded_downsample, :137-197, and
// multisegment_downsample, :233-286, which runs the same body once per
// segment shard with that segment's t0). For a slot that owns the series
// slice [lo, lo + local_series) of the output grid, each row gets
//   local = sid - lo (int32, wrapping as the JAX int32 arithmetic does),
//   bucket = floor((ts - t0) / bucket_ms) as int32,
//   in_slice = 0 <= local < local_series,
//   ok = valid && mask && in_slice && 0 <= bucket < num_buckets,
//   key = local * num_buckets + clip(bucket)      (in range when in_slice),
// as `masked_cell_keys` and the sentinel and typed-zero rules of
// scan.py:83-90 build them. A row of another slice goes to the sentinel
// (cells = local_series * num_buckets), where in (sid, ts) order it forms
// one prefix or suffix run, and drops. A masked row (not ok, in the slice)
// keeps its in-range key, so sorted runs stay whole: it adds +0.0 to its
// cell's sum and 0 to its count, and never touches min or max. `mask` is
// kernel E's output (predicate.cu, in the same library) when the step has
// a predicate, else null.
//
// A row's id is its key in the low 31 bits with MASKED set on a masked
// row (`SlotKey`: ids compare, and index a cell, by the low bits alone).
// Two routes, both ending in segreduce.cuh's fold with one Op (`SlotOp`:
// sum and weight, min and max gated on the flag, each cell the left fold
// of its run's rows as kernels B and C fold them, with fold_long past
// LONG rows):
//   - sorted rows (ids monotone in the slice): one run_kernel whose ids
//     come from ts, sid, valid and mask, computed into shared memory while
//     the value lane's bulk copy runs; nothing is written but the cells;
//   - unsorted rows: onesweep.cuh sorts the rows by id, stably, carrying
//     the values (its key pass computes the ids from the raw lanes, its
//     presorted shortcut takes rows already in order; the flag rides above
//     the ordering bits), then run_kernel folds the sorted ids and values.
// Either way a cell's sum and weight are bitwise those of kernel B over
// (safe key, masked value, weight), and its min and max those of kernel C
// (sorted) or grouped_stats (unsorted) over the ok rows: the same runs, the
// same rows in the same order (the sort is stable), the same association.
//
// Bound on an H100: memory. Per row it reads ts (8 B), sid (4 B), the
// value (8 B), the validity byte and the mask byte; per cell it writes sum,
// count, min and max (32 B). The unsorted route adds the sort's passes
// (key 4 B written; 12 B a row each way a digit pass, or one partition). The
// work is one integer division a row. CUDA's `/` truncates toward zero, so
// the bucket is floored by hand (a row 1 ms before t0 lands in bucket -1).
#include "onesweep.cuh"
#include "segreduce.cuh"

namespace {

constexpr uint32_t MASKED = 1u << 31;
constexpr uint32_t ID = MASKED - 1;

struct SlotKey {
    uint32_t bits;
    SlotKey() = default;
    __host__ __device__ constexpr SlotKey(uint32_t b) : bits(b) {}
    __device__ explicit operator int64_t() const { return (int64_t)(bits & ID); }
    __device__ bool operator==(SlotKey o) const { return ((bits ^ o.bits) & ID) == 0; }
    __device__ bool operator!=(SlotKey o) const { return ((bits ^ o.bits) & ID) != 0; }
    __device__ bool masked() const { return (bits & MASKED) != 0; }
};

// the ids of a slot's rows, from the raw lanes (the sort's key source).
// Every lane of the row is loaded before any branch, so an unrolled loop
// over rows issues all its loads at once. The quotient takes 32-bit
// division when 0 <= ts - t0 < 2^32 and bucket_ms < 2^32 (a window of
// milliseconds always), else the 64-bit division floored by hand.
struct SlotRows {
    static constexpr uint32_t ORDER = ID;  // the sort orders by the cell, not the flag
    const int64_t* ts;
    const int32_t* sid;
    const uint8_t* valid;
    const uint8_t* mask;
    int64_t t0;
    int64_t bucket_ms;
    int32_t lo;
    int32_t local_series;
    int32_t num_buckets;
    __device__ uint32_t key(int64_t i) const {
        const int32_t s = sid[i];
        const int64_t t = ts[i];
        const uint8_t m = mask == nullptr ? (uint8_t)1 : mask[i];  // a uniform branch
        const bool live = (valid[i] != 0) & (m != 0);
        const int32_t local = (int32_t)((uint32_t)s - (uint32_t)lo);
        const int64_t d = (int64_t)((uint64_t)t - (uint64_t)t0);
        int64_t q;
        if ((uint64_t)d <= 0xffffffffull && (uint64_t)bucket_ms <= 0xffffffffull) {
            q = (int64_t)((uint32_t)d / (uint32_t)bucket_ms);
        } else {
            q = d / bucket_ms;
            if (d % bucket_ms != 0 && d < 0) --q;  // floor; bucket_ms > 0
        }
        const int32_t bucket = (int32_t)(uint32_t)(uint64_t)q;
        if (local < 0 || local >= local_series) return (uint32_t)(local_series * num_buckets);
        const bool ok = live && bucket >= 0 && bucket < num_buckets;
        const int32_t cb = bucket < 0 ? 0 : (bucket >= num_buckets ? num_buckets - 1 : bucket);
        return (uint32_t)(local * num_buckets + cb) | (ok ? 0u : MASKED);
    }
};

// the sorted route's key source: ids computed, no id lane
struct SlotKeys {
    using Key = SlotKey;
    static constexpr bool COMPUTED = true;
    SlotRows rows;
    __device__ SlotKey operator[](int64_t i) const { return SlotKey(rows.key(i)); }
};

struct Stats {
    double sum;
    double w;
    double mn;
    double mx;
};

struct SlotOp {
    using Acc = Stats;
    static constexpr int LANES = 1;
    static constexpr bool KEYED = true;
    seg::Lanes<LANES> lanes;  // the values (raw, or in the sort's order)
    double* out_sum;
    double* out_count;
    double* out_min;  // null together with out_max: no min and max
    double* out_max;
    __host__ __device__ static constexpr int bytes(int) { return 8; }
    __host__ __device__ static Acc identity() {
        return {0.0, 0.0, (double)INFINITY, -(double)INFINITY};
    }
    __device__ Acc load(const seg::Lanes<LANES>& at, int64_t i, SlotKey k) const {
        const double x = static_cast<const double*>(at.p[0])[i];
        return k.masked() ? identity() : Acc{x, 1.0, x, x};
    }
    __device__ static Acc combine(Acc x, Acc y) {
        return {x.sum + y.sum, x.w + y.w, seg::nan_min(x.mn, y.mn), seg::nan_max(x.mx, y.mx)};
    }
    __device__ void store(int64_t c, Acc a) const {
        out_sum[c] = a.sum;
        out_count[c] = a.w;
        if (out_min != nullptr) {
            out_min[c] = a.mn;
            out_max[c] = a.mx;
        }
    }
};

// u32 slot ids (at most 4 digits: cells < 2^31) carrying the 8 B values;
// with p null, only the layout (and its bytes)
onesweep::Scratch<uint32_t, uint64_t> carve(void* p, int64_t n, int64_t* bytes = nullptr) {
    return onesweep::carve<uint32_t, uint64_t>(p, n, 4, 2, bytes);
}

}  // namespace

extern "C" int64_t sharded_slot_scratch_bytes(int64_t n) {
    int64_t bytes = 0;
    carve(nullptr, n, &bytes);
    return bytes;
}

// ts: int64[n]; sid: int32[n]; val: f64[n]; valid: uint8[n]; mask: uint8[n]
// or null; sorted: 1 when the rows are in (sid, ts) order; outputs
// f64[local_series * num_buckets] each (out_min and out_max both null: no
// min and max); scratch: sharded_slot_scratch_bytes(n) bytes when unsorted,
// else unused. bucket_ms > 0, local_series, num_buckets > 0,
// local_series * num_buckets < 2^31, n < 2^31.
extern "C" int sharded_slot_launch(const void* ts, const void* sid, const void* val,
                                   const void* valid, const void* mask, int64_t t0,
                                   int64_t bucket_ms, int32_t lo, int32_t local_series,
                                   int32_t num_buckets, int64_t n, int32_t sorted, void* out_sum,
                                   void* out_count, void* out_min, void* out_max, void* scratch,
                                   void* stream) {
    const int64_t cells = (int64_t)local_series * num_buckets;
    if (bucket_ms <= 0 || local_series <= 0 || num_buckets <= 0 || cells >= ((int64_t)1 << 31) ||
        n < 0 || n >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const SlotRows rows{static_cast<const int64_t*>(ts), static_cast<const int32_t*>(sid),
                        static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(mask),
                        t0, bucket_ms, lo, local_series, num_buckets};
    SlotOp op{{{val}}, static_cast<double*>(out_sum), static_cast<double*>(out_count),
              static_cast<double*>(out_min), static_cast<double*>(out_max)};
    if (sorted) return seg::launch_keys(SlotKeys{rows}, n, cells, op, s);
    const SlotKey* keys = nullptr;
    if (n > 0) {
        const onesweep::Rows<uint32_t> in_play{n, nullptr, true, (uint32_t)cells};
        const auto o = onesweep::sort(rows, static_cast<const uint64_t*>(val), in_play,
                                      onesweep::digits_for((uint64_t)cells), carve(scratch, n), s);
        keys = reinterpret_cast<const SlotKey*>(o.keys);
        op.lanes.p[0] = o.vals;
    }
    return seg::launch_keys(seg::IdLane<SlotKey>{keys}, n, cells, op, s);
}

// run_kernel's occupancy for the sorted (1) or unsorted (0) route: blocks
// an SM, registers a thread, static and dynamic shared bytes.
extern "C" int sharded_slot_occupancy(int32_t* out, int32_t sorted) {
    static const double lane = 0.0;
    const SlotOp op{{{&lane}}, nullptr, nullptr, nullptr, nullptr};
    return sorted ? seg::occupancy_keys<SlotOp, SlotKeys>(op, out)
                  : seg::occupancy_keys<SlotOp, seg::IdLane<SlotKey>>(op, out);
}
