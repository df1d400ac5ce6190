// packedsort.cuh: the merge of rows by one packed u64 sort key, shared by
// packed_merge.cu (kernel D) and sample_sort_merge.cu (row 14's two steps).
//
// Keys arrive mapped to int64 (bit 63 flipped, backend.u64_to_i64): the
// sentinel of a rejected row (all ones) reads INT64_MAX, and mapped ^ 2^63
// is the raw key, so the digits and the group shift run on raw u64 bits.
//
//   sort_valid: a stable partition of the valid rows (key != sentinel) to
//     the front (compact.cuh), their count on the device; then
//     onesweep.cuh's u64-key, int32-payload sort of the valid rows: its key
//     pass gathers each valid row's raw key through the partition, the
//     digits come from key_bits (a 42-bit key takes 6 look-back sweeps,
//     none when the valid keys already ascend: the presorted shortcut), the
//     row carried as the payload, and every pass reads the valid count on
//     the device and skips the tiles past it. A sentinel row never costs a
//     digit pass (sorted, the all-ones key would force 8). Equal keys keep
//     input order: the sort is stable and the partition keeps order.
//   merge: sort_valid, then one compaction over the sorted keys (no
//     gather): with dedup the last row of each group (raw key >>
//     seq_width; the next row of the last valid row is the sentinel
//     group), else every valid row; it writes each kept row's index, or
//     the row id carried beside the key when the caller gives them.
// No host synchronisation: the valid count and the kept count stay on the
// device.
#pragma once

#include "compact.cuh"
#include "onesweep.cuh"

namespace packedsort {

struct NotSentinel {
    const int64_t* key;
    __device__ bool flag(int64_t i) const { return key[i] != INT64_MAX; }
    __device__ int32_t value(int64_t i) const { return (int32_t)i; }
};

// the raw key of valid row perm[i] (mapped ^ 2^63)
struct RawKey {
    const int64_t* mapped;
    const int32_t* perm;
    __device__ uint64_t key(int64_t i) const {
        return (uint64_t)mapped[perm[i]] ^ 0x8000000000000000ULL;
    }
};

// the output of sorted position i: its row, or the row id carried beside
// the key (row_id non-null)
struct RowOf {
    const int32_t* perm;
    const int32_t* row_id;
    __device__ int32_t operator()(int64_t i) const {
        return row_id != nullptr ? row_id[perm[i]] : perm[i];
    }
};

// sorted position i ends its group: the last valid row, or the next row's
// group differs
struct KeepLast {
    const uint64_t* u;
    const int32_t* nv;
    int seq_width;
    RowOf row;
    __device__ bool flag(int64_t i) const {
        return i == (int64_t)*nv - 1 || (u[i] >> seq_width) != (u[i + 1] >> seq_width);
    }
    __device__ int32_t value(int64_t i) const { return row(i); }
};

struct AllRows {
    RowOf row;
    __device__ bool flag(int64_t) const { return true; }
    __device__ int32_t value(int64_t i) const { return row(i); }
};

struct Scratch {
    onesweep::Scratch<uint64_t, int32_t> sort;
    int32_t* tiles;
    int32_t* nv;
    int32_t* start;  // `starts` words the caller may use (sample_sort_merge's buckets)
};

inline int digits_of(int32_t key_bits) { return (key_bits + 7) / 8; }

// with p null, only the layout (and its bytes)
inline Scratch carve(void* p, int64_t n, int32_t key_bits, int64_t starts,
                     int64_t* bytes = nullptr) {
    onesweep::Carver c{reinterpret_cast<uintptr_t>(p)};
    Scratch s;
    s.sort = onesweep::carve<uint64_t, int32_t>(p, n, digits_of(key_bits), 3, &c.used);
    s.tiles = c.take<int32_t>(compact::tiles_for(n));
    s.nv = c.take<int32_t>(1);
    s.start = c.take<int32_t>(starts > 0 ? starts : 1);
    if (bytes) *bytes = c.used;
    return s;
}

inline int64_t scratch_size(int64_t n, int32_t key_bits, int64_t starts) {
    int64_t bytes = 0;
    carve(nullptr, n, key_bits < 1 ? 1 : key_bits > 63 ? 63 : key_bits, starts, &bytes);
    return bytes;
}

inline bool valid_widths(int32_t key_bits, int32_t seq_width) {
    return key_bits >= 1 && key_bits <= 63 && seq_width >= 0 && seq_width <= 63;
}

// partition the valid rows of key[0, n) and sort them by raw key
inline onesweep::Sorted<uint64_t, int32_t> sort_valid(const void* key, int64_t n,
                                                      int32_t key_bits, const Scratch& sc,
                                                      cudaStream_t s) {
    const int64_t* k = static_cast<const int64_t*>(key);
    int32_t* part = sc.sort.v[2];
    compact::run(NotSentinel{k}, n, nullptr, sc.tiles, part, sc.nv, s);
    const onesweep::Rows<uint64_t> rows{n, sc.nv, false, 0};
    return onesweep::sort(RawKey{k, part}, part, rows, digits_of(key_bits), sc.sort, s);
}

// out[0, *count) = the kept rows (or their row ids) in key order
inline void merge(const void* key, const int32_t* row_id, int64_t n, int32_t key_bits,
                  int32_t seq_width, bool do_dedup, int32_t* out, int32_t* count,
                  const Scratch& sc, cudaStream_t s) {
    const auto r = sort_valid(key, n, key_bits, sc, s);
    const RowOf row{r.vals, row_id};
    if (do_dedup) {
        compact::run(KeepLast{r.keys, sc.nv, seq_width, row}, n, sc.nv, sc.tiles, out, count, s);
    } else {
        compact::run(AllRows{row}, n, sc.nv, sc.tiles, out, count, s);
    }
}

}  // namespace packedsort
