// index_merge: filter -> merge -> last-value dedup over the sort-key lanes
// (pk..., seq), returning only the compacted survivor row indices.
//
// Replaces the JAX package's storage/read.py::_build_index_kernel (catalog
// names index_merge_mask and index_merge_filter): a stable lax.sort of
// (~mask, pk..., __seq__, iota), or a stable partition when the rows are
// presorted, then keep-last per pk run, compacted int32 indices + count.
// index_merge_mask takes the mask from the host; index_merge_filter builds
// this file together with predicate.cu (kernel E), which writes the mask on
// the device first.
//
// Bound on an H100: memory. The least traffic reads each key lane once
// (8 B per row and key), the mask (1 B per row), and writes 4 B per
// survivor. Design:
//   1. sorting by (~mask, keys..., iota) equals a stable partition by the
//      mask followed by a stable sort of the kept rows by their keys, so
//      the partition (compact.cuh) comes first and rejected rows never
//      enter a digit pass; the kept count stays on the device;
//   2. an LSD sort over the lanes on onesweep.cuh's u64-key, int32-payload
//      path, the kept count as its device-side row count: the host packs
//      adjacent lanes into one u64 key where their spans fit together
//      (lane - lo, shifted; the caller ranks __seq__ densely and drops
//      constant lanes), and from the least significant key to the most
//      each key gets one key pass, which gathers its lanes through the
//      current permutation for the kept rows only, then that key's digit
//      sweeps carrying the row index. Every sort is stable and the
//      partition left the kept rows in input order, so the chain is the
//      lexicographic order with ties broken by row. Presorted input skips
//      this step;
//   3. keep-last flags compare adjacent pk values through the permutation
//      (no gathered copies of the lanes), and one more compaction writes
//      the survivors' row indices.
// No host synchronisation: every pass reads the kept count on the device,
// and blocks past it return at once.
#include "compact.cuh"
#include "onesweep.cuh"

namespace {

constexpr int MAX_KEYS = 16;

// one packed key: sum over its lanes of (lane[perm[i]] - lo) << shift
struct GroupKey {
    const int64_t* lane[MAX_KEYS];
    uint64_t lo[MAX_KEYS];
    int32_t shift[MAX_KEYS];
    int count;
    const int32_t* perm;
    __device__ uint64_t key(int64_t i) const {
        const int32_t p = perm[i];
        uint64_t k = 0;
        for (int j = 0; j < count; ++j) k |= ((uint64_t)lane[j][p] - lo[j]) << shift[j];
        return k;
    }
};

struct KeepLastKeys {
    const int64_t* keys[MAX_KEYS];
    int num_pk;
    const int32_t* perm;
    const int32_t* nv;
    __device__ bool flag(int64_t i) const {
        if (i == (int64_t)*nv - 1) return true;
        const int32_t p = perm[i];
        const int32_t q = perm[i + 1];
        for (int k = 0; k < num_pk; ++k) {
            if (keys[k][p] != keys[k][q]) return true;
        }
        return false;
    }
    __device__ int32_t value(int64_t i) const { return perm[i]; }
};

struct Scratch {
    onesweep::Scratch<uint64_t, int32_t> sort;
    int32_t* tiles;
    int32_t* nv;
};

// with p null, only the layout (and its bytes)
Scratch carve(void* p, int64_t n, int digits, int64_t* bytes = nullptr) {
    onesweep::Carver c{reinterpret_cast<uintptr_t>(p)};
    Scratch s;
    s.sort = onesweep::carve<uint64_t, int32_t>(p, n, digits, 3, &c.used);
    s.tiles = c.take<int32_t>(compact::scratch_bytes(n) / 4);
    s.nv = c.take<int32_t>(1);
    if (bytes) *bytes = c.used;
    return s;
}

}  // namespace

// n rows whose packed keys take at most `digits` digits (1-8)
extern "C" int64_t index_merge_scratch_bytes(int64_t n, int32_t digits) {
    int64_t bytes = 0;
    carve(nullptr, n, digits < 1 ? 1 : digits, &bytes);
    return bytes;
}

// keys: num_keys pointers to int64[n] mapped sort-key lanes, most
// significant first, the first num_pk of them the primary key; lo[i] bounds
// lane i from below. The packed keys (ops/merge.py::pack_lanes): num_groups
// of them, most significant first; key g packs the lanes lane_of[j] for j
// in [group_start[g], group_start[g + 1]), each (lane - lo) << shift_of[j],
// into group_digits[g] digits (1-8). mask: uint8[n] (0 = rejected);
// out_idx: int32[n], of which the first *count hold the survivors' row
// indices in key order; count: int32[1]; scratch:
// index_merge_scratch_bytes(n, the most group_digits) bytes.
extern "C" int index_merge_launch(const void* const* keys, const int64_t* lo, int32_t num_keys,
                                  int32_t num_pk, const int32_t* lane_of,
                                  const int32_t* shift_of, const int32_t* group_start,
                                  const int32_t* group_digits, int32_t num_groups, int64_t n,
                                  const void* mask, int32_t presorted, int32_t do_dedup,
                                  void* out_idx, void* count, void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_keys < 0 || num_keys > MAX_KEYS || num_pk < 0 || num_pk > num_keys ||
        num_groups < 0 || num_groups > num_keys || n < 0 || n >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    int max_digits = 1;
    for (int g = 0; g < num_groups; ++g) {
        const int a = group_start[g], b = group_start[g + 1];
        if (a < 0 || b <= a || b - a > MAX_KEYS || group_digits[g] < 1 || group_digits[g] > 8) {
            return (int)cudaErrorInvalidValue;
        }
        for (int j = a; j < b; ++j) {
            if (lane_of[j] < 0 || lane_of[j] >= num_keys || shift_of[j] < 0 ||
                shift_of[j] >= 8 * group_digits[g]) {
                return (int)cudaErrorInvalidValue;
            }
        }
        max_digits = group_digits[g] > max_digits ? group_digits[g] : max_digits;
    }
    int32_t* out = static_cast<int32_t*>(out_idx);
    int32_t* cnt = static_cast<int32_t*>(count);
    const Scratch sc = carve(scratch, n, max_digits);
    int32_t* part = sc.sort.v[2];  // the partition's permutation feeds the first sort
    compact::run(compact::MaskFlag{static_cast<const uint8_t*>(mask)}, n, nullptr, sc.tiles,
                 part, sc.nv, s);
    const int32_t* perm = part;
    if (!presorted) {
        const onesweep::Rows<uint64_t> rows{n, sc.nv, false, 0};
        for (int g = num_groups - 1; g >= 0; --g) {
            GroupKey src{};
            src.count = group_start[g + 1] - group_start[g];
            for (int j = 0; j < src.count; ++j) {
                const int k = lane_of[group_start[g] + j];
                src.lane[j] = static_cast<const int64_t*>(keys[k]);
                src.lo[j] = (uint64_t)lo[k];
                src.shift[j] = shift_of[group_start[g] + j];
            }
            src.perm = perm;
            perm = onesweep::sort(src, perm, rows, group_digits[g], sc.sort, s).vals;
        }
    }
    if (do_dedup) {
        KeepLastKeys f{};
        for (int k = 0; k < num_pk; ++k) f.keys[k] = static_cast<const int64_t*>(keys[k]);
        f.num_pk = num_pk;
        f.perm = perm;
        f.nv = sc.nv;
        compact::run(f, n, sc.nv, sc.tiles, out, cnt, s);
    } else {
        compact::run(compact::AllFlag{perm}, n, sc.nv, sc.tiles, out, cnt, s);
    }
    return (int)cudaGetLastError();
}
