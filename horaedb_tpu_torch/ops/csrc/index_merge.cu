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
//   2. the chain of look-back sorts of keychain.cuh over the kept rows,
//      the kept count as its device-side row count: the host packs the
//      lanes into u64 keys (ops/keychain.py::pack_lanes), each key gets a
//      key pass through the current permutation and its digit sweeps, so
//      the chain is the lexicographic order with ties broken by row.
//      Presorted input skips this step;
//   3. keep-last flags compare adjacent pk values through the permutation
//      (no gathered copies of the lanes), and one more compaction writes
//      the survivors' row indices.
// No host synchronisation: every pass reads the kept count on the device,
// and blocks past it return at once.
#include "compact.cuh"
#include "keychain.cuh"

namespace {

using keychain::MAX_KEYS;

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
    keychain::Scratch sort;
    int32_t* tiles;
    int32_t* nv;
};

// with p null, only the layout (and its bytes)
Scratch carve(void* p, int64_t n, int digits, int64_t* bytes = nullptr) {
    onesweep::Carver c{reinterpret_cast<uintptr_t>(p)};
    Scratch s;
    s.sort = keychain::carve(p, n, digits, &c.used);
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
// lane i from below; lane_of, shift_of, group_start, group_digits,
// num_groups: the packed keys (keychain::Layout). mask: uint8[n] (0 =
// rejected); out_idx: int32[n], of which the first *count hold the survivors' row
// indices in key order; count: int32[1]; scratch:
// index_merge_scratch_bytes(n, the most group_digits) bytes.
extern "C" int index_merge_launch(const void* const* keys, const int64_t* lo, int32_t num_keys,
                                  int32_t num_pk, const int32_t* lane_of,
                                  const int32_t* shift_of, const int32_t* group_start,
                                  const int32_t* group_digits, int32_t num_groups, int64_t n,
                                  const void* mask, int32_t presorted, int32_t do_dedup,
                                  void* out_idx, void* count, void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const keychain::Layout layout{keys,     lo,          num_keys,     lane_of,
                                  shift_of, group_start, group_digits, num_groups};
    const int max_digits = keychain::max_digits(layout);
    if (max_digits == 0 || num_keys > MAX_KEYS || num_pk < 0 || num_pk > num_keys || n < 0 ||
        n >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    int32_t* out = static_cast<int32_t*>(out_idx);
    int32_t* cnt = static_cast<int32_t*>(count);
    const Scratch sc = carve(scratch, n, max_digits);
    int32_t* part = sc.sort.v[2];  // the partition's permutation feeds the first sort
    compact::run(compact::MaskFlag{static_cast<const uint8_t*>(mask)}, n, nullptr, sc.tiles,
                 part, sc.nv, s);
    const int32_t* perm = part;
    if (!presorted) {
        perm = keychain::sort(layout, perm, onesweep::Rows<uint64_t>{n, sc.nv, false, 0}, sc.sort,
                              s);
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
