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
//      enter a radix pass;
//   2. kernel A's LSD radix passes (radix.cuh) over the kept rows, each key
//      offset by its minimum so only digits below the key's span are
//      sorted (the caller ranks __seq__ densely and drops constant keys);
//      presorted input skips this step;
//   3. keep-last flags compare adjacent pk values through the permutation
//      (no gathered copies of the lanes), and one more compaction writes
//      the survivors' row indices.
// The kept count lives on the device between the steps: no synchronisation.
#include "compact.cuh"

namespace {

constexpr int MAX_KEYS = 16;

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
    int32_t* perm;
    int32_t* perm_tmp;
    uint64_t* ua;
    uint64_t* ub;
    int32_t* hist;
    int32_t* tiles;
    int32_t* nv;
};

Scratch carve(void* p, int64_t n) {
    compact::Arena a{static_cast<char*>(p)};
    const int64_t m = n > 0 ? n : 1;
    Scratch s;
    s.perm = a.take<int32_t>(m);
    s.perm_tmp = a.take<int32_t>(m);
    s.ua = a.take<uint64_t>(m);
    s.ub = a.take<uint64_t>(m);
    s.hist = a.take<int32_t>(radix::hist_bytes(n) / 4);
    s.tiles = a.take<int32_t>(compact::scratch_bytes(n) / 4);
    s.nv = a.take<int32_t>(1);
    return s;
}

}  // namespace

extern "C" int64_t index_merge_scratch_bytes(int64_t n) {
    using compact::Arena;
    const int64_t m = n > 0 ? n : 1;
    return 2 * Arena::size_of(4 * m) + 2 * Arena::size_of(8 * m) +
           Arena::size_of(radix::hist_bytes(n)) + Arena::size_of(compact::scratch_bytes(n)) +
           Arena::size_of(4);
}

// keys: num_keys pointers to int64[n] mapped sort-key lanes, most
// significant first, the first num_pk of them the primary key; lo/digits
// as for sort_perm_launch; mask: uint8[n] (0 = rejected); out_idx:
// int32[n], of which the first *count hold the survivors' row indices in
// key order; count: int32[1]; scratch: index_merge_scratch_bytes(n) bytes.
extern "C" int index_merge_launch(const void* const* keys, const int64_t* lo,
                                  const int32_t* digits, int32_t num_keys, int32_t num_pk,
                                  int64_t n, const void* mask, int32_t presorted,
                                  int32_t do_dedup, void* out_idx, void* count,
                                  void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_keys < 0 || num_keys > MAX_KEYS || num_pk < 0 || num_pk > num_keys) {
        return (int)cudaErrorInvalidValue;
    }
    int32_t* out = static_cast<int32_t*>(out_idx);
    int32_t* cnt = static_cast<int32_t*>(count);
    Scratch sc = carve(scratch, n);
    compact::run(compact::MaskFlag{static_cast<const uint8_t*>(mask)}, n, nullptr, sc.tiles,
                 sc.perm, sc.nv, s);
    int32_t* perm = sc.perm;
    if (!presorted) {
        perm = radix::sort(keys, lo, digits, num_keys, n, sc.nv, sc.perm, sc.perm_tmp, sc.ua,
                           sc.ub, sc.hist, s).perm;
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
