// packed_merge: merge and last-value dedup of rows whose whole sort key
// (pk offsets + seq rank) is packed into one u64 per row.
//
// Replaces the JAX package's storage/read.py::_build_packed_index_kernel
// (catalog name packed_merge): a stable lax.sort of (packed, iota) with
// rejected rows pre-sunk to the all-ones sentinel, keep-last per group
// (packed >> seq_width), and the compacted survivor indices plus count.
//
// Keys arrive mapped to int64 (bit 63 flipped, backend.u64_to_i64), so the
// sentinel reads as INT64_MAX and a valid key k (< 2^63) as k - 2^63.
//
// Bound on an H100: memory. The work is a sort of n 8-byte keys; the least
// traffic reads each key once and writes 4 bytes per survivor. Design:
//   1. stable partition of the valid rows (key != sentinel) to the front
//      (compact.cuh), so the sentinel never costs a digit pass: sorted, the
//      all-ones key would force 8 passes;
//   2. kernel A's LSD radix passes (radix.cuh) over the valid rows only,
//      with digits from the packed width (key_bits <= 63, usually far
//      fewer: 10K series x 2 h of 1 s offsets x a few seqs is ~5 digits);
//   3. keep-last flags from the sorted keys themselves (no gather: the
//      radix passes carry the key), and one more compaction that writes
//      the original row index of every survivor.
// The valid-row count lives on the device between the steps, so the call
// never synchronises.
#include "compact.cuh"

namespace {

struct NotSentinel {
    const int64_t* key;
    __device__ bool flag(int64_t i) const { return key[i] != INT64_MAX; }
    __device__ int32_t value(int64_t i) const { return (int32_t)i; }
};

// sorted position i ends its group: the last valid row, or the next row's
// group (u >> seq_width) differs
struct KeepLastPacked {
    const uint64_t* u;
    const int32_t* perm;
    const int32_t* nv;
    int seq_width;
    __device__ bool flag(int64_t i) const {
        return i == (int64_t)*nv - 1 || (u[i] >> seq_width) != (u[i + 1] >> seq_width);
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

extern "C" int64_t packed_merge_scratch_bytes(int64_t n) {
    using compact::Arena;
    const int64_t m = n > 0 ? n : 1;
    return 2 * Arena::size_of(4 * m) + 2 * Arena::size_of(8 * m) +
           Arena::size_of(radix::hist_bytes(n)) + Arena::size_of(compact::scratch_bytes(n)) +
           Arena::size_of(4);
}

// key: int64[n] mapped packed keys (INT64_MAX = rejected); key_bits: bit
// width of the valid packed keys (<= 63); out_idx: int32[n], of which the
// first *count hold the survivors' row indices in key order; count:
// int32[1]; scratch: packed_merge_scratch_bytes(n) bytes.
extern "C" int packed_merge_launch(const void* key, int64_t n, int32_t key_bits,
                                   int32_t seq_width, int32_t do_dedup, void* out_idx,
                                   void* count, void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (key_bits < 1 || key_bits > 63 || seq_width < 0 || seq_width > 63) {
        return (int)cudaErrorInvalidValue;
    }
    const int64_t* k = static_cast<const int64_t*>(key);
    int32_t* out = static_cast<int32_t*>(out_idx);
    int32_t* cnt = static_cast<int32_t*>(count);
    Scratch sc = carve(scratch, n);
    compact::run(NotSentinel{k}, n, nullptr, sc.tiles, sc.perm, sc.nv, s);
    const void* keys[1] = {key};
    const int64_t lo[1] = {INT64_MIN};  // mapped - INT64_MIN = the raw packed key
    const int32_t digits[1] = {(key_bits + 7) / 8};
    const radix::Sorted r = radix::sort(keys, lo, digits, 1, n, sc.nv, sc.perm, sc.perm_tmp,
                                        sc.ua, sc.ub, sc.hist, s);
    if (do_dedup) {
        compact::run(KeepLastPacked{r.u, r.perm, sc.nv, seq_width}, n, sc.nv, sc.tiles, out,
                     cnt, s);
    } else {
        compact::run(compact::AllFlag{r.perm}, n, sc.nv, sc.tiles, out, cnt, s);
    }
    return (int)cudaGetLastError();
}
