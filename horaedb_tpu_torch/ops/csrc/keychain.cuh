// A stable lexicographic sort over mapped int64 lanes, as a chain of
// onesweep.cuh sorts of packed u64 keys carrying the int32 row permutation:
// the sort of index_merge.cu (rows 19, 20), scan.cu (row 21) and
// sort_perm.cu (row 4).
//
// The host packs adjacent lanes into one u64 key where their spans fit 64
// bits together (ops/keychain.py::pack_lanes: lane - lo, shifted; lanes
// constant over the rows are in no key). From the least significant key to
// the most, each key gets one onesweep::sort: its key pass gathers the
// key's lanes through the current permutation, for the rows in play only,
// then its digit sweeps carry the permutation. Every sort is stable, so the
// chain orders the rows lexicographically by the lanes, ties kept in the
// order of the permutation it started from (the identity, or a stable
// partition's kept rows in input order): ties broken by input row.
//
// Bound on an H100: memory. Each key costs its key pass (the key's lanes
// read through the permutation, the key written once) and one sweep per
// digit (12 B a row read and written); a key whose rows arrive in order
// costs one partition instead of its sweeps (onesweep.cuh).
#pragma once

#include "onesweep.cuh"

namespace keychain {

constexpr int MAX_KEYS = 16;  // lanes a packed key may hold

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

// The packed keys, as ops/keychain.py::layout flattens pack_lanes: lanes
// are num_lanes pointers to int64[n], most significant first, lo[i] lane
// i's minimum; key g (most significant first) packs the lanes lane_of[j]
// for j in [group_start[g], group_start[g + 1]), each shifted by
// shift_of[j], into group_digits[g] 8-bit digits (1-8). Host pointers.
struct Layout {
    const void* const* lanes;
    const int64_t* lo;
    int32_t num_lanes;
    const int32_t* lane_of;
    const int32_t* shift_of;
    const int32_t* group_start;
    const int32_t* group_digits;
    int32_t num_groups;
};

// The most digits of any key (1 when there is no key), or 0 when the
// layout is malformed.
inline int max_digits(const Layout& l) {
    if (l.num_lanes < 0 || l.num_groups < 0 || l.num_groups > l.num_lanes) return 0;
    int most = 1;
    for (int g = 0; g < l.num_groups; ++g) {
        const int a = l.group_start[g], b = l.group_start[g + 1];
        const int d = l.group_digits[g];
        if (a < 0 || b <= a || b - a > MAX_KEYS || d < 1 || d > 8) return 0;
        for (int j = a; j < b; ++j) {
            if (l.lane_of[j] < 0 || l.lane_of[j] >= l.num_lanes || l.shift_of[j] < 0 ||
                l.shift_of[j] >= 8 * d) {
                return 0;
            }
        }
        most = d > most ? d : most;
    }
    return most;
}

using Scratch = onesweep::Scratch<uint64_t, int32_t>;

// The chain's scratch for n rows and keys of at most `digits` digits, with
// three payload buffers; with p null, only the layout (and its bytes).
inline Scratch carve(void* p, int64_t n, int digits, int64_t* bytes) {
    return onesweep::carve<uint64_t, int32_t>(p, n, digits, 3, bytes);
}

// The rows in play of perm, stably sorted by the layout's keys; returns the
// buffer that holds the result: one of the scratch's payload buffers, never
// perm's own (perm itself when there is no key). perm may be a scratch
// payload buffer. All launches on `s`, nothing synchronised.
inline const int32_t* sort(const Layout& l, const int32_t* perm,
                           const onesweep::Rows<uint64_t>& rows, const Scratch& sc,
                           cudaStream_t s) {
    for (int g = l.num_groups - 1; g >= 0; --g) {
        GroupKey src{};
        src.count = l.group_start[g + 1] - l.group_start[g];
        for (int j = 0; j < src.count; ++j) {
            const int k = l.lane_of[l.group_start[g] + j];
            src.lane[j] = static_cast<const int64_t*>(l.lanes[k]);
            src.lo[j] = (uint64_t)l.lo[k];
            src.shift[j] = l.shift_of[l.group_start[g] + j];
        }
        src.perm = perm;
        perm = onesweep::sort(src, perm, rows, l.group_digits[g], sc, s).vals;
    }
    return perm;
}

}  // namespace keychain
