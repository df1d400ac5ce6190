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
// traffic reads each key once and writes 4 bytes per survivor. Design
// (packedsort.cuh, shared with sample_sort_merge.cu):
//   1. stable partition of the valid rows (key != sentinel) to the front
//      (compact.cuh), the valid count on the device;
//   2. onesweep.cuh's look-back sort of the valid rows' raw keys, the row
//      as its int32 payload: one key pass through the partition, then one
//      sweep per 8-bit digit of key_bits (<= 63, usually far fewer: 10K
//      series x 2 h of 1 s offsets x a few seqs is ~5 digits), or none when
//      the valid keys already ascend (the presorted shortcut);
//   3. keep-last flags from the sorted keys themselves (no gather: the
//      sweeps carry the key), and one compaction that writes the original
//      row index of every survivor.
// The valid-row count lives on the device between the steps, so the call
// never synchronises.
#include "packedsort.cuh"

// Bytes of scratch for n rows of keys up to key_bits wide.
extern "C" int64_t packed_merge_scratch_bytes(int64_t n, int32_t key_bits) {
    return packedsort::scratch_size(n, key_bits, 1);
}

// key: int64[n] mapped packed keys (INT64_MAX = rejected); key_bits: bit
// width of the valid packed keys (<= 63); out_idx: int32[n], of which the
// first *count hold the survivors' row indices in key order; count:
// int32[1]; scratch: packed_merge_scratch_bytes(n, key_bits) bytes.
extern "C" int packed_merge_launch(const void* key, int64_t n, int32_t key_bits,
                                   int32_t seq_width, int32_t do_dedup, void* out_idx,
                                   void* count, void* scratch, void* stream) {
    if (!packedsort::valid_widths(key_bits, seq_width)) return (int)cudaErrorInvalidValue;
    const packedsort::Scratch sc = packedsort::carve(scratch, n, key_bits, 1);
    packedsort::merge(key, nullptr, n, key_bits, seq_width, do_dedup != 0,
                      static_cast<int32_t*>(out_idx), static_cast<int32_t*>(count), sc,
                      static_cast<cudaStream_t>(stream));
    return (int)cudaGetLastError();
}
