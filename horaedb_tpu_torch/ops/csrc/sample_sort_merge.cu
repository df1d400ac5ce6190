// sample_sort_merge: the two per-slot steps of the distributed sample sort
// that merges and dedups packed-key rows across the slots of a mesh.
//
// Replaces the JAX package's parallel/merge.py::_build_sharded_merge
// (catalog name sample_sort_merge, :73-137): each device sorts its shard
// of (packed u64 key, global row id), buckets the sorted rows by D - 1
// group-granular splitters (group = packed >> seq_width, so a dedup group
// never spans two devices), scatters each bucket into its lane of a
// [D, cap] send block (sentinel fill), exchanges the lanes with
// all_to_all, sorts the received block on (key, row id) and keeps the last
// row of each group. The output row ids equal packed_merge's (kernel D)
// bytewise, ties on the packed key resolved by global row order.
//
// Keys arrive mapped to int64 (bit 63 flipped, backend.u64_to_i64), as
// kernel D takes them: the sentinel (all ones) reads INT64_MAX, and
// mapped ^ 2^63 is the raw key, so the digits, the group shift and the
// splitter compares all run on raw u64 bits, as the JAX package's do. The
// host computes the splitters (raw group ids) and the exact
// per-(slot, bucket) counts, so `cap` never overflows.
//
//   ssm_local_launch (per slot, before the exchange):
//     1. packedsort::sort_valid (packedsort.cuh, shared with kernel D):
//        the valid rows (key != sentinel) partitioned to the front, their
//        count on the device, then sorted by raw key on onesweep.cuh with
//        the row as payload. A sentinel row never leaves its slot, since
//        the merge drops it anyway. The shard's rows are in global row
//        order, so a stable sort by key alone leaves equal keys in row-id
//        order: the two-key order (key, row id);
//     2. start of each bucket by binary search over the sorted groups (a
//        bucket's rows are one contiguous range of them), then every row
//        finds its bucket by binary search over the splitters (numpy's
//        searchsorted side="right") and is written to
//        send[bucket * cap + (i - start[bucket])], with its global row id
//        beside it; the lanes are filled with the sentinel first.
//   The exchange is the wrapper's: slot e gathers lane e of every slot in
//   slot order (peer copies between cards, device copies on one).
//   ssm_merge_launch (per slot, after it): the received block holds D
//   sorted runs, run d from slot d, whose row ids all lie below run
//   d + 1's; so in received order equal keys are already in row-id order,
//   and one stable sort by key gives (key, row id): packedsort::merge
//   sorts the valid rows as above and compacts the last row of each group
//   (next of the last valid row = the sentinel group), writing its row id.
//
// Bound on an H100: memory. Each step reads each key once (8 B/row) and
// the merge writes 4 B per survivor; the sweeps move 12 B a valid row each
// way per digit. No host synchronisation inside a step: the valid-row
// count stays on the device.
#include "packedsort.cuh"

namespace {

// count of splitters <= g (numpy searchsorted side="right")
__device__ inline int bucket_of(uint64_t g, const uint64_t* __restrict__ sp, int nsp) {
    int lo = 0, hi = nsp;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sp[mid] <= g) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// start[b] = first sorted valid row whose group >= sp[b - 1] (b = 1..D-1);
// start[0] = 0, start[D] = the valid-row count
__global__ void starts_kernel(const uint64_t* __restrict__ u, const int32_t* __restrict__ nv,
                              int seq_width, const uint64_t* __restrict__ sp, int d_slots,
                              int32_t* __restrict__ start) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b > d_slots) return;
    const int64_t n = *nv;
    if (b == 0) { start[0] = 0; return; }
    if (b == d_slots) { start[d_slots] = (int32_t)n; return; }
    const uint64_t want = sp[b - 1];
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if ((u[mid] >> seq_width) < want) lo = mid + 1; else hi = mid;
    }
    start[b] = (int32_t)lo;
}

__global__ void fill_kernel(int64_t* __restrict__ send_k, int32_t* __restrict__ send_i,
                            int64_t m) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    send_k[i] = INT64_MAX;
    send_i[i] = 0;
}

__global__ void scatter_kernel(const uint64_t* __restrict__ u, const int32_t* __restrict__ perm,
                               const int32_t* __restrict__ nv, int seq_width,
                               const uint64_t* __restrict__ sp, int d_slots,
                               const int32_t* __restrict__ start, int64_t cap, int32_t row_base,
                               int64_t n, int64_t* __restrict__ send_k,
                               int32_t* __restrict__ send_i) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || i >= (int64_t)*nv) return;
    const uint64_t raw = u[i];
    const int b = bucket_of(raw >> seq_width, sp, d_slots - 1);
    const int64_t at = (int64_t)b * cap + (i - start[b]);
    send_k[at] = (int64_t)(raw ^ 0x8000000000000000ULL);  // back to the mapped form
    send_i[at] = row_base + perm[i];
}

}  // namespace

extern "C" int64_t ssm_local_scratch_bytes(int64_t n, int32_t key_bits, int64_t d_slots) {
    return packedsort::scratch_size(n, key_bits, d_slots + 1);
}

extern "C" int64_t ssm_merge_scratch_bytes(int64_t m, int32_t key_bits) {
    return packedsort::scratch_size(m, key_bits, 1);
}

// key: int64[n] mapped packed keys of this slot's shard (INT64_MAX =
// rejected or padding), in global row order from row id row_base;
// splitters: d_slots - 1 raw u64 group ids, ascending, on the device;
// send_k: int64[d_slots * cap], send_i: int32[d_slots * cap] out;
// scratch: ssm_local_scratch_bytes(n, key_bits, d_slots) bytes.
extern "C" int ssm_local_launch(const void* key, int64_t n, int32_t key_bits, int32_t seq_width,
                                const void* splitters, int32_t d_slots, int64_t cap,
                                int32_t row_base, void* send_k, void* send_i, void* scratch,
                                void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!packedsort::valid_widths(key_bits, seq_width) || d_slots < 1 || d_slots > 1023 ||
        cap < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const packedsort::Scratch sc = packedsort::carve(scratch, n, key_bits, d_slots + 1);
    int64_t* sk = static_cast<int64_t*>(send_k);
    int32_t* si = static_cast<int32_t*>(send_i);
    const int64_t m = (int64_t)d_slots * cap;
    if (m > 0) fill_kernel<<<compact::blocks_for(m, 256), 256, 0, s>>>(sk, si, m);
    if (n == 0) return (int)cudaGetLastError();
    const auto r = packedsort::sort_valid(key, n, key_bits, sc, s);
    const uint64_t* sp = static_cast<const uint64_t*>(splitters);
    starts_kernel<<<1, d_slots + 1, 0, s>>>(r.keys, sc.nv, seq_width, sp, d_slots, sc.start);
    scatter_kernel<<<compact::blocks_for(n, 256), 256, 0, s>>>(
        r.keys, r.vals, sc.nv, seq_width, sp, d_slots, sc.start, cap, row_base, n, sk, si);
    return (int)cudaGetLastError();
}

// recv_k: int64[m] received mapped keys, recv_i: int32[m] their row ids;
// out: int32[m], of which the first *count hold the survivors' row ids in
// key order; count: int32[1]; scratch: ssm_merge_scratch_bytes(m, key_bits) bytes.
extern "C" int ssm_merge_launch(const void* recv_k, const void* recv_i, int64_t m,
                                int32_t key_bits, int32_t seq_width, int32_t do_dedup, void* out,
                                void* count, void* scratch, void* stream) {
    if (!packedsort::valid_widths(key_bits, seq_width)) return (int)cudaErrorInvalidValue;
    const packedsort::Scratch sc = packedsort::carve(scratch, m, key_bits, 1);
    packedsort::merge(recv_k, static_cast<const int32_t*>(recv_i), m, key_bits, seq_width,
                      do_dedup != 0, static_cast<int32_t*>(out), static_cast<int32_t*>(count),
                      sc, static_cast<cudaStream_t>(stream));
    return (int)cudaGetLastError();
}
