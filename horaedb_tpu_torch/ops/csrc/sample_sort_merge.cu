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
//     1. stable partition of the valid rows (key != sentinel) to the front
//        (compact.cuh), the valid count on the device: a sentinel row
//        never leaves its slot, since the merge drops it anyway, and never
//        costs a digit pass (sorted, the all-ones key would force 8);
//     2. onesweep.cuh's u64-key, int32-payload sort of the valid rows:
//        its key pass gathers each valid row's raw key through the
//        partition, the digits come from key_bits (a 42-bit key takes 6
//        look-back sweeps), the row carried as the payload; every pass
//        reads the valid count on the device and skips the tiles past it.
//        The shard's rows are in global row order, so a stable sort by key
//        alone leaves equal keys in row-id order: the two-key order
//        (key, row id);
//     3. start of each bucket by binary search over the sorted groups (a
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
//   and one stable sort by key gives (key, row id). Partition the valid
//   rows, sort them as above, and compact the last row of each group
//   (next of the last valid row = the sentinel group) writing its row id.
//
// Bound on an H100: memory. Each step reads each key once (8 B/row) and
// the merge writes 4 B per survivor; the sweeps move 12 B a valid row each
// way per digit. No host synchronisation inside a step: the valid-row
// count stays on the device.
#include "compact.cuh"
#include "onesweep.cuh"

namespace {

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

// sorted position i ends its group: the last valid row, or the next row's
// group differs; writes the row id carried beside the key
struct KeepLastRowId {
    const uint64_t* u;
    const int32_t* perm;
    const int32_t* row_id;
    const int32_t* nv;
    int seq_width;
    __device__ bool flag(int64_t i) const {
        return i == (int64_t)*nv - 1 || (u[i] >> seq_width) != (u[i + 1] >> seq_width);
    }
    __device__ int32_t value(int64_t i) const { return row_id[perm[i]]; }
};

struct AllRowIds {
    const int32_t* perm;
    const int32_t* row_id;
    __device__ bool flag(int64_t) const { return true; }
    __device__ int32_t value(int64_t i) const { return row_id[perm[i]]; }
};

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

struct Scratch {
    onesweep::Scratch<uint64_t, int32_t> sort;
    int32_t* tiles;
    int32_t* nv;
    int32_t* start;
};

int digits_of(int32_t key_bits) { return (key_bits + 7) / 8; }

// with p null, only the layout (and its bytes)
Scratch carve(void* p, int64_t n, int32_t key_bits, int64_t d_slots, int64_t* bytes = nullptr) {
    onesweep::Carver c{reinterpret_cast<uintptr_t>(p)};
    Scratch s;
    s.sort = onesweep::carve<uint64_t, int32_t>(p, n, digits_of(key_bits), 3, &c.used);
    s.tiles = c.take<int32_t>(compact::scratch_bytes(n) / 4);
    s.nv = c.take<int32_t>(1);
    s.start = c.take<int32_t>(d_slots + 1);
    if (bytes) *bytes = c.used;
    return s;
}

int64_t scratch_size(int64_t n, int32_t key_bits, int64_t d_slots) {
    int64_t bytes = 0;
    carve(nullptr, n, key_bits < 1 ? 1 : key_bits > 63 ? 63 : key_bits, d_slots, &bytes);
    return bytes;
}

// partition the valid rows of key[0, n) and sort them by raw key
onesweep::Sorted<uint64_t, int32_t> sort_valid(const void* key, int64_t n, int32_t key_bits,
                                               const Scratch& sc, cudaStream_t s) {
    const int64_t* k = static_cast<const int64_t*>(key);
    int32_t* part = sc.sort.v[2];
    compact::run(NotSentinel{k}, n, nullptr, sc.tiles, part, sc.nv, s);
    const onesweep::Rows<uint64_t> rows{n, sc.nv, false, 0};
    return onesweep::sort(RawKey{k, part}, part, rows, digits_of(key_bits), sc.sort, s);
}

}  // namespace

extern "C" int64_t ssm_local_scratch_bytes(int64_t n, int32_t key_bits, int64_t d_slots) {
    return scratch_size(n, key_bits, d_slots);
}

extern "C" int64_t ssm_merge_scratch_bytes(int64_t m, int32_t key_bits) {
    return scratch_size(m, key_bits, 1);
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
    if (key_bits < 1 || key_bits > 63 || seq_width < 0 || seq_width > 63 || d_slots < 1 ||
        d_slots > 1023 || cap < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const Scratch sc = carve(scratch, n, key_bits, d_slots);
    int64_t* sk = static_cast<int64_t*>(send_k);
    int32_t* si = static_cast<int32_t*>(send_i);
    const int64_t m = (int64_t)d_slots * cap;
    if (m > 0) fill_kernel<<<radix::blocks_for(m, 256), 256, 0, s>>>(sk, si, m);
    if (n == 0) return (int)cudaGetLastError();
    const auto r = sort_valid(key, n, key_bits, sc, s);
    const uint64_t* sp = static_cast<const uint64_t*>(splitters);
    starts_kernel<<<1, d_slots + 1, 0, s>>>(r.keys, sc.nv, seq_width, sp, d_slots, sc.start);
    scatter_kernel<<<radix::blocks_for(n, 256), 256, 0, s>>>(
        r.keys, r.vals, sc.nv, seq_width, sp, d_slots, sc.start, cap, row_base, n, sk, si);
    return (int)cudaGetLastError();
}

// recv_k: int64[m] received mapped keys, recv_i: int32[m] their row ids;
// out: int32[m], of which the first *count hold the survivors' row ids in
// key order; count: int32[1]; scratch: ssm_merge_scratch_bytes(m, key_bits) bytes.
extern "C" int ssm_merge_launch(const void* recv_k, const void* recv_i, int64_t m,
                                int32_t key_bits, int32_t seq_width, int32_t do_dedup, void* out,
                                void* count, void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (key_bits < 1 || key_bits > 63 || seq_width < 0 || seq_width > 63) {
        return (int)cudaErrorInvalidValue;
    }
    const Scratch sc = carve(scratch, m, key_bits, 1);
    int32_t* o = static_cast<int32_t*>(out);
    int32_t* cnt = static_cast<int32_t*>(count);
    const int32_t* ids = static_cast<const int32_t*>(recv_i);
    const auto r = sort_valid(recv_k, m, key_bits, sc, s);
    if (do_dedup) {
        compact::run(KeepLastRowId{r.keys, r.vals, ids, sc.nv, seq_width}, m, sc.nv, sc.tiles, o,
                     cnt, s);
    } else {
        compact::run(AllRowIds{r.vals, ids}, m, sc.nv, sc.tiles, o, cnt, s);
    }
    return (int)cudaGetLastError();
}
