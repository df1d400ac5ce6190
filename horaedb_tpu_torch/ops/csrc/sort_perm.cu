// sort_perm: the stable lexicographic permutation of rows over k integer
// keys, as the chain of look-back sorts of keychain.cuh.
//
// Replaces the JAX package's ops/sort.py::_sort_perm (catalog name
// sort_perm): one variadic stable lax.sort with an iota payload, used by
// the write path's primary-key sort (storage/storage.py::_sort_batch).
//
// Bound on an H100: memory (each key read once, the int32 permutation
// written once); at the write batch's size (302,400 rows, 74 tiles) the
// launches and the look-back's latency set the time, not the bytes. The
// design cuts the passes: the host offsets each key by its batch minimum
// and packs adjacent keys into one u64 key where their spans fit 64 bits
// together (ops/keychain.py::pack_lanes), so a constant key (metric_id,
// field_id) costs nothing and the batch's tsid (64 bits) and ts (23 bits)
// take two keys, 8 + 3 digit sweeps. Starting from the identity, the chain
// breaks ties by row, as the iota payload does.
#include "keychain.cuh"

namespace {

__global__ void iota_kernel(int32_t* __restrict__ perm, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) perm[i] = (int32_t)i;
}

}  // namespace

// n rows whose packed keys take at most `digits` digits (1-8)
extern "C" int64_t sort_perm_scratch_bytes(int64_t n, int32_t digits) {
    int64_t bytes = 0;
    keychain::carve(nullptr, n, digits < 1 ? 1 : digits, &bytes);
    return bytes;
}

// keys: num_keys pointers to int64[n], most significant first, lo[i] key
// i's batch minimum; lane_of, shift_of, group_start, group_digits,
// num_groups: the packed keys (keychain::Layout; no key: the identity).
// perm: int32[n] out. scratch: sort_perm_scratch_bytes(n, the most
// group_digits) bytes. Fewer than two rows, or no key, launch no sweep.
extern "C" int sort_perm_launch(const void* const* keys, const int64_t* lo, int32_t num_keys,
                                const int32_t* lane_of, const int32_t* shift_of,
                                const int32_t* group_start, const int32_t* group_digits,
                                int32_t num_groups, int64_t n, void* perm, void* scratch,
                                void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const keychain::Layout layout{keys,     lo,          num_keys,     lane_of,
                                  shift_of, group_start, group_digits, num_groups};
    const int max_digits = keychain::max_digits(layout);
    if (max_digits == 0 || n < 0 || n >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    int32_t* p_out = static_cast<int32_t*>(perm);
    iota_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p_out, n);
    if (n < 2 || num_groups == 0) return (int)cudaGetLastError();
    const keychain::Scratch sc = keychain::carve(scratch, n, max_digits, nullptr);
    const int32_t* sorted =
        keychain::sort(layout, p_out, onesweep::Rows<uint64_t>{n, nullptr, false, 0}, sc, s);
    cudaMemcpyAsync(p_out, sorted, (size_t)n * sizeof(int32_t), cudaMemcpyDeviceToDevice, s);
    return (int)cudaGetLastError();
}

// The u64-key instantiation's sweep (onesweep::sweep_occupancy): blocks an
// SM, registers a thread, static and dynamic shared bytes.
extern "C" int sort_perm_sweep_occupancy(int32_t* out) {
    return onesweep::sweep_occupancy<uint64_t, int32_t>(out);
}
