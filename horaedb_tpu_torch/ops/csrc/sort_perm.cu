// sort_perm: the stable lexicographic permutation of rows over k integer
// keys, as an LSD radix sort of (key, row index) pairs (radix.cuh).
//
// Replaces the JAX package's ops/sort.py::_sort_perm (catalog name
// sort_perm): one variadic stable lax.sort with an iota payload, used by
// the write path's primary-key sort (storage/storage.py::_sort_batch).
//
// Bound on an H100: memory. A radix pass reads each (key, index) pair
// twice (histogram, then scatter) and writes it once; the arithmetic is a
// shift and a mask per row. The design cuts the number of passes: keys go
// least significant first, each key is offset by its batch minimum (the
// host computes min/max, as the packed-merge key packing does), and only
// the 8-bit digits below the bit length of (max - min) are sorted, so a
// constant key (metric_id, field_id) costs nothing and a timestamp that
// spans one 2 h segment costs three passes.
#include "radix.cuh"

// Bytes of the hist scratch that sort_perm_launch needs for n rows.
extern "C" int64_t sort_perm_hist_bytes(int64_t n) { return radix::hist_bytes(n); }

// keys: num_keys pointers to int64[n], most significant first; lo[i]: the
// batch minimum of key i; digits[i]: 8-bit passes needed for key i (0 skips
// it). perm: int32[n] out. perm_tmp: int32[n], kbuf and kbuf_tmp: u64[n],
// hist: sort_perm_hist_bytes(n) bytes of scratch.
extern "C" int sort_perm_launch(const void* const* keys, const int64_t* lo,
                                const int32_t* digits, int32_t num_keys, int64_t n,
                                void* perm, void* perm_tmp, void* kbuf,
                                void* kbuf_tmp, void* hist, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n == 0) return (int)cudaGetLastError();
    int32_t* p_out = static_cast<int32_t*>(perm);
    radix::iota_kernel<<<radix::blocks_for(n, 256), 256, 0, s>>>(p_out, n);
    const radix::Sorted r = radix::sort(
        keys, lo, digits, num_keys, n, nullptr, p_out, static_cast<int32_t*>(perm_tmp),
        static_cast<uint64_t*>(kbuf), static_cast<uint64_t*>(kbuf_tmp),
        static_cast<int32_t*>(hist), s);
    if (r.perm != p_out) {
        cudaMemcpyAsync(p_out, r.perm, (size_t)n * sizeof(int32_t), cudaMemcpyDeviceToDevice, s);
    }
    return (int)cudaGetLastError();
}
