// sharded_downsample / multisegment_downsample: the cell keys of one mesh
// slot's rows, the first step of the slot's partial grids.
//
// Replaces the per-device body of the JAX package's parallel/scan.py
// step, `_local_grids` (catalog names sharded_downsample, :137-197, and
// multisegment_downsample, :233-286, which runs the same body once per
// segment shard with that segment's t0). For a slot that owns the series
// slice [lo, lo + local_series) of the output grid, each row gets
//   local = sid - lo (int32, wrapping as the JAX int32 arithmetic does),
//   bucket = floor((ts - t0) / bucket_ms) as int32,
//   in_slice = 0 <= local < local_series,
//   ok = valid && mask && in_slice && 0 <= bucket < num_buckets,
//   key = clip(local) * num_buckets + clip(bucket)    (in range always),
//   safe = in_slice ? key : cells      (feeds sum / count: a masked row
//          keeps its in-range key, so sorted runs stay whole, and rides the
//          weight; a row of another slice goes to the sentinel, where in
//          (sid, ts) order it forms one prefix or suffix run),
//   flat = ok ? key : cells            (feeds min / max: drop semantics),
//   value = ok ? value : 0.0, weight = ok ? 1.0 : 0.0,
// as `masked_cell_keys` and the sentinel and typed-zero rules of
// scan.py:83-90 build them. `mask` is kernel E's output (predicate.cu, in
// the same library) when the step has a predicate, else null. The wrapper
// then reduces `safe` with kernels B and C (sorted rows) or grouped_stats
// (unsorted), and folds the row shards' grids with grid_fold.
//
// Bound on an H100: memory. Per row it reads ts (8 B), sid (4 B), the
// value (8 B), the validity byte and the mask byte, and writes two int32
// keys, the masked value, the weight and the ok byte (25 B); the work is
// one 64-bit division. Design: one thread per row, every output written
// once, so the step that follows reads each lane it needs as a plain
// contiguous array. CUDA's `/` truncates toward zero, so the bucket is
// floored by hand (a row 1 ms before t0 lands in bucket -1 and drops).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void keys_kernel(const int64_t* __restrict__ ts, const int32_t* __restrict__ sid,
                            const double* __restrict__ val, const uint8_t* __restrict__ valid,
                            const uint8_t* __restrict__ mask, int64_t t0, int64_t bucket_ms,
                            int32_t lo, int32_t local_series, int32_t num_buckets, int64_t n,
                            int32_t* __restrict__ safe, int32_t* __restrict__ flat,
                            double* __restrict__ vm, double* __restrict__ w,
                            uint8_t* __restrict__ ok_out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int32_t local = (int32_t)((uint32_t)sid[i] - (uint32_t)lo);
    const int64_t d = (int64_t)((uint64_t)ts[i] - (uint64_t)t0);
    int64_t q = d / bucket_ms;
    if (d % bucket_ms != 0 && d < 0) --q;  // floor; bucket_ms > 0
    const int32_t bucket = (int32_t)(uint32_t)(uint64_t)q;
    const bool in_slice = local >= 0 && local < local_series;
    const bool ok = valid[i] != 0 && (mask == nullptr || mask[i] != 0) && in_slice &&
                    bucket >= 0 && bucket < num_buckets;
    const int32_t cl = local < 0 ? 0 : (local >= local_series ? local_series - 1 : local);
    const int32_t cb = bucket < 0 ? 0 : (bucket >= num_buckets ? num_buckets - 1 : bucket);
    const int32_t key = cl * num_buckets + cb;
    const int32_t cells = local_series * num_buckets;
    safe[i] = in_slice ? key : cells;
    flat[i] = ok ? key : cells;
    vm[i] = ok ? val[i] : 0.0;
    w[i] = ok ? 1.0 : 0.0;
    ok_out[i] = ok ? 1 : 0;
}

}  // namespace

// ts: int64[n]; sid: int32[n]; val: f64[n]; valid: uint8[n]; mask:
// uint8[n] or null; outputs safe, flat: int32[n], vm, w: f64[n], ok:
// uint8[n]. bucket_ms > 0, local_series, num_buckets > 0 and
// local_series * num_buckets < 2^31.
extern "C" int sharded_keys_launch(const void* ts, const void* sid, const void* val,
                                   const void* valid, const void* mask, int64_t t0,
                                   int64_t bucket_ms, int32_t lo, int32_t local_series,
                                   int32_t num_buckets, int64_t n, void* safe, void* flat,
                                   void* vm, void* w, void* ok, void* stream) {
    if (bucket_ms <= 0 || local_series <= 0 || num_buckets <= 0 ||
        (int64_t)local_series * num_buckets >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n > 0) {
        const unsigned blocks = (unsigned)((n + 255) / 256);
        keys_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(ts), static_cast<const int32_t*>(sid),
            static_cast<const double*>(val), static_cast<const uint8_t*>(valid),
            static_cast<const uint8_t*>(mask), t0, bucket_ms, lo, local_series, num_buckets, n,
            static_cast<int32_t*>(safe), static_cast<int32_t*>(flat), static_cast<double*>(vm),
            static_cast<double*>(w), static_cast<uint8_t*>(ok));
    }
    return (int)cudaGetLastError();
}
