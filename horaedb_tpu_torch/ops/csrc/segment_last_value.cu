// segment_last_value: per segment, the value of the valid row with the
// largest seq (dedup as a reduction).
//
// Replaces the JAX package's ops/aggregate.py::segment_last_value (catalog
// name segment_last_value). Its function, kept here: a row takes part when
// it is valid and its index lies in [0, num_segments); a segment's winner is
// the row of largest int64 seq among them, ties going to the latest
// position; the output is the winner's value (its bits unchanged), NaN for a
// segment with no such row. The wrapper casts a u64 seq to int64 as the JAX
// function does (`astype(int64)`: 2^63 and above wrap negative).
//
// Bound on an H100: memory. Per row it reads the value (8 B), the seq
// (8 B), the index (4 B) and the mask (1 B); per segment it writes the
// value (8 B).
// Design: three passes, all exact in any order. Pass 1 takes each
// segment's max seq with a 64-bit atomicMax; pass 2 the max position among
// the rows whose seq equals it, again with atomicMax; pass 3 gathers the
// winner's value. Max is associative and commutative on integers, so the
// atomics give the same bits from run to run. Scratch holds the per-segment
// max seq and position (16 B a segment).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void slv_init_kernel(int64_t num_segments, long long* __restrict__ max_seq,
                                long long* __restrict__ best) {
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= num_segments) return;
    max_seq[s] = INT64_MIN;
    best[s] = -1;
}

__device__ inline bool takes_part(const int32_t* index, const uint8_t* valid, int64_t i,
                                  int64_t num_segments) {
    const int64_t seg = index[i];
    return valid[i] != 0 && seg >= 0 && seg < num_segments;
}

__global__ void slv_max_seq_kernel(const int64_t* __restrict__ seq,
                                   const int32_t* __restrict__ index,
                                   const uint8_t* __restrict__ valid, int64_t n,
                                   int64_t num_segments, long long* __restrict__ max_seq) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !takes_part(index, valid, i, num_segments)) return;
    atomicMax(max_seq + index[i], (long long)seq[i]);
}

__global__ void slv_max_pos_kernel(const int64_t* __restrict__ seq,
                                   const int32_t* __restrict__ index,
                                   const uint8_t* __restrict__ valid, int64_t n,
                                   int64_t num_segments, const long long* __restrict__ max_seq,
                                   long long* __restrict__ best) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !takes_part(index, valid, i, num_segments)) return;
    const int32_t seg = index[i];
    if ((long long)seq[i] == max_seq[seg]) atomicMax(best + seg, (long long)i);
}

__global__ void slv_gather_kernel(const double* __restrict__ values,
                                  const long long* __restrict__ best, int64_t num_segments,
                                  double* __restrict__ out) {
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= num_segments) return;
    const long long b = best[s];
    out[s] = b >= 0 ? values[b] : __longlong_as_double(0x7ff8000000000000LL);  // quiet NaN
}

}  // namespace

// Bytes of scratch a launch over num_segments segments needs.
extern "C" int64_t segment_last_value_scratch_bytes(int64_t num_segments) {
    return 2 * num_segments * (int64_t)sizeof(long long);
}

// values: f64[n]; seq: int64[n]; index: int32[n]; valid: uint8[n];
// scratch: segment_last_value_scratch_bytes(num_segments) bytes; out:
// f64[num_segments].
extern "C" int segment_last_value_launch(const void* values, const void* seq, const void* index,
                                         const void* valid, int64_t n, int64_t num_segments,
                                         void* scratch, void* out, void* stream) {
    if (num_segments <= 0) return (int)cudaGetLastError();
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    long long* max_seq = static_cast<long long*>(scratch);
    long long* best = max_seq + num_segments;
    const unsigned seg_blocks = (unsigned)((num_segments + THREADS - 1) / THREADS);
    slv_init_kernel<<<seg_blocks, THREADS, 0, s>>>(num_segments, max_seq, best);
    if (n > 0) {
        const unsigned row_blocks = (unsigned)((n + THREADS - 1) / THREADS);
        const int64_t* sq = static_cast<const int64_t*>(seq);
        const int32_t* ix = static_cast<const int32_t*>(index);
        const uint8_t* ok = static_cast<const uint8_t*>(valid);
        slv_max_seq_kernel<<<row_blocks, THREADS, 0, s>>>(sq, ix, ok, n, num_segments, max_seq);
        slv_max_pos_kernel<<<row_blocks, THREADS, 0, s>>>(sq, ix, ok, n, num_segments, max_seq,
                                                          best);
    }
    slv_gather_kernel<<<seg_blocks, THREADS, 0, s>>>(static_cast<const double*>(values), best,
                                                     num_segments, static_cast<double*>(out));
    return (int)cudaGetLastError();
}
