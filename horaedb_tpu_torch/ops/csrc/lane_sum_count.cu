// lane_sum_count: per-cell f32 (sum, count) over UNSORTED cell ids, the
// lane-parallel scatter of the aggregation dispatcher's `lanes` lane.
//
// Replaces the JAX package's ops/aggregate.py::lane_segment_sum_count
// (catalog name lane_sum_count). Its function, kept here:
//   m = n - n % 8 rows reshape to [8, m / 8] (lane j holds rows
//   j * m / 8 .. (j + 1) * m / 8 - 1); each lane adds its f32 values and
//   f32 weights (1 when there are none) into its own partial grid, with the
//   ids clipped to [0, num_cells] and slot num_cells dropped (a negative id
//   lands in cell 0, an id >= num_cells is dropped); the eight lane grids
//   are summed in lane order, then the n % 8 tail rows are added.
//
// Bound on an H100: memory. Per row it reads the id (4 B), the value (4 B)
// and the weight (4 B); per cell it writes sum and count (8 B).
// Design: the simple form. The wrapper hands in scratch for nine partial
// grids (eight lanes and the tail) of sum and count; the launch zeroes it,
// one thread per row adds its row into its lane's grid with f32 atomics,
// and one thread per cell folds the nine grids in lane order. The atomics
// make a cell's sum depend on the order rows arrive in, within f32
// rounding: the lane makes no bitwise promise (the JAX package's XLA
// scatter on an accelerator is not ordered either). Counts of 0/1 weights
// are exact up to 2^24 rows a cell.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 8;
constexpr int GRIDS = LANES + 1;  // the eight lanes, then the tail rows
constexpr int THREADS = 256;

__global__ void lane_scatter_kernel(const int32_t* __restrict__ k, const float* __restrict__ v,
                                    const float* __restrict__ w, int64_t n, int64_t per_lane,
                                    int64_t m, int64_t num_cells, float* __restrict__ part_sum,
                                    float* __restrict__ part_count) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        int64_t key = k[i];
        if (key < 0) key = 0;            // clip to [0, num_cells]
        if (key >= num_cells) continue;  // slot num_cells is dropped
        const int64_t lane = i < m ? i / per_lane : LANES;
        const int64_t slot = lane * num_cells + key;
        atomicAdd(part_sum + slot, v[i]);
        atomicAdd(part_count + slot, w == nullptr ? 1.0f : w[i]);
    }
}

__global__ void lane_fold_kernel(const float* __restrict__ part_sum,
                                 const float* __restrict__ part_count, int64_t num_cells,
                                 float* __restrict__ out_sum, float* __restrict__ out_count) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= num_cells) return;
    float s = part_sum[c];
    float cnt = part_count[c];
#pragma unroll
    for (int lane = 1; lane < LANES; ++lane) {
        s += part_sum[lane * num_cells + c];
        cnt += part_count[lane * num_cells + c];
    }
    out_sum[c] = s + part_sum[LANES * num_cells + c];
    out_count[c] = cnt + part_count[LANES * num_cells + c];
}

}  // namespace

// Bytes of scratch a launch over num_cells cells needs.
extern "C" int64_t lane_sum_count_scratch_bytes(int64_t num_cells) {
    return 2 * (int64_t)GRIDS * num_cells * (int64_t)sizeof(float);
}

// k: int32[n]; v: f32[n]; w: f32[n] or null (weight 1); scratch:
// lane_sum_count_scratch_bytes(num_cells) bytes; out_sum, out_count:
// f32[num_cells].
extern "C" int lane_sum_count_launch(const void* k, const void* v, const void* w, int64_t n,
                                     int64_t num_cells, void* scratch, void* out_sum,
                                     void* out_count, void* stream) {
    if (num_cells <= 0) return (int)cudaGetLastError();
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* part_sum = static_cast<float*>(scratch);
    float* part_count = part_sum + (int64_t)GRIDS * num_cells;
    cudaError_t rc = cudaMemsetAsync(scratch, 0, lane_sum_count_scratch_bytes(num_cells), s);
    if (rc != cudaSuccess) return (int)rc;
    const int64_t m = n - n % LANES;
    if (n > 0) {
        int64_t blocks = (n + THREADS - 1) / THREADS;
        if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 blocks an SM
        lane_scatter_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
            static_cast<const int32_t*>(k), static_cast<const float*>(v),
            static_cast<const float*>(w), n, m / LANES, m, num_cells, part_sum, part_count);
    }
    const int64_t cell_blocks = (num_cells + THREADS - 1) / THREADS;
    lane_fold_kernel<<<(unsigned)cell_blocks, THREADS, 0, s>>>(
        part_sum, part_count, num_cells, static_cast<float*>(out_sum),
        static_cast<float*>(out_count));
    return (int)cudaGetLastError();
}
