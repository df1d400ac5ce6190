// lane_sum_count: per-cell f32 (sum, count) over UNSORTED cell ids, the
// aggregation dispatcher's `lanes` lane.
//
// Replaces the JAX package's ops/aggregate.py::lane_segment_sum_count
// (catalog name lane_sum_count). Its function, kept here: every row adds
// its f32 value and its f32 weight (1 when there are none) into its cell,
// with the ids clipped to [0, num_cells] and slot num_cells dropped (a
// negative id lands in cell 0, an id >= num_cells is dropped); the n % 8
// tail rows are added like the others. The JAX function spreads an XLA
// scatter over eight lane grids, summed in lane order, then the tail rows;
// that order is its layout on the TPU, not part of the result this kernel
// promises.
//
// Order and tolerance: the kernel adds with f32 atomics, so a cell's sum
// depends on the order its rows arrive in and makes no bitwise promise,
// not even from one run to the next. Against the JAX function's order (the
// plain version, `lane_sum_count_plain`) each cell's sum stays within
// 2^-20 x the cell's L1 mass (sum of |v|). Counts of 0/1 weights are exact
// up to 2^24 rows a cell.
//
// Bound on an H100: memory. Per row it reads the id (4 B), the value (4 B)
// and the weight (4 B); per cell it writes sum and count (8 B).
// Design: no lane scratch. The launch zeroes the two output grids (8 B a
// cell, one cudaMemsetAsync over the [2, num_cells] output) and rows add
// straight into them. Each warp takes 32 neighbouring rows and groups them
// by cell (__match_any_sync); each group sums its values and weights in
// registers, a tree over the group's lanes in lane order, and the group's
// lowest lane issues the two atomicAdds. Sorted ids, where about 16
// neighbouring rows share a cell, then cost about two atomics a warp
// instead of 32 that would serialise on one address; unsorted ids form
// groups of one and take the same path. Dropped rows and the lanes past n
// join a group of their own that adds nothing. Blocks of 256 threads, at
// most 8 an SM (a grid-stride loop past that).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // an H100's SMs x resident blocks of 256
constexpr unsigned FULL = 0xffffffffu;

// Sums x and y over the lanes of `peers` (the lanes of this warp whose row
// has this lane's cell, this lane among them) into the lowest of them: in
// round r each remaining lane adds the partial of its next remaining peer,
// and the lanes at odd positions among the remaining drop out. Every lane
// of the warp runs every round (the shuffles need them all).
__device__ inline void reduce_peers(unsigned peers, float& x, float& y) {
    const unsigned lane = threadIdx.x & 31;
    unsigned rank = __popc(peers & ((1u << lane) - 1));  // peers below this lane
    unsigned above = peers & ~((2u << lane) - 1);          // peers above it
    while (__any_sync(FULL, above != 0)) {
        const int next = __ffs(above);  // 1-based; 0: none
        const float tx = __shfl_sync(FULL, x, next ? next - 1 : lane);
        const float ty = __shfl_sync(FULL, y, next ? next - 1 : lane);
        if (next) {
            x += tx;
            y += ty;
        }
        above &= ~__ballot_sync(FULL, rank & 1);
        rank >>= 1;
    }
}

__global__ void __launch_bounds__(THREADS)
lane_sum_count_kernel(const int32_t* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ w, int64_t n, int32_t num_cells,
                      float* __restrict__ out_sum, float* __restrict__ out_count) {
    const unsigned lane = threadIdx.x & 31;
    const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
    for (int64_t base = warp * 32; base < n; base += warps * 32) {
        const int64_t i = base + lane;
        int32_t cell = -1;  // dropped rows and lanes past n
        float x = 0.0f, y = 0.0f;
        if (i < n) {
            const int32_t id = k[i];
            if (id < num_cells) {  // slot num_cells and beyond are dropped
                cell = id < 0 ? 0 : id;  // a negative id lands in cell 0
                x = v[i];
                y = w == nullptr ? 1.0f : w[i];
            }
        }
        const unsigned peers = __match_any_sync(FULL, cell);
        reduce_peers(peers, x, y);
        if (cell >= 0 && (peers & ((1u << lane) - 1)) == 0) {
            atomicAdd(out_sum + cell, x);
            atomicAdd(out_count + cell, y);
        }
    }
}

}  // namespace

// k: int32[n]; v: f32[n]; w: f32[n] or null (weight 1); out: f32
// [2, num_cells] (sum, then count), zeroed here. 0 <= num_cells < 2^31.
extern "C" int lane_sum_count_launch(const void* k, const void* v, const void* w, int64_t n,
                                     int64_t num_cells, void* out, void* stream) {
    if (n < 0 || num_cells < 0 || num_cells >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (num_cells == 0) return (int)cudaGetLastError();
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* out_sum = static_cast<float*>(out);
    cudaError_t rc = cudaMemsetAsync(out, 0, 2 * num_cells * (int64_t)sizeof(float), s);
    if (rc != cudaSuccess) return (int)rc;
    if (n > 0) {
        int64_t blocks = (n + THREADS - 1) / THREADS;
        if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
        lane_sum_count_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
            static_cast<const int32_t*>(k), static_cast<const float*>(v),
            static_cast<const float*>(w), n, (int32_t)num_cells, out_sum, out_sum + num_cells);
    }
    return (int)cudaGetLastError();
}
