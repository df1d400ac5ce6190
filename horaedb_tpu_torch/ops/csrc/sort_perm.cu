// sort_perm: the stable lexicographic permutation of rows over k integer
// keys, as an LSD radix sort of (key, row index) pairs.
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
//
// Keys arrive as int64 whose signed order is the desired order (u64 lanes
// are mapped by flipping bit 63 on the host); (key - min) taken as u64 is
// then an order-preserving unsigned digit source.
//
// Each pass: a per-tile digit histogram, one exclusive scan over the
// (digit, tile) counts in digit-major order, and a stable scatter in which
// every element's rank inside its tile follows input order (warp match for
// ranks inside a warp, per-warp digit counts for the warps before it, a
// running count for the earlier sub-tiles). Stability of every pass makes
// the LSD chain lexicographic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int RADIX = 256;
constexpr int SCAN_THREADS = 1024;
static_assert(RADIX == THREADS, "one thread per digit in hist and scatter");

__device__ inline int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

__global__ void iota_kernel(int32_t* __restrict__ perm, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) perm[i] = (int32_t)i;
}

// u[i] = key[perm[i]] - lo, as u64
__global__ void gather_kernel(const int64_t* __restrict__ key, uint64_t lo,
                              const int32_t* __restrict__ perm,
                              uint64_t* __restrict__ u, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) u[i] = (uint64_t)key[perm[i]] - lo;
}

// hist[d * num_tiles + tile] = count of digit d in the tile
__global__ void __launch_bounds__(THREADS)
hist_kernel(const uint64_t* __restrict__ u, int64_t n, int shift,
            int64_t num_tiles, int32_t* __restrict__ hist) {
    __shared__ int32_t h[RADIX];
    const int t = threadIdx.x;
    h[t] = 0;
    __syncthreads();
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int64_t te = imin(ts + TILE, n);
    for (int64_t i = ts + t; i < te; i += THREADS) {
        atomicAdd(&h[(u[i] >> shift) & (RADIX - 1)], 1);
    }
    __syncthreads();
    hist[(int64_t)t * num_tiles + blockIdx.x] = h[t];
}

// in-place exclusive scan of data[0, m), one block
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int32_t* __restrict__ data, int64_t m) {
    __shared__ int32_t sums[SCAN_THREADS];
    const int t = threadIdx.x;
    const int64_t chunk = (m + SCAN_THREADS - 1) / SCAN_THREADS;
    const int64_t lo = imin((int64_t)t * chunk, m);
    const int64_t hi = imin(lo + chunk, m);
    int32_t s = 0;
    for (int64_t i = lo; i < hi; ++i) s += data[i];
    sums[t] = s;
    __syncthreads();
    for (int d = 1; d < SCAN_THREADS; d <<= 1) {
        const int32_t x = t >= d ? sums[t - d] : 0;
        __syncthreads();
        sums[t] += x;
        __syncthreads();
    }
    int32_t run = sums[t] - s;
    for (int64_t i = lo; i < hi; ++i) {
        const int32_t x = data[i];
        data[i] = run;
        run += x;
    }
}

// stable scatter of one digit pass; offs = scanned hist
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const uint64_t* __restrict__ u_in, const int32_t* __restrict__ p_in,
               uint64_t* __restrict__ u_out, int32_t* __restrict__ p_out,
               const int32_t* __restrict__ offs, int64_t n, int shift,
               int64_t num_tiles) {
    __shared__ int32_t base[RADIX];
    __shared__ int32_t running[RADIX];
    __shared__ int32_t wc[WARPS][RADIX];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    base[t] = offs[(int64_t)t * num_tiles + blockIdx.x];
    running[t] = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) wc[w][t] = 0;
    __syncthreads();
    const int64_t ts = (int64_t)blockIdx.x * TILE;
    const int64_t te = imin(ts + TILE, n);
    const unsigned lt_mask = (1u << lane) - 1u;
    for (int it = 0; it < ITEMS; ++it) {
        const int64_t row = ts + (int64_t)it * THREADS + t;
        const bool valid = row < te;
        uint64_t x = 0;
        int32_t p = 0;
        int d = RADIX;  // invalid lanes group on a digit no valid lane has
        if (valid) {
            x = u_in[row];
            p = p_in[row];
            d = (int)((x >> shift) & (RADIX - 1));
        }
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int rank = __popc(peers & lt_mask);
        if (valid && rank == 0) wc[warp][d] = __popc(peers);
        __syncthreads();
        if (valid) {
            int32_t pos = base[d] + running[d] + rank;
            for (int w = 0; w < warp; ++w) pos += wc[w][d];
            u_out[pos] = x;
            p_out[pos] = p;
        }
        __syncthreads();
        int32_t tot = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            tot += wc[w][t];
            wc[w][t] = 0;
        }
        running[t] += tot;
        __syncthreads();
    }
}

inline unsigned blocks_for(int64_t n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// Bytes of the hist scratch that sort_perm_launch needs for n rows.
extern "C" int64_t sort_perm_hist_bytes(int64_t n) {
    const int64_t num_tiles = n > 0 ? (n + TILE - 1) / TILE : 1;
    return (int64_t)RADIX * num_tiles * (int64_t)sizeof(int32_t);
}

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
    iota_kernel<<<blocks_for(n, 256), 256, 0, s>>>(p_out, n);
    const int64_t num_tiles = (n + TILE - 1) / TILE;
    int32_t* h = static_cast<int32_t*>(hist);
    int32_t* pa = p_out;
    int32_t* pb = static_cast<int32_t*>(perm_tmp);
    uint64_t* ua = static_cast<uint64_t*>(kbuf);
    uint64_t* ub = static_cast<uint64_t*>(kbuf_tmp);
    for (int ki = num_keys - 1; ki >= 0; --ki) {
        if (digits[ki] <= 0) continue;
        gather_kernel<<<blocks_for(n, 256), 256, 0, s>>>(
            static_cast<const int64_t*>(keys[ki]), (uint64_t)lo[ki], pa, ua, n);
        for (int dg = 0; dg < digits[ki]; ++dg) {
            const int shift = 8 * dg;
            hist_kernel<<<(unsigned)num_tiles, THREADS, 0, s>>>(ua, n, shift, num_tiles, h);
            scan_kernel<<<1, SCAN_THREADS, 0, s>>>(h, (int64_t)RADIX * num_tiles);
            scatter_kernel<<<(unsigned)num_tiles, THREADS, 0, s>>>(ua, pa, ub, pb, h, n,
                                                                   shift, num_tiles);
            uint64_t* tu = ua; ua = ub; ub = tu;
            int32_t* tp = pa; pa = pb; pb = tp;
        }
    }
    if (pa != p_out) {
        cudaMemcpyAsync(p_out, pa, (size_t)n * sizeof(int32_t), cudaMemcpyDeviceToDevice, s);
    }
    return (int)cudaGetLastError();
}
