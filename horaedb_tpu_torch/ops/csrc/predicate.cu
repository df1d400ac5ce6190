// predicate (kernel E): one fused elementwise pass that evaluates a
// flattened predicate program over the scan's lanes and writes a uint8
// keep-mask. Part of index_merge_filter (built into the same library as
// index_merge.cu; it is not a catalog kernel of its own).
//
// Replaces the JAX package's ops/filter.py::eval_predicate / _eval as
// traced inside the index_merge_filter XLA kernel: Compare against literal
// slots, InSetProbe (a broadcast compare up to 128 values, binary search
// above), And / Or / Not.
//
// Bound on an H100: memory. Each row reads its predicate lanes once and
// writes one byte; the work is a few compares per row. Design: the host
// flattens the predicate template into a postfix program (ops/filter.py::
// compile_program), and one compiled interpreter serves every template:
// one thread per row walks the program, keeping a stack of up to 32 bools
// in one register. Semantics held to the JAX package's:
//   - integer lanes compare as int64 (u64 lanes and literals arrive mapped
//     by flipping bit 63, so signed compares give the unsigned order);
//   - float lanes compare as IEEE doubles: NaN is unequal to everything and
//     unordered (ne true, the others false), -0.0 == 0.0; no fast-math;
//   - set members arrive sorted and unique (NaN dropped, since it matches
//     nothing); up to 128 are probed linearly, larger sets by a lower-bound
//     binary search; an empty set matches nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LANES = 16;
constexpr int LANE_I64 = 0, LANE_I32 = 1, LANE_U8 = 2, LANE_F64 = 3;
constexpr int OP_CMP = 1, OP_SET = 2, OP_AND = 3, OP_OR = 4, OP_NOT = 5;
constexpr int LINEAR_SET_MAX = 128;

struct Lanes {
    const void* ptr[MAX_LANES];
    int32_t type[MAX_LANES];
};

__device__ inline int64_t load_int(const Lanes& l, int lane, int64_t i) {
    switch (l.type[lane]) {
        case LANE_I32: return static_cast<const int32_t*>(l.ptr[lane])[i];
        case LANE_U8: return static_cast<const uint8_t*>(l.ptr[lane])[i];
        default: return static_cast<const int64_t*>(l.ptr[lane])[i];
    }
}

template <class T>
__device__ inline bool compare(int op, T x, T lit) {
    switch (op) {
        case 0: return x == lit;
        case 1: return x != lit;
        case 2: return x < lit;
        case 3: return x <= lit;
        case 4: return x > lit;
        default: return x >= lit;
    }
}

template <class T>
__device__ inline bool member(T x, const T* set, int32_t size) {
    if (size <= LINEAR_SET_MAX) {
        bool hit = false;
        for (int32_t j = 0; j < size; ++j) hit |= set[j] == x;
        return hit;
    }
    int32_t lo = 0, hi = size;  // first position with set[pos] >= x
    while (lo < hi) {
        const int32_t mid = (lo + hi) >> 1;
        if (set[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo < size && set[lo] == x;
}

__global__ void predicate_kernel(Lanes lanes, const int4* __restrict__ code, int32_t code_len,
                                 const int64_t* __restrict__ lit_i64,
                                 const double* __restrict__ lit_f64,
                                 const int64_t* __restrict__ set_i64,
                                 const double* __restrict__ set_f64, int64_t n,
                                 uint8_t* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t stack = 0;  // bit d = stack slot d
    int top = 0;
    for (int pc = 0; pc < code_len; ++pc) {
        const int4 ins = code[pc];
        bool v;
        switch (ins.x) {
            case OP_CMP:
                if (lanes.type[ins.z] == LANE_F64) {
                    v = compare(ins.y, static_cast<const double*>(lanes.ptr[ins.z])[i],
                                lit_f64[ins.w]);
                } else {
                    v = compare(ins.y, load_int(lanes, ins.z, i), lit_i64[ins.w]);
                }
                stack = (stack & ~(1u << top)) | ((uint32_t)v << top);
                ++top;
                break;
            case OP_SET:
                if (lanes.type[ins.y] == LANE_F64) {
                    v = member(static_cast<const double*>(lanes.ptr[ins.y])[i], set_f64 + ins.z,
                               ins.w);
                } else {
                    v = member(load_int(lanes, ins.y, i), set_i64 + ins.z, ins.w);
                }
                stack = (stack & ~(1u << top)) | ((uint32_t)v << top);
                ++top;
                break;
            case OP_NOT:
                stack ^= 1u << (top - 1);
                break;
            default: {  // AND / OR: pop y, x; push x op y
                const bool y = (stack >> (top - 1)) & 1u;
                const bool x = (stack >> (top - 2)) & 1u;
                --top;
                v = ins.x == OP_AND ? (x && y) : (x || y);
                stack = (stack & ~(1u << (top - 1))) | ((uint32_t)v << (top - 1));
            }
        }
    }
    out[i] = top > 0 ? (uint8_t)(stack & 1u) : (uint8_t)1;
}

}  // namespace

// lanes / lane_types: num_lanes host arrays of device pointers and their
// types; code: int32[code_len * 4] program on the device; lit_*, set_*:
// literal slots and set members on the device; out: uint8[n].
extern "C" int predicate_launch(const void* const* lanes, const int32_t* lane_types,
                                int32_t num_lanes, const void* code, int32_t code_len,
                                const void* lit_i64, const void* lit_f64, const void* set_i64,
                                const void* set_f64, int64_t n, void* out, void* stream) {
    if (num_lanes < 0 || num_lanes > MAX_LANES) return (int)cudaErrorInvalidValue;
    Lanes l{};
    for (int k = 0; k < num_lanes; ++k) {
        l.ptr[k] = lanes[k];
        l.type[k] = lane_types[k];
    }
    if (n > 0) {
        const unsigned blocks = (unsigned)((n + 255) / 256);
        predicate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            l, static_cast<const int4*>(code), code_len, static_cast<const int64_t*>(lit_i64),
            static_cast<const double*>(lit_f64), static_cast<const int64_t*>(set_i64),
            static_cast<const double*>(set_f64), n, static_cast<uint8_t*>(out));
    }
    return (int)cudaGetLastError();
}
