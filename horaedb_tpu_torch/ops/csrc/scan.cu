// scan_kernel: the fused per-segment scan pass. Filter -> stable sort by
// (pk..., seq) -> gather of every lane -> keep-last and run-start flags.
//
// Replaces the JAX package's storage/read.py::_build_scan_kernel (catalog
// name scan_kernel, :903-959): the predicate mask, a stable lax.sort of
// (~mask, pk..., __seq__, iota) or, for presorted rows, a stable partition,
// every column gathered through the permutation, the overwrite-mode
// keep-last mask over the primary key among the kept rows (or every kept
// row without dedup), the run-start mask, and the kept count. It is built
// with predicate.cu (kernel E), which the wrapper launches first to write
// the mask when the predicate runs on the device.
//
// Output contract: perm[0, kept) and every gathered lane's rows [0, kept)
// are the kept rows in key order; keep and starts are 0 from row kept on;
// perm and the gathered lanes past kept are left unwritten (no caller
// reads them). kept stays on the device.
//
// Bound on an H100: memory. The least traffic reads the key lanes and the
// predicate lanes once, reads and writes every gathered lane once, and
// writes 4 B of perm and 2 B of flags per row. Design:
//   1. sorting by (~mask, keys..., iota) equals a stable partition by the
//      mask followed by a stable sort of the kept rows, so the partition of
//      compact.cuh runs first (no mask: every row is kept);
//   2. the chain of look-back sorts of keychain.cuh over the kept rows
//      only, the kept count as its device-side row count: the host packs
//      the key lanes into u64 keys (ops/keychain.py::pack_lanes: each lane
//      offset by its minimum, adjacent lanes sharing a key where their
//      spans fit; the caller ranks __seq__ densely and drops constant
//      keys), and each key gets a key pass through the current permutation
//      and one look-back sweep per digit; presorted rows skip this step;
//   3. one gather kernel reads each row's source index once and copies
//      every lane (1, 2, 4 or 8 bytes wide) as raw bits, so NaN payloads
//      and -0.0 pass unchanged;
//   4. one flags kernel compares adjacent primary keys through the
//      permutation (start: differs from the row before; keep: the last kept
//      row, or differs from the row after).
// The kept count lives on the device between the steps: no synchronisation.
#include "compact.cuh"
#include "keychain.cuh"

namespace {

using keychain::MAX_KEYS;
constexpr int MAX_LANES = 32;

// mask == nullptr keeps every row
struct RowFlag {
    const uint8_t* mask;
    __device__ bool flag(int64_t i) const { return mask == nullptr || mask[i] != 0; }
    __device__ int32_t value(int64_t i) const { return (int32_t)i; }
};

struct Lanes {
    const void* in[MAX_LANES];
    void* out[MAX_LANES];
    int32_t width[MAX_LANES];
    int32_t count;
};

struct PkKeys {
    const int64_t* key[MAX_KEYS];
    int32_t count;
};

__global__ void gather_kernel(Lanes l, const int32_t* __restrict__ perm,
                              int32_t* __restrict__ perm_out, int64_t n,
                              const int32_t* __restrict__ kept) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= compact::rows(n, kept)) return;
    const int32_t p = perm[i];
    if (perm_out != nullptr) perm_out[i] = p;
    for (int k = 0; k < l.count; ++k) {
        switch (l.width[k]) {
            case 1:
                static_cast<uint8_t*>(l.out[k])[i] = static_cast<const uint8_t*>(l.in[k])[p];
                break;
            case 2:
                static_cast<uint16_t*>(l.out[k])[i] = static_cast<const uint16_t*>(l.in[k])[p];
                break;
            case 4:
                static_cast<uint32_t*>(l.out[k])[i] = static_cast<const uint32_t*>(l.in[k])[p];
                break;
            default:
                static_cast<uint64_t*>(l.out[k])[i] = static_cast<const uint64_t*>(l.in[k])[p];
        }
    }
}

__device__ inline bool same_pk(const PkKeys& pk, int32_t p, int32_t q) {
    for (int k = 0; k < pk.count; ++k) {
        if (pk.key[k][p] != pk.key[k][q]) return false;
    }
    return true;
}

__global__ void flags_kernel(PkKeys pk, const int32_t* __restrict__ perm, int64_t n,
                             const int32_t* __restrict__ kept, int32_t do_dedup,
                             uint8_t* __restrict__ keep, uint8_t* __restrict__ starts) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t nv = *kept;
    if (i >= nv) {
        keep[i] = 0;
        starts[i] = 0;
        return;
    }
    const int32_t p = perm[i];
    starts[i] = i == 0 || !same_pk(pk, perm[i - 1], p);
    keep[i] = !do_dedup || i == nv - 1 || !same_pk(pk, p, perm[i + 1]);
}

struct Scratch {
    keychain::Scratch sort;  // its third payload buffer takes the partition
    int32_t* tiles;
};

// with p null, only the layout (and its bytes)
Scratch carve(void* p, int64_t n, int digits, int64_t* bytes = nullptr) {
    onesweep::Carver c{reinterpret_cast<uintptr_t>(p)};
    Scratch s;
    s.sort = keychain::carve(p, n, digits, &c.used);
    s.tiles = c.take<int32_t>(compact::scratch_bytes(n) / 4);
    if (bytes) *bytes = c.used;
    return s;
}

}  // namespace

// n rows whose packed keys take at most `digits` digits (1-8)
extern "C" int64_t scan_scratch_bytes(int64_t n, int32_t digits) {
    int64_t bytes = 0;
    carve(nullptr, n, digits < 1 ? 1 : digits, &bytes);
    return bytes;
}

// keys: num_keys pointers to int64[n] mapped sort-key lanes, most
// significant first, the first num_pk of them the primary key; lo[i]: key
// i's minimum; lane_of, shift_of, group_start, group_digits, num_groups:
// the packed keys (keychain::Layout); mask: uint8[n] (0 = rejected) or
// null (keep every row); lanes_in / lanes_out / widths: num_lanes device
// lanes of n rows, their gathered outputs and their byte widths (1, 2, 4
// or 8); perm_out: int32[n]; keep_out, starts_out: uint8[n]; kept_out:
// int32[1]; scratch: scan_scratch_bytes(n, the most group_digits) bytes.
extern "C" int scan_launch(const void* const* keys, const int64_t* lo, int32_t num_keys,
                           int32_t num_pk, const int32_t* lane_of, const int32_t* shift_of,
                           const int32_t* group_start, const int32_t* group_digits,
                           int32_t num_groups, int64_t n, const void* mask,
                           int32_t presorted, int32_t do_dedup, const void* const* lanes_in,
                           void* const* lanes_out, const int32_t* widths, int32_t num_lanes,
                           void* perm_out, void* keep_out, void* starts_out, void* kept_out,
                           void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const keychain::Layout layout{keys,     lo,          num_keys,     lane_of,
                                  shift_of, group_start, group_digits, num_groups};
    const int max_digits = keychain::max_digits(layout);
    if (max_digits == 0 || num_keys > MAX_KEYS || num_pk < 0 || num_pk > num_keys ||
        num_lanes < 0 || n < 0 || n >= ((int64_t)1 << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    for (int k = 0; k < num_lanes; ++k) {
        if (widths[k] != 1 && widths[k] != 2 && widths[k] != 4 && widths[k] != 8) {
            return (int)cudaErrorInvalidValue;
        }
    }
    int32_t* kept = static_cast<int32_t*>(kept_out);
    const Scratch sc = carve(scratch, n, max_digits);
    int32_t* part = sc.sort.v[2];  // the partition's permutation feeds the first sort
    compact::run(RowFlag{static_cast<const uint8_t*>(mask)}, n, nullptr, sc.tiles, part, kept, s);
    const int32_t* perm = part;
    if (!presorted && n > 1) {
        perm = keychain::sort(layout, perm, onesweep::Rows<uint64_t>{n, kept, false, 0}, sc.sort,
                              s);
    }
    if (n == 0) return (int)cudaGetLastError();
    const unsigned blocks = compact::blocks_for(n, 256);
    int32_t* p_out = static_cast<int32_t*>(perm_out);
    int32_t done = 0;
    do {  // lanes in groups of MAX_LANES; the first launch also writes perm_out
        Lanes l{};
        l.count = num_lanes - done < MAX_LANES ? num_lanes - done : MAX_LANES;
        for (int k = 0; k < l.count; ++k) {
            l.in[k] = lanes_in[done + k];
            l.out[k] = lanes_out[done + k];
            l.width[k] = widths[done + k];
        }
        gather_kernel<<<blocks, 256, 0, s>>>(l, perm, done == 0 ? p_out : nullptr, n, kept);
        done += l.count;
    } while (done < num_lanes);
    PkKeys pk{};
    pk.count = num_pk;
    for (int k = 0; k < num_pk; ++k) pk.key[k] = static_cast<const int64_t*>(keys[k]);
    flags_kernel<<<blocks, 256, 0, s>>>(pk, p_out, n, kept, do_dedup,
                                        static_cast<uint8_t*>(keep_out),
                                        static_cast<uint8_t*>(starts_out));
    return (int)cudaGetLastError();
}
