"""Sorted-segment reductions: kernels B (`block_sum_count`) and C
(`block_min_max`), and the dispatch surface of the JAX package's
`ops/blockagg.py`.

The JAX package reduces rows sorted by flat cell id with a one-hot MXU
contraction and falls back to a scatter when a block holds too many
distinct cells (`horaedb_tpu/ops/blockagg.py`); f64 values always take
the scatter. On a CUDA tensor these functions launch a hand-written
segmented reduction (`csrc/segreduce.cuh`), which has no density limit and
so no fallback; on a CPU tensor they run the plain PyTorch version beside
each. Values and sums stay f64 on the card.

Contract of both: `k` is int32 and sorted (nondecreasing); ids outside
[0, num_cells) are dropped. Excluded rows keep their in-range sorted id
and contribute nothing: weight 0 with a pre-masked value 0 for the sum,
`valid=False` for min/max. A caller that gives no weights (or no mask)
gives the kernel no lane: it weighs every row 1 (counts every row)
itself, bitwise as a lane of ones would, and the wrapper builds no lane of
ones on the card.

Dispatch (`impl`): the JAX package's registry names
(`ops/agg_registry.py`), so pins and metric labels read the same. None
reads `HORAEDB_SORTED_IMPL`; `auto` asks the calibrated dispatcher. The
TPU's block settings mean nothing to kernel B, so every block variant and
both scatters are kernel B: bitwise equal to `block`. `block_bf16` is
kernel B with each value rounded to bf16 on load; `lanes` is kernel
`lane_sum_count` (ops/aggregate.py); `reduceat` is the host lane, for CPU
tensors only (refused on the card: no work leaves it). As in
the JAX package, values that are not f32 take the dtype-preserving route
before any lane runs (here kernel B, which sums f64): f64 never reaches the
f32 lanes. Min/max have one device form, kernel C, under every device
name. f32 values ride kernel B's and C's f64 lanes exactly and come back
as f32.
"""

from __future__ import annotations

import ctypes
import os

import torch

from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import _build

_MINMAX_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
# kernel B takes the bf16 rounding flag before the stream
_SUM_ARGTYPES = _MINMAX_ARGTYPES[:-1] + [ctypes.c_int32, ctypes.c_void_p]

_SORTED_IMPL_NAMES = (
    "auto", "scatter", "scatter_fused", "lanes", "reduceat",
    "block", "block_wide", "block_r32", "block_bf16", "block_scan",
)
_UNSORTED_IMPL_NAMES = ("auto", "scatter", "sort", "bincount")
_FLOATS = (torch.float32, torch.float64)
# grids below this many cells take the sorted-segment route in the mesh
# step (the JAX package's bound: its one-hot id recovery is exact in f32
# below 2^24; kept so both packages route the same grids the same way)
F32_EXACT = 1 << 24


def _check(name: str, k, v, aux, aux_dtypes, num_cells: int) -> None:
    """`aux` is the side lane (weights or valid), or None."""
    n = k.shape[0]
    ensure(k.dtype == torch.int32, f"{name}: cell ids must be int32, got {k.dtype}")
    ensure(v.dtype == torch.float64, f"{name}: values must be float64, got {v.dtype}")
    lanes = (k, v)
    if aux is not None:
        ensure(aux.dtype in aux_dtypes, f"{name}: bad side-lane dtype {aux.dtype}")
        lanes += (aux,)
    for t in lanes:
        ensure(t.dim() == 1 and t.shape[0] == n, f"{name}: lanes must be 1-D of length {n}")
        ensure(t.is_contiguous(), f"{name}: lanes must be contiguous")
        ensure(t.device == k.device, f"{name}: lanes must share one device")
    ensure(0 <= num_cells < 2**31, f"{name}: num_cells {num_cells} outside [0, 2^31)")
    ensure(n < 2**31, f"{name}: {n} rows exceed int32 indices")


def _require_card(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise HoraeError(f"{name}: unsupported device {dev}")


def _launch(name: str, fn_name: str, argtypes, k, v, aux, num_cells: int, *flags):
    """Launch kernel `name` through `_build.launch` (no device switch when
    the device is current, the raw stream handle); an absent side lane
    (`aux` None) goes to the kernel as a null pointer."""
    _require_card(name, k.device)
    dev = k.device
    out_a = torch.empty(num_cells, dtype=torch.float64, device=dev)
    out_b = torch.empty(num_cells, dtype=torch.float64, device=dev)
    fn = _build.kernel(name, fn_name, argtypes)
    _build.launch(name, fn, dev, k.data_ptr(), v.data_ptr(),
                  None if aux is None else aux.data_ptr(), k.shape[0], num_cells,
                  out_a.data_ptr(), out_b.data_ptr(), *flags)
    return out_a, out_b


def _in_range(k: torch.Tensor, num_cells: int) -> torch.Tensor:
    return (k >= 0) & (k < num_cells)


# segreduce.cuh's association of a run's f64 sum (its header): a run of up
# to LONG_RUN rows folds left to right; a longer one folds chunks of CHUNK
# rows counted from its head, then groups of GROUP_CHUNKS chunk partials,
# then the group partials, each left to right
LONG_RUN, CHUNK, GROUP_CHUNKS = 256, 16, 32


def fold_sums(x: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    """Per-cell sums of float `x` over int64 ids `idx` in [0, m), each
    cell's rows taken in row order as one run and associated as kernels B
    and grouped_stats associate it. index_add_ folds in row order on the
    CPU: once into chunk partials, once into group partials, once into
    the cells."""
    n = idx.shape[0]
    out = torch.zeros(m, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    order = torch.argsort(idx, stable=True)
    sk, sx = idx[order], x[order]
    count = torch.bincount(sk, minlength=m)
    start = (torch.cumsum(count, 0) - count)[sk]
    rank = torch.arange(n, device=x.device) - start
    long = count[sk] > LONG_RUN
    span = CHUNK * GROUP_CHUNKS
    chunk = start + torch.where(long, rank // CHUNK, 0)
    group = start + torch.where(long, rank // span, 0)
    partial = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, chunk, sx)
    head = torch.where(long, rank % CHUNK == 0, rank == 0)
    grouped = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
        0, group[head], partial[chunk[head]])
    head = torch.where(long, rank % span == 0, rank == 0)
    return out.index_add_(0, sk[head], grouped[group[head]])


def round_bf16(v: torch.Tensor) -> torch.Tensor:
    """f32-exact f64 values rounded to bf16 (nearest even), as f64: what
    kernel B's `round_bf16` flag loads."""
    return v.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def sum_count_plain(k, v, w, num_cells: int, bf16: bool = False):
    """Plain version of kernel B: `fold_sums` over the in-range ids (of the
    bf16-rounded values when `bf16`)."""
    keep = _in_range(k, num_cells)
    idx = k[keep].long()
    vk = round_bf16(v[keep]) if bf16 else v[keep]
    return fold_sums(vk, idx, num_cells), fold_sums(w[keep], idx, num_cells)


def min_max_plain(k, v, valid, num_cells: int):
    """Plain version of kernel C: scatter_reduce from +/-inf fills (it
    propagates NaN, as segment_min/segment_max do)."""
    keep = _in_range(k, num_cells) & valid.bool()
    idx = k[keep].long()
    vk = v[keep]
    mn = torch.full((num_cells,), torch.inf, dtype=v.dtype, device=v.device)
    mx = torch.full((num_cells,), -torch.inf, dtype=v.dtype, device=v.device)
    mn.scatter_reduce_(0, idx, vk, "amin", include_self=True)
    mx.scatter_reduce_(0, idx, vk, "amax", include_self=True)
    return mn, mx


def block_sum_count(k, v, num_cells: int, weights=None, bf16: bool = False):
    """(sum, count) per cell over sorted int32 ids `k` and f64 values:
    kernel B on a CUDA tensor, `sum_count_plain` on a CPU one. `weights`
    (f64, None: every row weighs 1, with no lane built on the card) is each
    row's count contribution; rows weighted 0 must carry value 0. `bf16`
    rounds each value to bf16 on load."""
    _check("block_sum_count", k, v, weights, (torch.float64,), num_cells)
    if k.device.type == "cpu":
        w = torch.ones_like(v) if weights is None else weights
        return sum_count_plain(k, v, w, num_cells, bf16)
    return _launch("block_sum_count", "block_sum_count_launch", _SUM_ARGTYPES, k, v, weights,
                   num_cells, int(bf16))


def block_min_max(k, v, num_cells: int, valid=None):
    """(min, max) per cell over sorted int32 ids `k` and f64 values,
    +inf/-inf for empty cells: kernel C on a CUDA tensor, `min_max_plain`
    on a CPU one. `valid` (bool or uint8; None: every row counts, with no
    lane built on the card) excludes rows."""
    _check("block_min_max", k, v, valid, (torch.bool, torch.uint8), num_cells)
    if k.device.type == "cpu":
        ok = torch.ones(v.shape, dtype=torch.bool, device=v.device) if valid is None else valid
        return min_max_plain(k, v, ok, num_cells)
    return _launch("block_min_max", "block_min_max_launch", _MINMAX_ARGTYPES, k, v, valid,
                   num_cells)


# -- the dispatch surface --------------------------------------------------------

def _sorted_impl() -> str:
    """Strategy override: HORAEDB_SORTED_IMPL naming any registry impl
    (`HORAEDB_AGG_IMPL` takes precedence inside the dispatcher); auto = the
    calibrated per-platform choice."""
    return os.environ.get("HORAEDB_SORTED_IMPL", "auto")


def _unsorted_impl() -> str:
    """Strategy override for UNSORTED input: HORAEDB_UNSORTED_IMPL in
    {auto, scatter, sort, bincount}."""
    return os.environ.get("HORAEDB_UNSORTED_IMPL", "auto")


def resolve_sorted_impl(impl: str | None, n: int, num_cells: int, device) -> str:
    """`impl`, else HORAEDB_SORTED_IMPL, checked against the registry's
    names; `auto` asks the calibrated dispatcher (which counts the choice)."""
    impl = impl or _sorted_impl()
    ensure(impl in _SORTED_IMPL_NAMES,
           f"unknown sorted impl {impl!r} ({'|'.join(_SORTED_IMPL_NAMES)})")
    if impl == "auto":
        from horaedb_tpu_torch.ops import agg_registry

        impl = agg_registry.choose_sorted(n, num_cells, device=device)
    return impl


def _host_tensors(name: str, fn, k, v, num_cells: int, **lanes):
    """Run host lane `name` on the numpy views of CPU tensors; refused for
    tensors on the card (agg_registry.check_host_lane)."""
    from horaedb_tpu_torch.ops import agg_registry

    agg_registry.check_host_lane(name, k.device)
    host = {key: (None if a is None else a.numpy()) for key, a in lanes.items()}
    return tuple(torch.from_numpy(o) for o in fn(k.numpy(), v.numpy(), num_cells, **host))


def sorted_segment_sum_count(k, v, num_cells: int, impl: str | None = None, weights=None):
    """(sum, count) per cell over SORTED int32 ids `k` (ids outside
    [0, num_cells) are dropped) of f32 or f64 values `v`, in their dtype.
    `weights` (optional) is each row's count contribution; rows weighted 0
    must carry value 0. `impl` takes the registry's names (module
    docstring)."""
    ensure(v.dtype in _FLOATS, f"block_sum_count: values must be float32 or float64, "
                               f"got {v.dtype}")
    impl = resolve_sorted_impl(impl, k.shape[0], num_cells, k.device)
    if v.dtype != torch.float32 and impl != "reduceat":
        # f64 keeps the dtype-preserving route: the f32 lanes never see it
        impl = "scatter"
    if impl == "reduceat":
        from horaedb_tpu_torch.ops import agg_registry

        return _host_tensors(impl, agg_registry.host_reduceat_sum_count, k, v,
                             num_cells=num_cells, weights=weights)
    if impl == "lanes":
        from horaedb_tpu_torch.ops.aggregate import lane_segment_sum_count

        return lane_segment_sum_count(k, v, num_cells, w=weights)
    w = None if weights is None else weights.to(torch.float64)
    s, c = block_sum_count(k, v.to(torch.float64), num_cells, weights=w,
                           bf16=impl == "block_bf16")
    return s.to(v.dtype), c.to(v.dtype)


def sorted_segment_min_max(k, v, num_cells: int, impl: str | None = None, valid=None):
    """(min, max) per cell over SORTED int32 ids `k` of f32 or f64 values,
    +inf/-inf for empty cells; `valid` (bool or uint8, default all)
    excludes rows. Kernel C (plain version on the CPU) under every device
    name; `reduceat` is the host lane (CPU tensors only)."""
    ensure(v.dtype in _FLOATS, f"block_min_max: values must be float32 or float64, "
                               f"got {v.dtype}")
    impl = resolve_sorted_impl(impl, k.shape[0], num_cells, k.device)
    if impl == "reduceat":
        from horaedb_tpu_torch.ops import agg_registry

        return _host_tensors(impl, agg_registry.host_reduceat_min_max, k, v,
                             num_cells=num_cells, valid=valid)
    mn, mx = block_min_max(k, v.to(torch.float64), num_cells, valid=valid)
    return mn.to(v.dtype), mx.to(v.dtype)


def unsorted_strategy(n: int, num_cells: int, dtype, impl: str | None = None,
                      platform: str = "cpu") -> str:
    """Resolve the unsorted-reduction strategy. `auto` takes `sort` (kernel
    A, then kernel B) for dense f32 grids off the CPU, `scatter`
    (grouped_stats) otherwise, as the JAX package's static rule does; its
    f32-exact grid bound belongs to the TPU's one-hot id recovery and is
    left out."""
    impl = impl or _unsorted_impl()
    ensure(impl in _UNSORTED_IMPL_NAMES,
           f"unknown unsorted impl {impl!r} ({'|'.join(_UNSORTED_IMPL_NAMES)})")
    if impl != "auto":
        return impl
    return ("sort" if n >= 8 * num_cells and platform != "cpu" and dtype == torch.float32
            else "scatter")


def _scatter_sum_count(k, v, num_cells: int, w=None):
    """The JAX package's scatter: ids clipped to [0, num_cells] (a negative
    id lands in cell 0), slot num_cells dropped; grouped_stats (the kernel
    on a CUDA tensor) sums in f64, integers in int64."""
    from horaedb_tpu_torch.ops.aggregate import grouped_stats

    kc = torch.clamp(k, 0, num_cells)
    g = grouped_stats(v, kc, None, num_cells)
    s = g["sum"]
    c = g["count"] if w is None else grouped_stats(w, kc, None, num_cells)["sum"]
    if v.dtype.is_floating_point:
        return s.to(v.dtype), c.to(v.dtype)
    return s, c.to(s.dtype)


def segment_sum_count(k, v, num_cells: int, impl: str | None = None, weights=None):
    """(sum, count) per cell over UNSORTED ids `k` (int32 or int64; invalid
    rows carry id >= num_cells with values pre-masked to 0, or a 0 weight).
    `sort` sorts the clipped ids (kernel A) and reduces with kernel B;
    `scatter` is grouped_stats; `bincount` is the host lane; `auto` asks the
    calibrated dispatcher."""
    resolved = impl or _unsorted_impl()
    if resolved == "auto":
        from horaedb_tpu_torch.ops import agg_registry

        resolved = agg_registry.choose_unsorted(k.shape[0], num_cells, device=k.device)
    impl = unsorted_strategy(k.shape[0], num_cells, v.dtype, resolved, k.device.type)
    if impl == "bincount":
        from horaedb_tpu_torch.ops import agg_registry

        return _host_tensors(impl, agg_registry.host_bincount_sum_count, k, v,
                             num_cells=num_cells, weights=weights)
    if impl == "scatter":
        return _scatter_sum_count(k, v, num_cells, w=weights)
    ensure(impl == "sort", f"unknown unsorted impl {impl!r}")
    from horaedb_tpu_torch.ops.sort import sort_perm

    kc = torch.clamp(k, 0, num_cells)
    perm = sort_perm([kc.to(torch.int64).contiguous()], [(0, num_cells)]).long()
    ks = kc[perm].to(torch.int32)
    ws = None if weights is None else weights[perm]
    return sorted_segment_sum_count(ks, v[perm], num_cells, impl="block", weights=ws)
