"""Sorted-segment reductions: kernels B (`block_sum_count`) and C
(`block_min_max`).

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
`valid=False` for min/max.
"""

from __future__ import annotations

import ctypes

import torch

from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import _build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _check(name: str, k, v, aux, aux_dtypes, num_cells: int) -> None:
    n = k.shape[0]
    ensure(k.dtype == torch.int32, f"{name}: cell ids must be int32, got {k.dtype}")
    ensure(v.dtype == torch.float64, f"{name}: values must be float64, got {v.dtype}")
    ensure(aux.dtype in aux_dtypes, f"{name}: bad side-lane dtype {aux.dtype}")
    for t in (k, v, aux):
        ensure(t.dim() == 1 and t.shape[0] == n, f"{name}: lanes must be 1-D of length {n}")
        ensure(t.is_contiguous(), f"{name}: lanes must be contiguous")
        ensure(t.device == k.device, f"{name}: lanes must share one device")
    ensure(0 <= num_cells < 2**31, f"{name}: num_cells {num_cells} outside [0, 2^31)")
    ensure(n < 2**31, f"{name}: {n} rows exceed int32 indices")


def _launch(name: str, fn_name: str, k, v, aux, num_cells: int):
    if k.device.type != "cuda":
        raise HoraeError(f"{name}: unsupported device {k.device}")
    dev = k.device
    out_a = torch.empty(num_cells, dtype=torch.float64, device=dev)
    out_b = torch.empty(num_cells, dtype=torch.float64, device=dev)
    fn = _build.kernel(name, fn_name, _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(k.data_ptr(), v.data_ptr(), aux.data_ptr(), k.shape[0], num_cells,
                out_a.data_ptr(), out_b.data_ptr(), stream)
    _build.check(name, rc)
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


def sum_count_plain(k, v, w, num_cells: int):
    """Plain version of kernel B: `fold_sums` over the in-range ids."""
    keep = _in_range(k, num_cells)
    idx = k[keep].long()
    return fold_sums(v[keep], idx, num_cells), fold_sums(w[keep], idx, num_cells)


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


def sorted_segment_sum_count(k, v, num_cells: int, weights=None):
    """(sum, count) per cell over sorted int32 ids `k`: kernel B on a CUDA
    tensor, `sum_count_plain` on a CPU one. `weights` (f64, default 1) is
    each row's count contribution; rows weighted 0 must carry value 0."""
    w = torch.ones_like(v) if weights is None else weights
    _check("block_sum_count", k, v, w, (torch.float64,), num_cells)
    if k.device.type == "cpu":
        return sum_count_plain(k, v, w, num_cells)
    return _launch("block_sum_count", "block_sum_count_launch", k, v, w, num_cells)


def sorted_segment_min_max(k, v, num_cells: int, valid=None):
    """(min, max) per cell over sorted int32 ids `k`, +inf/-inf for empty
    cells: kernel C on a CUDA tensor, `min_max_plain` on a CPU one.
    `valid` (bool or uint8, default all) excludes rows."""
    ok = torch.ones(v.shape, dtype=torch.bool, device=v.device) if valid is None else valid
    _check("block_min_max", k, v, ok, (torch.bool, torch.uint8), num_cells)
    if k.device.type == "cpu":
        return min_max_plain(k, v, ok, num_cells)
    return _launch("block_min_max", "block_min_max_launch", k, v, ok, num_cells)
