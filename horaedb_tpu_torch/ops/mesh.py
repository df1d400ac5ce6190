"""The mesh steps' kernels: `grid_fold`, the slot pass of `sharded_downsample`
/ `multisegment_downsample`, and the two per-slot steps of
`sample_sort_merge`.

The JAX package runs these inside `shard_map` bodies
(`parallel/merge.py`, `parallel/scan.py`); the port's mesh layer
(`horaedb_tpu_torch/parallel/`) drives one call per slot from the host and
calls these wrappers, which launch the hand-written kernels
(`csrc/grid_fold.cu`, `csrc/sharded_downsample.cu`,
`csrc/sample_sort_merge.cu`) on CUDA tensors and run the plain PyTorch
versions beside them on CPU tensors. Each wrapper counts its launches
under the catalog name of the step it serves.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import _build
from horaedb_tpu_torch.ops.aggregate import grouped_stats_plain, masked_cell_keys
from horaedb_tpu_torch.ops.blockagg import F32_EXACT, min_max_plain, sum_count_plain
from horaedb_tpu_torch.ops.merge import I64_MAX, packed_merge_plain

FOLD_KEYS = ("sum", "count", "min", "max")
_QUIET_BIT = 1 << 51
_DEFAULT_NAN = torch.tensor(np.array([0xFFF8000000000000], np.uint64).view(np.int64)).view(
    torch.float64)[0]


def _on_card(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise HoraeError(f"{name}: unsupported device {dev}")


# -- grid_fold -------------------------------------------------------------------

def _quieted(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int64) | _QUIET_BIT).view(torch.float64)


def np_add(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`np.add.at`'s element rule in the host fold's use (grid_fold.cu's
    header): a NaN operand wins, the partial's first, quieted; inf + -inf
    is the default NaN."""
    out = torch.where(torch.isinf(acc) & torch.isinf(x) & (acc != x),
                      _DEFAULT_NAN.to(acc.device), acc + x)
    out = torch.where(torch.isnan(acc), _quieted(acc), out)
    return torch.where(torch.isnan(x), _quieted(x), out)


def np_min(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`np.minimum.at`'s element rule: a NaN operand wins (the
    accumulator's first, not quieted); on a tie the partial's wins."""
    return torch.where((acc < x) | torch.isnan(acc), acc, x)


def np_max(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`np.maximum.at`'s element rule (as `np_min`)."""
    return torch.where((acc > x) | torch.isnan(acc), acc, x)


def grid_fold_plain(stacked: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Plain version of kernel `grid_fold`: the left fold of the k stacked
    [k, ...] f64 grids from the identity, element rule by element rule."""
    k = stacked["sum"].shape[0]
    shape = stacked["sum"].shape[1:]
    dev = stacked["sum"].device
    out = {"sum": torch.zeros(shape, dtype=torch.float64, device=dev),
           "count": torch.zeros(shape, dtype=torch.float64, device=dev)}
    has_minmax = "min" in stacked
    if has_minmax:
        out["min"] = torch.full(shape, torch.inf, dtype=torch.float64, device=dev)
        out["max"] = torch.full(shape, -torch.inf, dtype=torch.float64, device=dev)
    for j in range(k):
        out["sum"] = np_add(out["sum"], stacked["sum"][j])
        out["count"] = np_add(out["count"], stacked["count"][j])
        if has_minmax:
            out["min"] = np_min(out["min"], stacked["min"][j])
            out["max"] = np_max(out["max"], stacked["max"][j])
    return out


_FOLD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int32, ctypes.c_int64] + \
    [ctypes.c_void_p] * 2


def grid_fold(stacked: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fold k stacked partial grids (`sum`, `count` and, together, `min` and
    `max`: contiguous f64 [k, ...] on one device, k >= 1) left to right from
    the identity, bitwise as the host fold of `cluster/partial.py` folds
    them. Kernel `grid_fold` on CUDA tensors, `grid_fold_plain` on CPU
    ones. On the card the folded grids are views of one [keys, ...]
    allocation, and one launch writes them all."""
    keys = [k for k in FOLD_KEYS if k in stacked]
    if keys != ["sum", "count"] and keys != list(FOLD_KEYS):
        raise HoraeError(f"grid_fold: needs sum and count, and min with max, got {sorted(stacked)}")
    ref = stacked["sum"]
    if ref.dim() < 1 or ref.shape[0] < 1:
        raise HoraeError("grid_fold: needs k >= 1 partials")
    shape, dev = ref.shape, ref.device
    for key in keys:
        t = stacked[key]
        if not (t.dtype == torch.float64 and t.shape == shape and t.is_contiguous()
                and t.device == dev):
            raise HoraeError(f"grid_fold: {key} must be a contiguous f64 {tuple(shape)} on {dev}, "
                             f"got {t.dtype}{tuple(t.shape)} on {t.device}")
    if dev.type == "cpu":
        return grid_fold_plain(stacked)
    _on_card(dev, "grid_fold")
    grid = shape[1:]
    out = ref.new_empty((len(keys),) + grid)
    minmax = len(keys) == 4
    fn = _build.kernel("grid_fold", "grid_fold_launch", _FOLD_ARGTYPES)
    _build.launch("grid_fold", fn, dev, ref.data_ptr(), stacked["count"].data_ptr(),
                  stacked["min"].data_ptr() if minmax else None,
                  stacked["max"].data_ptr() if minmax else None, shape[0], grid.numel(),
                  out.data_ptr())
    return dict(zip(keys, out.unbind(0)))


# -- the partial grids of a mesh slot ---------------------------------------------

def sharded_keys_plain(ts, sid, vals, valid, mask, t0: int, bucket_ms: int, lo: int,
                       local_series: int, num_buckets: int):
    """The cell keys of a slot's rows for its series slice [lo, lo +
    local_series), as the JAX step's `_local_grids` builds them: (safe,
    flat, masked value, weight, ok). `safe` keeps a masked row at its
    in-range key and sends a row of another slice to the sentinel; `flat`
    sends every row that is not ok there."""
    local = (sid.to(torch.int64) - lo).to(torch.int32)  # int32 wrap
    bucket = torch.div(ts - t0, bucket_ms, rounding_mode="floor").to(torch.int32)
    in_slice = (local >= 0) & (local < local_series)
    ok = valid.bool() & in_slice & (bucket >= 0) & (bucket < num_buckets)
    if mask is not None:
        ok &= mask.bool()
    key, flat = masked_cell_keys(local, bucket, ok, local_series, num_buckets)
    safe = torch.where(in_slice, key, torch.full_like(key, local_series * num_buckets))
    vm = torch.where(ok, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    return safe, flat, vm, ok.to(torch.float64), ok


def sorted_route(sorted_input: bool, cells: int) -> bool:
    """Whether a slot's rows take the sorted route: rows in (sid, ts) order
    over fewer than 2^24 cells, the JAX package's rule (its one-hot id
    recovery is exact in f32 below that; kept so both packages route the
    same grids the same way)."""
    return sorted_input and cells < F32_EXACT


def slot_grids_plain(ts, sid, vals, valid, mask, t0: int, bucket_ms: int, lo: int,
                     local_series: int, num_buckets: int, sorted_input: bool,
                     with_minmax: bool = True) -> dict[str, torch.Tensor]:
    """Plain version of the slot pass (`csrc/sharded_downsample.cu`), on the
    tensors' own device: the keys of `sharded_keys_plain`, then, for sorted
    rows, kernel B's and C's plain versions over `safe` (the weight and the
    ok mask riding along), else grouped_stats' over the clipped `safe`
    (values, then weights) and over `flat` (min and max). Flat [cells]
    grids of sum and count (and min, max)."""
    cells = local_series * num_buckets
    safe, flat, vm, w, ok = sharded_keys_plain(ts, sid, vals, valid, mask, t0, bucket_ms, lo,
                                               local_series, num_buckets)
    if sorted_route(sorted_input, cells):
        s, c = sum_count_plain(safe, vm, w, cells)
        out = {"sum": s, "count": c}
        if with_minmax:
            out["min"], out["max"] = min_max_plain(safe, vm, ok, cells)
        return out
    every = torch.ones(safe.shape, dtype=torch.bool, device=safe.device)
    kc = torch.clamp(safe, 0, cells)
    out = {"sum": grouped_stats_plain(vm, kc, every, cells)["sum"],
           "count": grouped_stats_plain(w, kc, every, cells)["sum"]}
    if with_minmax:
        g = grouped_stats_plain(vm, flat, every, cells)
        out["min"], out["max"] = g["min"], g["max"]
    return out


_SLOT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                          ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
                                          ctypes.c_int32] + [ctypes.c_void_p] * 6


def slot_grids(ts, sid, vals, valid, mask, t0: int, bucket_ms: int, lo: int, local_series: int,
               num_buckets: int, sorted_input: bool, with_minmax: bool = True, out=None,
               library: str = "sharded_downsample") -> dict[str, torch.Tensor]:
    """One mesh slot's partial grids for its series slice [lo, lo +
    local_series): flat [local_series * num_buckets] f64 grids of sum and
    count (and min, max). Lanes: ts int64, sid int32, vals f64, valid bool
    or uint8, `mask` (kernel E's output, or None). `sorted_input` declares
    rows in (sid, ts) order. On CUDA tensors one launch of the slot pass,
    counted under `library` (`sharded_downsample` or
    `multisegment_downsample`), writing into `out` (contiguous f64 grids on
    the lanes' device, the same keys) when given; `slot_grids_plain` on
    CPU tensors."""
    n = ts.shape[0]
    dev = ts.device
    # each message is built only on failure: this runs once a slot a step
    for name, t, dts in (("ts", ts, (torch.int64,)), ("sid", sid, (torch.int32,)),
                         ("vals", vals, (torch.float64,)),
                         ("valid", valid, (torch.bool, torch.uint8)),
                         ("mask", mask, (torch.bool, torch.uint8))):
        if t is not None and not (t.dtype in dts and t.dim() == 1 and t.shape[0] == n
                                  and t.is_contiguous() and t.device == dev):
            raise HoraeError(f"{library}: {name} must be a contiguous 1-D {dts} of {n} rows on "
                             f"{dev}, got {t.dtype}{tuple(t.shape)} on {t.device}")
    if bucket_ms <= 0:
        raise HoraeError(f"{library}: bucket_ms must be positive, got {bucket_ms}")
    cells = local_series * num_buckets
    if not (local_series > 0 and num_buckets > 0 and cells < 2**31):
        raise HoraeError(f"{library}: a slice of {local_series} x {num_buckets} cells exceeds "
                         "int32 ids")
    if n >= 2**31:
        raise HoraeError(f"{library}: {n} rows exceed int32 row indices")
    keys = FOLD_KEYS if with_minmax else FOLD_KEYS[:2]
    if dev.type == "cpu":
        grids = slot_grids_plain(ts, sid, vals, valid, mask, t0, bucket_ms, lo, local_series,
                                 num_buckets, sorted_input, with_minmax)
        if out is None:
            return grids
        for k in keys:
            out[k].copy_(grids[k])
        return out
    _on_card(dev, library)
    if out is None:
        out = dict(zip(keys, torch.empty((len(keys), cells), dtype=torch.float64,
                                         device=dev).unbind(0)))
    for k in keys:
        t = out[k]
        if not (t.dtype == torch.float64 and t.numel() == cells and t.is_contiguous()
                and t.device == dev):
            raise HoraeError(f"{library}: out[{k!r}] must be a contiguous f64 grid of {cells} "
                             f"cells on {dev}")
    sorted_pass = sorted_route(sorted_input, cells)
    scratch = None
    if not sorted_pass:
        scratch = torch.empty(_build.scratch_bytes(library, "sharded_slot_scratch_bytes", n),
                              dtype=torch.uint8, device=dev)
    fn = _build.kernel(library, "sharded_slot_launch", _SLOT_ARGTYPES)
    _build.launch(library, fn, dev, ts.data_ptr(), sid.data_ptr(), vals.data_ptr(),
                  valid.data_ptr(), None if mask is None else mask.data_ptr(), t0, bucket_ms, lo,
                  local_series, num_buckets, n, int(sorted_pass), out["sum"].data_ptr(),
                  out["count"].data_ptr(), out["min"].data_ptr() if with_minmax else None,
                  out["max"].data_ptr() if with_minmax else None,
                  None if scratch is None else scratch.data_ptr())
    return out


# -- sample_sort_merge: the per-slot steps --------------------------------------------

def _raw(key: torch.Tensor) -> torch.Tensor:
    """Raw packed bits of mapped keys (valid keys are < 2^63, so the int64
    reads them unsigned)."""
    return key ^ torch.tensor(-(1 << 63), dtype=torch.int64, device=key.device)


def ssm_local_plain(key: torch.Tensor, key_bits: int, seq_width: int, splitters: torch.Tensor,
                    d_slots: int, cap: int, row_base: int):
    """Plain version of the local step: the valid rows sorted by key (stable,
    so equal keys stay in row order), bucketed by the splitters, written
    into the [d_slots * cap] send lanes (sentinel fill). `key_bits` only
    sets the kernel's digit sweeps (ceil(key_bits / 8))."""
    dev = key.device
    send_k = torch.full((d_slots * cap,), I64_MAX, dtype=torch.int64, device=dev)
    send_i = torch.zeros(d_slots * cap, dtype=torch.int32, device=dev)
    rows = torch.nonzero(key != I64_MAX).flatten()
    if rows.numel() == 0:
        return send_k, send_i
    order = torch.sort(key[rows], stable=True).indices
    rows = rows[order]
    sk = key[rows]
    grp = _raw(sk) >> seq_width
    bucket = torch.searchsorted(splitters, grp, right=True)
    counts = torch.bincount(bucket, minlength=d_slots)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(rows), device=dev) - start[bucket]
    at = bucket * cap + rank
    send_k[at] = sk
    send_i[at] = (rows + row_base).to(torch.int32)
    return send_k, send_i


_LOCAL_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def ssm_local(key: torch.Tensor, key_bits: int, seq_width: int, splitters: torch.Tensor,
              d_slots: int, cap: int, row_base: int):
    """The local step of `sample_sort_merge` on one slot: int64 mapped keys
    of the slot's shard (global rows from `row_base`), int64 raw splitter
    group ids (d_slots - 1, ascending) on the same device; returns the
    send lanes (int64 keys, int32 row ids) of [d_slots * cap]. The kernel
    on CUDA tensors, `ssm_local_plain` on CPU ones."""
    n = key.shape[0]
    dev = key.device
    ensure(key.dtype == torch.int64 and key.dim() == 1 and key.is_contiguous(),
           "sample_sort_merge: keys must be contiguous int64")
    ensure(splitters.dtype == torch.int64 and splitters.shape == (d_slots - 1,)
           and splitters.device == dev, "sample_sort_merge: splitters must be int64 [D - 1]")
    ensure(1 <= key_bits <= 63 and 0 <= seq_width < 64,
           f"sample_sort_merge: key_bits {key_bits}, seq_width {seq_width} out of range")
    ensure(row_base + n < 2**31 and d_slots * cap < 2**31,
           "sample_sort_merge: row ids and send lanes are int32-indexed")
    if dev.type == "cpu":
        return ssm_local_plain(key, key_bits, seq_width, splitters, d_slots, cap, row_base)
    _on_card(dev, "sample_sort_merge")
    send_k = torch.empty(d_slots * cap, dtype=torch.int64, device=dev)
    send_i = torch.empty(d_slots * cap, dtype=torch.int32, device=dev)
    nbytes = _build.kernel("sample_sort_merge", "ssm_local_scratch_bytes",
                           [ctypes.c_int64, ctypes.c_int32, ctypes.c_int64],
                           ctypes.c_int64)(n, key_bits, d_slots)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = _build.kernel("sample_sort_merge", "ssm_local_launch", _LOCAL_ARGTYPES)
    _build.launch("sample_sort_merge", fn, dev, key.data_ptr(), n, key_bits, seq_width,
                  splitters.data_ptr(), d_slots, cap, row_base, send_k.data_ptr(),
                  send_i.data_ptr(), scratch.data_ptr())
    return send_k, send_i


def ssm_merge_plain(recv_k: torch.Tensor, recv_i: torch.Tensor, key_bits: int, seq_width: int,
                    do_dedup: bool):
    """Plain version of the merge step: kernel D's plain version over the
    received keys (a stable sort keeps received order, which is row-id
    order, among equal keys), mapped through the received row ids."""
    idx, count = packed_merge_plain(recv_k, seq_width, do_dedup)
    return recv_i[idx.long()].to(torch.int32), count


_MERGE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]


def ssm_merge(recv_k: torch.Tensor, recv_i: torch.Tensor, key_bits: int, seq_width: int,
              do_dedup: bool):
    """The merge step of `sample_sort_merge` on one slot: the received
    [m] int64 keys and int32 row ids; returns (int32 [m] row ids whose
    first `count` are the survivors in key order, int32 [1] count). The
    kernel on CUDA tensors, `ssm_merge_plain` on CPU ones."""
    m = recv_k.shape[0]
    dev = recv_k.device
    ensure(recv_k.dtype == torch.int64 and recv_i.dtype == torch.int32
           and recv_i.shape == (m,) and recv_k.is_contiguous() and recv_i.is_contiguous()
           and recv_i.device == dev, "sample_sort_merge: received lanes must be int64/int32 [m]")
    ensure(1 <= key_bits <= 63 and 0 <= seq_width < 64,
           f"sample_sort_merge: key_bits {key_bits}, seq_width {seq_width} out of range")
    if dev.type == "cpu":
        return ssm_merge_plain(recv_k, recv_i, key_bits, seq_width, do_dedup)
    _on_card(dev, "sample_sort_merge")
    if m == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
    out = torch.empty(m, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    nbytes = _build.kernel("sample_sort_merge", "ssm_merge_scratch_bytes",
                           [ctypes.c_int64, ctypes.c_int32], ctypes.c_int64)(m, key_bits)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = _build.kernel("sample_sort_merge", "ssm_merge_launch", _MERGE_ARGTYPES)
    _build.launch("sample_sort_merge", fn, dev, recv_k.data_ptr(), recv_i.data_ptr(), m,
                  key_bits, seq_width, int(do_dedup), out.data_ptr(), count.data_ptr(),
                  scratch.data_ptr())
    return out, count
