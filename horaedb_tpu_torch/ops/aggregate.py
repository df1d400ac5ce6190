"""Segment reductions: time-bucket downsample and grouped stats.

A port of `horaedb_tpu/ops/aggregate.py`:
- `downsample_sorted`: rows sorted by (series, ts) map to the flat cell id
  `sid * num_buckets + bucket`, which is monotone over that order, and the
  sorted-segment reductions (ops/blockagg.py, behind the calibrated
  dispatcher of ops/agg_registry.py) reduce each cell's run;
- `grouped_stats` (kernel `grouped_stats`) and `downsample` (kernel
  `downsample`) over UNSORTED rows, the fused scan route's reduction:
  `csrc/grouped_stats.cu` (with `csrc/onesweep.cuh`'s sort) on CUDA
  tensors, the plain versions beside them (`masked_segment_stats`,
  `masked_minmax`, index_add_ and scatter_reduce) on CPU ones;
- `stacked_downsample` (kernel `stacked_downsample`, grouped_stats'
  library computing the cell ids in its key pass): the grids of a stack of
  coalesced queries in one launch, the query batcher's device lane;
- `lane_segment_sum_count` (kernel `lane_sum_count`, `csrc/
  lane_sum_count.cu`): the dispatcher's `lanes` lane, f32;
- `segment_last_value` (kernel `segment_last_value`, `csrc/
  segment_last_value.cu`): the value of each segment's max-seq row.
Float values accumulate in f64 on the card: the H100 has native FP64 and
the reduction is memory-bound (the JAX package's f32 rule was for the
TPU's lack of FP64). Integer values sum exactly in 64 bits: signed in
int64, unsigned in uint64 (carried as int64 bits, `unsigned=True`), with a
count of the same type; their min and max come back as f64, as the JAX
package promotes them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device, to_device
from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import _build
from horaedb_tpu_torch.ops.blockagg import (
    fold_sums,
    sorted_segment_min_max,
    sorted_segment_sum_count,
)


def bucket_of(ts: torch.Tensor, t0: int, bucket_ms: int) -> torch.Tensor:
    """Time-bucket index relative to t0, floor division (a row just before
    t0 lands in bucket -1, not 0), as int32."""
    return torch.div(ts - t0, bucket_ms, rounding_mode="floor").to(torch.int32)


def downsample_sorted(
    ts: np.ndarray,
    series_idx: np.ndarray,
    values: np.ndarray,
    t0: int,
    bucket_ms: int,
    num_series: int,
    num_buckets: int,
    with_minmax: bool = True,
    valid: np.ndarray | None = None,
    device=DEFAULT_DEVICE,
) -> dict[str, torch.Tensor]:
    """[num_series, num_buckets] grids of sum, count, mean (and min, max)
    over host rows sorted by (series, ts), computed on `device`.

    The calibrated dispatcher (ops/agg_registry.py) is asked once and its
    choice goes to both reductions, so a dispatch counts once. When it
    names a host lane (on the CPU only, by calibration or a pin; the
    dispatcher refuses a host pin for the card), the whole grid computes in
    `host_downsample_sorted`.

    Otherwise the rows `valid` (optional bool) excludes leave on the host,
    before the upload: an excluded row of a series outside the query
    carries the clipped index of its neighbour, and kernels B and C need
    nondecreasing cell ids. The rows outside the grid (bucket < 0 or >=
    num_buckets, sid < 0 or >= num_series) leave on the device, before the
    reduction, when there are any (the engine's scans pass none). So each
    cell's run holds exactly its in-grid rows in row order, as the query
    batcher's stacked lane does: a cell's sum is bitwise equal to its
    stacked run's. Empty cells: sum and count 0, mean NaN, min +inf, max
    -inf."""
    from horaedb_tpu_torch.ops import agg_registry

    dev = resolve_device(device)
    num_cells = num_series * num_buckets
    ensure(num_series > 0 and num_buckets > 0, "empty grid")
    ensure(num_cells < 2**31, f"grid of {num_cells} cells exceeds int32 cell ids")
    choice = agg_registry.choose_sorted(len(values), num_cells, device=dev)
    if agg_registry.is_host_impl(choice):
        out = agg_registry.host_downsample_sorted(
            ts, series_idx, values, t0, bucket_ms, num_series=num_series,
            num_buckets=num_buckets, with_minmax=with_minmax, valid=valid, impl=choice)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in out.items()}
    if valid is not None:
        keep = np.asarray(valid, dtype=bool)
        ts, series_idx, values = (np.asarray(a)[keep] for a in (ts, series_idx, values))
    ts_t = to_device(np.asarray(ts, dtype=np.int64), dev)
    sid_t = to_device(np.asarray(series_idx, dtype=np.int32), dev)
    val_t = to_device(np.asarray(values, dtype=np.float64), dev)
    bucket = bucket_of(ts_t, t0, bucket_ms)
    ok = (bucket >= 0) & (bucket < num_buckets) & (sid_t >= 0) & (sid_t < num_series)
    if not bool(ok.all()):
        bucket, sid_t, val_t = bucket[ok], sid_t[ok], val_t[ok]
    cell_t = sid_t * num_buckets + bucket
    s, c = sorted_segment_sum_count(cell_t, val_t, num_cells, impl=choice)
    shape = (num_series, num_buckets)
    out = {"sum": s.reshape(shape), "count": c.reshape(shape), "mean": (s / c).reshape(shape)}
    if with_minmax:
        mn, mx = sorted_segment_min_max(cell_t, val_t, num_cells, impl=choice)
        out["min"] = mn.reshape(shape)
        out["max"] = mx.reshape(shape)
    return out


# -- grouped_stats and downsample over unsorted rows ---------------------------

KIND_F64, KIND_I64, KIND_U64 = 0, 1, 2


def _value_lane(values: torch.Tensor, unsigned: bool) -> tuple[torch.Tensor, int]:
    """Values as the reduction's accumulator lane: floats as f64, integers
    and bools as int64 (`unsigned`: the int64 bits are a uint64 lane)."""
    if values.dtype.is_floating_point:
        return values.to(torch.float64), KIND_F64
    ensure(not values.dtype.is_complex, f"unsupported value dtype {values.dtype}")
    return values.to(torch.int64), KIND_U64 if unsigned else KIND_I64


def to_f64(t: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """An accumulator lane as f64, rounded once to nearest: an unsigned lane
    splits into 32-bit halves (each exact in f64), so one addition rounds."""
    if t.dtype == torch.float64 or not unsigned:
        return t.to(torch.float64)
    hi = torch.bitwise_and(torch.bitwise_right_shift(t, 32), 0xFFFFFFFF)
    lo = torch.bitwise_and(t, 0xFFFFFFFF)
    return hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)


def masked_cell_keys(series_idx: torch.Tensor, bucket: torch.Tensor, ok: torch.Tensor,
                     num_series: int, num_buckets: int):
    """Cell ids shared by the downsample paths: (safe, flat). `safe` keeps a
    masked row at an in-range id (clipped series and bucket, so ids stay
    monotone in (series, ts) order and sorted runs stay whole; its mask
    rides the weight column) and feeds sum/count; `flat` sends it to the
    num_cells sentinel (drop semantics) and feeds min/max. The plain form
    of the mesh step's key kernel (`ops/mesh.py::sharded_keys`)."""
    safe = (torch.clamp(series_idx.to(torch.int32), 0, num_series - 1) * num_buckets
            + torch.clamp(bucket, 0, num_buckets - 1)).to(torch.int32)
    flat = torch.where(ok, safe, torch.full_like(safe, num_series * num_buckets))
    return safe, flat


def masked_minmax(values: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                  num_segments: int):
    """Scatter min/max per segment of f64 `values`; `idx` routes invalid rows
    to num_segments, which is dropped. NaN propagates (scatter_reduce
    amin/amax); empty segments read +inf / -inf."""
    i = idx.long()
    m = num_segments + 1
    mn = torch.full((m,), torch.inf, dtype=torch.float64, device=values.device)
    mx = torch.full((m,), -torch.inf, dtype=torch.float64, device=values.device)
    mn.scatter_reduce_(0, i, torch.where(valid, values, torch.inf), "amin", include_self=True)
    mx.scatter_reduce_(0, i, torch.where(valid, values, -torch.inf), "amax", include_self=True)
    return mn[:-1], mx[:-1]


def masked_segment_stats(values: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                         num_segments: int, with_minmax: bool = True, unsigned: bool = False):
    """(sum, count, min|None, max|None) per segment, by index_add_ and
    scatter_reduce; `idx` must already route invalid rows to num_segments.
    Sums and counts keep the accumulator lane's type (`_value_lane`); f64
    sums are associated as the kernel associates them (`fold_sums`),
    integer sums wrap in any order."""
    vals, _ = _value_lane(values, unsigned)
    i = idx.long()
    m = num_segments + 1
    masked = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype))
    s = (fold_sums(masked, i, m) if vals.dtype.is_floating_point else
         torch.zeros(m, dtype=vals.dtype, device=vals.device).index_add_(0, i, masked))[:-1]
    c = torch.zeros(m, dtype=vals.dtype, device=vals.device).index_add_(
        0, i, valid.to(vals.dtype))[:-1]
    if not with_minmax:
        return s, c, None, None
    mn, mx = masked_minmax(to_f64(vals, unsigned), idx, valid, num_segments)
    return s, c, mn, mx


def grouped_stats_plain(values, index, valid, num_segments: int, unsigned: bool = False):
    """Plain version of kernel `grouped_stats`: the masked scatters."""
    ok = valid.bool() & (index >= 0) & (index < num_segments)
    idx = torch.where(ok, index.long(), num_segments)
    s, c, mn, mx = masked_segment_stats(values, idx, ok, num_segments, unsigned=unsigned)
    return {"sum": s, "count": c, "min": mn, "max": mx,
            "mean": to_f64(s, unsigned) / to_f64(c, unsigned)}


def _check_rows(name: str, n: int, dev, **lanes) -> None:
    for lname, t in lanes.items():
        if not (t.dim() == 1 and t.shape[0] == n and t.is_contiguous() and t.device == dev):
            raise HoraeError(f"{name}: {lname} must be a contiguous 1-D lane of {n} rows on "
                             f"{dev}, got {t.dtype}{tuple(t.shape)} on {t.device}")


_STATS = ("sum", "count", "min", "max", "mean")
_GROUPED_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def grouped_stats(values: torch.Tensor, index: torch.Tensor, valid: torch.Tensor | None,
                  num_segments: int, unsigned: bool = False) -> dict[str, torch.Tensor]:
    """sum / count / min / max / mean per segment over unsorted `index`
    (int32 or int64). Ids outside [0, num_segments) drop regardless of
    `valid` (bool or uint8; None keeps every row). Empty segments: count 0,
    sum 0, min +inf, max -inf, mean NaN. Kernel `grouped_stats` on CUDA
    tensors, `grouped_stats_plain` on CPU ones."""
    n = index.shape[0]
    dev = index.device
    _check_rows("grouped_stats", n, dev, values=values, index=index,
                **({} if valid is None else {"valid": valid}))
    ensure(index.dtype in (torch.int32, torch.int64), f"grouped_stats: index is {index.dtype}")
    ensure(valid is None or valid.dtype in (torch.bool, torch.uint8),
           f"grouped_stats: valid is {valid.dtype if valid is not None else None}")
    ensure(0 <= num_segments < 2**62, f"grouped_stats: {num_segments} segments")
    if dev.type == "cpu":
        ok = torch.ones(n, dtype=torch.bool) if valid is None else valid
        return grouped_stats_plain(values, index, ok, num_segments, unsigned)
    if dev.type != "cuda":
        raise HoraeError(f"grouped_stats: unsupported device {dev}")
    ensure(n < 2**31, f"grouped_stats: {n} rows exceed int32 row indices")
    ensure(num_segments < 2**32, f"grouped_stats: {num_segments} segments exceed the "
           "kernel's u32 keys (and the card: 40 B of outputs a segment)")
    return grouped_stats_cuda(values, index, valid, num_segments, unsigned)[0]


def grouped_stats_cuda(values, index, valid, num_segments: int, unsigned: bool = False):
    """Kernel `grouped_stats` on checked CUDA lanes: (flat grids, the
    launch's scratch, for `took_presorted_path`)."""
    n = index.shape[0]
    return _stats_call("grouped_stats", "grouped_stats_launch", _GROUPED_ARGTYPES, values,
                       unsigned, (index.data_ptr(), int(index.dtype == torch.int64),
                                  0 if valid is None else valid.data_ptr(), n, num_segments),
                       n, num_segments, index.device)


def _stats_call(name: str, fn_name: str, argtypes: list, values: torch.Tensor, unsigned: bool,
                lanes: tuple, n: int, cells: int, dev) -> tuple[dict, torch.Tensor]:
    """Launch an entry of grouped_stats' library, fn(values, kind, *lanes,
    the five outputs, scratch, stream), and count it under `name`. Returns
    the flat grids and the scratch."""
    vals, kind = _value_lane(values, unsigned)
    out = {k: torch.empty(cells, dtype=vals.dtype if k in ("sum", "count") else torch.float64,
                          device=dev) for k in _STATS}
    scratch = torch.empty(_build.scratch_bytes("grouped_stats", "grouped_stats_scratch_bytes", n),
                          dtype=torch.uint8, device=dev)
    fn = _build.kernel(name, fn_name, argtypes)
    _build.launch(name, fn, dev, vals.data_ptr(), kind, *lanes,
                  *(out[k].data_ptr() for k in _STATS), scratch.data_ptr())
    return out, scratch


def took_presorted_path(scratch: torch.Tensor, n: int) -> bool:
    """Whether the grouped_stats launch over n rows (n > 0, at least one
    segment) that used `scratch` found its kept rows in cell order and took
    the partition instead of the digit passes (csrc/onesweep.cuh). Reads
    the card."""
    off = _build.kernel("grouped_stats", "grouped_stats_flag_offset", [ctypes.c_int64],
                        ctypes.c_int64)(n)
    return bool(scratch[off:off + 4].view(torch.int32).item())


def downsample_plain(ts, series_idx, values, valid, t0: int, bucket_ms: int, num_series: int,
                     num_buckets: int, unsigned: bool = False) -> dict[str, torch.Tensor]:
    """Plain version of kernel `downsample` (flat [cells] grids)."""
    bucket = bucket_of(ts, t0, bucket_ms)
    in_grid = (valid.bool() & (bucket >= 0) & (bucket < num_buckets)
               & (series_idx >= 0) & (series_idx < num_series))
    flat = series_idx.to(torch.int32) * num_buckets + bucket
    return grouped_stats_plain(values, flat, in_grid, num_series * num_buckets, unsigned)


_DOWNSAMPLE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]


def downsample(ts: torch.Tensor, series_idx: torch.Tensor, values: torch.Tensor,
               valid: torch.Tensor | None, t0: int, bucket_ms: int, num_series: int,
               num_buckets: int, unsigned: bool = False) -> dict[str, torch.Tensor]:
    """Per-(series, bucket) stats as [num_series, num_buckets] grids over
    unsorted rows: bucket = floor((ts - t0) / bucket_ms), and a row counts
    when `valid` (None: every row) and its series and bucket are in the
    grid. On CUDA tensors grouped_stats' library computes the cell ids in
    its key pass (kernel `downsample`) and reduces them (kernel
    `grouped_stats`), one launch counted under each name; on CPU tensors
    `downsample_plain`."""
    n = ts.shape[0]
    dev = ts.device
    _check_rows("downsample", n, dev, ts=ts, series_idx=series_idx, values=values,
                **({} if valid is None else {"valid": valid}))
    ensure(ts.dtype == torch.int64 and series_idx.dtype == torch.int32,
           f"downsample: ts must be int64 and series_idx int32, got {ts.dtype}, "
           f"{series_idx.dtype}")
    ensure(valid is None or valid.dtype in (torch.bool, torch.uint8),
           f"downsample: valid is {valid.dtype if valid is not None else None}")
    ensure(bucket_ms > 0, f"downsample: bucket_ms must be positive, got {bucket_ms}")
    cells = num_series * num_buckets
    ensure(num_series >= 0 and num_buckets >= 0 and cells < 2**31,
           f"downsample: grid of {num_series} x {num_buckets} exceeds int32 cell ids")
    shape = (num_series, num_buckets)
    if dev.type == "cpu":
        ok = torch.ones(n, dtype=torch.bool) if valid is None else valid
        flat = downsample_plain(ts, series_idx, values, ok, t0, bucket_ms, num_series,
                                num_buckets, unsigned)
        return {k: v.reshape(shape) for k, v in flat.items()}
    if dev.type != "cuda":
        raise HoraeError(f"downsample: unsupported device {dev}")
    ensure(n < 2**31, f"downsample: {n} rows exceed int32 row indices")
    out, _ = downsample_cuda(ts, series_idx, values, valid, t0, bucket_ms, num_series,
                             num_buckets, unsigned)
    return {k: v.reshape(shape) for k, v in out.items()}


def downsample_cuda(ts, series_idx, values, valid, t0: int, bucket_ms: int, num_series: int,
                    num_buckets: int, unsigned: bool = False):
    """Kernel `downsample` on checked CUDA lanes: (flat grids, the
    launch's scratch, for `took_presorted_path`). The call computes the
    cell ids (kernel downsample) and reduces them (kernel grouped_stats):
    it counts under both names."""
    n = ts.shape[0]
    out = _stats_call("downsample", "grouped_stats_downsample_launch", _DOWNSAMPLE_ARGTYPES,
                      values, unsigned,
                      (ts.data_ptr(), series_idx.data_ptr(),
                       0 if valid is None else valid.data_ptr(), t0, bucket_ms, num_series,
                       num_buckets, n), n, num_series * num_buckets, ts.device)
    _build.LAUNCHES["grouped_stats"] += 1
    return out


# -- stacked_downsample: the query batcher's device lane -----------------------

def stacked_downsample_plain(ts, series_idx, values, valid, t0, bucket_ms: int,
                             num_series: int, num_buckets: int) -> dict[str, torch.Tensor]:
    """Plain version of kernel `stacked_downsample`, the JAX function's
    arithmetic on [B, R] lanes: flat id `lane * S * T + sid * T + bucket`,
    rows outside their grid to the sentinel B * S * T, then the masked
    scatters (each cell's rows in row order, summed in the kernel's
    association, `fold_sums`)."""
    nb, cells = t0.shape[0], num_series * num_buckets
    bucket = torch.div(ts - t0[:, None], bucket_ms, rounding_mode="floor").to(torch.int32)
    ok = (valid.bool() & (bucket >= 0) & (bucket < num_buckets)
          & (series_idx >= 0) & (series_idx < num_series))
    lane = torch.arange(nb, dtype=torch.int64, device=ts.device)[:, None]
    safe = (torch.clamp(series_idx.long(), 0, num_series - 1) * num_buckets
            + torch.clamp(bucket.long(), 0, num_buckets - 1))
    flat = torch.where(ok, lane * cells + safe, nb * cells)
    s, c, mn, mx = masked_segment_stats(values.reshape(-1), flat.reshape(-1), ok.reshape(-1),
                                        nb * cells)
    shape = (nb, num_series, num_buckets)
    s, c = s.reshape(shape), c.reshape(shape)
    return {"sum": s, "count": c, "min": mn.reshape(shape), "max": mx.reshape(shape),
            "mean": s / c}


_STACKED_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def stacked_downsample(ts: torch.Tensor, series_idx: torch.Tensor, values: torch.Tensor,
                       valid: torch.Tensor, t0: torch.Tensor, bucket_ms: int, num_series: int,
                       num_buckets: int) -> dict[str, torch.Tensor]:
    """Downsample grids of a STACK of B coalesced queries in one launch:
    [B, R] row lanes (ts int64, series_idx int32, values f64, valid bool),
    a [B] int64 `t0` per query; [B, num_series, num_buckets] grids of sum,
    count, min, max and mean. Query b's cells take exactly its own in-grid
    rows in row order, so its grid is bitwise equal to its solo reduction.
    On CUDA tensors grouped_stats' library computes each row's cell id in
    its key pass (no id lane) and reduces them: one launch counted under
    `stacked_downsample` and under `grouped_stats`;
    `stacked_downsample_plain` on CPU ones."""
    dev = ts.device
    ensure(ts.dim() == 2, f"stacked_downsample: ts must be [B, R], got {tuple(ts.shape)}")
    b, r = ts.shape
    for name, t, dt in (("ts", ts, torch.int64), ("series_idx", series_idx, torch.int32),
                        ("values", values, torch.float64), ("valid", valid, torch.bool)):
        ensure(t.shape == (b, r) and t.dtype == dt and t.is_contiguous() and t.device == dev,
               f"stacked_downsample: {name} must be a contiguous {dt} [{b}, {r}] on {dev}, "
               f"got {t.dtype}{tuple(t.shape)} on {t.device}")
    ensure(t0.shape == (b,) and t0.dtype == torch.int64 and t0.is_contiguous()
           and t0.device == dev,
           f"stacked_downsample: t0 must be a contiguous int64 [{b}] on {dev}")
    ensure(bucket_ms > 0, f"stacked_downsample: bucket_ms must be positive, got {bucket_ms}")
    cells = num_series * num_buckets
    ensure(num_series > 0 and num_buckets > 0 and b * cells < 2**31,
           f"stacked_downsample: {b} x {num_series} x {num_buckets} cells exceed int32 ids")
    if dev.type == "cpu":
        return stacked_downsample_plain(ts, series_idx, values, valid, t0, bucket_ms,
                                        num_series, num_buckets)
    if dev.type != "cuda":
        raise HoraeError(f"stacked_downsample: unsupported device {dev}")
    ensure(r > 0, "stacked_downsample: empty row lanes")
    ensure(b * r < 2**31, f"stacked_downsample: {b} x {r} rows exceed int32 row indices")
    flat, _ = _stats_call("stacked_downsample", "grouped_stats_stacked_launch",
                          _STACKED_ARGTYPES, values, False,
                          (ts.data_ptr(), series_idx.data_ptr(), valid.data_ptr(),
                           t0.data_ptr(), bucket_ms, num_series, num_buckets, b, r),
                          b * r, b * cells, dev)
    _build.LAUNCHES["grouped_stats"] += 1
    shape = (b, num_series, num_buckets)
    return {k: v.reshape(shape) for k, v in flat.items()}


# -- lane_sum_count: the dispatcher's `lanes` lane ------------------------------

def lane_sum_count_plain(k, v, num_cells: int, lanes: int = 8, w=None):
    """Plain version of kernel `lane_sum_count`, the JAX function's
    arithmetic: ids clipped to [0, num_cells] (slot num_cells dropped), the
    first n - n % lanes rows as [lanes, n / lanes] partial grids by
    index_add_, summed in lane order, then the tail rows; f32 sums and
    counts."""
    n = k.shape[0]
    m = n - n % lanes
    dev = v.device
    kc = torch.clamp(k.long(), 0, num_cells)
    vf = v.to(torch.float32)
    wf = torch.ones_like(vf) if w is None else w.to(torch.float32)
    width = num_cells + 1

    def scatter(x, flat, parts: int) -> torch.Tensor:
        grids = torch.zeros(parts * width, dtype=torch.float32, device=dev).index_add_(0, flat, x)
        return grids.reshape(parts, width)[:, :num_cells]

    s = torch.zeros(num_cells, dtype=torch.float32, device=dev)
    c = torch.zeros(num_cells, dtype=torch.float32, device=dev)
    if m:
        flat = torch.arange(m, device=dev) // (m // lanes) * width + kc[:m]
        gs, gc = scatter(vf[:m], flat, lanes), scatter(wf[:m], flat, lanes)
        s, c = gs[0], gc[0]
        for lane in range(1, lanes):
            s, c = s + gs[lane], c + gc[lane]
    if m < n:
        s = s + scatter(vf[m:], kc[m:], 1)[0]
        c = c + scatter(wf[m:], kc[m:], 1)[0]
    return s, c


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.to(torch.float32)


_LANES_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2


def lane_segment_sum_count(k: torch.Tensor, v: torch.Tensor, num_cells: int,
                           w: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, count) per cell as f32, over unsorted int32 ids `k` and values
    `v` (cast to f32, as the JAX function casts them); ids clipped to
    [0, num_cells] (a negative id lands in cell 0, an id >= num_cells is
    dropped). `w` (optional) is each row's count contribution.
    `lane_sum_count_plain` on CPU tensors: the JAX function's eight partial
    grids summed in lane order, then the n % 8 tail rows. Kernel
    `lane_sum_count` on CUDA tensors: every row adds straight into the two
    grids (views of one [2, num_cells] allocation) with warp-grouped f32
    atomics, in no fixed order: sums within 2^-20 x each cell's L1 mass of the
    plain version's, counts of 0/1 weights exact up to 2^24 a cell."""
    n = k.shape[0]
    dev = k.device
    vf = _f32(v).contiguous()
    wf = None if w is None else _f32(w).contiguous()
    _check_rows("lane_sum_count", n, dev, k=k, v=vf, **({} if wf is None else {"w": wf}))
    if k.dtype != torch.int32:
        raise HoraeError(f"lane_sum_count: ids must be int32, got {k.dtype}")
    if not 0 <= num_cells < 2**31:
        raise HoraeError(f"lane_sum_count: num_cells {num_cells} outside [0, 2^31)")
    if dev.type == "cpu":
        return lane_sum_count_plain(k, vf, num_cells, w=wf)
    if dev.type != "cuda":
        raise HoraeError(f"lane_sum_count: unsupported device {dev}")
    out = vf.new_empty((2, num_cells))
    fn = _build.kernel("lane_sum_count", "lane_sum_count_launch", _LANES_ARGTYPES)
    _build.launch("lane_sum_count", fn, dev, k.data_ptr(), vf.data_ptr(),
                  None if wf is None else wf.data_ptr(), n, num_cells, out.data_ptr())
    return out.unbind(0)


# -- segment_last_value: dedup as a reduction ------------------------------------

_I64_MIN = -(2**63)


def seq_as_int64(seq: np.ndarray) -> np.ndarray:
    """A host seq lane as the JAX function reads it (`astype(int64)`): a u64
    seq of 2^63 or more wraps negative. Not the order-preserving bit-63 flip
    of `backend.order_key`."""
    seq = np.asarray(seq)
    return seq.view(np.int64) if seq.dtype == np.uint64 else seq.astype(np.int64)


def segment_last_value_plain(values, seq, index, valid, num_segments: int) -> torch.Tensor:
    """Plain version of kernel `segment_last_value`: two scatter_reduce amax
    passes (the max seq, then the latest position holding it) and a
    gather."""
    n = values.shape[0]
    dev = values.device
    out = torch.full((num_segments,), torch.nan, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    ok = valid.bool() & (index >= 0) & (index < num_segments)
    idx = torch.where(ok, index.long(), num_segments)
    low = torch.full((num_segments + 1,), _I64_MIN, dtype=torch.int64, device=dev)
    max_seq = low.scatter_reduce(0, idx, torch.where(ok, seq, _I64_MIN), "amax",
                                 include_self=True)
    winner = ok & (seq == max_seq[idx])
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    best = torch.full((num_segments + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, idx, torch.where(winner, pos, -1), "amax", include_self=True)[:-1]
    return torch.where(best >= 0, values[best.clamp(0, n - 1)], out)


_SLV_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def segment_last_value(values: torch.Tensor, seq: torch.Tensor, index: torch.Tensor,
                       valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per segment, the value of the valid row with the largest seq (ties
    to the latest position), NaN for a segment no valid row reaches. Rows
    with an index outside [0, num_segments) drop. values f64, seq int64
    (a u64 seq through `seq_as_int64`), index int32, valid bool or uint8.
    Kernel `segment_last_value` on CUDA tensors,
    `segment_last_value_plain` on CPU ones; the outputs' bits are the
    winners' bits either way."""
    n = values.shape[0]
    dev = values.device
    _check_rows("segment_last_value", n, dev, values=values, seq=seq, index=index, valid=valid)
    for name, t, dts in (("values", values, (torch.float64,)), ("seq", seq, (torch.int64,)),
                         ("index", index, (torch.int32,)),
                         ("valid", valid, (torch.bool, torch.uint8))):
        ensure(t.dtype in dts, f"segment_last_value: {name} is {t.dtype}")
    ensure(0 <= num_segments < 2**31, f"segment_last_value: {num_segments} segments")
    if dev.type == "cpu":
        return segment_last_value_plain(values, seq, index, valid, num_segments)
    if dev.type != "cuda":
        raise HoraeError(f"segment_last_value: unsupported device {dev}")
    out = torch.empty(num_segments, dtype=torch.float64, device=dev)
    scratch = torch.empty(
        _build.scratch_bytes("segment_last_value", "segment_last_value_scratch_bytes",
                             num_segments), dtype=torch.uint8, device=dev)
    fn = _build.kernel("segment_last_value", "segment_last_value_launch", _SLV_ARGTYPES)
    _build.launch("segment_last_value", fn, dev, values.data_ptr(), seq.data_ptr(),
                  index.data_ptr(), valid.data_ptr(), n, num_segments, scratch.data_ptr(),
                  out.data_ptr())
    return out
