"""Time-bucket downsample over rows sorted by (series, ts).

A port of `horaedb_tpu/ops/aggregate.py::downsample_sorted` and its
helpers: rows map to the flat cell id `sid * num_buckets + bucket`, which
is monotone over the scan's (series, ts) order, and the sorted-segment
kernels (ops/blockagg.py) reduce each cell's run. Values accumulate in f64
on the card: the H100 has native FP64 and the reduction is memory-bound
(the JAX package's f32 rule was for the TPU's lack of FP64).
"""

from __future__ import annotations

import numpy as np
import torch

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device, to_device
from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.ops.blockagg import sorted_segment_min_max, sorted_segment_sum_count


def bucket_of(ts: torch.Tensor, t0: int, bucket_ms: int) -> torch.Tensor:
    """Time-bucket index relative to t0, floor division (a row just before
    t0 lands in bucket -1, not 0), as int32."""
    return torch.div(ts - t0, bucket_ms, rounding_mode="floor").to(torch.int32)


def masked_cell_keys(series_idx, bucket, num_series: int, num_buckets: int) -> torch.Tensor:
    """Flat cell ids with both parts clipped into range BEFORE they combine,
    so masked rows keep an in-range id and the ids stay monotone in
    (sid, ts); masked rows contribute through the weight / valid lanes."""
    sid = torch.clamp(series_idx.to(torch.int32), 0, num_series - 1)
    return sid * num_buckets + torch.clamp(bucket, 0, num_buckets - 1)


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

    `valid` (optional bool) excludes rows without breaking the sorted runs:
    excluded rows keep a monotone `series_idx`. Empty cells: sum and count
    0, mean NaN, min +inf, max -inf."""
    dev = resolve_device(device)
    num_cells = num_series * num_buckets
    ensure(num_series > 0 and num_buckets > 0, "empty grid")
    ensure(num_cells < 2**31, f"grid of {num_cells} cells exceeds int32 cell ids")
    ts_t = to_device(np.asarray(ts, dtype=np.int64), dev)
    sid_t = to_device(np.asarray(series_idx, dtype=np.int32), dev)
    val_t = to_device(np.asarray(values, dtype=np.float64), dev)
    bucket = bucket_of(ts_t, t0, bucket_ms)
    ok = (bucket >= 0) & (bucket < num_buckets) & (sid_t >= 0) & (sid_t < num_series)
    if valid is not None:
        ok &= to_device(np.asarray(valid, dtype=bool), dev)
    safe = masked_cell_keys(sid_t, bucket, num_series, num_buckets)
    s, c = sorted_segment_sum_count(
        safe, torch.where(ok, val_t, 0.0), num_cells, weights=ok.to(torch.float64)
    )
    shape = (num_series, num_buckets)
    out = {"sum": s.reshape(shape), "count": c.reshape(shape), "mean": (s / c).reshape(shape)}
    if with_minmax:
        mn, mx = sorted_segment_min_max(safe, val_t, num_cells, valid=ok)
        out["min"] = mn.reshape(shape)
        out["max"] = mx.reshape(shape)
    return out
