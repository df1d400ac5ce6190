"""The downsample query over one table: per-segment scans folded in segment order.

The storage-level form of the engine's solo pushdown
(`engine/data.py::_query_downsample_pushdown`, which the metric engine
runs with its semaphore, deadline checks and reorder buffer), for a caller
that holds a table and a predicate: each segment
of the selected SSTs reduces to grids
(`ParquetReader.scan_segment_downsample`: the packed route; the fused
route of kernels `scan_kernel`, `downsample` and `grouped_stats` where the
packed pass declines, as at 2^17 series or more; the chunked route above
`scan_block_rows`), and the host folds the grids in SEGMENT order, never
completion order, so the result is bitwise repeatable (float addition does
not reassociate).
"""

from __future__ import annotations

import numpy as np

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.storage.types import TimeRange


async def query_downsample(
    storage,
    series_ids: np.ndarray,
    time_range: TimeRange,
    bucket_ms: int,
    predicate,
    ts_column: str = "ts",
    value_column: str = "value",
    series_column: str = "tsid",
) -> dict[str, np.ndarray]:
    """[len(series_ids), num_buckets] host grids of sum, count, min, max and
    mean over `time_range` in `bucket_ms` buckets (bucket 0 starts at
    time_range.start), computed on the storage's device. `series_ids` must
    be sorted and unique. `predicate` must pin every primary-key column
    other than the series and time (the engine pins metric_id), since the
    packed pass dedups by (series, ts). Empty cells: sum and count 0, min
    +inf, max -inf, mean NaN."""
    ensure(bucket_ms > 0, f"bucket_ms must be positive, got {bucket_ms}")
    series_ids = np.asarray(series_ids)
    ensure(series_ids.ndim == 1 and len(series_ids) > 0, "series_ids must be a non-empty 1-D array")
    ensure(bool(np.all(series_ids[1:] > series_ids[:-1])), "series_ids must be sorted and unique")
    num_buckets = -(-(time_range.end - time_range.start) // bucket_ms)
    ensure(num_buckets > 0, "empty time range")
    shape = (len(series_ids), num_buckets)
    acc = {"sum": np.zeros(shape), "count": np.zeros(shape),
           "min": np.full(shape, np.inf), "max": np.full(shape, -np.inf)}
    reader = storage.parquet_reader
    for seg in storage.group_by_segment(storage.select_ssts(time_range)):
        part = await reader.scan_segment_downsample(
            seg, predicate, ts_column, value_column, series_column, series_ids,
            time_range.start, bucket_ms, num_buckets, packed_ok=True,
        )
        acc["sum"] = acc["sum"] + part["sum"]
        acc["count"] = acc["count"] + part["count"]
        acc["min"] = np.minimum(acc["min"], part["min"])
        acc["max"] = np.maximum(acc["max"], part["max"])
    with np.errstate(invalid="ignore", divide="ignore"):
        acc["mean"] = acc["sum"] / acc["count"]
    return acc
