"""Segment downsample scan of the port: the packed route.

A port of `horaedb_tpu/storage/read.py::ParquetReader.
scan_segment_downsample` as the engine calls it (`packed_ok=True`): the
segment's runs are ordered by first key and concatenated; series keys map
to dense ids (`dense_sid`); the host packed pass filters, merges and
last-value dedups; the surviving (series, ts)-sorted rows reduce to grids
on the device (`ops/aggregate.py::downsample_sorted`, kernels B and C).

The other routes of the reference (the fused scan kernel when the packed
pass declines, and the chunked scan of a segment above `scan_block_rows`)
are not ported yet: they raise `NotPortedError` instead of running
anything else.
"""

from __future__ import annotations

import numpy as np

from horaedb_tpu_torch.backend import DEFAULT_DEVICE
from horaedb_tpu_torch.common.error import HoraeError
from horaedb_tpu_torch.ops import aggregate as agg_ops
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops.blocks import PACK_SENTINEL
from horaedb_tpu_torch.storage.config import UpdateMode
from horaedb_tpu_torch.storage.sst import SstFile
from horaedb_tpu_torch.storage.types import SEQ_COLUMN_NAME

# packed-key budget: sid | ts-offset | seq-rank must fit below bit 63
PACK_SID_BITS = 17
PACK_TS_BITS = 34   # ~198 days of ms offsets within one scan
PACK_SEQ_BITS = 12  # distinct write sequences per segment


class NotPortedError(HoraeError):
    """A route of the JAX package that this slice of the port lacks."""


def _order_by_first_key(tables: list[dict], sort_keys: tuple[str, ...]) -> list[dict]:
    """Order runs by their first row's sort key (each run is sorted)."""
    return sorted(tables, key=lambda t: tuple(int(t[k][0]) for k in sort_keys))


def packed_downsample_pass(lanes, predicate, sid, sid_valid, ts_column: str,
                           value_column: str, num_series: int, update_mode: UpdateMode):
    """(dense sid, ts, seq-rank) packed into one u64 per row; the predicate
    evaluates on the host, rejected rows sink to PACK_SENTINEL, one stable
    argsort merges, and the last row of each (sid, ts) group among the
    surviving rows wins (highest seq-rank). Returns (ts, sid, values) as
    sorted, deduped host lanes, or None when a budget is exceeded (too
    many series, write sequences or ms of span) or in append mode.

    Dedup is by (sid, ts), not the full primary key: the caller pins every
    other primary-key column (the engine pins metric_id with an eq
    predicate; field_id is constant)."""
    if update_mode != UpdateMode.OVERWRITE:
        return None
    if num_series >= (1 << PACK_SID_BITS):
        return None
    ts_np = lanes[ts_column]
    n = len(ts_np)
    if n == 0:
        return (np.empty(0, np.int64),) * 3
    seq_np = lanes[SEQ_COLUMN_NAME]
    uniq_seq = np.unique(seq_np)
    if len(uniq_seq) > (1 << PACK_SEQ_BITS):
        return None
    ts_min = int(ts_np.min())
    if int(ts_np.max()) - ts_min >= (1 << PACK_TS_BITS):
        return None
    mask = sid_valid.copy()
    if predicate is not None:
        mask &= filter_ops.eval_predicate_np(predicate, lanes)
    srank = (
        np.searchsorted(uniq_seq, seq_np).astype(np.uint64)
        if len(uniq_seq) > 1 else np.zeros(n, np.uint64)
    )
    shift_ts = np.uint64(PACK_SEQ_BITS)
    shift_sid = np.uint64(PACK_SEQ_BITS + PACK_TS_BITS)
    packed = (
        (sid.astype(np.int64).astype(np.uint64) << shift_sid)
        | ((ts_np - ts_min).astype(np.uint64) << shift_ts)
        | srank
    )
    packed = np.where(mask, packed, PACK_SENTINEL)
    perm = np.argsort(packed, kind="stable")
    packed_s = packed[perm]
    group = packed_s >> shift_ts
    keep = np.empty(n, dtype=bool)
    keep[:-1] = group[:-1] != group[1:]
    keep[-1] = True
    keep &= packed_s != PACK_SENTINEL
    idx = perm[keep]
    return ts_np[idx], sid[idx].astype(np.int32), lanes[value_column][idx]


def scan_segment_downsample(
    storage,
    ssts: list[SstFile],
    predicate,
    ts_column: str,
    value_column: str,
    series_column: str,
    series_ids: np.ndarray,
    t0: int,
    bucket_ms: int,
    num_buckets: int,
    with_minmax: bool = True,
    device=DEFAULT_DEVICE,
) -> dict[str, np.ndarray]:
    """Reduce one segment's runs to host [num_series, num_buckets] grids of
    sum and count (plus min/max when `with_minmax`; no mean: callers derive
    it after folding segments). `series_ids` is SORTED; output row i is
    series_ids[i], rows of other series drop."""
    num_series = len(series_ids)
    grids = {
        "sum": np.zeros((num_series, num_buckets)),
        "count": np.zeros((num_series, num_buckets)),
    }
    if with_minmax:
        grids["min"] = np.full((num_series, num_buckets), np.inf)
        grids["max"] = np.full((num_series, num_buckets), -np.inf)

    def dense_sid(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(dense position, hit mask). Misses keep their monotone
        searchsorted position, not -1, and are excluded by the mask."""
        pos = np.searchsorted(series_ids, col)
        pos_c = np.clip(pos, 0, max(0, num_series - 1))
        hit = series_ids[pos_c] == col
        return pos_c.astype(np.int32), hit

    total_rows = sum(s.meta.num_rows for s in ssts)
    if total_rows > storage.config.scan_block_rows and len(ssts) > 1:
        raise NotPortedError(
            f"not ported yet: chunked scan path ({total_rows} rows in "
            f"{len(ssts)} runs exceed scan_block_rows="
            f"{storage.config.scan_block_rows})"
        )
    tables = [t for t in (storage.read_run(s) for s in ssts) if len(t[ts_column])]
    if not tables:
        return grids
    schema = storage.schema
    tables = _order_by_first_key(tables, tuple(schema.primary_key_names) + (SEQ_COLUMN_NAME,))
    lanes = {name: np.concatenate([t[name] for t in tables]) for name in schema.names}
    sid, sid_hit = dense_sid(lanes[series_column])
    fast = packed_downsample_pass(lanes, predicate, sid, sid_hit, ts_column,
                                  value_column, num_series, storage.config.update_mode)
    if fast is None:
        raise NotPortedError(
            "not ported yet: fused scan path (the packed pass declined: "
            "append mode, or a series / sequence / time-span budget exceeded)"
        )
    ts_s, sid_s, val_s = fast
    if len(ts_s):
        out = agg_ops.downsample_sorted(
            ts_s, sid_s, val_s, t0, bucket_ms, num_series=num_series,
            num_buckets=num_buckets, with_minmax=with_minmax, device=device,
        )
        grids["sum"] += out["sum"].cpu().numpy()
        grids["count"] += out["count"].cpu().numpy()
        if with_minmax:
            grids["min"] = np.minimum(grids["min"], out["min"].cpu().numpy())
            grids["max"] = np.maximum(grids["max"], out["max"].cpu().numpy())
    return grids
