"""SampleManager: sample persistence + the device-side query pipeline.

A port of the JAX package's `engine/data.py`: raw sample rows land in the
`data` table, one storage write per touched time segment, and queries run
the storage scan with (metric_id eq + TSID set-membership + time range)
predicates followed by the aggregation on the storage's device.

- `persist` writes every call through (`buffer_rows=0`, the JAX default);
  the memtable, its flush executor and the native accumulator are not
  ported, and the engine refuses `ingest_buffer_rows > 0`.
- `query_downsample` is the query batcher's dispatch point
  (`_query_downsample_cold`, `server/batching.py`): aligned grid queries
  with concurrent company coalesce into one `stacked_downsample` launch;
  the rest run the solo per-segment pushdown, whose grids fold in segment
  order.
- The serving tier (result cache, rollups) is not ported, so every query
  is cold; the engine refuses an active tier.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common import deadline as deadline_ctx
from horaedb_tpu_torch.common.aio import TaskGroup
from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.engine.tables import DATA_SCHEMA
from horaedb_tpu_torch.ops import aggregate as agg_ops
from horaedb_tpu_torch.ops import filter as F
from horaedb_tpu_torch.storage import scanstats
from horaedb_tpu_torch.storage.types import ScanRequest, TimeRange, WriteRequest

logger = logging.getLogger(__name__)

# Above this series cardinality the dense pushdown grid (num_series x
# num_buckets x 4 stats) and the device membership probe stop paying off;
# fall back to materializing + np.unique sizing by the rows actually in range.
MAX_PUSHDOWN_SERIES = 65_536

# Resolution guard: a downsample query must not demand an absurd number of
# buckets (start=0, bucket=1m would be a ~30M-bucket grid per series) —
# reject loudly, like Prometheus's max-resolution limit.
MAX_BUCKETS = 100_000

# In-flight per-segment pushdown scans PER SampleManager (shared across
# concurrent queries — a dashboard burst cannot multiply it).
SEGMENT_SCAN_CONCURRENCY = 4


class SampleManager:
    def __init__(self, storage, segment_duration_ms: int):
        self._storage = storage
        self._segment_duration = segment_duration_ms
        # observability identity (the storage root)
        self._table_id = getattr(storage, "_root", None) or "data"
        # shared bound for concurrent segment-pushdown scans (lazy: binds
        # the running loop)
        self._scan_sem: "asyncio.Semaphore | None" = None

    async def persist(
        self,
        metric_ids: np.ndarray,  # u64 per sample
        tsids: np.ndarray,       # u64 per sample
        ts: np.ndarray,          # i64 ms per sample
        values: np.ndarray,      # f64 per sample
    ) -> None:
        """One storage write per touched segment, rows sorted by the write
        path (kernel A on the card)."""
        if len(ts) == 0:
            return
        seg = ts - (ts % self._segment_duration)
        uniq = np.unique(seg)
        for seg_start in uniq:
            m = seg == seg_start if len(uniq) > 1 else slice(None)
            await self._write_segment(metric_ids[m], tsids[m], ts[m], values[m])

    async def _write_segment(self, metric_ids, tsids, ts, values) -> None:
        batch = pa.RecordBatch.from_arrays(
            [pa.array(np.asarray(metric_ids, dtype=np.uint64)),
             pa.array(np.asarray(tsids, dtype=np.uint64)),
             pa.array(np.zeros(len(ts), dtype=np.uint64)),
             pa.array(np.asarray(ts, dtype=np.int64)),
             pa.array(np.asarray(values, dtype=np.float64))],
            schema=DATA_SCHEMA,
        )
        lo = int(ts.min())
        hi = int(ts.max()) + 1
        await self._storage.write(WriteRequest(batch, TimeRange(lo, hi)))

    # -- queries ---------------------------------------------------------------
    def _predicate(self, metric_id: int, tsids: list[int] | None, rng: TimeRange):
        parts = [
            F.Compare("metric_id", "eq", metric_id),
            F.Compare("ts", "ge", rng.start),
            F.Compare("ts", "lt", rng.end),
        ]
        if tsids is not None:
            parts.append(F.InSet("tsid", tuple(tsids)))
        return F.And(*parts)

    async def query_raw(
        self,
        metric_id: int,
        tsids: list[int] | None,
        rng: TimeRange,
        limit: int | None = None,
    ) -> pa.Table | None:
        """Materialized (merged, deduped) sample rows. `limit` pushes down
        into the scan: later segments are never read once enough rows
        accumulated."""
        return await self._query_raw_cold(metric_id, tsids, rng, limit)

    async def _query_raw_cold(
        self,
        metric_id: int,
        tsids: list[int] | None,
        rng: TimeRange,
        limit: int | None = None,
    ) -> pa.Table | None:
        from contextlib import aclosing

        batches = []
        total = 0
        # aclosing: an early break must run the generator's finally NOW so
        # the prefetched next-segment read is cancelled deterministically
        async with aclosing(self._storage.scan(
            ScanRequest(range=rng, predicate=self._predicate(metric_id, tsids, rng))
        )) as gen:
            async for b in gen:
                if limit is not None and total + b.num_rows >= limit:
                    batches.append(b.slice(0, limit - total))
                    total = limit
                    break
                batches.append(b)
                total += b.num_rows
        return pa.Table.from_batches(batches) if batches else None

    async def query_downsample(
        self,
        metric_id: int,
        tsids: list[int],
        rng: TimeRange,
        bucket_ms: int,
        filtered: bool = True,
    ) -> tuple[list[int], dict[str, np.ndarray]] | None:
        """Per-(series, bucket) sum/count/min/max/mean grids via aggregate
        PUSHDOWN: each segment reduces on the device inside the scan (raw
        rows never return to the host); per-segment partial grids combine
        because the data-table pk includes the timestamp, so duplicates
        cannot span segments. Returns (tsid order, grids), or None.

        Precision: f64 accumulation on the card and on the host, the JAX
        package's CPU contract.

        `filtered=False` means `tsids` is just the metric's full series set
        (no tag filter): the TSID membership predicate is skipped, and very
        high cardinalities fall back to the materializing path whose output
        is sized by the series actually present in range."""
        n_buckets = -(-(rng.end - rng.start) // bucket_ms)
        ensure(
            n_buckets <= MAX_BUCKETS,
            f"downsample resolution too high: {n_buckets} buckets "
            f"(max {MAX_BUCKETS}); narrow the range or coarsen bucket_ms",
        )
        return await self._query_downsample_cold(
            metric_id, tsids, rng, bucket_ms, int(n_buckets), filtered,
        )

    async def _query_downsample_cold(
        self,
        metric_id: int,
        tsids: list[int],
        rng: TimeRange,
        bucket_ms: int,
        num_buckets: int,
        filtered: bool,
    ) -> tuple[list[int], dict[str, np.ndarray]] | None:
        """One uncached downsample computation, and the query batcher's
        dispatch point (server/batching.py): a grid query with compatible
        concurrent company coalesces into ONE stacked kernel launch.

        Eligibility: grid/segment alignment (bucket_ms divides the segment
        duration AND rng.start is bucket-aligned) guarantees no bucket
        spans a segment boundary, so every cell accumulates rows of exactly
        one segment: the condition under which the stacked reduction is
        bitwise equal to the solo per-segment fold. Unaligned grids run
        solo. (The JAX package also sends rollup-covered queries solo; the
        port has no rollups.)

        Everything else (lone queries, short deadlines, oversized shapes,
        HORAEDB_BATCH=off) continues down the solo pushdown unchanged."""
        from horaedb_tpu_torch.server import batching

        ssts = self._storage.select_ssts(rng)
        if not ssts or not tsids:
            return None
        if len(tsids) > MAX_PUSHDOWN_SERIES:
            return await self._query_downsample_materialized(
                metric_id, tsids if filtered else None, rng, bucket_ms
            )
        series_ids = np.asarray(sorted(tsids), dtype=np.uint64)
        segments = self._storage.group_by_segment(ssts)
        batcher = batching.GLOBAL_BATCHER
        aligned = (
            self._segment_duration % bucket_ms == 0
            and rng.start % bucket_ms == 0
        )
        if not aligned:
            batcher.note_ineligible()
            return await self._query_downsample_pushdown(
                metric_id, series_ids, ssts, segments, rng, bucket_ms, num_buckets, filtered,
            )
        tok = batcher.begin()
        try:
            res = await batcher.coalesce(
                bucket_ms=bucket_ms, num_buckets=num_buckets,
                series_ids=series_ids, t0=rng.start, filtered=filtered,
                # same-(table, metric, range) members share ONE union
                # scan — the N-panels-one-dashboard case pays one read
                share_key=(self._table_id, metric_id, rng.start, rng.end),
                scan=lambda ids: self._batch_scan_rows(metric_id, rng, ids),
                device=self._storage.device,
            )
            if res is not batching.SOLO:
                grids, notes = res
                for k, n in (notes or {}).items():
                    if k == "batched_with":
                        scanstats.note_max(k, n)
                    else:
                        scanstats.note(k, n)
                if grids is None:
                    return None
                return [int(x) for x in series_ids], grids
            return await self._query_downsample_pushdown(
                metric_id, series_ids, ssts, segments, rng, bucket_ms, num_buckets, filtered,
            )
        finally:
            batcher.end(tok)

    async def _batch_scan_rows(
        self,
        metric_id: int,
        rng: TimeRange,
        tsids: "list[int] | None",
    ):
        """One batch scan's row materialization (runs in the group's
        detached context): the same merged/deduped rows a solo scan sees,
        as flat (ts i64, tsid u64, values f64) lanes, or None when nothing
        is in range. `tsids` may be the UNION of several members' series
        sets (batching.py de-multiplexes rows per member afterwards); None
        scans the whole metric."""
        table = await self._query_raw_cold(metric_id, tsids, rng)
        if table is None or table.num_rows == 0:
            return None
        return (
            table.column("ts").to_numpy().astype(np.int64, copy=False),
            table.column("tsid").to_numpy(),
            table.column("value").to_numpy().astype(np.float64, copy=False),
        )

    async def _query_downsample_pushdown(
        self,
        metric_id: int,
        series_ids: np.ndarray,
        ssts: list,
        segments: list,
        rng: TimeRange,
        bucket_ms: int,
        num_buckets: int,
        filtered: bool,
    ) -> tuple[list[int], dict[str, np.ndarray]] | None:
        """The solo per-segment device pushdown (the batcher's oracle).
        Per-segment passes run concurrently under a semaphore shared by
        every query of this manager; partials fold in SEGMENT order, not
        completion order (float addition is not associative), through a
        small reorder buffer. TaskGroup cancels + awaits siblings on the
        first error."""
        scanstats.note("ssts_selected", len(ssts))
        pred = self._predicate(
            metric_id, list(series_ids) if filtered else None, rng
        )
        if self._scan_sem is None:
            self._scan_sem = asyncio.Semaphore(SEGMENT_SCAN_CONCURRENCY)
        acc: dict[str, np.ndarray] | None = None
        pending: dict[int, dict[str, np.ndarray] | None] = {}
        next_fold = 0

        def _fold_one(part) -> None:
            nonlocal acc
            if part is None:
                return
            if acc is None:
                acc = part
            else:
                acc["sum"] = acc["sum"] + part["sum"]
                acc["count"] = acc["count"] + part["count"]
                acc["min"] = np.minimum(acc["min"], part["min"])
                acc["max"] = np.maximum(acc["max"], part["max"])

        def fold(idx: int, part) -> None:
            nonlocal next_fold
            pending[idx] = part
            while next_fold in pending:
                _fold_one(pending.pop(next_fold))
                next_fold += 1

        async def one_segment(seg, idx):
            async with self._scan_sem:
                # cooperative deadline: a segment pass acquired AFTER the
                # budget died must not read + reduce
                deadline_ctx.check("segment_scan")
                part = await self._storage.scan_segment_retrying(
                    seg, rng,
                    lambda fresh: self._storage.parquet_reader.scan_segment_downsample(
                        fresh,
                        predicate=pred,
                        ts_column="ts",
                        value_column="value",
                        series_column="tsid",
                        series_ids=series_ids,
                        t0=rng.start,
                        bucket_ms=bucket_ms,
                        num_buckets=num_buckets,
                        # data-table pk is (metric_id, tsid, field_id, ts):
                        # metric_id is eq-pinned in `pred`, field_id is
                        # constant 0, so the packed (sid, ts) dedup is exact
                        packed_ok=True,
                    ),
                )
            fold(idx, part)
            if part is not None:
                scanstats.note("raw_segments")

        async with TaskGroup() as tg:
            for idx, seg in enumerate(segments):
                tg.create_task(one_segment(seg, idx))
        if acc is None or acc["count"].sum() == 0:
            return None
        with np.errstate(invalid="ignore", divide="ignore"):
            acc["mean"] = acc["sum"] / acc["count"]
        return [int(x) for x in series_ids], acc

    async def _query_downsample_materialized(
        self,
        metric_id: int,
        tsids: list[int] | None,
        rng: TimeRange,
        bucket_ms: int,
    ) -> tuple[list[int], dict[str, np.ndarray]] | None:
        """High-cardinality fallback: materialize rows and size the output
        grid by np.unique of the series present in range (scan output is
        pk-ordered, so the sorted-segment kernels apply)."""
        table = await self._query_raw_cold(metric_id, tsids, rng)
        if table is None or table.num_rows == 0:
            return None
        t = table.column("ts").to_numpy()
        v = table.column("value").to_numpy()
        uniq, sid_dense = np.unique(table.column("tsid").to_numpy(), return_inverse=True)
        num_buckets = int(-(-(rng.end - rng.start) // bucket_ms))
        out = agg_ops.downsample_sorted(
            t, sid_dense.astype(np.int32), v, rng.start, bucket_ms,
            num_series=len(uniq), num_buckets=num_buckets, device=self._storage.device,
        )
        return [int(x) for x in uniq], {k: val.cpu().numpy() for k, val in out.items()}
