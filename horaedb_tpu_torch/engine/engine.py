"""MetricEngine facade: Prometheus-shaped writes and queries end-to-end.

A port of the JAX package's `engine/engine.py`. Six ColumnarStorage
tables under one root ({root}/{metrics,series,index,tags,data,exemplars},
the JAX package's layout and schemas, so either package opens a root the
other wrote). The write path is the RFC pipeline: populate metric ids ->
populate series ids (registering new series + inverted index entries) ->
persist samples; the read path is index probe -> storage scan with the
device predicate -> device aggregation (solo, or coalesced by the query
batcher).

What the JAX engine does and the port refuses with `NotPortedError`
(never running something else in its place): an active serving tier (the
JAX default; pass `serving=ServingTierConfig(enabled=False)` or set
`HORAEDB_SERVING=off`), `enable_compaction=True` (the JAX default),
`ingest_buffer_rows > 0`, `max_series > 0`, `fence_node_id`,
`retention_period_ms`, `read_only`, and payloads carrying exemplars.
"""

from __future__ import annotations

import asyncio
import copy
import logging
from dataclasses import dataclass, field

import numpy as np

from horaedb_tpu_torch.backend import DEFAULT_DEVICE
from horaedb_tpu_torch.common import deadline as deadline_ctx
from horaedb_tpu_torch.common import tracing
from horaedb_tpu_torch.common.error import NotPortedError, ensure
from horaedb_tpu_torch.common.time_ext import now_ms
from horaedb_tpu_torch.engine import tables
from horaedb_tpu_torch.engine.data import SampleManager
from horaedb_tpu_torch.engine.index import SEEN_CACHE_MAX, IndexManager
from horaedb_tpu_torch.engine.metric import MetricManager
from horaedb_tpu_torch.ingest.cardinality import SeriesSketch
from horaedb_tpu_torch.ingest.types import ParsedWriteRequest
from horaedb_tpu_torch.ingest.wire_parser import WireParser
from horaedb_tpu_torch.objstore import ObjectStore
from horaedb_tpu_torch.server.metrics import GLOBAL_METRICS
from horaedb_tpu_torch.serving import ServingTier
from horaedb_tpu_torch.storage.config import ColumnOptions, StorageConfig
from horaedb_tpu_torch.storage.storage import ObjectBasedStorage
from horaedb_tpu_torch.storage.types import TimeRange

logger = logging.getLogger(__name__)

NAME_LABEL = b"__name__"

DEFAULT_SEGMENT_MS = 2 * 3600_000  # 2h data segments

SERIES_CARDINALITY = GLOBAL_METRICS.gauge(
    "horaedb_series_cardinality",
    help="HLL-sketch estimate of distinct (metric, tsid) series this "
         "table has ever ingested (ingest/cardinality.py; seeded from "
         "the index at open).",
    labelnames=("table",),
)


def sample_table_config(config: StorageConfig | None) -> StorageConfig:
    """Data/exemplars-table write config with the JAX engine's encoding
    defaults (parquet DELTA_BINARY_PACKED on the id and time lanes,
    BYTE_STREAM_SPLIT with zstd on `value`, each with enable_dict=False),
    so the port writes the JAX engine's SSTs. Explicit user column_options
    win."""
    cfg = copy.deepcopy(config) if config is not None else StorageConfig()
    opts = dict(cfg.write.column_options or {})
    defaults = {
        "metric_id": "DELTA_BINARY_PACKED",
        "tsid": "DELTA_BINARY_PACKED",
        "field_id": "DELTA_BINARY_PACKED",
        "ts": "DELTA_BINARY_PACKED",
        "value": "BYTE_STREAM_SPLIT",
    }
    for name, enc in defaults.items():
        opts.setdefault(name, ColumnOptions(
            enable_dict=False, encoding=enc,
            compression="zstd" if name == "value" else None,
        ))
    cfg.write.column_options = opts
    return cfg


@dataclass
class QueryRequest:
    metric: bytes
    start_ms: int
    end_ms: int
    filters: list[tuple[bytes, bytes]] = field(default_factory=list)
    # Prometheus-style extended matchers: (key, op, pattern) with op in
    # "ne" (!=), "re" (=~ full match), "nre" (!~)
    matchers: list[tuple[bytes, str, bytes]] = field(default_factory=list)
    bucket_ms: int | None = None  # None -> raw rows
    # raw-row limit pushed into the scan; ignored for bucketed queries
    limit: int | None = None
    # region restriction of the scatter-gather read: None = every region;
    # a list restricts `RegionedEngine.query_partial_grids` to those region
    # shards. Ignored by `query`.
    regions: "list[int] | None" = None


def _refuse_unported(serving, enable_compaction: bool, ingest_buffer_rows: int,
                     max_series: int, fence_node_id, retention_period_ms,
                     read_only: bool) -> ServingTier:
    tier = ServingTier(serving)
    asked = []
    if tier.active():
        asked.append("the serving tier (pass serving=ServingTierConfig(enabled=False) "
                     "or set HORAEDB_SERVING=off)")
    if enable_compaction:
        asked.append("compaction (pass enable_compaction=False)")
    if ingest_buffer_rows > 0:
        asked.append("buffered ingest (ingest_buffer_rows > 0)")
    if max_series > 0:
        asked.append("the series-cardinality limit (max_series > 0)")
    if fence_node_id is not None:
        asked.append("the epoch fence (fence_node_id)")
    if retention_period_ms is not None:
        asked.append("retention (retention_period_ms)")
    if read_only:
        asked.append("read-only replica views")
    if asked:
        raise NotPortedError("not ported yet: " + "; ".join(asked))
    return tier


class MetricEngine:
    def __init__(self) -> None:
        raise RuntimeError("use MetricEngine.open")

    @classmethod
    async def open(
        cls,
        root: str,
        store: ObjectStore,
        segment_duration_ms: int = DEFAULT_SEGMENT_MS,
        config: StorageConfig | None = None,
        enable_compaction: bool = True,
        ingest_buffer_rows: int = 0,
        fence_node_id: str | None = None,
        retention_period_ms: int | None = None,
        max_series: int = 0,
        serving=None,
        read_only: bool = False,
        device=DEFAULT_DEVICE,
    ) -> "MetricEngine":
        """Open (or create) the engine at `root` in `store`. The tables'
        sorts, merges and reductions run on `device` ("cuda" by default,
        which raises where there is no card; "cpu" runs the kernels' plain
        versions). The parameters the JAX engine has and the port lacks
        raise `NotPortedError` when asked for (module docstring)."""
        self = object.__new__(cls)
        self.serving = _refuse_unported(serving, enable_compaction, ingest_buffer_rows,
                                        max_series, fence_node_id, retention_period_ms,
                                        read_only)
        self._store = store
        self._segment_duration = segment_duration_ms
        self._table_label = root.strip("/")
        self._sketch = SeriesSketch()
        self._parser = WireParser()
        # raw label bytes of a series (ParsedWriteRequest.series_raw_keys)
        # -> (metric_id, tsid), filled only once the series is durably
        # registered: scrapers resend the same series every interval, so a
        # hit skips label decoding, hashing and the registration probes
        self._ids_by_key: dict[bytes, tuple[int, int]] = {}
        SERIES_CARDINALITY.labels(self._table_label).set(0)
        sample_cfg = sample_table_config(config)

        async def open_table(name, schema, num_pks):
            sample_table = name in ("data", "exemplars")
            return await ObjectBasedStorage.try_new(
                root=f"{root}/{name}",
                store=store,
                arrow_schema=schema,
                num_primary_keys=num_pks,
                segment_duration_ms=segment_duration_ms,
                config=sample_cfg if sample_table else config,
                enable_compaction_scheduler=False,
                device=device,
                time_column="ts" if sample_table else None,
            )

        self.metrics_table = await open_table(
            "metrics", tables.METRICS_SCHEMA, tables.METRICS_NUM_PKS)
        self.series_table = await open_table(
            "series", tables.SERIES_SCHEMA, tables.SERIES_NUM_PKS)
        self.index_table = await open_table(
            "index", tables.INDEX_SCHEMA, tables.INDEX_NUM_PKS)
        self.tags_table = await open_table(
            "tags", tables.TAGS_SCHEMA, tables.TAGS_NUM_PKS)
        self.data_table = await open_table(
            "data", tables.DATA_SCHEMA, tables.DATA_NUM_PKS)
        self.exemplars_table = await open_table(
            "exemplars", tables.EXEMPLARS_SCHEMA, tables.EXEMPLARS_NUM_PKS)

        self.metric_mgr = MetricManager(self.metrics_table, segment_duration_ms)
        self.index_mgr = IndexManager(
            self.series_table, self.index_table, segment_duration_ms,
            tags_storage=self.tags_table,
        )
        self.sample_mgr = SampleManager(self.data_table, segment_duration_ms)
        await self.metric_mgr.open()
        await self.index_mgr.open()
        # seed the cardinality sketch from the index the open just loaded
        mids, tsids = self.index_mgr.series_lanes()
        self._feed_sketch(mids, tsids)
        return self

    def _tables(self):
        return (self.metrics_table, self.series_table, self.index_table,
                self.tags_table, self.data_table, self.exemplars_table)

    async def flush(self) -> None:
        """Every write is durable when it returns (no ingest buffer)."""

    async def close(self) -> None:
        await self.flush()
        for t in self._tables():
            await t.close()

    # -- write path -----------------------------------------------------------
    def metadata(self) -> dict[bytes, str]:
        """Metric-family metadata (family name -> prom type string)."""
        return dict(self.metric_mgr.metadata)

    def _record_metadata(self, req: ParsedWriteRequest) -> None:
        for i in range(len(req.meta_type)):
            self.metric_mgr.record_metadata(req.meta_name(i), int(req.meta_type[i]))

    def _feed_sketch(self, metric_arr, tsid_arr) -> None:
        if self._sketch.add_pairs(metric_arr, tsid_arr):
            SERIES_CARDINALITY.labels(self._table_label).set(round(self._sketch.estimate()))

    async def _resolve_ids(self, req: ParsedWriteRequest) -> tuple[np.ndarray, np.ndarray]:
        """Per-series (metric_id, tsid) u64 lanes, registering unseen
        metrics and series: the JAX engine's slow path (`write_parsed`:
        `populate_metric_ids`, then `populate_series_ids` over the labels
        without `__name__`), run only for series whose raw label bytes the
        id cache has not seen."""
        keys = req.series_raw_keys()
        cache = self._ids_by_key
        hits = [cache.get(k) if k is not None else None for k in keys]
        miss = [i for i, h in enumerate(hits) if h is None]
        metric_arr = np.empty(req.n_series, dtype=np.uint64)
        tsid_arr = np.empty(req.n_series, dtype=np.uint64)
        if len(miss) < req.n_series:
            have = np.fromiter((i for i, h in enumerate(hits) if h is not None), dtype=np.int64)
            pairs = np.asarray([hits[i] for i in have.tolist()], dtype=np.uint64).reshape(-1, 2)
            metric_arr[have] = pairs[:, 0]
            tsid_arr[have] = pairs[:, 1]
        if not miss:
            return metric_arr, tsid_arr
        ts_now = now_ms()
        names: list[bytes] = []
        label_sets: list[list[tuple[bytes, bytes]]] = []
        for s in miss:
            name = b""
            rest = []
            for k, v in req.series_labels(s):
                if k == NAME_LABEL:
                    name = v
                else:
                    rest.append((k, v))
            ensure(bool(name), f"series {s} missing __name__ label")
            names.append(name)
            label_sets.append(rest)
        ids = await self.metric_mgr.populate_metric_ids(names, ts_now)
        mids = [ids[n] for n in names]
        tsids = await self.index_mgr.populate_series_ids(mids, label_sets, ts_now)
        metric_arr[miss] = np.asarray(mids, dtype=np.uint64)
        tsid_arr[miss] = np.asarray(tsids, dtype=np.uint64)
        if len(cache) > SEEN_CACHE_MAX:
            cache.clear()
        for s, m, t in zip(miss, mids, tsids):
            if keys[s] is not None:
                cache[keys[s]] = (m, t)
        return metric_arr, tsid_arr

    async def write_parsed(self, req: ParsedWriteRequest) -> int:
        """Ingest one decoded remote-write request; returns sample count."""
        if len(req.meta_type):
            self._record_metadata(req)
        if req.n_series == 0:
            return 0
        if len(req.exemplar_value):
            raise NotPortedError("not ported yet: exemplar persistence")
        metric_arr, tsid_arr = await self._resolve_ids(req)
        self._feed_sketch(metric_arr, tsid_arr)
        n = req.n_samples
        if n:
            series_idx = req.sample_series
            await self.sample_mgr.persist(
                metric_arr[series_idx], tsid_arr[series_idx],
                req.sample_ts, req.sample_value,
            )
        return n

    async def write_payload(self, payload: bytes) -> int:
        """Parse + ingest one remote-write payload end-to-end (the decode
        runs in a worker thread, off the event loop)."""
        with tracing.span("parse", bytes=len(payload)):
            parsed = await asyncio.to_thread(self._parser.parse, payload)
        with tracing.span("append", samples=parsed.n_samples):
            return await self.write_parsed(parsed)

    # -- query path -------------------------------------------------------------
    def _resolve_query(
        self, metric: bytes, filters, matchers=None
    ) -> tuple[int, list | None] | None:
        """Shared lookup prologue: metric id + TSID candidates, or None when
        the metric is unknown / no series matches the filters."""
        hit = self.metric_mgr.get(metric)
        if hit is None:
            return None
        tsids = self.index_mgr.find_tsids(hit[0], filters, matchers)
        if tsids == []:
            return None
        return hit[0], tsids

    async def _resolve_query_async(self, req: QueryRequest):
        """Regex matchers evaluate in a worker thread: Python re has no
        linear-time guarantee and must not stall the event loop."""
        if req.matchers:
            return await asyncio.to_thread(
                self._resolve_query, req.metric, req.filters, req.matchers
            )
        return self._resolve_query(req.metric, req.filters, req.matchers)

    async def query(self, req: QueryRequest):
        """Raw rows (bucket_ms None) or (tsids, downsample grids)."""
        # cooperative end-to-end deadline (common/deadline.py): a query
        # whose budget is already spent must not pay resolution + scan
        deadline_ctx.check("query_resolve")
        resolved = await self._resolve_query_async(req)
        if resolved is None:
            return None
        metric_id, tsids = resolved
        rng = TimeRange(req.start_ms, req.end_ms)
        if req.bucket_ms is None:
            return await self.sample_mgr.query_raw(metric_id, tsids, rng, limit=req.limit)
        filtered = tsids is not None
        if tsids is None:  # no tag filter: all series of the metric
            tsids = self.index_mgr.series_of(metric_id)
        return await self.sample_mgr.query_downsample(
            metric_id, tsids, rng, req.bucket_ms, filtered=filtered
        )

    def label_values(self, metric: bytes, key: bytes) -> list[bytes]:
        hit = self.metric_mgr.get(metric)
        if hit is None:
            return []
        return self.index_mgr.label_values(hit[0], key)

    def metric_names(self) -> list[bytes]:
        """All registered metric names."""
        return self.metric_mgr.names()

    def series_count(self, metric: bytes) -> int:
        """Registered series of a metric (in-memory index lookup, no IO);
        0 for unknown metrics."""
        hit = self.metric_mgr.get(metric)
        if hit is None:
            return 0
        return len(self.index_mgr.series_of(hit[0]))

    @property
    def device(self):
        """The torch device the engine's tables reduce on."""
        return self.data_table.device

    def label_names(self) -> list[bytes]:
        """All label KEYS across every registered series (`__name__` is the
        caller's concern)."""
        names: set[bytes] = set()
        for metric in self.metric_mgr.names():
            hit = self.metric_mgr.get(metric)
            if hit is None:
                continue
            for labs in self.index_mgr.series_labels(hit[0]).values():
                names.update(labs)
        return sorted(names)

    def series(self, metric: bytes) -> list[dict[str, str]]:
        """Label sets of every series of a metric, tagless series included,
        each with its `__tsid__`."""
        hit = self.metric_mgr.get(metric)
        if hit is None:
            return []
        per_tsid = self.index_mgr.series_labels(hit[0])
        return [
            {k.decode(errors="replace"): v.decode(errors="replace")
             for k, v in labels.items()} | {"__tsid__": str(t)}
            for t, labels in sorted(per_tsid.items())
        ]

    def series_labels_map(
        self, metric: bytes, tsids: "list[int] | None" = None
    ) -> dict[int, dict[bytes, bytes]]:
        """tsid -> raw label map for a metric, optionally restricted to
        `tsids` (a selective query never decodes the whole metric)."""
        hit = self.metric_mgr.get(metric)
        if hit is None:
            return {}
        per_tsid = self.index_mgr.series_labels(hit[0])
        if tsids is None:
            return per_tsid
        return {t: per_tsid[t] for t in tsids if t in per_tsid}

    async def match_series(
        self, metric: bytes, filters, matchers
    ) -> dict[int, dict[bytes, bytes]]:
        """Matched tsid -> label map (Prometheus match[] resolution); regex
        matchers evaluate off the event loop, as queries' do."""
        resolved = await self._resolve_query_async(
            QueryRequest(metric=metric, start_ms=0, end_ms=1,
                         filters=filters, matchers=matchers)
        )
        if resolved is None:
            return {}
        metric_id, tsids = resolved
        per_tsid = self.index_mgr.series_labels(metric_id)
        if tsids is None:
            return per_tsid
        return {t: per_tsid[t] for t in tsids if t in per_tsid}
