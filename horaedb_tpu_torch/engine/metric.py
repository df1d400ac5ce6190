"""MetricManager: metric-name -> MetricId registry.

A copy of the JAX package's `engine/metric.py`: a write-through in-memory
cache over the `metrics` table. The full table loads at open (metric
cardinality is tiny next to data) and new metrics append as storage
writes. The hash-lane registration of the native parser
(`unknown_ids`, `register_named`) waits for that parser.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.engine.tables import METRICS_SCHEMA
from horaedb_tpu_torch.engine.types import MetricId, metric_id_of
from horaedb_tpu_torch.storage.types import ScanRequest, TimeRange, WriteRequest

DEFAULT_FIELD = b"value"
FIELD_TYPE_F64 = 0


class MetricManager:
    def __init__(self, storage, segment_duration_ms: int):
        self._storage = storage
        self._segment_duration = segment_duration_ms
        # name -> (metric_id, field_id); write-through cache over the table
        self._cache: dict[bytes, tuple[int, int]] = {}
        # Prometheus metric-family metadata (remote-write METADATA records,
        # prompb MetricMetadata.type). Advisory and in-memory only, like
        # Prometheus itself: clients re-send it on a slow clock.
        self.metadata: dict[bytes, str] = {}

    # prompb MetricMetadata.MetricType enum
    _PROM_TYPES = (
        "unknown", "counter", "gauge", "histogram",
        "gaugehistogram", "summary", "info", "stateset",
    )

    def record_metadata(self, name: bytes, type_code: int) -> None:
        t = self._PROM_TYPES[type_code] if 0 <= type_code < len(self._PROM_TYPES) \
            else "unknown"
        self.metadata[bytes(name)] = t

    async def open(self) -> None:
        async for batch in self._storage.scan(
            ScanRequest(range=TimeRange(-(2**62), 2**62))
        ):
            names = batch.column("metric_name").to_pylist()
            mids = batch.column("metric_id").to_pylist()
            fids = batch.column("field_id").to_pylist()
            for n, m, f in zip(names, mids, fids):
                self._cache[n] = (m, f)

    def get(self, name: bytes) -> tuple[int, int] | None:
        return self._cache.get(name)

    def names(self) -> list[bytes]:
        """All registered metric names."""
        return sorted(self._cache.keys())

    async def populate_metric_ids(
        self, names: list[bytes], now_ms: int
    ) -> dict[bytes, MetricId]:
        """Resolve (registering if new) ids for a batch of metric names."""
        out: dict[bytes, MetricId] = {}
        new: list[bytes] = []
        for name in names:
            hit = self._cache.get(name)
            if hit is None:
                out[name] = metric_id_of(name)
                new.append(name)
            else:
                out[name] = hit[0]
        if new:
            await self._persist(sorted(set(new)), out, now_ms)
        return out

    async def _persist(self, new_names: list[bytes], ids: dict[bytes, int], now_ms: int) -> None:
        n = len(new_names)
        field_id = 0
        batch = pa.RecordBatch.from_pydict(
            {
                "metric_id": np.asarray([ids[x] for x in new_names], dtype=np.uint64),
                "field_id": np.full(n, field_id, dtype=np.uint64),
                "metric_name": list(new_names),
                "field_name": [DEFAULT_FIELD] * n,
                "field_type": np.full(n, FIELD_TYPE_F64, dtype=np.uint64),
            },
            schema=METRICS_SCHEMA,
        )
        seg_start = now_ms - now_ms % self._segment_duration
        await self._storage.write(
            WriteRequest(batch, TimeRange(seg_start, seg_start + 1), enable_check=True)
        )
        for name in new_names:
            self._cache[name] = (ids[name], field_id)
