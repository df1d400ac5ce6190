"""Schemas of the six metric-engine tables over ColumnarStorage.

A copy of the JAX package's `engine/tables.py`: the port's engine writes
the same six tables, so either package opens a root the other wrote.

RFC table layouts (docs/rfcs/20240827-metric-engine.md:100-145) mapped onto
the storage schema contract (pk columns first, then values). String columns
from the RFC are binary here (labels are not UTF-8-validated, matching the
ingest contract), and each table gets numeric hash pks so primary-key
comparisons stay on the device-friendly numeric path.
"""

from __future__ import annotations

import pyarrow as pa

# metrics: pk (metric_id, field_id); values: names + type
METRICS_SCHEMA = pa.schema(
    [
        ("metric_id", pa.uint64()),
        ("field_id", pa.uint64()),
        ("metric_name", pa.binary()),
        ("field_name", pa.binary()),
        ("field_type", pa.uint64()),
    ]
)
METRICS_NUM_PKS = 2

# series: pk (metric_id, tsid); value: the canonical sorted-label key
SERIES_SCHEMA = pa.schema(
    [
        ("metric_id", pa.uint64()),
        ("tsid", pa.uint64()),
        ("series_key", pa.binary()),
    ]
)
SERIES_NUM_PKS = 2

# index (inverted): pk (metric_id, tag_hash, tsid); values: raw tag bytes for
# collision verification and LabelValues queries
INDEX_SCHEMA = pa.schema(
    [
        ("metric_id", pa.uint64()),
        ("tag_hash", pa.uint64()),
        ("tsid", pa.uint64()),
        ("tag_key", pa.binary()),
        ("tag_value", pa.binary()),
    ]
)
INDEX_NUM_PKS = 3

# data: pk (metric_id, tsid, field_id, ts); value: the sample
# (RFC :218-232 keeps MetricID/TSID/FieldID as the sorted prefix; ts joins
# the pk here because rows are raw samples, not 30-min compressed batches)
DATA_SCHEMA = pa.schema(
    [
        ("metric_id", pa.uint64()),
        ("tsid", pa.uint64()),
        ("field_id", pa.uint64()),
        ("ts", pa.int64()),
        ("value", pa.float64()),
    ]
)
DATA_NUM_PKS = 4

# tags (RFC :118-130, the "optional" table): pk (metric_id, tag_hash);
# values: the raw tag bytes. One row per DISTINCT (metric, key, value) —
# the LabelValues acceleration surface that avoids touching per-series
# posting rows. The hash pk keeps pk comparisons numeric (engine-wide
# contract); raw bytes disambiguate collisions at read time.
TAGS_SCHEMA = pa.schema(
    [
        ("metric_id", pa.uint64()),
        ("tag_hash", pa.uint64()),
        ("tag_key", pa.binary()),
        ("tag_value", pa.binary()),
    ]
)
TAGS_NUM_PKS = 2

# exemplars: pk (metric_id, tsid, ts); values: sample + serialized labels
# (length-prefixed KV encoding from engine.types, carrying trace ids etc.)
EXEMPLARS_SCHEMA = pa.schema(
    [
        ("metric_id", pa.uint64()),
        ("tsid", pa.uint64()),
        ("ts", pa.int64()),
        ("value", pa.float64()),
        ("labels", pa.binary()),
    ]
)
EXEMPLARS_NUM_PKS = 3
