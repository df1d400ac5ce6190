"""Metric engine of the port: Prometheus remote-write in, label-filtered
downsample grids out.

A port of the JAX package's `engine/` over the port's storage: six tables
(metrics, series, index, tags, data, exemplars) under one root, the same
schemas and ids (seahash), and the query path down to the device kernels,
with the query batcher (`server/batching.py`) at its cold downsample
dispatch point.
"""

from horaedb_tpu_torch.engine.engine import MetricEngine, QueryRequest
from horaedb_tpu_torch.engine.types import MetricId, SeriesId, seahash

__all__ = ["MetricEngine", "QueryRequest", "MetricId", "SeriesId", "seahash"]
