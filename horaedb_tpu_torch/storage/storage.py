"""The port's storage engine: writes seal immutable sorted runs in memory.

Mirrors `horaedb_tpu/storage/storage.py::ObjectBasedStorage` up to its
storage API. Each write becomes a run: the lanes a parquet SST holds after
`read_sst` (the user columns plus `__seq__`), kept as host numpy arrays.
The parquet and manifest layer waits for a later slice, so nothing here
touches an object store.

The write path is the reference's: the segment check, the primary-key
sort (kernel A on the card, skipped when the batch is already sorted),
sequence allocation, sealing the run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device
from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.common.time_ext import ReadableDuration
from horaedb_tpu_torch.ops import sort as sort_ops
from horaedb_tpu_torch.storage.config import StorageConfig
from horaedb_tpu_torch.storage.sst import FileMeta, SstFile, allocate_id, ensure_id_above
from horaedb_tpu_torch.storage.types import (
    SEQ_COLUMN_NAME,
    StorageSchema,
    TimeRange,
    Timestamp,
    WriteRequest,
)


def _is_pk_sorted(keys: list[np.ndarray]) -> bool:
    """O(n) check that rows are lexicographically nondecreasing over `keys`
    (most significant first)."""
    n = len(keys[0])
    if n <= 1:
        return True
    decided_lt = np.zeros(n - 1, dtype=bool)
    for k in keys:
        a, b = k[:-1], k[1:]
        if ((a > b) & ~decided_lt).any():
            return False
        decided_lt |= a < b
    return True


@dataclass(frozen=True)
class Run:
    """One sealed write: its handle and its pk-sorted lanes."""

    sst: SstFile
    lanes: dict[str, np.ndarray]


class ObjectBasedStorage:
    """Columnar storage over sorted in-memory runs."""

    def __init__(self, schema: StorageSchema, segment_duration_ms: int,
                 config: StorageConfig, device) -> None:
        self._schema = schema
        self._segment_duration = segment_duration_ms
        self._config = config
        self._device = device
        self._runs: dict[int, Run] = {}

    @classmethod
    def try_new(
        cls,
        schema,
        num_primary_keys: int,
        segment_duration_ms: int | str,
        config: StorageConfig | None = None,
        device=DEFAULT_DEVICE,
    ) -> "ObjectBasedStorage":
        """`schema`: (name, numpy dtype) pairs, primary key first.
        `segment_duration_ms`: ms, or a duration string such as "2h"."""
        seg = ReadableDuration.parse(segment_duration_ms).ms
        ensure(seg > 0, f"segment duration must be positive, got {seg}")
        return cls(StorageSchema.try_new(schema, num_primary_keys), seg,
                   config or StorageConfig(), resolve_device(device))

    @property
    def schema(self) -> StorageSchema:
        return self._schema

    @property
    def config(self) -> StorageConfig:
        return self._config

    # -- write path ----------------------------------------------------------
    def write(self, req: WriteRequest) -> SstFile:
        if req.enable_check:
            start_seg = Timestamp(req.time_range.start).truncate_by(self._segment_duration)
            end_seg = Timestamp(req.time_range.end - 1).truncate_by(self._segment_duration)
            ensure(
                start_seg == end_seg,
                f"time range of one write must fall in one segment, "
                f"range: [{req.time_range.start}, {req.time_range.end})",
            )
        batch = self._checked_batch(req.batch)
        file_id = allocate_id()
        if not req.presorted:
            batch = self._sort_batch(batch)
        seq = file_id if req.seq is None else req.seq
        n = len(batch[self._schema.names[0]])
        lanes = dict(batch)
        lanes[SEQ_COLUMN_NAME] = np.full(n, seq, dtype=np.uint64)
        return self.add_run(file_id, seq, req.time_range, lanes)

    def add_run(self, file_id: int, seq: int, time_range: TimeRange,
                lanes: dict[str, np.ndarray]) -> SstFile:
        """Seal pk-sorted `lanes` (every column, `__seq__` included) as run
        `file_id`. Later allocated ids stay above it."""
        ensure(file_id not in self._runs, f"run id {file_id} already exists")
        n = len(lanes[SEQ_COLUMN_NAME])
        meta = FileMeta(max_sequence=seq, num_rows=n,
                        size=sum(a.nbytes for a in lanes.values()),
                        time_range=time_range)
        sst = SstFile(id=file_id, meta=meta)
        self._runs[file_id] = Run(sst, {name: lanes[name] for name in self._schema.names})
        ensure_id_above(max(file_id, seq))
        return sst

    def _checked_batch(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        cols = self._schema.user_columns
        ensure(set(batch) == {n for n, _ in cols},
               f"batch columns {sorted(batch)} != schema {[n for n, _ in cols]}")
        lens = {len(batch[n]) for n, _ in cols}
        ensure(len(lens) == 1, f"ragged batch: column lengths {sorted(lens)}")
        out = {}
        for name, dt in cols:
            a = np.asarray(batch[name])
            ensure(a.ndim == 1 and a.dtype == dt,
                   f"column {name!r} must be 1-D {dt}, got {a.ndim}-D {a.dtype}")
            out[name] = a
        return out

    def _sort_batch(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Primary-key sort: the permutation comes from the device (kernel A),
        the gather of every column runs on the host."""
        keys = [batch[name] for name in self._schema.primary_key_names]
        if _is_pk_sorted(keys):
            return batch
        perm = sort_ops.sort_permutation(keys, device=self._device).cpu().numpy()
        return {name: a[perm] for name, a in batch.items()}

    # -- read side -----------------------------------------------------------
    def select_ssts(self, time_range: TimeRange) -> list[SstFile]:
        """Runs whose time range overlaps `time_range`, oldest id first."""
        return [self._runs[i].sst for i in sorted(self._runs)
                if self._runs[i].sst.meta.time_range.overlaps(time_range)]

    def group_by_segment(self, ssts: list[SstFile]) -> list[list[SstFile]]:
        """Bucket runs by segment start, ordered old -> new."""
        buckets: dict[int, list[SstFile]] = {}
        for s in ssts:
            seg = Timestamp(s.meta.time_range.start).truncate_by(self._segment_duration)
            buckets.setdefault(seg.value, []).append(s)
        return [buckets[k] for k in sorted(buckets)]

    def read_run(self, sst: SstFile) -> dict[str, np.ndarray]:
        """The lanes of one run."""
        return self._runs[sst.id].lanes
