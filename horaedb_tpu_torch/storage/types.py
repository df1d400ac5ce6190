"""Core storage types of the port: timestamps, time ranges, the schema
contract and the request types.

A copy of the JAX package's `storage/types.py` (and of `ScanRequest` /
`WriteRequest` from its `storage/read.py`). The schema contract is the
same:

    pk_1, ..., pk_N, value_1, ..., value_M, __seq__, __reserved__

- the first `num_primary_keys` user columns are the primary key (sort key);
- at least one value column must follow;
- `__seq__` (uint64) is the write sequence (== SST file id) used for dedup;
- `__reserved__` (uint64, all-null today) is kept for the file format.

Host batches are pyarrow RecordBatches; the device sees numpy lanes
converted to torch tensors (`backend.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common.error import ensure

SEQ_COLUMN_NAME = "__seq__"
RESERVED_COLUMN_NAME = "__reserved__"


@dataclass(frozen=True, order=True)
class Timestamp:
    """Millisecond timestamp."""

    value: int

    def truncate_by(self, duration_ms: int) -> "Timestamp":
        """Floor to a segment boundary (floors toward -inf for negative ts)."""
        return Timestamp(self.value - self.value % duration_ms)


@dataclass(frozen=True)
class TimeRange:
    """Half-open [start, end) in ms."""

    start: int  # inclusive
    end: int    # exclusive

    def __post_init__(self) -> None:
        ensure(self.start <= self.end, f"invalid time range [{self.start}, {self.end})")

    def overlaps(self, other: "TimeRange") -> bool:
        return self.start < other.end and other.start < self.end


@dataclass
class WriteResult:
    """Outcome of one SST write."""

    id: int
    seq: int
    size: int


@dataclass
class StorageSchema:
    """User schema plus the builtin columns."""

    arrow_schema: pa.Schema
    num_primary_keys: int
    seq_idx: int
    reserved_idx: int
    value_idxes: list[int]
    update_mode: "object" = None  # config.UpdateMode

    @classmethod
    def try_new(cls, arrow_schema: pa.Schema, num_primary_keys: int,
                update_mode) -> "StorageSchema":
        ensure(num_primary_keys > 0, "num_primary_keys should large than 0")
        names = arrow_schema.names
        ensure(SEQ_COLUMN_NAME not in names and RESERVED_COLUMN_NAME not in names,
               "schema should not use builtin columns name")
        value_idxes = list(range(num_primary_keys, len(names)))
        ensure(len(value_idxes) > 0, "no value column found")
        fields = list(arrow_schema) + [
            pa.field(SEQ_COLUMN_NAME, pa.uint64(), nullable=True),
            pa.field(RESERVED_COLUMN_NAME, pa.uint64(), nullable=True),
        ]
        return cls(
            arrow_schema=pa.schema(fields, metadata=arrow_schema.metadata),
            num_primary_keys=num_primary_keys,
            seq_idx=len(fields) - 2,
            reserved_idx=len(fields) - 1,
            value_idxes=value_idxes,
            update_mode=update_mode,
        )

    @staticmethod
    def is_builtin_name(name: str) -> bool:
        return name in (SEQ_COLUMN_NAME, RESERVED_COLUMN_NAME)

    @property
    def primary_key_names(self) -> list[str]:
        return self.arrow_schema.names[: self.num_primary_keys]

    def fill_required_projections(self, projections: list[int] | None) -> list[int] | None:
        """Primary keys and __seq__ are always fetched."""
        if projections is None:
            return None
        proj = list(projections)
        for i in range(self.num_primary_keys):
            if i not in proj:
                proj.append(i)
        if self.seq_idx not in proj:
            proj.append(self.seq_idx)
        return proj

    def fill_builtin_columns(self, batch: pa.RecordBatch, sequence: int) -> pa.RecordBatch:
        """Append __seq__=sequence and an all-null __reserved__."""
        n = batch.num_rows
        cols = list(batch.columns)
        cols.append(pa.array(np.full(n, sequence, dtype=np.uint64)))
        cols.append(pa.nulls(n, type=pa.uint64()))
        return pa.RecordBatch.from_arrays(cols, schema=self.arrow_schema)


@dataclass
class ScanRequest:
    """`range` prunes SSTs (row-exact time filtering is the caller's
    predicate). `projections` are user-column indexes; the primary key and
    `__seq__` are always fetched."""

    range: TimeRange
    predicate: "object | None" = None  # ops.filter.Predicate
    projections: list[int] | None = None


@dataclass
class WriteRequest:
    """One batch to write as one sorted SST. `enable_check`: the rows'
    range must fall in one segment."""

    batch: pa.RecordBatch
    time_range: TimeRange
    enable_check: bool = True
