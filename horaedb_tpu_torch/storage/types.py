"""Core storage types of the port: time ranges, the schema, write requests.

The schema contract is the JAX package's (`storage/types.py`):

    pk_1, ..., pk_N, value_1, ..., value_M, __seq__

with the first `num_primary_keys` columns as the sort key and `__seq__`
(uint64) as the write sequence used for last-value dedup. A schema is a
list of `(name, numpy dtype)` pairs in place of a `pa.Schema`, and a batch
is a dict of equal-length numpy lanes in place of a `pa.RecordBatch`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from horaedb_tpu_torch.common.error import ensure

SEQ_COLUMN_NAME = "__seq__"


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
class StorageSchema:
    """User columns plus the builtin `__seq__` lane."""

    columns: list[tuple[str, np.dtype]]
    num_primary_keys: int

    @classmethod
    def try_new(cls, columns, num_primary_keys: int) -> "StorageSchema":
        ensure(num_primary_keys > 0, "num_primary_keys should large than 0")
        cols = [(str(name), np.dtype(dt)) for name, dt in columns]
        names = [n for n, _ in cols]
        ensure(SEQ_COLUMN_NAME not in names, "schema should not use builtin columns name")
        ensure(len(set(names)) == len(names), f"duplicate column names: {names}")
        ensure(len(cols) > num_primary_keys, "no value column found")
        return cls(columns=cols + [(SEQ_COLUMN_NAME, np.dtype(np.uint64))],
                   num_primary_keys=num_primary_keys)

    @property
    def names(self) -> list[str]:
        return [n for n, _ in self.columns]

    @property
    def primary_key_names(self) -> list[str]:
        return self.names[: self.num_primary_keys]

    @property
    def user_columns(self) -> list[tuple[str, np.dtype]]:
        return self.columns[:-1]


@dataclass
class WriteRequest:
    """One batch to seal into an immutable sorted run.

    `batch` maps every user column to a numpy lane of the schema's dtype.
    `enable_check`: the rows' range must fall in one segment. `presorted`:
    the caller guarantees pk order, so the write skips the sort and its
    O(n) check. `seq`: explicit write sequence (defaults to the run id)."""

    batch: dict[str, np.ndarray]
    time_range: TimeRange
    enable_check: bool = True
    presorted: bool = False
    seq: int | None = None
