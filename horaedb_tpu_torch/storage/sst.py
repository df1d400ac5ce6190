"""Run handles: id allocation and metadata, one `SstFile` per sealed run.

Plain dataclasses in place of the JAX package's protobuf-backed handles
(`storage/sst.py`); the invariants are the same:
- ids come from a process-wide monotonic counter seeded with the
  nanosecond wall clock, and an id doubles as the write sequence used for
  dedup, so a later write always carries the higher sequence;
- `ensure_id_above` moves the counter past ids loaded from elsewhere.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

from horaedb_tpu_torch.storage.types import TimeRange

_U64_MASK = (1 << 64) - 1


class _IdAllocator:
    """Monotonic id allocator seeded from the ns clock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counter = itertools.count(time.time_ns() & _U64_MASK)

    def allocate(self) -> int:
        with self._lock:
            return next(self._counter) & _U64_MASK

    def ensure_above(self, floor: int) -> None:
        """Advance past `floor`: an id at or below an existing run's would
        lose the dedup tie-break to older data."""
        with self._lock:
            current = next(self._counter)
            self._counter = itertools.count(max(current, floor + 1) & _U64_MASK)


_ALLOCATOR = _IdAllocator()


def allocate_id() -> int:
    return _ALLOCATOR.allocate()


def ensure_id_above(floor: int) -> None:
    _ALLOCATOR.ensure_above(floor)


@dataclass(frozen=True)
class FileMeta:
    """Run metadata: the manifest record of the JAX package's SSTs."""

    max_sequence: int
    num_rows: int
    size: int
    time_range: TimeRange


@dataclass(frozen=True)
class SstFile:
    """Handle to one immutable sorted run."""

    id: int
    meta: FileMeta
