"""SST handles: id allocation, metadata, the protobuf bridge and paths.

A copy of the JAX package's `storage/sst.py`; the invariants are the same:
- ids come from a process-wide monotonic counter seeded with the
  nanosecond wall clock, and an id doubles as the write sequence used for
  dedup, so a later write always carries the higher sequence;
- `ensure_id_above` moves the counter past ids loaded from a store;
- the data path layout is `{prefix}/data/{id}.sst`, and a format-v2 SST's
  encoded-lane sidecar is `{prefix}/data/{id}.enc`.
The compaction marks and TTL helpers wait for the compaction slice.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

from horaedb_tpu_torch.common.error import HoraeError
from horaedb_tpu_torch.pb import sst_pb2
from horaedb_tpu_torch.storage.types import TimeRange

PREFIX_PATH = "data"

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
        """Advance past `floor`: an id at or below an existing SST's would
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
    """SST metadata carried in the manifest. `format_version` 2 marks an
    SST with an encoded-lane sidecar; `encodings` names each lane's codec
    there."""

    max_sequence: int
    num_rows: int
    size: int
    time_range: TimeRange
    format_version: int = 1
    encodings: tuple[tuple[str, str], ...] = ()


@dataclass(frozen=True)
class SstFile:
    """Handle to one immutable sorted parquet SST."""

    id: int
    meta: FileMeta

    def to_pb(self) -> sst_pb2.SstFile:
        pb = sst_pb2.SstFile()
        pb.id = self.id
        pb.meta.max_sequence = self.meta.max_sequence
        pb.meta.num_rows = self.meta.num_rows
        pb.meta.size = self.meta.size
        pb.meta.time_range.start = self.meta.time_range.start
        pb.meta.time_range.end = self.meta.time_range.end
        if self.meta.format_version > 1:
            pb.meta.format_version = self.meta.format_version
            for column, codec in self.meta.encodings:
                e = pb.meta.encodings.add()
                e.column = column
                e.codec = codec
        return pb

    @classmethod
    def from_pb(cls, pb: sst_pb2.SstFile) -> "SstFile":
        if not pb.HasField("meta"):
            raise HoraeError(f"sst pb missing meta: id={pb.id}")
        return cls(
            id=pb.id,
            meta=FileMeta(
                max_sequence=pb.meta.max_sequence,
                num_rows=pb.meta.num_rows,
                size=pb.meta.size,
                time_range=TimeRange(pb.meta.time_range.start, pb.meta.time_range.end),
                # proto3 absent scalar decodes 0: a v1 (plain parquet) SST
                format_version=max(1, pb.meta.format_version),
                encodings=tuple((e.column, e.codec) for e in pb.meta.encodings),
            ),
        )


@dataclass(frozen=True)
class SstPathGenerator:
    """`{prefix}/data/{id}.sst` and its sidecars."""

    prefix: str

    def generate(self, file_id: int) -> str:
        return f"{self.prefix}/{PREFIX_PATH}/{file_id}.sst"

    def generate_enc(self, file_id: int) -> str:
        """Encoded-lane sidecar of a format-v2 SST (storage/encoding.py):
        per-lane columnar encodings + zone maps the compressed-domain scan
        reads instead of the parquet columns."""
        return f"{self.prefix}/{PREFIX_PATH}/{file_id}.enc"
