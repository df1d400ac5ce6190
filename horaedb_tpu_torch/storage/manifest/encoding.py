"""Manifest snapshot codec and protobuf deltas, byte-compatible with the
JAX package's `storage/manifest/encoding.py` (a copy of it).

  header  = magic(u32 LE = 0xCAFE1234) | version(u8 = 1) | flag(u8 = 0)
          | length(u64 LE)                                   -> 14 bytes
  record  = id(u64) | start(i64) | end(i64) | size(u32) | num_rows(u32)
          (all little-endian)                                -> 32 bytes

Version 2 appends the SST format_version (u32) to each record; the encoder
writes version-1 bytes whenever every SST is format v1.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.pb import sst_pb2
from horaedb_tpu_torch.storage.sst import FileMeta, SstFile
from horaedb_tpu_torch.storage.types import TimeRange

MAGIC = 0xCAFE_1234
VERSION = 1
VERSION_ENC = 2
HEADER_LEN = 14
RECORD_LEN = 32
RECORD_LEN_V2 = 36
_HEADER = struct.Struct("<IBBQ")
_RECORD_DTYPE = np.dtype(
    [("id", "<u8"), ("start", "<i8"), ("end", "<i8"), ("size", "<u4"), ("num_rows", "<u4")]
)
_RECORD_DTYPE_V2 = np.dtype(
    [("id", "<u8"), ("start", "<i8"), ("end", "<i8"), ("size", "<u4"),
     ("num_rows", "<u4"), ("fmt", "<u4")]
)


@dataclass
class Snapshot:
    """Decoded snapshot state: the live SSTs at merge time, by id."""

    ssts: dict[int, SstFile]

    @classmethod
    def empty(cls) -> "Snapshot":
        return cls(ssts={})

    @classmethod
    def from_bytes(cls, data: bytes) -> "Snapshot":
        if len(data) == 0:
            return cls.empty()
        ensure(len(data) >= HEADER_LEN, "snapshot shorter than header")
        magic, version, _flag, length = _HEADER.unpack_from(data, 0)
        ensure(magic == MAGIC, "invalid bytes to convert to header.")
        ensure(version in (VERSION, VERSION_ENC), f"unsupported snapshot version: {version}")
        rec_len = RECORD_LEN if version == VERSION else RECORD_LEN_V2
        rec_dtype = _RECORD_DTYPE if version == VERSION else _RECORD_DTYPE_V2
        body = data[HEADER_LEN:]
        ensure(len(body) == length, "snapshot length mismatch")
        ensure(length % rec_len == 0, "snapshot body not a multiple of record size")
        ssts: dict[int, SstFile] = {}
        for rec in np.frombuffer(body, dtype=rec_dtype).tolist():
            rid, start, end, size, num_rows = rec[:5]
            fmt = int(rec[5]) if version == VERSION_ENC else 1
            # a snapshot may hold duplicate ids: the last record wins
            ssts[rid] = SstFile(
                id=rid,
                meta=FileMeta(
                    max_sequence=rid,
                    num_rows=int(num_rows),
                    size=int(size),
                    time_range=TimeRange(int(start), int(end)),
                    format_version=max(1, fmt),
                ),
            )
        return cls(ssts=ssts)

    def to_bytes(self) -> bytes:
        files = list(self.ssts.values())
        v2 = any(f.meta.format_version > 1 for f in files)
        recs = np.empty(len(files), dtype=_RECORD_DTYPE_V2 if v2 else _RECORD_DTYPE)
        recs["id"] = [f.id for f in files]
        recs["start"] = [f.meta.time_range.start for f in files]
        recs["end"] = [f.meta.time_range.end for f in files]
        recs["size"] = [f.meta.size for f in files]
        recs["num_rows"] = [f.meta.num_rows for f in files]
        if v2:
            recs["fmt"] = [f.meta.format_version for f in files]
        body = recs.tobytes()
        return _HEADER.pack(MAGIC, VERSION_ENC if v2 else VERSION, 0, len(body)) + body

    # delta application: adds then deletes, because delta files are read
    # in no particular order
    def add_records(self, files: list[SstFile]) -> None:
        for f in files:
            self.ssts[f.id] = f

    def delete_records(self, ids: list[int]) -> None:
        for i in ids:
            self.ssts.pop(i, None)

    def into_ssts(self) -> list[SstFile]:
        return list(self.ssts.values())


def encode_update(to_adds: list[SstFile], to_deletes: list[int]) -> bytes:
    pb = sst_pb2.ManifestUpdate()
    for f in to_adds:
        pb.to_adds.append(f.to_pb())
    pb.to_deletes.extend(to_deletes)
    return pb.SerializeToString()


def decode_update(data: bytes) -> tuple[list[SstFile], list[int]]:
    pb = sst_pb2.ManifestUpdate()
    try:
        pb.ParseFromString(data)
    except Exception as e:  # noqa: BLE001
        raise HoraeError("corrupt manifest delta") from e
    return [SstFile.from_pb(f) for f in pb.to_adds], list(pb.to_deletes)
