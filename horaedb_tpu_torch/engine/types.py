"""Metric-engine id types and the seahash function.

A copy of the JAX package's `engine/types.py`: `name_id = hash(name)`,
`series_id = hash(sorted labels)`, hash = seahash, so both packages give
every metric and series the same id. `tag_hashes_of` is the batch form of
`tag_hash_of` (`common/hash.py::seahash_many`), which the index uses to
register many new series at once.
"""

from __future__ import annotations

import struct

import numpy as np

from horaedb_tpu_torch.common.hash import seahash, seahash_many

__all__ = [
    "MetricId", "SeriesId", "seahash", "metric_id_of", "series_id_of",
    "series_key_of", "tag_hash_of", "tag_hashes_of", "decode_series_key",
]

MetricId = int  # u64
SeriesId = int  # u64 (a.k.a. TSID)


def metric_id_of(name: bytes) -> MetricId:
    return seahash(name)


def series_id_of(sorted_label_kvs: bytes) -> SeriesId:
    return seahash(sorted_label_kvs)


def series_key_of(labels: list[tuple[bytes, bytes]]) -> bytes:
    """Canonical series key: sorted `k=v` pairs joined with 0x01 (a byte that
    cannot appear in valid UTF-8 label names per Prometheus rules is not
    guaranteed, so the pairing also length-prefixes to stay injective)."""
    parts = []
    for k, v in sorted(labels):
        parts.append(struct.pack("<I", len(k)) + k + struct.pack("<I", len(v)) + v)
    return b"".join(parts)


def tag_hash_of(key: bytes, value: bytes) -> int:
    """Posting-list key for one tag KV in the inverted index."""
    return seahash(struct.pack("<I", len(key)) + key + value)


def tag_hashes_of(pairs: list[tuple[bytes, bytes]]) -> np.ndarray:
    """`tag_hash_of` of every (key, value) pair, as a uint64 array."""
    return seahash_many([struct.pack("<I", len(k)) + k + v for k, v in pairs])


def decode_series_key(data: bytes) -> list[tuple[bytes, bytes]]:
    """Inverse of series_key_of (length-prefixed sorted KV pairs)."""
    out = []
    i = 0
    n = len(data)
    while i + 4 <= n:
        (kl,) = struct.unpack_from("<I", data, i)
        i += 4
        k = data[i : i + kl]
        i += kl
        if i + 4 > n:
            break
        (vl,) = struct.unpack_from("<I", data, i)
        i += 4
        v = data[i : i + vl]
        i += vl
        out.append((k, v))
    return out
