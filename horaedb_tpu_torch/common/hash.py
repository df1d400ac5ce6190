"""SeaHash — the framework's shared byte-hash.

A copy of the JAX package's `common/hash.py` (the public portable
algorithm, seed-fixed variant of the seahash crate's `hash()`; the metric
and series ids of both packages must be equal bit for bit), plus
`seahash_many`, the same function over many inputs at once in numpy. The
engine hashes every new series key and tag pair of a write with it.
"""

from __future__ import annotations

import struct

import numpy as np

_MASK = (1 << 64) - 1
_P = 0x6EED_0E9D_A4D9_4A4F
# Default seeds of seahash::hash (crate src: lib.rs).
_SEEDS = (
    0x16F1_1FE8_9B0D_677C,
    0xB480_A793_D8E6_C86C,
    0x6FE2_E5AA_F078_EBC9,
    0x14F9_94A4_C525_9381,
)


def _diffuse(x: int) -> int:
    x = (x * _P) & _MASK
    x ^= (x >> 32) >> (x >> 60)
    return (x * _P) & _MASK


def seahash(data: bytes) -> int:
    """SeaHash of `data` with the default seeds."""
    a, b, c, d = _SEEDS
    n = len(data)
    # full 8-byte little-endian chunks, round-robin over the four lanes
    full = n & ~7
    lanes = [a, b, c, d]
    i = 0
    lane = 0
    while i < full:
        (chunk,) = struct.unpack_from("<Q", data, i)
        lanes[lane] = _diffuse(lanes[lane] ^ chunk)
        lane = (lane + 1) & 3
        i += 8
    if i < n:
        tail = data[i:] + b"\x00" * (8 - (n - i))
        (chunk,) = struct.unpack_from("<Q", tail, 0)
        lanes[lane] = _diffuse(lanes[lane] ^ chunk)
    a, b, c, d = lanes
    a ^= b
    c ^= d
    a ^= c
    a ^= n
    return _diffuse(a)


_P_U64 = np.uint64(_P)
_SEEDS_U64 = tuple(np.uint64(s) for s in _SEEDS)


def _diffuse_u64(x: np.ndarray) -> np.ndarray:
    x = x * _P_U64  # uint64 arrays wrap modulo 2^64
    x ^= (x >> np.uint64(32)) >> (x >> np.uint64(60))
    return x * _P_U64


def seahash_many(datas: list[bytes]) -> np.ndarray:
    """`seahash` of every input, as a uint64 array. A tail shorter than 8
    bytes is hashed as a zero-padded chunk, so inputs with the same number
    of (padded) chunks share one vectorized pass over their chunks."""
    m = len(datas)
    out = np.empty(m, dtype=np.uint64)
    if m == 0:
        return out
    lens = np.fromiter(map(len, datas), dtype=np.int64, count=m)
    flat = np.frombuffer(b"".join(datas) + b"\x00" * 8, dtype=np.uint8)
    starts = np.zeros(m, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    chunks = (lens + 7) // 8
    for c in np.unique(chunks).tolist():
        sel = np.flatnonzero(chunks == c)
        cols = np.arange(8 * c, dtype=np.int64)
        take = np.minimum(starts[sel, None] + cols, len(flat) - 1)
        mat = np.where(cols < lens[sel, None], flat[take], 0).astype(np.uint8)
        words = np.ascontiguousarray(mat).view("<u8").reshape(len(sel), c)
        lanes = [np.full(len(sel), s, dtype=np.uint64) for s in _SEEDS_U64]
        for j in range(c):
            lanes[j & 3] = _diffuse_u64(lanes[j & 3] ^ words[:, j].astype(np.uint64))
        a = lanes[0] ^ lanes[1]
        a ^= lanes[2] ^ lanes[3]
        a ^= lens[sel].astype(np.uint64)
        out[sel] = _diffuse_u64(a)
    return out
