"""Per-table series-cardinality defense: HLL sketch + graceful limiter.

A copy of the JAX package's `ingest/cardinality.py`, trimmed to the
sketch: the port's engine feeds it on every write and exports its
estimate, and refuses `max_series > 0` (the limiter and its
`CardinalityLimited` partial-accept are not ported yet).

Cardinality explosions — a label carrying request ids, a runaway
deployment minting a fresh pod name per second — are how real TSDBs die:
the inverted index and series registry grow without bound until memory
or the write path gives out. The defense here is a **HyperLogLog sketch
on the ingest path** (exported as ``horaedb_series_cardinality{table}``)
plus a configurable limit that degrades *gracefully*: when the estimate
crosses the limit, samples of NEW series are rejected (counted +
sampled-logged, surfaced as a 503/Retry-After partial-accept through
the error taxonomy) while samples of EXISTING series keep landing —
never a hang, never silent loss of in-budget traffic.

Why a sketch instead of the exact in-memory index count: the limiter
must stay off the ~110 ns/sample ingest budget. The sketch add is one
vectorized hash + scatter-max over the per-payload series lanes (the
hash-vs-sort group-by analysis, arXiv:2411.13245, is the reference for
keeping grouping cost vectorized and branch-free), costs O(series) not
O(samples), is idempotent (re-adding a known series is free of state
growth), and needs 2^p bytes of state total — 16 KiB at p=14 for ~0.8%
relative error, plenty for a threshold check.
"""

from __future__ import annotations

import numpy as np

# splitmix64 finalizer constants (public domain, Vigna)
_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)
_PHI = np.uint64(0x9E3779B97F4A7C15)


def mix_series_hash(metric_ids: np.ndarray, tsids: np.ndarray) -> np.ndarray:
    """One well-mixed u64 per (metric_id, tsid) pair. tsid alone is a
    seahash of the label key but is SHARED across metrics with identical
    tags, so metric_id must fold in before finalizing."""
    with np.errstate(over="ignore"):
        x = (np.asarray(metric_ids, dtype=np.uint64) * _PHI) ^ \
            np.asarray(tsids, dtype=np.uint64)
        x ^= x >> np.uint64(30)
        x *= _C1
        x ^= x >> np.uint64(27)
        x *= _C2
        x ^= x >> np.uint64(31)
    return x


class SeriesSketch:
    """Vectorized HyperLogLog over 64-bit series hashes.

    ``add_pairs`` returns True when any register grew (i.e. the estimate
    may have changed), so callers can recompute/export the gauge lazily.
    """

    def __init__(self, p: int = 14):
        assert 4 <= p <= 18
        self.p = p
        self.m = 1 << p
        self._reg = np.zeros(self.m, dtype=np.uint8)
        self._est: float | None = 0.0
        if self.m >= 128:
            self._alpha = 0.7213 / (1 + 1.079 / self.m)
        else:
            self._alpha = {64: 0.709, 32: 0.697}.get(self.m, 0.673)

    def add_pairs(self, metric_ids: np.ndarray, tsids: np.ndarray) -> bool:
        if len(metric_ids) == 0:
            return False
        return self.add_hashes(mix_series_hash(metric_ids, tsids))

    def add_hashes(self, h: np.ndarray) -> bool:
        p = np.uint64(self.p)
        idx = (h >> (np.uint64(64) - p)).astype(np.int64)
        # remaining 64-p bits, with a guard bit so the word is never zero
        # and the rank caps at (64 - p + 1)
        with np.errstate(over="ignore"):
            w = (h << p) | np.uint64(1 << (self.p - 1))
        # leading-zero count via the float64 exponent: frexp gives e with
        # 2^(e-1) <= w < 2^e, so bit_length == e and lz == 64 - e. The
        # u64->f64 rounding can only push w across a power of two UPWARD,
        # which at most underestimates lz by carrying into the next
        # exponent at the extreme top (clipped below).
        _, e = np.frexp(w.astype(np.float64))
        rank = np.clip(65 - e, 1, 64 - self.p + 1).astype(np.uint8)
        before = self._reg[idx]
        if bool(np.all(rank <= before)):
            return False
        np.maximum.at(self._reg, idx, rank)
        self._est = None  # dirty
        return True

    def estimate(self) -> float:
        if self._est is not None:
            return self._est
        reg = self._reg
        inv = np.ldexp(1.0, -reg.astype(np.int32))
        e = self._alpha * self.m * self.m / float(inv.sum())
        if e <= 2.5 * self.m:
            zeros = int(np.count_nonzero(reg == 0))
            if zeros:
                e = self.m * np.log(self.m / zeros)
        self._est = float(e)
        return self._est
