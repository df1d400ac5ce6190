"""IndexManager: series registry + inverted tag index.

A copy of the JAX package's `engine/index.py`, trimmed to what the port's
engine reads: the two-tier index (base arrays + delta dicts), the rebuild
from the series and index tables at open, `populate_series_ids` (which
hashes all new series keys and tag pairs of a write in one numpy pass,
`engine/types.py::tag_hashes_of`), `find_tsids` with filters and `ne`,
`re`, `nre` matchers, `series_of`, `series_lanes`, `label_values` and
`series_labels`. Not ported yet: the base sidecar (open always rebuilds
from the tables, as the JAX package does when no sidecar is present), the
native parser's hash-lane registration, the tags-table backfill and its
LabelValues scan, and the cardinality limiter's known-pairs probe. The
port writes the same series, index and tags rows.

Implements the reference's `IndexManager::populate_series_ids` skeleton
(src/metric_engine/src/index/mod.rs:34-41, dead code in the snapshot) per
the RFC: a `series` table mapping (metric_id, tsid) -> canonical series key,
and an inverted `index` table mapping (metric_id, tag KV) -> posting list of
TSIDs (RFC :114-136).

Scale design (RFC's 10M-series design point): the index is TWO-TIER.

- BASE: immutable numpy/arrow arrays per metric, built vectorized at open
  (no per-row Python objects) — sorted tsid arrays for membership via
  searchsorted, posting rows sorted by tag_hash for range lookup, tag
  key/value kept as arrow binary arrays. Regex matchers evaluate once per
  UNIQUE value via dictionary encoding, then fan out to series by code —
  latency scales with distinct values, not series.
- DELTA: plain dicts holding series registered since open; merged into a
  fresh base (atomic swap) when it grows past a threshold.

Query side: `find_tsids` intersects posting lists for the given tag filters
— the host-side index probe whose result feeds the device-side TSID
set-membership filter (SURVEY §7.7). Hash collisions are handled by
verifying the stored raw tag bytes.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from horaedb_tpu_torch.common.error import HoraeError
from horaedb_tpu_torch.common.hash import seahash_many
from horaedb_tpu_torch.engine.tables import INDEX_SCHEMA, SERIES_SCHEMA, TAGS_SCHEMA
from horaedb_tpu_torch.engine.types import SeriesId, series_key_of, tag_hash_of, tag_hashes_of
from horaedb_tpu_torch.storage.types import ScanRequest, TimeRange, WriteRequest

logger = logging.getLogger(__name__)

_ALL_TIME = TimeRange(-(2**62), 2**62)

# Python `re` lacks RE2's linear-time guarantee; bounding pattern size limits
# the blast radius of untrusted matcher patterns (the evaluation also runs
# off the event loop, engine.py::_resolve_query_async).
MAX_REGEX_LEN = 512
# A regex matcher that would run against a label value longer than this
# raises instead (never silently truncates — wrong matches are worse than a
# loud error): sre backtracking cost grows with subject length and runs in C
# holding the GIL, so a thread offload alone cannot contain it.
MAX_REGEX_SUBJECT_LEN = 4096

# Delta series count that triggers a merge into the base arrays.
DELTA_COMPACT_THRESHOLD = 65_536
# Recently-seen (metric_id, tsid) cache bound: O(1) steady-state ingest
# probes; cleared wholesale when full (cold probes fall through to the
# base/delta tiers, so correctness never depends on it).
SEEN_CACHE_MAX = 1 << 20


def _reject_catastrophic(pattern: str) -> None:
    """Reject patterns with nested unbounded repeats (the `(a+)+b` shape):
    sre backtracks exponentially on them while holding the GIL, freezing the
    whole process, not just the worker thread. A parse-tree walk catches the
    common catastrophic shapes; the length caps bound what slips through.
    Deliberately strict: `([a-z]+\\.)+` -style selectors are refused too —
    they are the textbook ReDoS shape on failing subjects."""
    try:
        import re._parser as sre_parse  # Python >= 3.11
    except ImportError:  # 3.10 spells the private parser sre_parse
        import sre_parse

    def walk(items, in_repeat: bool) -> None:
        for op, arg in items:
            name = str(op)
            if name in ("MAX_REPEAT", "MIN_REPEAT"):
                _lo, hi, sub = arg
                unbounded = hi is sre_parse.MAXREPEAT or hi >= 1 << 16
                # a counted outer repeat like (a+){2,100} backtracks
                # combinatorially too: any repeat wider than a few counts
                # as repeat context
                repeatish = unbounded or hi > 10
                if in_repeat and repeatish:
                    raise HoraeError(
                        "regex matcher rejected: nested wide repetition "
                        "(catastrophic backtracking risk)"
                    )
                walk(sub, in_repeat or repeatish)
            elif name == "SUBPATTERN":
                walk(arg[3], in_repeat)
            elif name == "BRANCH":
                for alt in arg[1]:
                    walk(alt, in_repeat)
            elif name in ("ASSERT", "ASSERT_NOT"):
                walk(arg[1], in_repeat)

    try:
        tree = sre_parse.parse(pattern)
    except Exception:  # noqa: BLE001 — compile() will surface the real error
        return
    walk(tree, False)


def _compile_matcher(pattern: bytes):
    import re as _re

    if len(pattern) > MAX_REGEX_LEN:
        raise HoraeError(
            f"regex matcher too long ({len(pattern)} > {MAX_REGEX_LEN})"
        )
    decoded = pattern.decode(errors="replace")
    _reject_catastrophic(decoded)
    try:
        return _re.compile(decoded)
    except _re.error as e:
        raise HoraeError(f"bad regex matcher {pattern!r}: {e}") from e


def _subject_of(raw: bytes) -> str:
    if len(raw) > MAX_REGEX_SUBJECT_LEN:
        raise HoraeError(
            f"label value too long for regex matcher "
            f"({len(raw)} > {MAX_REGEX_SUBJECT_LEN} bytes); "
            f"use equality filters for this label"
        )
    return raw.decode(errors="replace")


@dataclass
class _MetricIndex:
    """One metric's immutable base arrays."""

    tsids: np.ndarray       # u64, sorted — the series set
    p_hash: np.ndarray      # u64 posting tag_hash, sorted
    p_tsid: np.ndarray      # u64 aligned with p_hash
    p_key: pa.Array         # binary aligned
    p_value: pa.Array       # binary aligned

    def has_tsid(self, tsid: int) -> bool:
        i = np.searchsorted(self.tsids, np.uint64(tsid))
        return i < len(self.tsids) and int(self.tsids[i]) == tsid

    def posting(self, h: int, k: bytes, v: bytes) -> np.ndarray:
        """TSIDs whose (k, v) posting matches — raw bytes verified."""
        lo = np.searchsorted(self.p_hash, np.uint64(h), side="left")
        hi = np.searchsorted(self.p_hash, np.uint64(h), side="right")
        if lo == hi:
            return self.p_tsid[0:0]
        keys = self.p_key.slice(lo, hi - lo)
        vals = self.p_value.slice(lo, hi - lo)
        ok = pc.and_(pc.equal(keys, k), pc.equal(vals, v))
        return self.p_tsid[lo:hi][np.asarray(ok.to_numpy(zero_copy_only=False))]

    def key_rows(self, k: bytes) -> tuple[np.ndarray, pa.Array]:
        """(tsids, values) of every posting row whose key == k."""
        ok = np.asarray(pc.equal(self.p_key, k).to_numpy(zero_copy_only=False))
        idx = np.flatnonzero(ok)
        return self.p_tsid[idx], self.p_value.take(pa.array(idx))


_EMPTY = _MetricIndex(
    tsids=np.empty(0, np.uint64),
    p_hash=np.empty(0, np.uint64),
    p_tsid=np.empty(0, np.uint64),
    p_key=pa.array([], pa.binary()),
    p_value=pa.array([], pa.binary()),
)


def _build_base(
    s_mid: np.ndarray, s_tsid: np.ndarray,
    i_mid: np.ndarray, i_hash: np.ndarray, i_tsid: np.ndarray,
    i_key: pa.Array, i_value: pa.Array,
) -> dict[int, _MetricIndex]:
    """Group flat table arrays into per-metric sorted bases — vectorized,
    no per-row Python."""
    out: dict[int, _MetricIndex] = {}
    if len(s_mid):
        order = np.lexsort((s_tsid, s_mid))
        s_mid, s_tsid = s_mid[order], s_tsid[order]
        mids, starts = np.unique(s_mid, return_index=True)
        bounds = np.append(starts, len(s_mid))
        for j, m in enumerate(mids.tolist()):
            ts = np.unique(s_tsid[bounds[j]:bounds[j + 1]])
            out[m] = _MetricIndex(
                tsids=ts,
                p_hash=_EMPTY.p_hash, p_tsid=_EMPTY.p_tsid,
                p_key=_EMPTY.p_key, p_value=_EMPTY.p_value,
            )
    if len(i_mid):
        order = np.lexsort((i_hash, i_mid))
        i_mid, i_hash, i_tsid = i_mid[order], i_hash[order], i_tsid[order]
        take = pa.array(order)
        i_key = i_key.take(take)
        i_value = i_value.take(take)
        mids, starts = np.unique(i_mid, return_index=True)
        bounds = np.append(starts, len(i_mid))
        for j, m in enumerate(mids.tolist()):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            prev = out.get(m, _EMPTY)
            out[m] = _MetricIndex(
                tsids=prev.tsids,
                p_hash=i_hash[lo:hi],
                p_tsid=i_tsid[lo:hi],
                p_key=i_key.slice(lo, hi - lo).combine_chunks()
                if isinstance(i_key, pa.ChunkedArray) else i_key.slice(lo, hi - lo),
                p_value=i_value.slice(lo, hi - lo).combine_chunks()
                if isinstance(i_value, pa.ChunkedArray) else i_value.slice(lo, hi - lo),
            )
    return out


class IndexManager:
    def __init__(
        self,
        series_storage,
        index_storage,
        segment_duration_ms: int,
        tags_storage=None,
    ):
        self._series = series_storage
        self._index = index_storage
        self._segment_duration = segment_duration_ms
        # the `tags` table: one row per distinct (metric, key, value); the
        # seen-set only suppresses duplicate writes
        self._tags = tags_storage
        self._tags_seen: set[tuple[int, int]] = set()
        # BASE tier: metric_id -> immutable arrays (atomic reference swap)
        self._base: dict[int, _MetricIndex] = {}
        # DELTA tier (series registered since open/compact):
        # metric_id -> tsids registered since the base was built
        self._metric_known: dict[int, set[int]] = defaultdict(set)
        self._delta_series = 0
        # (metric_id, tag_hash) -> {tsid -> (key, value)} posting lists
        self._postings: dict[tuple[int, int], dict[int, tuple[bytes, bytes]]] = defaultdict(dict)
        # metric_id -> its posting keys (per-metric scans stay O(one metric))
        self._metric_postings: dict[int, set[tuple[int, int]]] = defaultdict(set)
        # Guards the delta structures + the base reference: queries run in
        # worker threads (engine.py::_resolve_query_async) while ingest
        # mutates on the event loop. Held only for in-memory access.
        self._mu = threading.Lock()
        # Serializes delta->base compactions (run in a worker thread).
        self._compact_lock: "asyncio.Lock | None" = None

    async def open(self) -> None:
        """Build the base from the series and index tables."""
        await self._rebuild_from_tables()

    async def _rebuild_from_tables(self) -> None:
        s_mid, s_tsid = [], []
        req = ScanRequest(range=_ALL_TIME)
        async for batch in self._series.scan(req):
            s_mid.append(batch.column("metric_id").to_numpy(zero_copy_only=False))
            s_tsid.append(batch.column("tsid").to_numpy(zero_copy_only=False))
        i_mid, i_hash, i_tsid, i_key, i_val = [], [], [], [], []
        async for batch in self._index.scan(req):
            i_mid.append(batch.column("metric_id").to_numpy(zero_copy_only=False))
            i_hash.append(batch.column("tag_hash").to_numpy(zero_copy_only=False))
            i_tsid.append(batch.column("tsid").to_numpy(zero_copy_only=False))
            i_key.append(batch.column("tag_key"))
            i_val.append(batch.column("tag_value"))

        def cat(parts, dtype):
            return (np.concatenate(parts).astype(dtype, copy=False)
                    if parts else np.empty(0, dtype))

        def cat_arrow(parts):
            if not parts:
                return _EMPTY.p_key
            return pa.concat_arrays(
                [c for p in parts for c in (p.chunks if isinstance(p, pa.ChunkedArray) else [p])]
            )

        self._base = _build_base(
            cat(s_mid, np.uint64), cat(s_tsid, np.uint64),
            cat(i_mid, np.uint64), cat(i_hash, np.uint64), cat(i_tsid, np.uint64),
            cat_arrow(i_key), cat_arrow(i_val),
        )

    # -- write path ----------------------------------------------------------
    def _is_known(self, mid: int, tsid: int) -> bool:
        base = self._base.get(mid)
        if base is not None and base.has_tsid(tsid):
            return True
        delta = self._metric_known.get(mid)
        return delta is not None and tsid in delta

    async def populate_series_ids(
        self,
        metric_ids: list[int],
        label_sets: list[list[tuple[bytes, bytes]]],
        now_ms: int,
    ) -> list[SeriesId]:
        """Resolve TSIDs for (metric, labels) pairs, registering new series
        in the series table and the inverted index. The series keys and
        the new series' tag pairs are hashed in one batch each."""
        keys = [series_key_of(labels) for labels in label_sets]
        tsids = seahash_many(keys).tolist()
        new_series_rows: list[tuple[int, int, bytes]] = []
        new_pairs: list[tuple[int, int, bytes, bytes]] = []
        staged: set[tuple[int, int]] = set()
        for mid, labels, key, tsid in zip(metric_ids, label_sets, keys, tsids):
            if self._is_known(mid, tsid) or (mid, tsid) in staged:
                continue
            staged.add((mid, tsid))
            new_series_rows.append((mid, tsid, key))
            for k, v in labels:
                new_pairs.append((mid, tsid, k, v))
        if new_series_rows:
            hashes = tag_hashes_of([(k, v) for _m, _t, k, v in new_pairs]).tolist()
            new_index_rows = [(m, h, t, k, v) for (m, t, k, v), h in zip(new_pairs, hashes)]
            # Persist FIRST, update caches only on success: caching before a
            # failed write would mark the series known while the durable
            # index rows never land.
            await self._persist(new_series_rows, new_index_rows, now_ms)
            if self._commit_rows(new_series_rows, new_index_rows):
                await self._compact_delta()
        return tsids

    def _commit_rows(self, series_rows, index_rows) -> bool:
        """Apply persisted rows to the in-memory delta (under the lock —
        queries read these structures from worker threads). Returns True
        when the delta is due for compaction."""
        with self._mu:
            for mid, tsid, _key in series_rows:
                s = self._metric_known[mid]
                if tsid not in s:
                    s.add(tsid)
                    self._delta_series += 1
            for mid, h, tsid, k, v in index_rows:
                self._postings[(mid, h)][tsid] = (k, v)
                self._metric_postings[mid].add((mid, h))
            return self._delta_series >= DELTA_COMPACT_THRESHOLD

    async def _compact_delta(self) -> None:
        """Merge the delta dicts into fresh base arrays (atomic swap).

        The heavy merge runs in a worker thread — the base is immutable, so
        the event loop only pays the two short lock sections. Registrations
        that land WHILE merging survive: the swap subtracts exactly the
        snapshot that was merged instead of clearing the delta."""
        import asyncio

        if self._compact_lock is None:
            self._compact_lock = asyncio.Lock()
        async with self._compact_lock:
            with self._mu:
                # re-check: writers queued behind an in-flight merge must
                # not each repeat a full-base merge on a near-empty delta
                if self._delta_series < DELTA_COMPACT_THRESHOLD:
                    return
                known = {m: set(s) for m, s in self._metric_known.items()}
                postings = {k: dict(v) for k, v in self._postings.items()}
                base = self._base
            merged = await asyncio.to_thread(
                self._merge_delta_into_base, base, known, postings
            )
            with self._mu:
                self._base = merged
                for m, s in known.items():
                    live = self._metric_known.get(m)
                    if live is not None:
                        live -= s
                        self._delta_series -= len(s)
                        if not live:
                            del self._metric_known[m]
                for pk, rows in postings.items():
                    live_rows = self._postings.get(pk)
                    if live_rows is None:
                        continue
                    for t in rows:
                        live_rows.pop(t, None)
                    if not live_rows:
                        del self._postings[pk]
                        mp = self._metric_postings.get(pk[0])
                        if mp is not None:
                            mp.discard(pk)
                            if not mp:
                                del self._metric_postings[pk[0]]

    @staticmethod
    def _merge_delta_into_base(
        base: dict[int, _MetricIndex], known, postings
    ) -> dict[int, _MetricIndex]:
        s_mid_l, s_tsid_l = [], []
        for m, s in known.items():
            s_mid_l.extend([m] * len(s))
            s_tsid_l.extend(s)
        i_mid, i_hash, i_tsid, i_key, i_val = [], [], [], [], []
        for (m, h), rows in postings.items():
            for t, (k, v) in rows.items():
                i_mid.append(m)
                i_hash.append(h)
                i_tsid.append(t)
                i_key.append(k)
                i_val.append(v)
        delta_base = _build_base(
            np.asarray(s_mid_l, dtype=np.uint64),
            np.asarray(s_tsid_l, dtype=np.uint64),
            np.asarray(i_mid, dtype=np.uint64),
            np.asarray(i_hash, dtype=np.uint64),
            np.asarray(i_tsid, dtype=np.uint64),
            pa.array(i_key, pa.binary()),
            pa.array(i_val, pa.binary()),
        )
        merged: dict[int, _MetricIndex] = dict(base)
        for m, d in delta_base.items():
            b = merged.get(m)
            if b is None:
                merged[m] = d
                continue
            order = np.argsort(
                np.concatenate([b.p_hash, d.p_hash]), kind="stable"
            )
            ph = np.concatenate([b.p_hash, d.p_hash])[order]
            pt = np.concatenate([b.p_tsid, d.p_tsid])[order]
            keys = pa.concat_arrays([
                *(b.p_key.chunks if isinstance(b.p_key, pa.ChunkedArray) else [b.p_key]),
                *(d.p_key.chunks if isinstance(d.p_key, pa.ChunkedArray) else [d.p_key]),
            ]).take(pa.array(order))
            vals = pa.concat_arrays([
                *(b.p_value.chunks if isinstance(b.p_value, pa.ChunkedArray) else [b.p_value]),
                *(d.p_value.chunks if isinstance(d.p_value, pa.ChunkedArray) else [d.p_value]),
            ]).take(pa.array(order))
            merged[m] = _MetricIndex(
                tsids=np.unique(np.concatenate([b.tsids, d.tsids])),
                p_hash=ph, p_tsid=pt, p_key=keys, p_value=vals,
            )
        return merged

    async def _persist(self, series_rows, index_rows, now_ms: int) -> None:
        seg_start = now_ms - now_ms % self._segment_duration
        rng = TimeRange(seg_start, seg_start + 1)
        s_batch = pa.RecordBatch.from_pydict(
            {
                "metric_id": np.asarray([r[0] for r in series_rows], dtype=np.uint64),
                "tsid": np.asarray([r[1] for r in series_rows], dtype=np.uint64),
                "series_key": [r[2] for r in series_rows],
            },
            schema=SERIES_SCHEMA,
        )
        if not index_rows:
            await self._series.write(WriteRequest(s_batch, rng))
            return
        # optional tags table first: distinct (metric, key, value) rows are
        # advisory ghosts until the index/series writes land — harmless on
        # a crash, and writing them last could lose a LabelValues row for
        # an acked series forever
        if self._tags is not None:
            dedup: dict[tuple[int, int], tuple] = {}
            for m, h, _t, k, v in index_rows:
                if (m, h) not in self._tags_seen:
                    dedup.setdefault((m, h), (m, h, k, v))
            if dedup:
                await self._write_tags_rows(list(dedup.values()), rng)
        i_batch = pa.RecordBatch.from_pydict(
            {
                "metric_id": np.asarray([r[0] for r in index_rows], dtype=np.uint64),
                "tag_hash": np.asarray([r[1] for r in index_rows], dtype=np.uint64),
                "tsid": np.asarray([r[2] for r in index_rows], dtype=np.uint64),
                "tag_key": [r[3] for r in index_rows],
                "tag_value": [r[4] for r in index_rows],
            },
            schema=INDEX_SCHEMA,
        )
        # index BEFORE series: "known" (series-ack) derives from the SERIES
        # table (_is_known), so the recoverable half-state must be
        # postings-without-series — a benign ghost (no samples can have been
        # acked for it; a retry rewrites both batches idempotently, pk+seq
        # dedup). The inverse order would leave a series marked known with
        # its postings missing FOREVER: tag-filtered queries would silently
        # skip it while its samples keep landing.
        await self._index.write(WriteRequest(i_batch, rng))
        await self._series.write(WriteRequest(s_batch, rng))

    async def _write_tags_rows(
        self, rows: list[tuple], rng: TimeRange
    ) -> None:
        """Write distinct (metric_id, tag_hash, key, value) rows to the
        tags table and record them in the bounded seen-set (cleared
        wholesale at the cap, like the series seen-cache — a miss only
        costs an idempotent pk-overwrite rewrite)."""
        t_batch = pa.RecordBatch.from_pydict(
            {
                "metric_id": np.asarray([r[0] for r in rows], dtype=np.uint64),
                "tag_hash": np.asarray([r[1] for r in rows], dtype=np.uint64),
                "tag_key": [r[2] for r in rows],
                "tag_value": [r[3] for r in rows],
            },
            schema=TAGS_SCHEMA,
        )
        await self._tags.write(WriteRequest(t_batch, rng))
        if len(self._tags_seen) > SEEN_CACHE_MAX:
            self._tags_seen.clear()
        self._tags_seen.update((r[0], r[1]) for r in rows)

    # -- query path ------------------------------------------------------------
    def _metric_delta(self, metric_id: int):
        """Copy ONE metric's delta (postings + tsids) under the lock — used
        by matcher/listing paths; equality filters copy per-hash instead."""
        with self._mu:
            base = self._base.get(metric_id, _EMPTY)
            delta_keys = list(self._metric_postings.get(metric_id, ()))
            delta_postings = {pk: dict(self._postings[pk]) for pk in delta_keys}
            delta_tsids = set(self._metric_known.get(metric_id, ()))
        return base, delta_postings, delta_tsids

    def find_tsids(
        self,
        metric_id: int,
        filters: list[tuple[bytes, bytes]],
        matchers: "list[tuple[bytes, str, bytes]] | None" = None,
    ) -> list[SeriesId] | None:
        """TSIDs matching ALL tag filters; None means 'no constraint' (caller
        scans the whole metric). Posting lists verify raw bytes to reject
        hash collisions.

        `matchers` extends equality with Prometheus-style ops per
        (key, op, pattern): "ne" (!=), "re" (=~ full-match), "nre" (!~).
        Base postings evaluate regexes once per unique value (arrow
        dictionary encoding); only matching series materialize Python ints."""
        if not filters and not matchers:
            return None
        result: set[int] | None = None

        def intersect(matched: set[int]) -> bool:
            nonlocal result
            result = matched if result is None else (result & matched)
            return bool(result)

        if filters:
            hashes = [tag_hash_of(k, v) for k, v in filters]
            with self._mu:
                base = self._base.get(metric_id, _EMPTY)
                flt_delta = [
                    dict(self._postings.get((metric_id, h), {})) for h in hashes
                ]
            for (k, v), h, drows in zip(filters, hashes, flt_delta):
                matched = set(base.posting(h, k, v).tolist())
                for t, kv in drows.items():
                    if kv == (k, v):
                        matched.add(t)
                if not intersect(matched):
                    return []
        if matchers:
            base, delta_postings, delta_tsids = self._metric_delta(metric_id)
            # all_tsids/present materialize O(series) Python ints — computed
            # lazily, only in the branches that actually union over absent
            # series ('nre', '!= non-empty', or a regex matching empty)
            _all: list[set] = []

            def all_tsids() -> set:
                if not _all:
                    _all.append(set(base.tsids.tolist()) | delta_tsids)
                return _all[0]

            for k, op, pattern in matchers:
                # base rows for this key, dictionary-encoded: the predicate
                # evaluates once per UNIQUE value, series fan out by code
                b_tsids, b_values = base.key_rows(k)
                enc = b_values.dictionary_encode()
                uniq_vals = enc.dictionary.to_pylist()
                codes = np.asarray(enc.indices.to_numpy(zero_copy_only=False))
                # delta overlay (small): tsid -> value for this key; delta
                # wins over base on duplicates
                delta_vals: dict[int, bytes] = {}
                for _pk, rows in delta_postings.items():
                    for t, (kk, vv) in rows.items():
                        if kk == k:
                            delta_vals[t] = vv
                if op == "ne":
                    # absent label reads as b"": it matches != pattern
                    # unless the pattern is itself empty
                    ok_uniq = np.asarray([v != pattern for v in uniq_vals], bool)
                elif op in ("re", "nre"):
                    rx = _compile_matcher(pattern)
                    ok_uniq = np.asarray(
                        [rx.fullmatch(_subject_of(v)) is not None for v in uniq_vals],
                        bool,
                    )
                else:
                    raise HoraeError(f"unknown matcher op: {op!r}")
                hit = (
                    set(b_tsids[ok_uniq[codes]].tolist())
                    if len(b_tsids) else set()
                )
                # delta overlay corrections
                for t, v in delta_vals.items():
                    if op == "ne":
                        v_ok = v != pattern
                    else:
                        v_ok = rx.fullmatch(_subject_of(v)) is not None
                    (hit.add if v_ok else hit.discard)(t)

                def absent() -> set:
                    # absent-label semantics: value reads as b""
                    return all_tsids() - (set(b_tsids.tolist()) | set(delta_vals))

                if op == "ne":
                    if pattern != b"":
                        hit |= absent()
                    matched = hit
                else:
                    if rx.fullmatch(""):
                        hit |= absent()
                    matched = hit if op == "re" else (all_tsids() - hit)
                if not intersect(matched):
                    return []
        return sorted(result)

    def series_of(self, metric_id: int) -> list[SeriesId]:
        """All known TSIDs of a metric (the no-tag-filter downsample scope)."""
        with self._mu:
            base = self._base.get(metric_id, _EMPTY)
            delta_tsids = set(self._metric_known.get(metric_id, ()))
        return sorted(set(base.tsids.tolist()) | delta_tsids)

    def series_lanes(self) -> tuple[np.ndarray, np.ndarray]:
        """(metric_id, tsid) u64 lanes of EVERY registered series — the
        cardinality sketch's recovery seed at engine open (the sketch is
        in-memory; restarts rebuild it from the index, which open just
        loaded anyway)."""
        mids: list[np.ndarray] = []
        tsids: list[np.ndarray] = []
        with self._mu:
            base_items = list(self._base.items())
            delta_items = [
                (m, np.fromiter(s, dtype=np.uint64, count=len(s)))
                for m, s in self._metric_known.items() if s
            ]
        for m, idx in base_items:
            if len(idx.tsids):
                mids.append(np.full(len(idx.tsids), m, dtype=np.uint64))
                tsids.append(idx.tsids.astype(np.uint64, copy=False))
        for m, arr in delta_items:
            mids.append(np.full(len(arr), m, dtype=np.uint64))
            tsids.append(arr)
        if not mids:
            e = np.empty(0, dtype=np.uint64)
            return e, e
        return np.concatenate(mids), np.concatenate(tsids)

    def label_values(self, metric_id: int, key: bytes) -> list[bytes]:
        """LabelValues via the inverted index (the RFC's two-step fallback,
        RFC :120-130). Unique values come straight from the dictionary —
        no per-series materialization."""
        base, delta_postings, _dt = self._metric_delta(metric_id)
        _tsids, b_values = base.key_rows(key)
        out = set(b_values.dictionary_encode().dictionary.to_pylist())
        for _pk, rows in delta_postings.items():
            for _t, (kk, vv) in rows.items():
                if kk == key:
                    out.add(vv)
        return sorted(out)

    def series_labels(self, metric_id: int) -> dict[int, dict[bytes, bytes]]:
        """tsid -> label map for every series of a metric, including series
        with no tags at all (seeded from the known-series set so tagless
        series don't vanish from listings). Materializes Python objects —
        an admin/listing surface, not a hot path."""
        base, delta_postings, delta_tsids = self._metric_delta(metric_id)
        per_tsid: dict[int, dict[bytes, bytes]] = {
            int(t): {} for t in base.tsids
        }
        for t in delta_tsids:
            per_tsid.setdefault(t, {})
        kcol = base.p_key.to_pylist()
        vcol = base.p_value.to_pylist()
        for t, k, v in zip(base.p_tsid.tolist(), kcol, vcol):
            per_tsid.setdefault(t, {})[k] = v
        for _pk, rows in delta_postings.items():
            for tsid, (k, v) in rows.items():
                per_tsid.setdefault(tsid, {})[k] = v
        return per_tsid
