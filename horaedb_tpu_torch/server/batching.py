"""Query batcher: coalesce compatible grid queries into ONE stacked launch.

A port of the JAX package's `server/batching.py`, unchanged in behaviour:

- **Shape classes.** Grid queries group by (bucket_ms, num_buckets,
  power-of-two series class, device). Members differ only in their series
  sets and start offsets (`t0` is a per-query operand), so padding the
  series axis to the shared class makes every member layout-identical.
- **Hold-for-coalescing window.** The FIRST member of a class arms a
  `max_delay` timer; compatible arrivals join until the window closes or
  `max_group` fills. A query with no concurrent batchable company launches
  solo IMMEDIATELY (`batched_with=1`, no window), and a query whose
  end-to-end deadline cannot cover the window never waits.
- **One stacked launch.** The group's scans run concurrently (the same
  merged/deduped row materialization a solo query uses; members with one
  `share_key` share ONE union scan), rows pad to a power-of-two row
  bucket, queries pad to a power-of-two batch axis, and ONE
  `ops/aggregate.py::stacked_downsample` call (kernel `stacked_downsample`
  on the card) reduces every member's grid. Results de-multiplex per
  member, bitwise equal to solo execution on the device lanes: each
  member's cells fold exactly its own rows in scan order
  (`csrc/segreduce.cuh` folds a cell's rows left to right, wherever they
  sit in the buffer). On a CPU engine whose calibration picks the host
  `reduceat` lane for the solo route, numpy associates a solo cell's sum
  otherwise: its last bits may differ (counts, min and max stay equal).
- **Deadlines survive.** Group execution runs detached
  (deadline_ctx.detach, its own scanstats collector): a member whose
  deadline dies mid-batch raises DeadlineExceeded alone while the rest of
  the group completes.

Honesty: `HORAEDB_BATCH=off` (read per query) forces every query down the
solo path, the A/B oracle the parity tests assert against. Each member's
notes carry `batched_with=N`, pad waste, the shape class and the window
wait; the `horaedb_batch_*` families below count decisions and launches.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass, field

import numpy as np

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, to_device
from horaedb_tpu_torch.common import deadline as deadline_ctx
from horaedb_tpu_torch.common.error import DeadlineExceeded
from horaedb_tpu_torch.common.time_ext import ReadableDuration
from horaedb_tpu_torch.server.metrics import GLOBAL_METRICS
from horaedb_tpu_torch.storage import scanstats

BATCH_GROUP_SIZE = GLOBAL_METRICS.histogram(
    "horaedb_batch_group_size",
    help="Queries per stacked kernel launch (1 never lands here — lone "
         "queries run the solo path without a launch; the window knob "
         "trades p50 hold time for bigger groups).",
    buckets=(1, 2, 4, 8, 16, 32, 64),
)
BATCH_PAD_WASTE = GLOBAL_METRICS.histogram(
    "horaedb_batch_pad_waste_ratio",
    help="Padded-but-dead fraction of each stacked launch's row buffer "
         "(batch x row x series padding to shared power-of-two buckets). "
         "Sustained high waste means the shape classes are too coarse "
         "for the traffic mix — see docs/operations.md 'Query batching'.",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99),
)
BATCH_WINDOW_WAIT = GLOBAL_METRICS.histogram(
    "horaedb_batch_window_wait_seconds",
    help="Time a coalesced query spent holding in the batching window "
         "before its group launched (bounded by "
         "[metric_engine.query.batching] max_delay).",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1),
)
BATCH_QUERIES = GLOBAL_METRICS.counter(
    "horaedb_batch_queries_total",
    help="Grid queries through the batching decision point, by mode: "
         "batched (rode a stacked launch), solo_lone (no concurrent "
         "batchable company — immediate solo, no window), solo_window "
         "(held the window but no co-runner arrived), solo_deadline "
         "(budget could not cover the window), solo_ineligible (shape "
         "outside the stacked lane's caps), solo_overflow (scan larger "
         "than max_rows — demoted after materialization), solo_off "
         "(batching disabled or HORAEDB_BATCH=off).",
    labelnames=("mode",),
)
BATCH_LAUNCHES = GLOBAL_METRICS.counter(
    "horaedb_batch_launches_total",
    help="Stacked kernel launches (each covers >= 2 coalesced queries).",
)

BATCH_MODES = ("batched", "solo_lone", "solo_window", "solo_deadline",
               "solo_ineligible", "solo_overflow", "solo_off")
for _m in BATCH_MODES:
    BATCH_QUERIES.labels(_m)
del _m
# window wait is a first-class scan stage (EXPLAIN stages_s, /metrics,
# the flight recorder of the JAX package's server)
scanstats.STAGE_SECONDS.labels("batch_window")

# Sentinel: the caller owns execution (run the normal solo path).
SOLO = object()

# row-bucket floor: shapes below this pad up to one row bucket (the JAX
# package's floor, kept so both packages pad alike). Kept small on
# purpose: the stacked reduction's cost scales with PADDED rows.
MIN_ROW_BUCKET = 64


def batch_env_off() -> bool:
    """The honesty switch: HORAEDB_BATCH=off forces every grid query down
    the solo path so batched answers can be asserted bit-exact (and the
    QPS lane A/B-measured) against unbatched execution. Read per query,
    not at import, so tests and operators flip it live."""
    return os.environ.get("HORAEDB_BATCH", "").lower() in (
        "off", "0", "false", "no",
    )


def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass
class BatchingConfig:
    """Knobs of the query batcher (`[metric_engine.query.batching]`).

    Defaults are ON: coalesced results are bit-exact vs solo execution
    by construction (regression- and property-tested), and the lone-query
    fast path means a 1-client workload never pays the window."""

    enabled: bool = True
    # hold-for-coalescing window: how long the first member of a shape
    # class waits for company before launching. The p50 floor at high
    # concurrency, the p50 ceiling for unlucky non-coalescible bursts.
    # 2 ms rides just above one event-loop turn: a concurrent burst's
    # co-runners arrive within microseconds of each other, so a longer
    # hold only ever taxes the unlucky.
    max_delay: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.millis(2)
    )
    # queries per stacked launch (a full group launches early)
    max_group: int = 16
    # ceiling on the stacked output grid (batch x padded series x
    # buckets); shapes that cannot fit two members run solo
    max_stacked_cells: int = 4 << 20
    # total padded-row budget of ONE stacked buffer (batch x row-bucket
    # after power-of-two padding, ~21 bytes/row); members whose scans
    # would blow it demote to the solo path, largest first
    max_rows: int = 1 << 20


class _Member:
    __slots__ = ("scan", "series_ids", "filtered", "share_key", "fut",
                 "enq_t")

    def __init__(self, scan, series_ids: np.ndarray, filtered: bool,
                 share_key, fut: asyncio.Future, enq_t: float):
        self.scan = scan
        self.series_ids = series_ids
        self.filtered = filtered
        self.share_key = share_key
        self.fut = fut
        self.enq_t = enq_t

    @property
    def n_series(self) -> int:
        return len(self.series_ids)


class _Group:
    __slots__ = ("key", "bucket_ms", "num_buckets", "spad", "members",
                 "t0s", "launched", "handle", "loop", "launch_t", "device")

    def __init__(self, key, bucket_ms: int, num_buckets: int, spad: int,
                 loop, device):
        self.key = key
        self.device = device
        self.bucket_ms = bucket_ms
        self.num_buckets = num_buckets
        self.spad = spad
        self.members: list[_Member] = []
        self.t0s: list[int] = []
        self.launched = False
        self.handle = None
        self.loop = loop
        self.launch_t = 0.0


class QueryBatcher:
    """The coalescing planner (module docstring has the contract).

    Event-loop-confined: all state mutates
    between awaits; groups remember their loop so a stale group from a
    finished test loop can never capture a live query."""

    def __init__(self, config: "BatchingConfig | None" = None,
                 clock=time.monotonic):
        self.config = config or BatchingConfig()
        self._clock = clock
        self._groups: dict[tuple, _Group] = {}
        # concurrent batchable CLIENTS between begin()/end(), keyed by
        # scanstats collector identity — the signal that a window is
        # worth holding at all. Collector-keyed (not a bare counter) so
        # a regioned query's own N fan-out sub-queries count as ONE
        # client: a lone regioned query keeps the no-window fast path
        # instead of its sub-queries holding windows for each other.
        self._active: dict[object, int] = {}
        self._tasks: set[asyncio.Task] = set()

    def configure(self, config: BatchingConfig) -> None:
        self.config = config

    def active(self) -> bool:
        return self.config.enabled and not batch_env_off()

    # -- concurrency tracking (the lone-query fast path's signal) ------------
    def begin(self) -> object:
        """A batchable grid query entered the cold execution path.
        Returns the token end() takes; sub-queries sharing a scanstats
        collector share a token (one client)."""
        st = scanstats.current()
        tok = id(st) if st is not None else object()
        self._active[tok] = self._active.get(tok, 0) + 1
        return tok

    def end(self, tok: object) -> None:
        n = self._active.get(tok, 0) - 1
        if n <= 0:
            self._active.pop(tok, None)
        else:
            self._active[tok] = n

    def note_ineligible(self) -> None:
        """Count a grid query the dispatch point could not batch (grid
        not segment-aligned, or a rollup plan covers it — the solo
        pushdown is strictly better there) without it entering the
        concurrency signal: company that can never join a group must
        not make other queries hold windows."""
        if not self.active():
            BATCH_QUERIES.labels("solo_off").inc()
            return
        BATCH_QUERIES.labels("solo_ineligible").inc()
        scanstats.note_max("batched_with", 1)

    # -- the coalescing protocol ---------------------------------------------
    def shape_key(self, bucket_ms: int, num_buckets: int,
                  n_series: int) -> tuple:
        """(step, window, power-of-two series class): members of one key
        are layout-identical after padding — the CostModel's power-of-two
        cell class (num_buckets x spad) in key form."""
        return (int(bucket_ms), int(num_buckets), pow2ceil(n_series))

    def _max_group_for(self, spad: int, num_buckets: int) -> int:
        cells = spad * num_buckets
        if cells <= 0:
            return 0
        return min(self.config.max_group,
                   self.config.max_stacked_cells // cells)

    async def coalesce(self, *, bucket_ms: int, num_buckets: int,
                       series_ids: np.ndarray, t0: int, filtered: bool,
                       share_key, scan, device=DEFAULT_DEVICE):
        """One grid query's batching decision. Returns SOLO (the caller
        runs the un-batched path; `batched_with=1` already noted) or
        `(grids | None, notes)` from a stacked group launch — `grids` has
        the solo return contract (dense [n_series, num_buckets] arrays
        for sum/count/min/max/mean over the caller's sorted `series_ids`;
        None = no surviving rows), `notes` is the group's provenance for
        the caller's collector.

        `scan(tsids | None)` is a coroutine materializing merged/deduped
        row lanes (ts i64, tsid u64, values f64) for a series set — or
        None when nothing is in range — and runs in the group's detached
        context. Members sharing `share_key` (same table, metric, and
        time range — the N-panels-one-dashboard case) are scanned ONCE
        with the union of their series sets and de-multiplexed, so the
        group pays one read where solo execution pays N."""
        n_series = len(series_ids)
        if not self.active():
            BATCH_QUERIES.labels("solo_off").inc()
            return SOLO
        key = self.shape_key(bucket_ms, num_buckets, n_series) + (str(device),)
        if n_series < 1 or num_buckets < 1 \
                or self._max_group_for(key[2], num_buckets) < 2:
            BATCH_QUERIES.labels("solo_ineligible").inc()
            scanstats.note_max("batched_with", 1)
            return SOLO
        window = self.config.max_delay.seconds
        rem = deadline_ctx.remaining_s()
        if rem is not None and rem < 4.0 * window:
            # the budget cannot cover the hold + a stacked execution:
            # keep every remaining millisecond for the solo scan
            BATCH_QUERIES.labels("solo_deadline").inc()
            scanstats.note_max("batched_with", 1)
            return SOLO
        loop = asyncio.get_running_loop()
        group = self._groups.get(key)
        if group is not None and group.loop is not loop:
            # stale group parked by a finished event loop (test harness
            # churn): unreachable timers can never fire — drop it
            self._groups.pop(key, None)
            group = None
        if group is None and len(self._active) <= 1:
            # lone query: no batchable company is even executing, so no
            # co-runner can arrive inside the window — solo NOW, no hold
            BATCH_QUERIES.labels("solo_lone").inc()
            scanstats.note_max("batched_with", 1)
            return SOLO
        if group is None or group.launched \
                or len(group.members) >= self._max_group_for(
                    key[2], num_buckets):
            group = _Group(key, int(bucket_ms), int(num_buckets), key[2],
                           loop, device)
            self._groups[key] = group
            group.handle = loop.call_later(
                window, self._launch, key, group
            )
        m = _Member(scan, series_ids, filtered, share_key,
                    loop.create_future(), self._clock())
        group.members.append(m)
        group.t0s.append(int(t0))
        if len(group.members) >= self._max_group_for(key[2], num_buckets):
            self._launch(key, group)  # full group: no reason to wait
        try:
            rem = deadline_ctx.remaining_s()
            if rem is None:
                res, notes = await asyncio.shield(m.fut)
            else:
                res, notes = await asyncio.wait_for(
                    asyncio.shield(m.fut), timeout=max(rem, 0.0)
                )
        except asyncio.TimeoutError:
            # mid-batch deadline expiry: leave the group (pre-launch:
            # the scan is never run; post-launch: the result is dropped)
            # and 504 with the standard deadline machinery. The explicit
            # raise covers the clock-edge race where wait_for fired a
            # hair before check() agrees — a bare TimeoutError must
            # never escape as a 500.
            self._abandon(group, m)
            deadline_ctx.check("batch_window")
            raise DeadlineExceeded(
                "query budget expired while coalescing",
                at="batch_window",
            ) from None
        except asyncio.CancelledError:
            # client disconnect while coalescing: same cleanup, then let
            # the cancellation unwind
            self._abandon(group, m)
            raise
        wait = group.launch_t - m.enq_t
        scanstats.record("batch_window", max(wait, 0.0))
        BATCH_WINDOW_WAIT.observe(max(wait, 0.0))
        if res is SOLO:
            # held the window but everyone else left (or never came), or
            # the scan overflowed the stacked buffer: caller runs solo
            scanstats.note_max("batched_with", 1)
            return SOLO
        return res, notes

    def _abandon(self, group: _Group, m: _Member) -> None:
        if not group.launched:
            try:
                i = group.members.index(m)
            except ValueError:
                return
            group.members.pop(i)
            group.t0s.pop(i)
            if not group.members:
                if group.handle is not None:
                    group.handle.cancel()
                if self._groups.get(group.key) is group:
                    del self._groups[group.key]
        if not m.fut.done():
            m.fut.cancel()
        elif not m.fut.cancelled():
            # the group resolved in the abandon race: consume the result
            # so an unretrieved exception never warns at GC
            m.fut.exception()

    def _launch(self, key, group: _Group) -> None:
        """Close the window: detach the group from the pending map and
        hand it to a planner-owned execution task (no member's deadline
        or cancellation can kill the shared work)."""
        if group.launched:
            return
        group.launched = True
        group.launch_t = self._clock()
        if group.handle is not None:
            group.handle.cancel()
        if self._groups.get(key) is group:
            del self._groups[key]
        if not group.members:
            return
        if len(group.members) == 1:
            # the co-runners the window bet on never arrived (or all
            # abandoned): release the survivor to the solo path
            BATCH_QUERIES.labels("solo_window").inc()
            m = group.members[0]
            if not m.fut.done():
                m.fut.set_result((SOLO, None))
            return
        task = group.loop.create_task(self._execute(group))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _execute(self, group: _Group) -> None:
        """Scan every member (one union scan per share_key cluster),
        stack, launch ONE kernel, de-multiplex."""
        deadline_ctx.detach()  # no member budget owns the shared work
        members = group.members
        try:
            with scanstats.scan_stats() as st:
                lanes = await self._scan_members(members)
                results = self._stack_and_launch(group, lanes)
            notes = dict(st.counts)
        except Exception as e:  # noqa: BLE001 — fan the failure out
            for m in members:
                if not m.fut.done():
                    m.fut.set_exception(e)
            return
        live = [
            i for i, r in enumerate(results)
            if not isinstance(r, BaseException) and r is not SOLO
        ]
        pct = notes.pop("_pad_waste_pct", 0)
        cls = f"batch_class_b{group.bucket_ms}" \
              f"_t{group.num_buckets}_s{group.spad}"
        batched_n = 0
        for i, m in enumerate(members):
            if m.fut.done():
                continue
            r = results[i]
            if isinstance(r, BaseException):
                m.fut.set_exception(r)
            elif r is SOLO:
                BATCH_QUERIES.labels("solo_overflow").inc()
                m.fut.set_result((SOLO, None))
            else:
                # empty (None) results count as batched too: the query
                # rode the group's shared scan — sum-over-modes of
                # horaedb_batch_queries_total must cover every decision
                batched_n += 1
                m.fut.set_result((r, {
                    **notes,
                    "batched_with": len(live),
                    "batch_pad_waste_pct": pct,
                    cls: 1,
                }))
        if batched_n:
            BATCH_QUERIES.labels("batched").inc(batched_n)

    async def _scan_members(self, members: list) -> list:
        """Materialize every member's row lanes, sharing one union scan
        across members whose share_key matches (same table + metric +
        time range, the dashboard-panel case). Returns one entry per
        member: (ts, dense sid, values) | None | BaseException."""
        clusters: dict = {}
        for i, m in enumerate(members):
            clusters.setdefault(m.share_key, []).append(i)
        lanes: list = [None] * len(members)

        async def one_cluster(idxs: list[int]) -> None:
            ms = [members[i] for i in idxs]
            try:
                if len(ms) == 1:
                    m = ms[0]
                    rows = await m.scan(
                        [int(x) for x in m.series_ids]
                        if m.filtered else None
                    )
                elif not all(m.filtered for m in ms):
                    # an unfiltered member's series set IS the metric's
                    # full set: scanning without the membership predicate
                    # covers every member (each demuxes to its own set)
                    scanstats.note("batch_shared_scans", len(ms) - 1)
                    rows = await ms[0].scan(None)
                else:
                    scanstats.note("batch_shared_scans", len(ms) - 1)
                    union = ms[0].series_ids
                    for m in ms[1:]:
                        union = np.union1d(union, m.series_ids)
                    rows = await ms[0].scan([int(x) for x in union])
            except BaseException as e:  # noqa: BLE001 — per-member fate
                for i in idxs:
                    lanes[i] = e
                return
            for i in idxs:
                lanes[i] = self._demux_rows(members[i], rows)

        await asyncio.gather(*(one_cluster(v) for v in clusters.values()))
        return lanes

    @staticmethod
    def _demux_rows(m: _Member, rows):
        """One member's lanes out of a (possibly shared) scan: rows whose
        tsid is in the member's set, dense-indexed against its sorted
        series_ids. Selection preserves the scan's (tsid, ts) order, so
        each cell still accumulates its rows exactly as a member-only
        scan would deliver them."""
        if rows is None:
            return None
        ts, tsid, vals = rows
        pos = np.searchsorted(m.series_ids, tsid)
        pos_c = np.clip(pos, 0, max(0, len(m.series_ids) - 1))
        hit = m.series_ids[pos_c] == tsid
        if bool(hit.all()):
            return ts, pos_c.astype(np.int32), vals
        sel = np.flatnonzero(hit)
        if not len(sel):
            return None
        return ts[sel], pos_c[sel].astype(np.int32), vals[sel]

    def _stack_and_launch(self, group: _Group, lanes: list) -> list:
        """Pad member row lanes to shared power-of-two buckets, run ONE
        stacked kernel, slice per-member grids back out. Synchronous (no
        awaits): runs on the event loop like the solo fold path. Returns
        one entry per member: grids dict | None | SOLO (overflow) |
        BaseException (that member's scan failed)."""
        members = group.members
        results: list = [None] * len(members)
        stack_idx: list[int] = []
        for i, lane in enumerate(lanes):
            if isinstance(lane, BaseException):
                results[i] = lane
            elif lane is not None:
                stack_idx.append(i)
            # lane None: nothing in range — results[i] stays None
        # fit the padded buffer inside the max_rows budget: demote the
        # largest members to the solo path until Bpad x Rpad fits (a
        # stacked launch must never allocate an unbounded buffer just
        # because one member's scan came back huge). A sole fitting
        # member still launches stacked (B=1): its scan is already paid
        # — demoting it would re-run the whole read on the solo path.
        while stack_idx:
            bpad = pow2ceil(len(stack_idx))
            rpad = max(
                MIN_ROW_BUCKET,
                pow2ceil(max(len(lanes[i][0]) for i in stack_idx)),
            )
            if bpad * rpad <= self.config.max_rows:
                break
            big = max(stack_idx, key=lambda i: len(lanes[i][0]))
            stack_idx.remove(big)
            results[big] = SOLO
        if not stack_idx:
            return results
        import torch

        from horaedb_tpu_torch.ops import aggregate as agg_ops

        bsz = len(stack_idx)
        spad = group.spad
        nb = group.num_buckets
        ts_b = np.zeros((bpad, rpad), dtype=np.int64)
        sid_b = np.zeros((bpad, rpad), dtype=np.int32)
        val_b = np.zeros((bpad, rpad), dtype=np.float64)
        ok_b = np.zeros((bpad, rpad), dtype=bool)
        t0_b = np.zeros((bpad,), dtype=np.int64)
        rows = 0
        for j, i in enumerate(stack_idx):
            ts, sid, vals = lanes[i]
            n = len(ts)
            rows += n
            ts_b[j, :n] = ts
            sid_b[j, :n] = sid
            val_b[j, :n] = vals
            ok_b[j, :n] = True
            t0_b[j] = group.t0s[i]
        waste = 1.0 - rows / float(bpad * rpad)
        dev = torch.device(group.device)
        with scanstats.stage("device_agg"):
            out = agg_ops.stacked_downsample(
                to_device(ts_b, dev), to_device(sid_b, dev), to_device(val_b, dev),
                to_device(ok_b, dev), to_device(t0_b, dev), group.bucket_ms,
                num_series=spad, num_buckets=nb,
            )
            grids = {k: v.cpu().numpy() for k, v in out.items()}
        BATCH_LAUNCHES.inc()
        BATCH_GROUP_SIZE.observe(bsz)
        BATCH_PAD_WASTE.observe(waste)
        scanstats.note("batch_stacked_rows", rows)
        # ride the waste ratio out through the group collector's notes
        # (int percent; _execute pops it into the per-member notes)
        scanstats.note("_pad_waste_pct", int(round(waste * 100)))
        for j, i in enumerate(stack_idx):
            s = members[i].n_series
            # contiguous copies: a sliced view would pin the whole padded
            # stacked grid alive for as long as any member's answer lives
            g = {
                k: np.ascontiguousarray(grids[k][j, :s, :])
                for k in ("sum", "count", "min", "max", "mean")
            }
            # match the solo contract: an all-empty grid is None
            results[i] = g if g["count"].sum() != 0 else None
        return results


# The process-global planner (a server configures it from
# [metric_engine.query.batching]; engine-level callers use the defaults).
GLOBAL_BATCHER = QueryBatcher()
