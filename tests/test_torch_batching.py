"""The port's query batcher (server/batching.py) and its stacked kernel's
plain version (ops/aggregate.py::stacked_downsample_plain), on the CPU.

- `stacked_downsample` on CPU tensors against the JAX package's
  `stacked_downsample` on the shapes of tests/test_batching.py (batch, row
  and series axes in different power-of-two classes) with quarter-integer
  and with non-dyadic values, and against the port's own solo reduction
  (`downsample_sorted`): bitwise, sums as u64 views, with the dispatcher
  pinned to a device lane; under the CPU calibration's host `reduceat`
  lane, counts, min and max bitwise and sums within 2^-40 x a cell's L1
  mass;
- engine bursts (asyncio.gather, each member under its own scanstats
  collector) against the same queries under HORAEDB_BATCH=off, bitwise:
  filtered panels, a shared union scan with an unfiltered member, the
  lone-query path, `max_rows` demotion, a mid-batch deadline, an
  unaligned grid, and HORAEDB_BATCH=off itself.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from horaedb_tpu.ops import aggregate as jax_agg
from horaedb_tpu.pb import remote_write_pb2
from horaedb_tpu_torch.common.deadline import Deadline, deadline_scope
from horaedb_tpu_torch.common.error import DeadlineExceeded
from horaedb_tpu_torch.common.time_ext import ReadableDuration
from horaedb_tpu_torch.engine import MetricEngine, QueryRequest
from horaedb_tpu_torch.objstore import MemStore
from horaedb_tpu_torch.ops import agg_registry
from horaedb_tpu_torch.ops import aggregate as agg
from horaedb_tpu_torch.server import batching
from horaedb_tpu_torch.server.batching import SOLO, BatchingConfig, QueryBatcher, pow2ceil
from horaedb_tpu_torch.serving import ServingTierConfig
from horaedb_tpu_torch.storage import scanstats

BASE = 1_700_000_000_000
ms = ReadableDuration.millis


@pytest.fixture(autouse=True)
def _batch_env(monkeypatch, tmp_path):
    """Batching on, a fresh planner state per test, and the aggregation
    dispatcher's calibration file under `tmp_path` with no pin."""
    monkeypatch.delenv("HORAEDB_BATCH", raising=False)
    for var in ("HORAEDB_AGG_IMPL", "HORAEDB_SORTED_IMPL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HORAEDB_AGG_CACHE", str(tmp_path / "torch_agg_calib.json"))
    monkeypatch.setenv("HORAEDB_AGG_CALIB_N", "4096")
    agg_registry.reset_cache(memory_only=True)
    g = batching.GLOBAL_BATCHER
    saved = g.config
    g.configure(BatchingConfig())
    g._groups.clear()
    g._active.clear()
    yield
    g.configure(saved)
    g._groups.clear()
    g._active.clear()
    agg_registry.reset_cache(memory_only=True)


@pytest.fixture
def device_lanes(monkeypatch):
    """The solo route's dispatcher pinned to a device lane (kernel B's
    plain version here): stacked == solo bitwise is the device lanes'
    promise. Unpinned, the CPU calibration may pick the host reduceat lane
    (test_solo_sums_under_the_calibrated_lane)."""
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "block")


def make_payload(metric=b"batch_cpu", n_series=16, n_samples=30, seed=0):
    """Non-dyadic values (uniform floats), so a sum's association shows in
    its last bits."""
    rng = np.random.default_rng(seed)
    req = remote_write_pb2.WriteRequest()
    for s in range(n_series):
        series = req.timeseries.add()
        for k, v in ((b"__name__", metric), (b"host", f"h{s:03d}".encode()),
                     (b"rack", f"r{s % 3}".encode())):
            lab = series.labels.add()
            lab.name = k
            lab.value = v
        for i in range(n_samples):
            smp = series.samples.add()
            smp.timestamp = BASE + i * 1000
            smp.value = float(rng.uniform(-50, 150))
    return req.SerializeToString()


async def open_engine():
    return await MetricEngine.open("db", MemStore(), enable_compaction=False,
                                   serving=ServingTierConfig(enabled=False), device="cpu")


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint64), b.view(np.uint64))


def assert_same_result(got, want, ctx=""):
    assert (got is None) == (want is None), ctx
    if got is None:
        return
    assert got[0] == want[0], ctx
    for k in ("sum", "count", "min", "max", "mean"):
        assert same_bits(got[1][k], want[1][k]), f"{ctx}:{k}"


async def solo_then_burst(eng, reqs):
    """(solo answers under HORAEDB_BATCH=off, burst answers, each burst
    member's notes)."""
    os.environ["HORAEDB_BATCH"] = "off"
    solo = [await eng.query(r) for r in reqs]
    os.environ.pop("HORAEDB_BATCH", None)
    counts = [None] * len(reqs)

    async def one(i):
        with scanstats.scan_stats() as st:
            r = await eng.query(reqs[i])
        counts[i] = dict(st.counts)
        return r

    got = await asyncio.gather(*(one(i) for i in range(len(reqs))))
    return solo, got, counts


def host_reqs(n, bucket_ms=5000, start=BASE, span=30_000):
    return [QueryRequest(metric=b"batch_cpu", start_ms=start, end_ms=start + span,
                         bucket_ms=bucket_ms, filters=[(b"host", f"h{s:03d}".encode())])
            for s in range(n)]


@pytest.mark.parametrize("values", ["quarter", "uniform"])
@pytest.mark.usefixtures("device_lanes")
def test_stacked_plain_matches_jax_and_solo(values):
    rng = np.random.default_rng(42)
    for B, rpad, S, T in [(2, 32, 1, 4), (3, 64, 8, 6), (5, 128, 16, 3), (8, 64, 3, 10)]:
        bucket_ms = 1000
        ts_b = np.zeros((B, rpad), np.int64)
        sid_b = np.zeros((B, rpad), np.int32)
        val_b = np.zeros((B, rpad), np.float64)
        ok_b = np.zeros((B, rpad), bool)
        t0_b = np.zeros((B,), np.int64)
        solo = []
        for q in range(B):
            n = int(rng.integers(0, rpad))
            sid = np.sort(rng.integers(0, S, n)).astype(np.int32)
            ts = rng.integers(0, T * bucket_ms, n).astype(np.int64)
            order = np.lexsort((ts, sid))
            sid, ts = sid[order], ts[order]
            t0 = int(q * 7919)
            ts = ts + t0
            vals = (rng.integers(-1000, 1000, n).astype(np.float64) / 4 if values == "quarter"
                    else rng.uniform(-1e3, 1e3, n))
            solo.append(agg.downsample_sorted(ts, sid, vals, t0, bucket_ms, num_series=S,
                                              num_buckets=T, device="cpu"))
            ts_b[q, :n], sid_b[q, :n], val_b[q, :n], ok_b[q, :n] = ts, sid, vals, True
            t0_b[q] = t0
        got = agg.stacked_downsample(*(torch.from_numpy(a) for a in (ts_b, sid_b, val_b, ok_b,
                                                                      t0_b)),
                                     bucket_ms, num_series=S, num_buckets=T)
        want = jax_agg.stacked_downsample(ts_b, sid_b, val_b, ok_b, t0_b, bucket_ms,
                                          num_series=S, num_buckets=T)
        for k in ("sum", "count", "min", "max", "mean"):
            assert same_bits(got[k].numpy(), np.asarray(want[k])), (B, rpad, S, T, k)
            for q in range(B):
                assert same_bits(got[k][q].numpy(), solo[q][k].numpy()), (B, rpad, S, T, q, k)


def out_of_grid_case(seed: int = 5):
    """Two series sorted by (sid, ts): cell (0, 0) holds 700 in-grid rows
    (a run past segreduce's 256-row threshold, so its sum is folded in
    chunks counted from its head), with 37 rows of the same series before
    t0 ahead of it and 41 past the grid behind series 0's last bucket;
    non-dyadic values."""
    rng = np.random.default_rng(seed)
    S, T, bucket_ms, t0 = 2, 3, 1000, 10_000
    parts = []
    for s in range(S):
        ts = np.concatenate([rng.integers(t0 - 3000, t0, 37), rng.integers(t0, t0 + 1000, 700),
                             rng.integers(t0 + 1000, t0 + T * 1000, 300),
                             rng.integers(t0 + T * 1000, t0 + 9000, 41)])
        parts.append((np.full(len(ts), s, np.int32), np.sort(ts).astype(np.int64)))
    sid = np.concatenate([p[0] for p in parts])
    ts = np.concatenate([p[1] for p in parts])
    vals = rng.uniform(-1e3, 1e3, len(ts))
    return ts, sid, vals, t0, bucket_ms, S, T


@pytest.mark.usefixtures("device_lanes")
def test_out_of_grid_rows_keep_solo_bitwise_equal_to_stacked():
    """downsample_sorted drops rows outside the grid before the reduction,
    as the stacked lane does, so a cell of more than 256 rows with such rows
    of its series ahead of it sums in the stacked lane's association."""
    ts, sid, vals, t0, bucket_ms, S, T = out_of_grid_case()
    solo = agg.downsample_sorted(ts, sid, vals, t0, bucket_ms, num_series=S, num_buckets=T,
                                 device="cpu")
    ok = np.ones(len(ts), bool)
    stacked = agg.stacked_downsample(
        *(torch.from_numpy(a[None]) for a in (ts, sid, vals, ok)),
        torch.tensor([t0], dtype=torch.int64), bucket_ms, num_series=S, num_buckets=T)
    assert int(solo["count"][0, 0]) == 700
    for k in ("sum", "count", "min", "max", "mean"):
        assert same_bits(solo[k].numpy(), stacked[k][0].numpy()), k


@pytest.mark.parametrize("winner", ["block", "reduceat"])
def test_solo_sums_under_the_calibrated_lane(winner, monkeypatch):
    """Unpinned, the solo route takes the CPU calibration's winner. Under a
    device lane the solo grid is the stacked one bitwise; under the host
    reduceat lane numpy associates each cell's sum otherwise, so counts,
    min and max stay bitwise equal and sums agree within 2^-40 x the cell's
    L1 mass (rounding of a 700-row sum in another order)."""
    def calibrate(kind, device, klass):
        return {"impl": winner, "device_impl": "block", "ab": {winner: 1.0}, "rejected": {},
                "n": 0, "num_cells": 0, "calibrated_unix": 0}

    monkeypatch.setattr(agg_registry, "_calibrate", calibrate)
    ts, sid, vals, t0, bucket_ms, S, T = out_of_grid_case()
    solo = agg.downsample_sorted(ts, sid, vals, t0, bucket_ms, num_series=S, num_buckets=T,
                                 device="cpu")
    assert agg_registry.last_choice() == winner
    ok = np.ones(len(ts), bool)
    stacked = agg.stacked_downsample(
        *(torch.from_numpy(a[None]) for a in (ts, sid, vals, ok)),
        torch.tensor([t0], dtype=torch.int64), bucket_ms, num_series=S, num_buckets=T)
    for k in ("count", "min", "max") if winner == "reduceat" else ("sum", "count", "min",
                                                                    "max", "mean"):
        assert same_bits(solo[k].numpy(), stacked[k][0].numpy()), k
    if winner == "reduceat":
        bucket = (ts - t0) // bucket_ms
        inside = (bucket >= 0) & (bucket < T)
        l1 = np.zeros((S, T))
        np.add.at(l1, (sid[inside], bucket[inside]), np.abs(vals[inside]))
        err = np.abs(solo["sum"].numpy() - stacked["sum"][0].numpy())
        assert np.all(err <= 2.0 ** -40 * l1), float(err.max())


def test_stacked_edges_match_jax():
    """Rows before t0 and past the grid, sid out of range, an all-masked
    lane, NaN and +-inf, a different t0 per lane."""
    rng = np.random.default_rng(9)
    B, R, S, T, bucket_ms = 4, 96, 5, 7, 1000
    ts = rng.integers(-3000, 10_000, (B, R)).astype(np.int64)
    sid = rng.integers(-2, S + 2, (B, R)).astype(np.int32)
    vals = rng.uniform(-5, 5, (B, R))
    vals.flat[rng.choice(B * R, 12, replace=False)] = np.resize([np.nan, np.inf, -np.inf], 12)
    ok = rng.random((B, R)) > 0.2
    ok[2] = False
    t0 = np.array([0, 500, -1500, 2999], np.int64)
    got = agg.stacked_downsample(*(torch.from_numpy(a) for a in (ts, sid, vals, ok, t0)),
                                 bucket_ms, S, T)
    want = jax_agg.stacked_downsample(ts, sid, vals, ok, t0, bucket_ms, num_series=S,
                                      num_buckets=T)
    for k in ("sum", "count", "min", "max", "mean"):
        assert same_bits(got[k].numpy(), np.asarray(want[k])), k
    assert float(got["count"][2].sum()) == 0.0


def test_shape_classes():
    assert [pow2ceil(n) for n in (1, 2, 3, 7, 8, 9)] == [1, 2, 4, 8, 8, 16]
    b = QueryBatcher(BatchingConfig(max_stacked_cells=100))
    assert b.shape_key(5000, 12, 5) == b.shape_key(5000, 12, 8)
    assert b.shape_key(5000, 12, 8) != b.shape_key(5000, 12, 9)
    assert b._max_group_for(8, 4) == 3 and b._max_group_for(64, 4) == 0


@pytest.mark.usefixtures("device_lanes")
def test_burst_parity_and_shared_union_scan():
    """Single-host panels (class 1) plus two matcher panels and an
    unfiltered (whole-metric) panel (class 4, one shared union scan), one
    stacked launch per class, every demuxed answer bitwise equal to its
    solo run, across bucket sizes. The first panel finds no company yet
    and takes the lone path, as in the JAX package."""
    batching.GLOBAL_BATCHER.configure(BatchingConfig(max_delay=ms(200)))

    async def main():
        eng = await open_engine()
        try:
            await eng.write_payload(make_payload(n_series=4))
            for bucket_ms in (5000, 2000):
                reqs = host_reqs(4, bucket_ms)
                for rx in (b"h00[0-2]", b"h00[1-3]"):
                    reqs.append(QueryRequest(metric=b"batch_cpu", start_ms=BASE,
                                             end_ms=BASE + 30_000, bucket_ms=bucket_ms,
                                             matchers=[(b"host", "re", rx)]))
                reqs.append(QueryRequest(metric=b"batch_cpu", start_ms=BASE, end_ms=BASE + 30_000,
                                         bucket_ms=bucket_ms))
                launches = batching.BATCH_LAUNCHES.value
                solo, got, counts = await solo_then_burst(eng, reqs)
                for i, (g, w) in enumerate(zip(got, solo)):
                    assert_same_result(g, w, f"bucket={bucket_ms} q={i}")
                assert [c.get("batched_with") for c in counts] == [1, 3, 3, 3, 3, 3, 3], counts
                assert all(c.get("batch_shared_scans") == 2 for c in counts[4:]), counts
                assert batching.BATCH_LAUNCHES.value == launches + 2
        finally:
            await eng.close()

    asyncio.run(main())


def test_lone_query_is_solo_with_no_window():
    async def main():
        eng = await open_engine()
        try:
            await eng.write_payload(make_payload(n_series=4))
            with scanstats.scan_stats() as st:
                out = await eng.query(host_reqs(2)[1])
            assert out is not None
            assert st.counts.get("batched_with") == 1
            assert "batch_window" not in st.seconds
        finally:
            await eng.close()

    asyncio.run(main())


@pytest.mark.usefixtures("device_lanes")
def test_max_rows_demotes_the_largest_member():
    """Two 60-row members pad to 2 x 64 rows, over a max_rows of 64: the
    larger is demoted to the solo path (solo_overflow) and the other
    launches stacked alone; answers stay bitwise equal."""
    batching.GLOBAL_BATCHER.configure(BatchingConfig(max_rows=64, max_delay=ms(200)))

    async def main():
        eng = await open_engine()
        try:
            await eng.write_payload(make_payload(n_series=3, n_samples=60))
            before = batching.BATCH_QUERIES.labels("solo_overflow").value
            launches = batching.BATCH_LAUNCHES.value
            solo, got, counts = await solo_then_burst(eng, host_reqs(3, 5000, span=60_000))
            for i, (g, w) in enumerate(zip(got, solo)):
                assert_same_result(g, w, f"q={i}")
            assert batching.BATCH_QUERIES.labels("solo_overflow").value == before + 1
            assert batching.BATCH_LAUNCHES.value == launches + 1
            assert [c.get("batched_with") for c in counts] == [1, 1, 1], counts
            assert sum(1 for c in counts if c.get("batch_stacked_rows") == 60) == 1, counts
        finally:
            await eng.close()

    asyncio.run(main())


def test_unaligned_grid_runs_solo():
    async def main():
        eng = await open_engine()
        try:
            await eng.write_payload(make_payload(n_series=6))
            solo, got, counts = await solo_then_burst(eng, host_reqs(4, start=BASE + 1))
            for i, (g, w) in enumerate(zip(got, solo)):
                assert_same_result(g, w, f"unaligned q={i}")
            assert all(c.get("batched_with") == 1 for c in counts), counts
        finally:
            await eng.close()

    asyncio.run(main())


def test_env_off_forces_solo():
    async def main():
        eng = await open_engine()
        try:
            await eng.write_payload(make_payload(n_series=4))
            os.environ["HORAEDB_BATCH"] = "off"
            req = host_reqs(2)[1]

            async def one():
                with scanstats.scan_stats() as st:
                    await eng.query(req)
                return st.counts.get("batched_with")

            bw = await asyncio.gather(*(one() for _ in range(4)))
            assert all(x is None for x in bw), bw
        finally:
            os.environ.pop("HORAEDB_BATCH", None)
            await eng.close()

    asyncio.run(main())


def test_expiring_member_raises_and_the_group_survives():
    """A member whose deadline dies while its group executes raises
    DeadlineExceeded alone; the group completes for the rest."""
    b = QueryBatcher(BatchingConfig(max_delay=ms(30)))

    async def main():
        toks = [b.begin(), b.begin()]  # company, so nobody takes the lone path
        gate = asyncio.Event()
        sids = np.arange(3, dtype=np.uint64)

        async def slow_scan(ids):
            await gate.wait()
            return (np.arange(30, dtype=np.int64) * 1000,
                    np.repeat(np.arange(3, dtype=np.uint64), 10),
                    np.linspace(0.1, 3.3, 30))

        async def member(budget_s, key):
            with deadline_scope(Deadline(budget_s)):
                return await b.coalesce(bucket_ms=10_000, num_buckets=4, series_ids=sids, t0=0,
                                        filtered=True, share_key=key, scan=slow_scan,
                                        device="cpu")

        t_short = asyncio.create_task(member(0.15, "a"))
        t_long = asyncio.create_task(member(30.0, "b"))
        await asyncio.sleep(0.3)  # window closed, scans gated
        gate.set()
        with pytest.raises(DeadlineExceeded):
            await t_short
        res, notes = await t_long
        assert np.array_equal(res["count"].sum(axis=1), [10, 10, 10])
        assert notes["batched_with"] == 2
        for t in toks:
            b.end(t)

    asyncio.run(main())


def test_too_short_budget_never_joins_a_window():
    b = QueryBatcher(BatchingConfig(max_delay=ms(200)))

    async def main():
        toks = [b.begin(), b.begin()]

        async def scan(ids):  # pragma: no cover - must never run
            raise AssertionError("solo_deadline decision must not scan")

        with scanstats.scan_stats() as st, deadline_scope(Deadline(0.05)):
            res = await b.coalesce(bucket_ms=1000, num_buckets=2,
                                   series_ids=np.arange(2, dtype=np.uint64), t0=0, filtered=True,
                                   share_key="x", scan=scan, device="cpu")
        assert res is SOLO
        assert st.counts.get("batched_with") == 1
        assert not b._groups
        for t in toks:
            b.end(t)

    asyncio.run(main())
