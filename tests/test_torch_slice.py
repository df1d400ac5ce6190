"""The port's write -> parquet SSTs -> downsample query vs the JAX package.

The same seeded rows (about 50 series over two 2 h segments, shuffled
batches, a re-send that overwrites 5 % of the samples, rows of another
metric, NaN values) go through the JAX package's ObjectBasedStorage on a
LocalStore and are queried segment by segment with
`scan_segment_downsample(..., packed_ok=True)` plus the engine's
segment-order fold. The port answers the same query twice: over the SST
tree the JAX package wrote, opened as it is ("carry"), and over the same
batches written through its own `write` ("write"). Counts and min/max must
match exactly (NaN == NaN), sums and means to rtol=1e-12.
"""

import asyncio

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu.objstore import LocalStore as JLocalStore
from horaedb_tpu.ops import filter as JF
from horaedb_tpu.storage import ObjectBasedStorage as JaxStorage
from horaedb_tpu.storage import StorageConfig as JStorageConfig
from horaedb_tpu.storage import TimeRange as JTimeRange
from horaedb_tpu.storage import UpdateMode as JUpdateMode
from horaedb_tpu.storage import WriteRequest as JWriteRequest
from horaedb_tpu_torch.engine_query import query_downsample
from horaedb_tpu_torch.objstore import MemStore
from horaedb_tpu_torch.ops import filter as F
from horaedb_tpu_torch.storage import ObjectBasedStorage, StorageConfig, TimeRange, UpdateMode
from horaedb_tpu_torch.storage import WriteRequest
from horaedb_tpu_torch.storage.carry import open_local_root

SEGMENT_MS = 2 * 3600 * 1000
T0 = 100 * SEGMENT_MS
INTERVAL_MS = 60_000
BUCKET_MS = 5 * 60_000
NUM_SERIES = 50
METRIC = 3
ARROW_SCHEMA = pa.schema([("metric_id", pa.uint64()), ("tsid", pa.uint64()),
                          ("field_id", pa.uint64()), ("ts", pa.int64()),
                          ("value", pa.float64())])
# the query window starts and ends inside the segments
WINDOW = (T0 + 25 * 60_000, T0 + 2 * SEGMENT_MS - 35 * 60_000)


def make_batches(seed: int = 7):
    """[(segment start, record batch)] in write order."""
    rng = np.random.default_rng(seed)
    tsids = np.sort(rng.choice(
        np.unique(rng.integers(0, 2**64 - 1, 4 * NUM_SERIES, dtype=np.uint64, endpoint=True)),
        NUM_SERIES, replace=False))
    tsids[-1] = np.uint64(2**64 - 1)  # a key >= 2^63 at the u64 edge
    per_series = 2 * SEGMENT_MS // INTERVAL_MS
    sid = np.repeat(np.arange(NUM_SERIES), per_series)
    ts = T0 + np.tile(np.arange(per_series) * INTERVAL_MS, NUM_SERIES)
    ts = ts + rng.integers(0, 1000, len(ts))  # jitter inside the interval
    values = rng.normal(size=len(ts)) * 50
    values[rng.choice(len(values), 5, replace=False)] = np.nan
    metric = np.where(rng.random(len(ts)) < 0.03, METRIC + 1, METRIC).astype(np.uint64)
    seg = (ts - T0) // SEGMENT_MS

    def batch(rows, vals):
        return pa.RecordBatch.from_pydict(
            {"metric_id": metric[rows], "tsid": tsids[sid[rows]],
             "field_id": np.zeros(len(rows), np.uint64), "ts": ts[rows], "value": vals},
            schema=ARROW_SCHEMA)

    out = []
    for s in (0, 1):
        rows = rng.permutation(np.flatnonzero(seg == s))
        for part in np.array_split(rows, 4):
            out.append((T0 + s * SEGMENT_MS, batch(part, values[part])))
    resend = rng.permutation(rng.choice(len(ts), len(ts) // 20, replace=False))
    for s in (0, 1):
        part = resend[seg[resend] == s]
        out.append((T0 + s * SEGMENT_MS, batch(part, rng.normal(size=len(part)) * 50)))
    return tsids, out


def predicate(module):
    return module.And(module.Compare("metric_id", "eq", METRIC),
                      module.Compare("ts", "ge", WINDOW[0]),
                      module.Compare("ts", "lt", WINDOW[1]))


async def jax_reference(directory, batches, subsets, config=None):
    """Grids per series subset from the JAX package, which leaves its SST
    tree in the LocalStore at `directory`."""
    eng = await JaxStorage.try_new(
        root="db", store=JLocalStore(directory), arrow_schema=ARROW_SCHEMA,
        num_primary_keys=4, segment_duration_ms=SEGMENT_MS, config=config,
        enable_compaction_scheduler=False, start_background_merger=False,
    )
    try:
        for seg_start, batch in batches:
            await eng.write(JWriteRequest(batch, JTimeRange(seg_start, seg_start + SEGMENT_MS)))
        rng_ = JTimeRange(*WINDOW)
        num_buckets = -(-(WINDOW[1] - WINDOW[0]) // BUCKET_MS)
        segments = eng.group_by_segment(eng.select_ssts(rng_))
        grids = []
        for ids in subsets:
            acc = None
            for seg in segments:
                part = await eng.parquet_reader.scan_segment_downsample(
                    seg, predicate=predicate(JF), ts_column="ts", value_column="value",
                    series_column="tsid", series_ids=ids, t0=WINDOW[0], bucket_ms=BUCKET_MS,
                    num_buckets=num_buckets, packed_ok=True,
                )
                if acc is None:
                    acc = part
                else:
                    acc["sum"] = acc["sum"] + part["sum"]
                    acc["count"] = acc["count"] + part["count"]
                    acc["min"] = np.minimum(acc["min"], part["min"])
                    acc["max"] = np.maximum(acc["max"], part["max"])
            with np.errstate(invalid="ignore", divide="ignore"):
                acc["mean"] = acc["sum"] / acc["count"]
            grids.append(acc)
        return grids
    finally:
        await eng.close()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tsids, batches = make_batches()
    rng = np.random.default_rng(11)
    subset = np.sort(rng.choice(tsids, 9, replace=False))
    directory = str(tmp_path_factory.mktemp("jax_tree"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HORAEDB_AGG_IMPL", "scatter")
        grids = asyncio.run(jax_reference(directory, batches, [tsids, subset]))
    return {"batches": batches, "ids": {"all": tsids, "subset": subset},
            "grids": {"all": grids[0], "subset": grids[1]}, "directory": directory}


async def port_storage(route: str, ref, config=None):
    if route == "carry":
        return await open_local_root(ref["directory"], "db", ARROW_SCHEMA, 4, SEGMENT_MS,
                                     config=config, device="cpu")
    st = await ObjectBasedStorage.try_new(
        "db", MemStore(), ARROW_SCHEMA, 4, SEGMENT_MS, config=config,
        enable_compaction_scheduler=False, start_background_merger=False, device="cpu")
    for seg_start, batch in ref["batches"]:
        await st.write(WriteRequest(batch, TimeRange(seg_start, seg_start + SEGMENT_MS)))
    return st


async def port_query(route, ref, ids, config=None, repeat=1):
    st = await port_storage(route, ref, config)
    try:
        return [await query_downsample(st, ids, TimeRange(*WINDOW), BUCKET_MS, predicate(F))
                for _ in range(repeat)]
    finally:
        await st.close()


def assert_grids(got, want):
    assert got["count"].sum() > 0
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["min"], want["min"])
    np.testing.assert_array_equal(got["max"], want["max"])
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-12, atol=0, equal_nan=True)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-12, atol=0, equal_nan=True)


@pytest.mark.parametrize("series", ["all", "subset"])
@pytest.mark.parametrize("route", ["carry", "write"])
def test_port_grids_match_jax(reference, route, series):
    (got,) = asyncio.run(port_query(route, reference, reference["ids"][series]))
    assert_grids(got, reference["grids"][series])


def test_repeat_query_is_bitwise_identical(reference):
    a, b = asyncio.run(port_query("write", reference, reference["ids"]["all"], repeat=2))
    for k in a:
        np.testing.assert_array_equal(a[k].view(np.uint64), b[k].view(np.uint64))


def test_overwrite_resolves_to_later_write():
    async def run():
        st = await ObjectBasedStorage.try_new(
            "db", MemStore(), ARROW_SCHEMA, 4, SEGMENT_MS, enable_compaction_scheduler=False,
            start_background_merger=False, device="cpu")
        lanes = {"metric_id": np.full(2, METRIC, np.uint64), "tsid": np.array([9, 9], np.uint64),
                 "field_id": np.zeros(2, np.uint64), "ts": np.array([T0 + 5, T0 + 1], np.int64),
                 "value": np.array([1.0, 2.0])}
        rng_ = TimeRange(T0, T0 + SEGMENT_MS)
        await st.write(WriteRequest(pa.RecordBatch.from_pydict(lanes, schema=ARROW_SCHEMA), rng_))
        lanes["value"] = np.array([10.0, 20.0])
        await st.write(WriteRequest(pa.RecordBatch.from_pydict(lanes, schema=ARROW_SCHEMA), rng_))
        pred = F.And(F.Compare("metric_id", "eq", METRIC),
                     F.time_range_pred("ts", T0, T0 + 60_000))
        got = await query_downsample(st, np.array([9], np.uint64), TimeRange(T0, T0 + 60_000),
                                     60_000, pred)
        await st.close()
        return got

    got = asyncio.run(run())
    assert got["count"][0, 0] == 2 and got["sum"][0, 0] == 30.0


def test_packed_pass_decline_raises_not_ported(reference, tmp_path, monkeypatch):
    """In append mode the packed pass declines and the query takes the
    fused route (kernels scan_kernel, downsample, grouped_stats): its grids
    equal the JAX package's, where every re-sent sample counts twice."""
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "scatter")
    config = StorageConfig(update_mode=UpdateMode.APPEND)
    (want,) = asyncio.run(jax_reference(str(tmp_path), reference["batches"],
                                        [reference["ids"]["all"]],
                                        JStorageConfig(update_mode=JUpdateMode.APPEND)))
    (got,) = asyncio.run(port_query("write", reference, reference["ids"]["all"], config))
    assert_grids(got, want)
    assert got["count"].sum() > reference["grids"]["all"]["count"].sum()


@pytest.mark.parametrize("scan_path", ["host", "device"])
def test_segment_over_scan_block_rows_matches_single_block(reference, monkeypatch, scan_path):
    """The chunked route (segments above scan_block_rows) gives the packed
    route's grids: counts, min and max exact, sums to rtol 1e-12."""
    monkeypatch.setenv("HORAEDB_SCAN_PATH", scan_path)
    (got,) = asyncio.run(port_query("write", reference, reference["ids"]["all"],
                                    StorageConfig(scan_block_rows=1500)))
    assert_grids(got, reference["grids"]["all"])


def test_write_must_fall_in_one_segment():
    async def run():
        st = await ObjectBasedStorage.try_new(
            "db", MemStore(), ARROW_SCHEMA, 4, SEGMENT_MS, enable_compaction_scheduler=False,
            start_background_merger=False, device="cpu")
        batch = pa.RecordBatch.from_pydict(
            {"metric_id": np.ones(1, np.uint64), "tsid": np.ones(1, np.uint64),
             "field_id": np.zeros(1, np.uint64), "ts": np.array([T0], np.int64),
             "value": np.ones(1)}, schema=ARROW_SCHEMA)
        try:
            await st.write(WriteRequest(batch, TimeRange(T0, T0 + SEGMENT_MS + 1)))
        finally:
            await st.close()

    with pytest.raises(Exception, match="one segment"):
        asyncio.run(run())
