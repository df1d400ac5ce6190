"""The port's write -> sorted runs -> downsample slice vs the JAX package.

The same seeded rows (about 50 series over two 2 h segments, shuffled
batches, a re-send that overwrites 5 % of the samples, rows of another
metric, NaN values) go through the JAX package's ObjectBasedStorage on a
MemStore and are queried segment by segment with
`scan_segment_downsample(..., packed_ok=True)` plus the engine's
segment-order fold. The port answers the same query twice: over the JAX
package's stored runs carried across (`runs_from_reference`), and over
the same batches written through its own `write`. Counts and min/max must
match exactly (NaN == NaN), sums and means to rtol=1e-12.
"""

import asyncio

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu.objstore import MemStore
from horaedb_tpu.ops import filter as JF
from horaedb_tpu.storage import ObjectBasedStorage as JaxStorage
from horaedb_tpu.storage import TimeRange as JTimeRange
from horaedb_tpu.storage import WriteRequest as JWriteRequest
from horaedb_tpu_torch.engine_query import query_downsample
from horaedb_tpu_torch.ops import filter as F
from horaedb_tpu_torch.storage import ObjectBasedStorage, StorageConfig, TimeRange, UpdateMode
from horaedb_tpu_torch.storage import WriteRequest
from horaedb_tpu_torch.storage.carry import runs_from_reference
from horaedb_tpu_torch.storage.read import NotPortedError

SEGMENT_MS = 2 * 3600 * 1000
T0 = 100 * SEGMENT_MS
INTERVAL_MS = 60_000
BUCKET_MS = 5 * 60_000
NUM_SERIES = 50
METRIC = 3
SCHEMA = [("metric_id", np.uint64), ("tsid", np.uint64), ("field_id", np.uint64),
          ("ts", np.int64), ("value", np.float64)]
# the query window starts and ends inside the segments
WINDOW = (T0 + 25 * 60_000, T0 + 2 * SEGMENT_MS - 35 * 60_000)


def make_batches(seed: int = 7):
    """[(segment start, batch lanes)] in write order."""
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

    def lanes(rows, vals):
        return {"metric_id": metric[rows], "tsid": tsids[sid[rows]],
                "field_id": np.zeros(len(rows), np.uint64), "ts": ts[rows], "value": vals}

    out = []
    for s in (0, 1):
        rows = rng.permutation(np.flatnonzero(seg == s))
        for part in np.array_split(rows, 4):
            out.append((T0 + s * SEGMENT_MS, lanes(part, values[part])))
    resend = rng.permutation(rng.choice(len(ts), len(ts) // 20, replace=False))
    for s in (0, 1):
        part = resend[seg[resend] == s]
        out.append((T0 + s * SEGMENT_MS, lanes(part, rng.normal(size=len(part)) * 50)))
    return tsids, out


def predicate(module):
    return module.And(module.Compare("metric_id", "eq", METRIC),
                      module.Compare("ts", "ge", WINDOW[0]),
                      module.Compare("ts", "lt", WINDOW[1]))


async def jax_reference(batches, subsets):
    """Grids per series subset from the JAX package, and its stored runs as
    numpy lanes, one list per segment."""
    schema = pa.schema([(n, pa.from_numpy_dtype(dt)) for n, dt in SCHEMA])
    eng = await JaxStorage.try_new(
        root="db", store=MemStore(), arrow_schema=schema, num_primary_keys=4,
        segment_duration_ms=SEGMENT_MS, enable_compaction_scheduler=False,
        start_background_merger=False,
    )
    try:
        for seg_start, lanes in batches:
            batch = pa.RecordBatch.from_pydict(lanes, schema=schema)
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
        names = [n for n, _ in SCHEMA] + ["__seq__"]
        stored = []
        for seg in segments:
            runs = []
            for sst in seg:
                table = await eng.parquet_reader.read_sst(sst, names, None)
                runs.append({
                    "id": sst.id,
                    "time_range": (sst.meta.time_range.start, sst.meta.time_range.end),
                    "lanes": {n: table.column(n).to_numpy() for n in names},
                })
            stored.append(runs)
        return grids, stored
    finally:
        await eng.close()


@pytest.fixture(scope="module")
def reference():
    tsids, batches = make_batches()
    rng = np.random.default_rng(11)
    subset = np.sort(rng.choice(tsids, 9, replace=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HORAEDB_AGG_IMPL", "scatter")
        grids, stored = asyncio.run(jax_reference(batches, [tsids, subset]))
    return {"batches": batches, "ids": {"all": tsids, "subset": subset},
            "grids": {"all": grids[0], "subset": grids[1]}, "stored": stored}


def port_storage(route: str, ref):
    st = ObjectBasedStorage.try_new(SCHEMA, 4, "2h", device="cpu")
    if route == "carry":
        runs_from_reference(st, ref["stored"])
    else:
        for seg_start, lanes in ref["batches"]:
            st.write(WriteRequest(lanes, TimeRange(seg_start, seg_start + SEGMENT_MS)))
    return st


@pytest.mark.parametrize("series", ["all", "subset"])
@pytest.mark.parametrize("route", ["carry", "write"])
def test_port_grids_match_jax(reference, route, series):
    st = port_storage(route, reference)
    got = query_downsample(st, reference["ids"][series], TimeRange(*WINDOW), BUCKET_MS,
                           predicate(F), device="cpu")
    want = reference["grids"][series]
    assert got["count"].sum() > 0
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["min"], want["min"])
    np.testing.assert_array_equal(got["max"], want["max"])
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-12, atol=0, equal_nan=True)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-12, atol=0, equal_nan=True)


def test_repeat_query_is_bitwise_identical(reference):
    st = port_storage("write", reference)
    a, b = (query_downsample(st, reference["ids"]["all"], TimeRange(*WINDOW), BUCKET_MS,
                             predicate(F), device="cpu") for _ in range(2))
    for k in a:
        np.testing.assert_array_equal(a[k].view(np.uint64), b[k].view(np.uint64))


def test_overwrite_resolves_to_later_write():
    st = ObjectBasedStorage.try_new(SCHEMA, 4, SEGMENT_MS, device="cpu")
    lanes = {"metric_id": np.full(2, METRIC, np.uint64), "tsid": np.array([9, 9], np.uint64),
             "field_id": np.zeros(2, np.uint64), "ts": np.array([T0 + 5, T0 + 1], np.int64),
             "value": np.array([1.0, 2.0])}
    rng_ = TimeRange(T0, T0 + SEGMENT_MS)
    st.write(WriteRequest(lanes, rng_))
    st.write(WriteRequest({**lanes, "value": np.array([10.0, 20.0])}, rng_))
    pred = F.And(F.Compare("metric_id", "eq", METRIC), F.time_range_pred("ts", T0, T0 + 60_000))
    got = query_downsample(st, np.array([9], np.uint64), TimeRange(T0, T0 + 60_000), 60_000,
                           pred, device="cpu")
    assert got["count"][0, 0] == 2 and got["sum"][0, 0] == 30.0


def _one_run_storage(config=None):
    st = ObjectBasedStorage.try_new(SCHEMA, 4, SEGMENT_MS, config=config, device="cpu")
    _tsids, batches = make_batches()
    for seg_start, lanes in batches[:2]:
        st.write(WriteRequest(lanes, TimeRange(seg_start, seg_start + SEGMENT_MS)))
    return st, _tsids


def test_packed_pass_decline_raises_not_ported():
    st, tsids = _one_run_storage(StorageConfig(update_mode=UpdateMode.APPEND))
    with pytest.raises(NotPortedError, match="not ported yet: fused scan path"):
        query_downsample(st, tsids, TimeRange(*WINDOW), BUCKET_MS, predicate(F), device="cpu")


def test_segment_over_scan_block_rows_raises_not_ported():
    st, tsids = _one_run_storage(StorageConfig(scan_block_rows=100))
    with pytest.raises(NotPortedError, match="not ported yet: chunked scan path"):
        query_downsample(st, tsids, TimeRange(*WINDOW), BUCKET_MS, predicate(F), device="cpu")


def test_write_must_fall_in_one_segment():
    st = ObjectBasedStorage.try_new(SCHEMA, 4, SEGMENT_MS, device="cpu")
    lanes = {"metric_id": np.ones(1, np.uint64), "tsid": np.ones(1, np.uint64),
             "field_id": np.zeros(1, np.uint64), "ts": np.array([T0], np.int64),
             "value": np.ones(1)}
    with pytest.raises(Exception, match="one segment"):
        st.write(WriteRequest(lanes, TimeRange(T0, T0 + SEGMENT_MS + 1)))
