"""The port's storage (parquet SSTs, manifest, raw scan) vs the JAX package.

Each scenario of tests/test_storage.py runs through both packages on the
same batches; the scan batches must be equal on every lane, bitwise (floats
compared as u64 views, so NaN payloads and -0.0 count). The port runs each
scenario on three merge routes: `host` (numpy), `device` (the plain
versions of kernels E and F: `index_merge_filter`, `index_merge_mask`) and
`packed` (`HORAEDB_SCAN_PATH=device` with `HORAEDB_LINK_PROFILE=skip`,
which packs the keys for kernel D, `packed_merge`). The JAX package runs
its own planner's route.

Also here: SST trees written by one package and opened by the other, the
manifest snapshot and delta codecs across packages, the planner's routing
and its overrides, and the routes the port refuses (NotPortedError).
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu import objstore as jobjstore
from horaedb_tpu import storage as jstorage
from horaedb_tpu.ops import filter as JF
from horaedb_tpu.storage.manifest import encoding as jencoding
from horaedb_tpu_torch import objstore as tobjstore
from horaedb_tpu_torch import storage as tstorage
from horaedb_tpu_torch.common.error import HoraeError, NotPortedError
from horaedb_tpu_torch.engine_query import query_downsample
from horaedb_tpu_torch.ops import filter as TF
from horaedb_tpu_torch.storage import read as tread
from horaedb_tpu_torch.storage import scanstats as tscanstats
from horaedb_tpu_torch.storage.carry import open_local_root
from horaedb_tpu_torch.storage.manifest import encoding as tencoding

SEGMENT_MS = 3_600_000
SCHEMA = pa.schema([("pk1", pa.int64()), ("pk2", pa.uint64()), ("ts", pa.int64()),
                    ("value", pa.float64())])

JAX = SimpleNamespace(name="jax", st=jstorage, F=JF, objstore=jobjstore, kw={})
PORT = SimpleNamespace(name="port", st=tstorage, F=TF, objstore=tobjstore, kw={"device": "cpu"})
ROUTES = {
    "host": {"HORAEDB_SCAN_PATH": "host"},
    "device": {"HORAEDB_SCAN_PATH": "device"},
    "packed": {"HORAEDB_SCAN_PATH": "device", "HORAEDB_LINK_PROFILE": "skip"},
}


def batch(pk1, pk2, ts, value):
    return pa.RecordBatch.from_pydict({
        "pk1": np.asarray(pk1, np.int64), "pk2": np.asarray(pk2, np.uint64),
        "ts": np.asarray(ts, np.int64), "value": np.asarray(value, np.float64)}, schema=SCHEMA)


async def open_engine(pkg, store, config=None, num_pks=2):
    return await pkg.st.ObjectBasedStorage.try_new(
        "db", store, SCHEMA, num_pks, SEGMENT_MS, config=config,
        enable_compaction_scheduler=False, start_background_merger=False, **pkg.kw)


async def collect(pkg, eng, start=0, end=SEGMENT_MS, **kw):
    req = pkg.st.ScanRequest(range=pkg.st.TimeRange(start, end), **kw)
    out = [b async for b in eng.scan(req)]
    return pa.Table.from_batches(out) if out else None


async def write(pkg, eng, b, start, end):
    await eng.write(pkg.st.WriteRequest(b, pkg.st.TimeRange(start, end)))


def random_writes(seed, writes=6, rows=400, pk1_hi=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(writes):
        v = rng.normal(size=rows)
        v[rng.random(rows) < 0.02] = np.nan
        v[rng.random(rows) < 0.02] = -0.0
        out.append(batch(rng.integers(0, pk1_hi, rows),
                         rng.integers(2**63 - 2, 2**63 + 2, rows, dtype=np.uint64),
                         np.full(rows, 10), v))
    return out


# -- scenarios: each returns a list of results to compare -----------------------

async def s_overwrite_dedup(pkg):
    eng = await open_engine(pkg, pkg.objstore.MemStore())
    await write(pkg, eng, batch([1, 2, 3], [0, 0, 0], [100, 200, 300], [1, 2, 3]), 100, 301)
    await write(pkg, eng, batch([2, 3, 4], [0, 0, 0], [201, 301, 401], [20, 30, 40]), 201, 402)
    out = [await collect(pkg, eng)]
    await eng.close()
    return out


async def s_many_writes_sorted(pkg):
    eng = await open_engine(pkg, pkg.objstore.MemStore())
    for b in random_writes(0):
        await write(pkg, eng, b, 10, 11)
    out = [await collect(pkg, eng)]
    await eng.close()
    return out


async def s_predicate_projection(pkg):
    eng = await open_engine(pkg, pkg.objstore.MemStore())
    for b in random_writes(1, writes=3):
        await write(pkg, eng, b, 10, 11)
    F = pkg.F
    out = [await collect(pkg, eng, predicate=F.Compare("pk1", "eq", 7), projections=[0, 1, 3]),
           await collect(pkg, eng, predicate=F.Or(F.Compare("value", "gt", 0.5),
                                                  F.Not(F.Compare("pk1", "lt", 50))),
                         projections=[3])]
    await eng.close()
    return out


async def s_inset(pkg):
    eng = await open_engine(pkg, pkg.objstore.MemStore())
    for b in random_writes(2, writes=3):
        await write(pkg, eng, b, 10, 11)
    F = pkg.F
    big = tuple(range(0, 400, 2))  # > 128 members: the binary-search probe
    out = [await collect(pkg, eng, predicate=F.InSet("pk1", (2, 4, 55))),
           await collect(pkg, eng, predicate=F.And(F.InSet("pk1", big),
                                                   F.InSet("pk2", (2**63, 2**63 + 1)))),
           await collect(pkg, eng, predicate=F.InSet("pk1", (-1.5, 2**70)))]
    await eng.close()
    return out


async def s_filter_before_dedup(pkg):
    eng = await open_engine(pkg, pkg.objstore.MemStore())
    await write(pkg, eng, batch([1, 2], [1, 1], [10, 10], [5.0, 6.0]), 10, 11)
    await write(pkg, eng, batch([1, 2], [1, 1], [10, 10], [50.0, 1.0]), 10, 11)
    out = [await collect(pkg, eng, predicate=pkg.F.Compare("value", "lt", 10.0))]
    await eng.close()
    return out


async def s_multi_segment(pkg):
    eng = await open_engine(pkg, pkg.objstore.MemStore())
    t1 = SEGMENT_MS + 5
    await write(pkg, eng, batch([1, 3], [0, 0], [t1, t1], [11.0, 13.0]), t1, t1 + 1)
    await write(pkg, eng, batch([9, 2], [0, 0], [5, 5], [9.0, 2.0]), 5, 6)
    await write(pkg, eng, batch([1], [0], [t1], [111.0]), t1, t1 + 1)
    out = [await collect(pkg, eng, 0, 2 * SEGMENT_MS)]
    await eng.close()
    return out


async def s_empty_range(pkg):
    eng = await open_engine(pkg, pkg.objstore.MemStore())
    await write(pkg, eng, batch([1], [1], [10], [1.0]), 10, 11)
    out = [await collect(pkg, eng, 1000, 2000)]
    await eng.close()
    return out


async def s_cross_segment_rejected(pkg):
    eng = await open_engine(pkg, pkg.objstore.MemStore())
    try:
        await write(pkg, eng, batch([1], [1], [10], [1.0]), 10, SEGMENT_MS + 10)
        out = ["accepted"]
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        out = ["one segment" in str(e)]
    out.append(await collect(pkg, eng))
    await eng.close()
    return out


async def s_restart_recovery(pkg):
    store = pkg.objstore.MemStore()
    eng = await open_engine(pkg, store)
    for b in random_writes(3, writes=3):
        await write(pkg, eng, b, 10, 11)
    await eng.close()
    eng2 = await open_engine(pkg, store)
    out = [await collect(pkg, eng2), len(eng2.manifest.all_ssts())]
    await eng2.close()
    return out


async def s_chunked_equals_single(pkg):
    store = pkg.objstore.MemStore()
    big = await open_engine(pkg, store)
    for b in random_writes(4, rows=500, pk1_hi=40):
        await write(pkg, big, b, 10, 11)
    pred = pkg.F.Compare("value", "gt", 0.0)
    out = [await collect(pkg, big, predicate=pred)]
    small = await open_engine(pkg, store, pkg.st.StorageConfig(scan_block_rows=700))
    out.append(await collect(pkg, small, predicate=pred))
    await big.close()
    await small.close()
    return out


async def s_append_mode_numeric(pkg):
    cfg = pkg.st.StorageConfig(update_mode=pkg.st.UpdateMode.APPEND, scan_block_rows=4)
    eng = await open_engine(pkg, pkg.objstore.MemStore(), cfg)
    for v in (1.0, 2.0, 3.0):
        await write(pkg, eng, batch([1, 2], [0, 0], [10, 10], [v, v * 10]), 10, 11)
    out = [await collect(pkg, eng)]
    await eng.close()
    return out


SCENARIOS = {f.__name__[2:]: f for f in (
    s_overwrite_dedup, s_many_writes_sorted, s_predicate_projection, s_inset,
    s_filter_before_dedup, s_multi_segment, s_empty_range, s_cross_segment_rejected,
    s_restart_recovery, s_chunked_equals_single, s_append_mode_numeric)}
_JAX_RESULTS: dict = {}


def assert_same_results(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if not isinstance(w, pa.Table):
            assert g == w
            continue
        assert isinstance(g, pa.Table) and g.schema.names == w.schema.names
        assert g.num_rows == w.num_rows
        for name in w.schema.names:
            a = g.column(name).to_numpy()
            b = w.column(name).to_numpy()
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a.view(np.uint64) if a.dtype == np.float64 else a,
                                          b.view(np.uint64) if b.dtype == np.float64 else b,
                                          err_msg=name)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scan_matches_jax(scenario, route, monkeypatch):
    monkeypatch.delenv("HORAEDB_SCAN_PATH", raising=False)
    monkeypatch.delenv("HORAEDB_LINK_PROFILE", raising=False)
    if scenario not in _JAX_RESULTS:
        _JAX_RESULTS[scenario] = asyncio.run(SCENARIOS[scenario](JAX))
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    got = asyncio.run(SCENARIOS[scenario](PORT))
    assert_same_results(got, _JAX_RESULTS[scenario])


def test_routes_reach_the_kernels_plain_versions(monkeypatch):
    """Each route runs the function it names (the plain versions here)."""
    from horaedb_tpu_torch.ops import merge as merge_ops

    seen = []
    for name in ("packed_merge", "index_merge_mask", "index_merge_filter"):
        inner = getattr(merge_ops, name)
        monkeypatch.setattr(merge_ops, name,
                            lambda *a, _n=name, _f=inner, **k: seen.append(_n) or _f(*a, **k))

    async def run(**kw):
        eng = await open_engine(PORT, tobjstore.MemStore())
        for b in random_writes(5, writes=2):
            await write(PORT, eng, b, 10, 11)
        await collect(PORT, eng, **kw)
        await eng.close()

    monkeypatch.setenv("HORAEDB_SCAN_PATH", "device")
    asyncio.run(run(predicate=TF.Compare("value", "gt", 0.0)))
    monkeypatch.setenv("HORAEDB_LINK_PROFILE", "skip")
    asyncio.run(run())
    monkeypatch.setenv("HORAEDB_SCAN_PATH", "auto")
    monkeypatch.setattr(tread._HostCalib, "_sort", 1.0)  # the host looks slow
    asyncio.run(run(predicate=TF.Compare("value", "gt", 0.0)))
    assert seen == ["index_merge_filter", "packed_merge", "packed_merge"]
    monkeypatch.delenv("HORAEDB_LINK_PROFILE")
    monkeypatch.setattr(tread._LinkProfile, "_CPU", {
        "h2d_bw": 1e10, "d2h_bw": 1e10, "dispatch_s": 1e-5, "sort_s_per_row": 4e-9})
    monkeypatch.setattr(tread._LinkProfile, "_cached", {})
    asyncio.run(run(predicate=TF.Compare("value", "gt", 0.0)))
    assert seen[-1] == "index_merge_mask"


WIDE = pa.schema([(f"c{i}", pa.int64()) for i in range(17)] + [("value", pa.float64())])
_JAX_WIDE: dict = {}


def _beyond_kernel_e(F):
    """Predicates kernel E refuses: one reads 17 lanes, one nests 41 deep."""
    wide = F.And(*[F.Compare(f"c{i}", "ge", 0) for i in range(16)],
                 F.Compare("value", "gt", 0.0))
    deep = F.Compare("value", "gt", 0.0)
    for i in range(20):
        deep = F.Or(F.Compare("c2", "eq", i % 3), F.And(F.Compare("c3", "ne", i % 2), deep))
    return {"wide": wide, "deep": deep}


async def s_beyond_kernel_limits(pkg, num_pks, pred):
    eng = await pkg.st.ObjectBasedStorage.try_new(
        "db", pkg.objstore.MemStore(), WIDE, num_pks, SEGMENT_MS,
        enable_compaction_scheduler=False, start_background_merger=False, **pkg.kw)
    rng = np.random.default_rng(8)
    for _ in range(3):
        cols = {f"c{i}": rng.integers(0, 30 if i < 2 else 3, 300) for i in range(17)}
        cols["value"] = rng.normal(size=300)
        await write(pkg, eng, pa.RecordBatch.from_pydict(cols, schema=WIDE), 10, 11)
    out = [await collect(pkg, eng, predicate=_beyond_kernel_e(pkg.F)[pred] if pred else None)]
    await eng.close()
    return out


@pytest.mark.parametrize("route", ["auto", "device", "host"])
@pytest.mark.parametrize("num_pks,pred", [(2, "wide"), (2, "deep"), (17, None), (17, "deep")])
def test_beyond_kernel_limits_matches_jax(num_pks, pred, route, monkeypatch):
    """A predicate kernel E cannot take evaluates on the host and merges
    through `index_merge_mask`; under auto, sort keys beyond kernel F's 16
    lanes merge on the host, and the device route refuses them."""
    from horaedb_tpu_torch.ops import merge as merge_ops

    monkeypatch.delenv("HORAEDB_LINK_PROFILE", raising=False)
    monkeypatch.delenv("HORAEDB_SCAN_PATH", raising=False)
    key = (num_pks, pred)
    if key not in _JAX_WIDE:
        _JAX_WIDE[key] = asyncio.run(s_beyond_kernel_limits(JAX, num_pks, pred))
    seen = []
    for name in ("packed_merge", "index_merge_mask", "index_merge_filter"):
        inner = getattr(merge_ops, name)
        monkeypatch.setattr(merge_ops, name,
                            lambda *a, _n=name, _f=inner, **k: seen.append(_n) or _f(*a, **k))
    # the host looks slow and the link fast: auto takes the device wherever it may
    monkeypatch.setattr(tread._HostCalib, "_sort", 1.0)
    monkeypatch.setattr(tread._HostCalib, "_eval", 1.0)
    monkeypatch.setattr(tread._LinkProfile, "_CPU", {
        "h2d_bw": 1e10, "d2h_bw": 1e10, "dispatch_s": 1e-5, "sort_s_per_row": 4e-9})
    monkeypatch.setattr(tread._LinkProfile, "_cached", {})
    monkeypatch.setenv("HORAEDB_SCAN_PATH", route)
    if num_pks == 17 and route == "device":
        with pytest.raises(HoraeError, match="keys"):
            asyncio.run(s_beyond_kernel_limits(PORT, num_pks, pred))
        return
    got = asyncio.run(s_beyond_kernel_limits(PORT, num_pks, pred))
    assert_same_results(got, _JAX_WIDE[key])
    assert seen == (["index_merge_mask"] if num_pks == 2 and route != "host" else [])


# -- SST trees across packages ---------------------------------------------------

def tsbs_batches(seed=3, series=40, per_series=90, interval=60_000):
    """Two segments of a TSBS-like (metric, tsid, field, ts) -> value table,
    shuffled into writes plus a re-send."""
    rng = np.random.default_rng(seed)
    tsids = np.unique(rng.integers(0, 2**64 - 1, 2 * series, dtype=np.uint64, endpoint=True))
    tsids = np.sort(rng.choice(tsids, series, replace=False))
    schema = pa.schema([("metric_id", pa.uint64()), ("tsid", pa.uint64()),
                        ("field_id", pa.uint64()), ("ts", pa.int64()), ("value", pa.float64())])
    sid = np.repeat(np.arange(series), per_series)
    ts = np.tile(np.arange(per_series) * interval, series)
    vals = rng.normal(size=len(ts))
    seg = ts // SEGMENT_MS
    out = []
    for s in np.unique(seg):
        rows = rng.permutation(np.flatnonzero(seg == s))
        resend = rng.choice(rows, len(rows) // 10, replace=False)
        for part, v in ((rows[: len(rows) // 2], vals), (rows[len(rows) // 2:], vals),
                        (resend, rng.normal(size=len(vals)))):
            b = pa.RecordBatch.from_pydict({
                "metric_id": np.ones(len(part), np.uint64), "tsid": tsids[sid[part]],
                "field_id": np.zeros(len(part), np.uint64), "ts": ts[part],
                "value": v[part]}, schema=schema)
            out.append((int(s) * SEGMENT_MS, b))
    return schema, tsids, out


async def write_tree(pkg, directory, schema, batches):
    eng = await pkg.st.ObjectBasedStorage.try_new(
        "db", pkg.objstore.LocalStore(directory), schema, 4, SEGMENT_MS,
        enable_compaction_scheduler=False, start_background_merger=False, **pkg.kw)
    for start, b in batches:
        await write(pkg, eng, b, start, start + SEGMENT_MS)
    await eng.close()


async def read_tree(pkg, directory, schema, pred):
    if pkg is PORT:
        eng = await open_local_root(directory, "db", schema, 4, SEGMENT_MS, device="cpu")
    else:
        eng = await pkg.st.ObjectBasedStorage.try_new(
            "db", pkg.objstore.LocalStore(directory), schema, 4, SEGMENT_MS,
            enable_compaction_scheduler=False, start_background_merger=False)
    out = [await collect(pkg, eng, 0, 2 * SEGMENT_MS),
           await collect(pkg, eng, 0, 2 * SEGMENT_MS, predicate=pred(pkg.F))]
    await eng.close()
    return out


def _pred(F):
    return F.And(F.Compare("metric_id", "eq", 1), F.Compare("ts", "ge", 30 * 60_000))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sst_tree_crosses_packages(writer, tmp_path):
    """A LocalStore tree written by either package scans the same through
    the other as through itself."""
    schema, _tsids, batches = tsbs_batches()
    w, r = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    asyncio.run(write_tree(w, str(tmp_path / "a"), schema, batches))
    asyncio.run(write_tree(w, str(tmp_path / "b"), schema, batches))
    own = asyncio.run(read_tree(w, str(tmp_path / "a"), schema, _pred))
    other = asyncio.run(read_tree(r, str(tmp_path / "b"), schema, _pred))
    assert own[0].num_rows > 0
    assert_same_results(other, own)


def test_jax_tree_downsamples_the_same_in_the_port(tmp_path):
    schema, tsids, batches = tsbs_batches()
    asyncio.run(write_tree(JAX, str(tmp_path), schema, batches))
    window = (10 * 60_000, 2 * SEGMENT_MS - 7 * 60_000)
    num_buckets = -(-(window[1] - window[0]) // 300_000)

    async def jax_grids():
        eng = await jstorage.ObjectBasedStorage.try_new(
            "db", jobjstore.LocalStore(str(tmp_path)), schema, 4, SEGMENT_MS,
            enable_compaction_scheduler=False, start_background_merger=False)
        acc = None
        for seg in eng.group_by_segment(eng.select_ssts(jstorage.TimeRange(*window))):
            part = await eng.parquet_reader.scan_segment_downsample(
                seg, predicate=_pred(JF), ts_column="ts", value_column="value",
                series_column="tsid", series_ids=tsids, t0=window[0], bucket_ms=300_000,
                num_buckets=num_buckets, packed_ok=True)
            acc = part if acc is None else {
                "sum": acc["sum"] + part["sum"], "count": acc["count"] + part["count"],
                "min": np.minimum(acc["min"], part["min"]),
                "max": np.maximum(acc["max"], part["max"])}
        await eng.close()
        return acc

    async def port_grids():
        eng = await open_local_root(str(tmp_path), "db", schema, 4, SEGMENT_MS, device="cpu")
        got = await query_downsample(eng, tsids, tstorage.TimeRange(*window), 300_000,
                                     _pred(TF))
        await eng.close()
        return got

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HORAEDB_AGG_IMPL", "scatter")
        want = asyncio.run(jax_grids())
    got = asyncio.run(port_grids())
    assert got["count"].sum() > 0
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-12, atol=0)


# -- manifest codecs across packages ----------------------------------------------

def _files(pkg_sst, fmt=1):
    return [pkg_sst.SstFile(id=i * 7 + 2**63, meta=pkg_sst.FileMeta(
        max_sequence=i * 7 + 2**63, num_rows=i * 100 + 1, size=i * 4096 + 17,
        time_range=tstorage.TimeRange(-5 + i, 3_600_000 * i + 9)
        if pkg_sst is tstorage else jstorage.TimeRange(-5 + i, 3_600_000 * i + 9),
        format_version=fmt if i % 2 else 1)) for i in range(1, 6)]


def _records(ssts):
    return [(s.id, s.meta.max_sequence, s.meta.num_rows, s.meta.size, s.meta.time_range.start,
             s.meta.time_range.end, s.meta.format_version, tuple(s.meta.encodings))
            for s in ssts]


@pytest.mark.parametrize("fmt", [1, 2])
def test_manifest_snapshot_crosses_packages(fmt):
    t_snap = tencoding.Snapshot({f.id: f for f in _files(tstorage, fmt)})
    j_snap = jencoding.Snapshot({f.id: f for f in _files(jstorage, fmt)})
    t_bytes, j_bytes = t_snap.to_bytes(), j_snap.to_bytes()
    assert t_bytes == j_bytes
    t_back = tencoding.Snapshot.from_bytes(j_bytes)
    j_back = jencoding.Snapshot.from_bytes(t_bytes)
    assert _records(t_back.into_ssts()) == _records(j_back.into_ssts())
    assert t_back.to_bytes() == j_back.to_bytes() == j_bytes


def test_manifest_delta_crosses_packages():
    t_delta = tencoding.encode_update(_files(tstorage), [3, 2**64 - 1])
    j_delta = jencoding.encode_update(_files(jstorage), [3, 2**64 - 1])
    assert t_delta == j_delta
    t_adds, t_dels = tencoding.decode_update(j_delta)
    j_adds, j_dels = jencoding.decode_update(t_delta)
    assert _records(t_adds) == _records(j_adds) and t_dels == j_dels == [3, 2**64 - 1]
    assert tencoding.encode_update(t_adds, t_dels) == j_delta


# -- refusals and overrides -------------------------------------------------------

def test_root_with_tombstones_is_refused():
    async def run():
        store = tobjstore.MemStore()
        await store.put("db/manifest/tombstone/7", b"{}")
        await open_engine(PORT, store)

    with pytest.raises(NotPortedError, match="tombstone"):
        asyncio.run(run())


@pytest.mark.parametrize("ask", ["scheduler", "bloom", "column_bloom", "encoding"])
def test_unported_options_are_refused(ask):
    """The scheduler and bloom sidecars stay refused; encoding is ported:
    the table opens and a write lands an `.enc` sidecar beside its SST."""
    kw = {"enable_compaction_scheduler": ask == "scheduler", "start_background_merger": False,
          "device": "cpu"}
    cfg = tstorage.StorageConfig()
    if ask == "bloom":
        cfg.write.enable_bloom_filter = True
    elif ask == "column_bloom":
        from horaedb_tpu_torch.storage.config import ColumnOptions

        cfg.write.column_options = {"pk1": ColumnOptions(enable_bloom_filter=True)}
    elif ask == "encoding":
        cfg.encoding.enabled = True
        cfg.encoding.min_rows = 1

        async def run():
            store = tobjstore.MemStore()
            eng = await tstorage.ObjectBasedStorage.try_new(
                "db", store, SCHEMA, 2, SEGMENT_MS, config=cfg, **kw)
            await write(PORT, eng, batch([1, 2], [0, 0], [10, 10], [1.0, 2.0]), 10, 11)
            sst = eng.manifest.all_ssts()[0]
            await eng.close()
            return sst, sorted(m.path for m in await store.list("db/data"))

        sst, paths = asyncio.run(run())
        assert sst.meta.format_version == 2
        assert [lane for lane, _codec in sst.meta.encodings] == SCHEMA.names + [
            "__seq__", "__reserved__"]
        assert paths == [f"db/data/{sst.id}.enc", f"db/data/{sst.id}.sst"]
        return
    with pytest.raises(NotPortedError, match="not ported yet"):
        asyncio.run(tstorage.ObjectBasedStorage.try_new(
            "db", tobjstore.MemStore(), SCHEMA, 2, SEGMENT_MS, config=cfg, **kw))


def test_encoded_sst_and_sharded_route_are_refused(monkeypatch):
    """A format-v2 SST whose `.enc` object is missing reads through parquet,
    equal to its v1 read (the parquet object is authoritative, as in the
    JAX package); a bad route name is refused. The sharded route is ported:
    without a mesh installed it falls back to the single-device merge and
    says so (`path_sharded_fallback_no_mesh`), as the JAX package does;
    tests/test_torch_parallel.py drives it over a mesh."""
    async def run():
        eng = await open_engine(PORT, tobjstore.MemStore())
        await write(PORT, eng, batch([1, 2], [0, 0], [10, 10], [1.0, 2.0]), 10, 11)
        sst = eng.manifest.all_ssts()[0]
        v2 = tstorage.SstFile(sst.id, tstorage.FileMeta(
            sst.meta.max_sequence, sst.meta.num_rows, sst.meta.size, sst.meta.time_range,
            format_version=2))
        v1_read = await eng.parquet_reader.read_sst(sst, None, None)
        assert (await eng.parquet_reader.read_sst(v2, None, None)).equals(v1_read)
        assert eng.parquet_reader.sst_reads == {"encoded": 0, "parquet": 2}
        default = await collect(PORT, eng)
        monkeypatch.setenv("HORAEDB_SCAN_PATH", "sharded")
        with tscanstats.scan_stats() as st:
            assert (await collect(PORT, eng)).equals(default)
        assert st.counts.get("path_sharded_fallback_no_mesh", 0) >= 1
        monkeypatch.setenv("HORAEDB_SCAN_PATH", "sideways")
        with pytest.raises(HoraeError, match="HORAEDB_SCAN_PATH"):
            await collect(PORT, eng)
        await eng.close()

    asyncio.run(run())


def test_link_profile_overrides(monkeypatch):
    import torch

    cpu = torch.device("cpu")
    monkeypatch.setenv("HORAEDB_LINK_PROFILE", "skip")
    assert tread._LinkProfile.get(cpu) == tread._LinkProfile._WEDGED
    monkeypatch.setenv("HORAEDB_LINK_PROFILE", "device")
    assert tread._LinkProfile.get(cpu)["sort_s_per_row"] == tread.DEVICE_SORT_S_PER_ROW
    monkeypatch.setenv("HORAEDB_LINK_PROFILE", "wedgy")
    with pytest.raises(ValueError, match="HORAEDB_LINK_PROFILE"):
        tread._LinkProfile.get(cpu)
    monkeypatch.delenv("HORAEDB_LINK_PROFILE")
    assert tread._LinkProfile.get(cpu) == tread._LinkProfile._CPU


def test_streamed_sst_write_reads_back_in_jax(tmp_path, monkeypatch):
    """Tables above 4 chunks stream their parquet encode to the store; with
    a 4 KiB chunk every write here streams, and the JAX package reads the
    tree the same as the port does."""
    from horaedb_tpu_torch.storage import storage as tstorage_mod

    monkeypatch.setattr(tstorage_mod, "STREAM_CHUNK", 4096)
    schema, _tsids, batches = tsbs_batches(seed=8)
    asyncio.run(write_tree(PORT, str(tmp_path / "a"), schema, batches))
    own = asyncio.run(read_tree(PORT, str(tmp_path / "a"), schema, _pred))
    other = asyncio.run(read_tree(JAX, str(tmp_path / "a"), schema, _pred))
    assert own[0].num_rows > 0
    assert_same_results(other, own)
