"""The port's metric engine against the JAX package's, on the CPU.

The same seeded remote-write payloads (TSBS cpu-only host tags: hostname,
region, datacenter, rack, os, arch, team, service, service_version,
service_environment; three metrics; values that are not dyadic fractions)
go into the JAX `MetricEngine` (HORAEDB_SERVING=off,
enable_compaction=False) and the port's (`device="cpu"`). Checked:
- seahash, metric ids and tsids equal the JAX package's; the port's wire
  decoder gives the JAX WireParser's lanes;
- `find_tsids` for filters and `ne`/`re`/`nre` matchers, `series_of`,
  `label_values` and `series_count`;
- the `query` grids: ids, counts, min and max exact (NaN == NaN), sums
  and means to rtol 1e-12, with HORAEDB_BATCH=off (solo) and raw rows;
- a root written by either engine opens and answers the same in the
  other (LocalStore, all six tables);
- what the port refuses with NotPortedError.
"""

import asyncio
import os

import numpy as np
import pytest

from horaedb_tpu.common.hash import seahash as jax_seahash
from horaedb_tpu.engine import MetricEngine as JaxEngine
from horaedb_tpu.engine import QueryRequest as JaxQuery
from horaedb_tpu.ingest.wire_parser import WireParser as JaxWireParser
from horaedb_tpu.objstore import LocalStore as JaxLocalStore
from horaedb_tpu.pb import remote_write_pb2
from horaedb_tpu_torch.common.error import HoraeError, NotPortedError
from horaedb_tpu_torch.common.hash import seahash, seahash_many
from horaedb_tpu_torch.engine import MetricEngine, QueryRequest
from horaedb_tpu_torch.engine.types import tag_hash_of, tag_hashes_of
from horaedb_tpu_torch.ingest.wire_parser import WireParser
from horaedb_tpu_torch.objstore import LocalStore, MemStore
from horaedb_tpu_torch.serving import ServingTierConfig

BASE = 1_700_000_000_000 - 1_700_000_000_000 % 7_200_000
INTERVAL = 10_000
HOSTS = 24
METRICS = (b"cpu_usage_user", b"cpu_usage_system", b"cpu_usage_idle")
REGIONS = (b"us-east-1", b"eu-west-1", b"ap-south-1")
OFF = ServingTierConfig(enabled=False)


def host_tags(h: int) -> list[tuple[bytes, bytes]]:
    r = REGIONS[h % 3]
    return [(b"hostname", b"host_%d" % h), (b"region", r), (b"datacenter", r + b"a"),
            (b"rack", b"%d" % (h % 5)), (b"os", b"Ubuntu16.04LTS"), (b"arch", b"x64"),
            (b"team", b"NYC" if h % 2 else b"SF"), (b"service", b"%d" % (h % 7)),
            (b"service_version", b"%d" % (h % 2)), (b"service_environment", b"production")]


def make_payloads(seed: int = 11, scrapes: int = 36, per_payload: int = 9) -> list[bytes]:
    """Time-ordered payloads, `per_payload` scrapes of every host and metric
    each; values are uniform floats (not dyadic), a few NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for p0 in range(0, scrapes, per_payload):
        req = remote_write_pb2.WriteRequest()
        for m in METRICS:
            for h in range(HOSTS):
                ts = req.timeseries.add()
                for k, v in [(b"__name__", m)] + host_tags(h):
                    lab = ts.labels.add()
                    lab.name, lab.value = k, v
                for s in range(p0, min(p0 + per_payload, scrapes)):
                    smp = ts.samples.add()
                    smp.timestamp = BASE + s * INTERVAL + int(rng.integers(0, 50))
                    smp.value = float(rng.uniform(0, 100)) if rng.random() > 0.01 else float("nan")
        md = req.metadata.add()
        md.type = 2
        md.metric_family_name = METRICS[0]
        out.append(req.SerializeToString())
    return out


QUERIES = [
    dict(filters=[]),
    dict(filters=[(b"rack", b"3")]),
    dict(filters=[(b"region", b"eu-west-1"), (b"team", b"SF")]),
    dict(filters=[(b"rack", b"nope")]),
    dict(matchers=[(b"hostname", "re", b"host_1[0-9]")]),
    dict(matchers=[(b"hostname", "re", b"host_3|host_17|host_22|nohost")]),  # literal set
    dict(matchers=[(b"hostname", "nre", b"host_1|host_2")], filters=[(b"rack", b"1")]),
    dict(matchers=[(b"service", "ne", b"3")]),
    dict(matchers=[(b"region", "nre", b"us-.*")], filters=[(b"os", b"Ubuntu16.04LTS")]),
    dict(matchers=[(b"missing_label", "re", b"")]),
]


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("HORAEDB_SERVING", "off")
    monkeypatch.setenv("HORAEDB_BATCH", "off")


async def jax_open(store):
    return await JaxEngine.open("db", store, enable_compaction=False)


async def port_open(store):
    return await MetricEngine.open("db", store, enable_compaction=False, serving=OFF,
                                   device="cpu")


async def fill(eng, payloads) -> int:
    n = 0
    for p in payloads:
        n += await eng.write_payload(p)
    await eng.flush()
    return n


def same_grids(got, want, ctx: str) -> None:
    assert (got is None) == (want is None), ctx
    if got is None:
        return
    assert got[0] == want[0], ctx
    for k in ("count", "min", "max"):
        g, w = np.asarray(got[1][k]), np.asarray(want[1][k])
        assert g.shape == w.shape and np.array_equal(g, w, equal_nan=True), f"{ctx}: {k}"
    for k in ("sum", "mean"):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-12, atol=0, err_msg=f"{ctx}: {k}")


async def answers(eng, query_cls, bucket_ms: int = 60_000):
    out = {}
    for i, q in enumerate(QUERIES):
        for m in METRICS[:2]:
            req = query_cls(metric=m, start_ms=BASE, end_ms=BASE + 360_000, bucket_ms=bucket_ms,
                            filters=list(q.get("filters", [])),
                            matchers=list(q.get("matchers", [])))
            out[(i, m)] = await eng.query(req)
    raw = await eng.query(query_cls(metric=METRICS[1], start_ms=BASE + 20_000,
                                    end_ms=BASE + 200_000, filters=[(b"rack", b"1")]))
    return out, raw


def same_rows(got, want) -> bool:
    """Raw-row tables equal on every lane, floats as u64 views (NaN too)."""
    if got.num_rows != want.num_rows or got.column_names != want.column_names:
        return False
    for col in got.column_names:
        a, b = got.column(col).to_numpy(), want.column(col).to_numpy()
        if a.dtype == np.float64:
            a, b = a.view(np.uint64), b.view(np.uint64)
        if not np.array_equal(a, b):
            return False
    return True


def index_view(eng):
    mid = eng.metric_mgr.get(METRICS[0])[0]
    finds = [eng.index_mgr.find_tsids(mid, q.get("filters", []), q.get("matchers"))
             for q in QUERIES]
    return (mid, finds, eng.index_mgr.series_of(mid), eng.label_values(METRICS[0], b"rack"),
            eng.series_count(METRICS[1]), sorted(eng.metric_names()))


def test_seahash_matches_the_jax_package():
    rng = np.random.default_rng(2)
    datas = [bytes(rng.integers(0, 256, int(n)).astype(np.uint8))
             for n in rng.integers(0, 90, 300)] + [b"", b"a" * 7, b"b" * 8, b"c" * 9]
    want = [jax_seahash(d) for d in datas]
    assert [seahash(d) for d in datas] == want
    assert seahash_many(datas).tolist() == want
    pairs = [(b"rack", b"7"), (b"", b""), (b"k" * 20, b"v" * 13)]
    assert tag_hashes_of(pairs).tolist() == [tag_hash_of(k, v) for k, v in pairs]


def test_wire_parser_matches_the_jax_decoder():
    for p in make_payloads(scrapes=4, per_payload=2):
        got, want = WireParser().parse(p), JaxWireParser().parse(p)
        for f in ("series_label_start", "series_label_count", "series_sample_start",
                  "series_sample_count", "label_name_off", "label_name_len", "label_value_off",
                  "label_value_len", "sample_ts", "sample_series", "meta_type",
                  "meta_name_off", "meta_name_len", "exemplar_value"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert np.array_equal(got.sample_value.view(np.uint64), want.sample_value.view(np.uint64))
        keys = got.series_raw_keys()
        assert len(set(keys)) == got.n_series and None not in keys


@pytest.mark.parametrize("bad", [b"\x0a\x05ab", b"\x00", b"\x0b", bytes([0x0a, 0x02, 0x0a, 0x05]),
                                 b"\x08" + b"\xff" * 10])
def test_wire_parser_rejects_what_the_jax_decoder_rejects(bad):
    with pytest.raises(Exception):
        JaxWireParser().parse(bad)
    with pytest.raises(HoraeError):
        WireParser().parse(bad)


def test_ids_index_and_grids_match_the_jax_engine():
    payloads = make_payloads()

    async def both():
        from horaedb_tpu.objstore import MemStore as JaxMemStore

        je = await jax_open(JaxMemStore())
        pe = await port_open(MemStore())
        try:
            assert await fill(je, payloads) == await fill(pe, payloads)
            assert index_view(pe) == index_view(je)
            assert pe.metadata() == je.metadata()
            (pg, praw), (jg, jraw) = await answers(pe, QueryRequest), await answers(je, JaxQuery)
        finally:
            await je.close()
            await pe.close()
        assert pg.keys() == jg.keys()
        for key in pg:
            same_grids(pg[key], jg[key], str(key))
        assert praw.num_rows > 0 and same_rows(praw, jraw)

    run(both())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_root_written_by_either_engine_opens_in_the_other(tmp_path, writer):
    """All six tables, the manifests and the registrations cross: the
    reader reopens the writer's root and answers the same queries with
    the same ids and grids, then writes more and the writer reopens it."""
    payloads = make_payloads(seed=5)
    first, second = payloads[:2], payloads[2:]
    openers = {"jax": (lambda: jax_open(JaxLocalStore(str(tmp_path))), JaxQuery),
               "port": (lambda: port_open(LocalStore(str(tmp_path))), QueryRequest)}
    reader = "port" if writer == "jax" else "jax"

    async def main():
        w = await openers[writer][0]()
        await fill(w, first)
        w_view, w_ans = index_view(w), await answers(w, openers[writer][1])
        await w.close()
        r = await openers[reader][0]()
        r_view, r_ans = index_view(r), await answers(r, openers[reader][1])
        await fill(r, second)
        r_full = await answers(r, openers[reader][1])
        await r.close()
        w = await openers[writer][0]()
        w_full = await answers(w, openers[writer][1])
        await w.close()
        return w_view, w_ans, r_view, r_ans, r_full, w_full

    w_view, w_ans, r_view, r_ans, r_full, w_full = run(main())
    assert r_view == w_view
    for (a, a_raw), (b, b_raw) in ((r_ans, w_ans), (r_full, w_full)):
        for key in a:
            same_grids(a[key], b[key], f"{writer}->{reader} {key}")
        assert same_rows(a_raw, b_raw)
    assert sum(g[1]["count"].sum() for g in r_full[0].values() if g) > \
        sum(g[1]["count"].sum() for g in w_ans[0].values() if g)


@pytest.mark.parametrize("kw", [
    dict(),  # the JAX defaults: serving tier on, compaction on
    dict(enable_compaction=False),
    dict(serving=OFF),
    dict(serving=OFF, enable_compaction=False, ingest_buffer_rows=1000),
    dict(serving=OFF, enable_compaction=False, max_series=10),
    dict(serving=OFF, enable_compaction=False, read_only=True),
    dict(serving=OFF, enable_compaction=False, fence_node_id="n1"),
    dict(serving=OFF, enable_compaction=False, retention_period_ms=1000),
])
def test_unported_options_raise(monkeypatch, kw):
    monkeypatch.delenv("HORAEDB_SERVING")
    with pytest.raises(NotPortedError):
        run(MetricEngine.open("db", MemStore(), device="cpu", **kw))


def test_serving_env_off_and_exemplars(monkeypatch):
    req = remote_write_pb2.WriteRequest()
    ts = req.timeseries.add()
    lab = ts.labels.add()
    lab.name, lab.value = b"__name__", b"m"
    ex = ts.exemplars.add()
    ex.value, ex.timestamp = 1.0, BASE

    async def main():
        # HORAEDB_SERVING=off (set by the fixture) turns the default tier off
        eng = await MetricEngine.open("db", MemStore(), enable_compaction=False, device="cpu")
        try:
            with pytest.raises(NotPortedError):
                await eng.write_payload(req.SerializeToString())
            with pytest.raises(HoraeError):  # no __name__
                bad = remote_write_pb2.WriteRequest()
                bad.timeseries.add().samples.add().value = 1.0
                await eng.write_payload(bad.SerializeToString())
        finally:
            await eng.close()

    run(main())
    assert os.environ["HORAEDB_SERVING"] == "off"
