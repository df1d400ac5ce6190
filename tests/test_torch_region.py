"""The port's regioned engine against the JAX package's, on the CPU.

The same seeded remote-write payloads (tests/test_torch_engine.py: TSBS
host tags, three metrics, a few NaN values) go into a 4-region JAX
`RegionedEngine` (HORAEDB_SERVING=off, HORAEDB_BATCH=off) and the port's
(`device="cpu"`). Checked:
- the REGIONS descriptor bytes, and the region every series lands in;
- `query` grids (ids, counts, min and max exact, sums and means rtol
  1e-12) and raw rows against the JAX engine's;
- every split of `query_partial_grids` across "nodes", wire round-tripped
  and folded by `merge_partials` in the engine's region order, with and
  without a mesh of CPU slots: bitwise equal to `query` (u64 views);
- the discovery surface, v1 stores, and what the port refuses.
"""

import asyncio
import dataclasses
import json
import os

import numpy as np
import pytest

from horaedb_tpu.engine.region import RegionedEngine as JaxRegioned
from horaedb_tpu.engine import QueryRequest as JaxQuery
from horaedb_tpu.objstore import MemStore as JaxMemStore
from horaedb_tpu_torch.cluster.partial import decode_partials, encode_partials, merge_partials
from horaedb_tpu_torch.common.error import NotPortedError
from horaedb_tpu_torch.engine import QueryRequest
from horaedb_tpu_torch.engine.region import RangeRouter, RegionedEngine, RegionRouter
from horaedb_tpu_torch.objstore import MemStore
from horaedb_tpu_torch.parallel.mesh import make_mesh
from horaedb_tpu_torch.serving import ServingTierConfig
from tests.test_torch_engine import BASE, METRICS, fill, make_payloads, same_grids

ENV = {"HORAEDB_SERVING": "off", "HORAEDB_BATCH": "off"}
REGIONS = 4
QUERIES = [dict(filters=[]), dict(filters=[(b"rack", b"3")]),
           dict(matchers=[(b"hostname", "re", b"host_1[0-9]")])]


@pytest.fixture(scope="module")
def engines():
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    loop = asyncio.new_event_loop()
    payloads = make_payloads(scrapes=18, per_payload=9)
    jstore, pstore = JaxMemStore(), MemStore()
    jax_eng = loop.run_until_complete(JaxRegioned.open(
        "db", jstore, num_regions=REGIONS, enable_compaction=False))
    port_eng = loop.run_until_complete(RegionedEngine.open(
        "db", pstore, num_regions=REGIONS, enable_compaction=False,
        serving=ServingTierConfig(enabled=False), device="cpu"))
    loop.run_until_complete(fill(jax_eng, payloads))
    loop.run_until_complete(fill(port_eng, payloads))
    yield loop, jax_eng, port_eng, jstore, pstore
    loop.run_until_complete(jax_eng.close())
    loop.run_until_complete(port_eng.close())
    pending = asyncio.all_tasks(loop)
    for task in pending:
        task.cancel()
    loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
    loop.close()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _req(cls, metric=METRICS[0], bucket_ms=60_000, **kw):
    return cls(metric=metric, start_ms=BASE, end_ms=BASE + 180_000, bucket_ms=bucket_ms, **kw)


def test_descriptor_bytes_and_routing(engines):
    loop, jax_eng, port_eng, jstore, pstore = engines
    theirs = loop.run_until_complete(jstore.get("db/REGIONS"))
    ours = loop.run_until_complete(pstore.get("db/REGIONS"))
    assert ours == theirs
    assert json.loads(ours)["version"] == 2 and list(port_eng.engines) == list(jax_eng.engines)
    for m in METRICS:
        counts = [port_eng.engines[i].series_count(m) for i in port_eng.engines]
        assert counts == [jax_eng.engines[i].series_count(m) for i in jax_eng.engines]
        assert sum(counts) == 24 and min(counts) > 0  # one metric spans every region


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_query_grids_match_jax(engines, qi):
    loop, jax_eng, port_eng, _, _ = engines
    got = loop.run_until_complete(port_eng.query(_req(QueryRequest, **QUERIES[qi])))
    want = loop.run_until_complete(jax_eng.query(_req(JaxQuery, **QUERIES[qi])))
    same_grids(got, want, str(QUERIES[qi]))


def test_raw_query_matches_jax(engines):
    loop, jax_eng, port_eng, _, _ = engines
    got = loop.run_until_complete(port_eng.query(_req(QueryRequest, bucket_ms=None)))
    want = loop.run_until_complete(jax_eng.query(_req(JaxQuery, bucket_ms=None)))
    assert got.column_names == want.column_names and got.num_rows == want.num_rows
    for c in got.column_names:
        a, b = got.column(c).to_numpy(), want.column(c).to_numpy()
        if a.dtype == np.float64:
            a, b = a.view(np.uint64), b.view(np.uint64)
        assert np.array_equal(a, b), c


def _splits(ids):
    ids = list(ids)
    yield [ids]
    for cut in range(1, len(ids)):
        yield [ids[:cut], ids[cut:]]
    yield [[ids[0], ids[-1]], ids[1:-1]]
    yield [[i] for i in reversed(ids)]


@pytest.mark.parametrize("with_mesh", [False, True])
def test_every_split_folds_to_query_bitwise(engines, with_mesh):
    loop, _, port_eng, _, _ = engines
    mesh = make_mesh(4, series_parallel=2, devices=["cpu"] * 4) if with_mesh else None
    req = _req(QueryRequest)
    want = loop.run_until_complete(port_eng.query(req))
    order = list(port_eng.engines)
    for groups in _splits(order):
        parts = []
        for gi, group in enumerate(groups):
            frag = loop.run_until_complete(port_eng.query_partial_grids(
                dataclasses.replace(req, regions=[int(r) for r in group])))
            _, decoded = decode_partials(encode_partials(f"node-{gi}", frag))
            parts.extend(decoded)
        got = merge_partials(parts[::-1], order=order, device_mesh=mesh)
        assert got[0] == want[0], groups
        for k in ("sum", "count", "min", "max", "mean"):
            assert np.array_equal(np.asarray(got[1][k]).view(np.uint64),
                                  want[1][k].view(np.uint64)), (groups, k)


def test_discovery_matches_jax(engines):
    loop, jax_eng, port_eng, _, _ = engines
    m = METRICS[0]
    assert port_eng.metric_names() == jax_eng.metric_names()
    assert port_eng.label_names() == jax_eng.label_names()
    assert port_eng.label_values(m, b"rack") == jax_eng.label_values(m, b"rack")
    assert port_eng.series_count(m) == jax_eng.series_count(m)
    assert port_eng.series(m) == jax_eng.series(m)
    assert port_eng.series_labels_map(m) == jax_eng.series_labels_map(m)
    matched = loop.run_until_complete(port_eng.match_series(m, [(b"rack", b"2")], []))
    assert matched == loop.run_until_complete(jax_eng.match_series(m, [(b"rack", b"2")], []))
    assert port_eng.metadata() == jax_eng.metadata()


def test_v1_store_routes_by_metric_and_refusals():
    async def go():
        store = MemStore()
        await store.put("v1/REGIONS", json.dumps({"num_regions": 2}).encode())
        eng = await RegionedEngine.open("v1", store, num_regions=2, enable_compaction=False,
                                        serving=ServingTierConfig(enabled=False), device="cpu")
        assert isinstance(eng.router, RegionRouter)
        await fill(eng, make_payloads(scrapes=3, per_payload=3))
        out = await eng.query(_req(QueryRequest, bucket_ms=60_000))
        owner = eng.router.region_of_name(METRICS[0])
        assert out is not None and len(out[0]) == 24
        assert eng.engines[owner].series_count(METRICS[0]) == 24
        with pytest.raises(NotPortedError):
            await eng.split_region(0)
        await eng.close()
        with pytest.raises(NotPortedError, match="writable_regions"):
            await RegionedEngine.open("w", MemStore(), 2, writable_regions={0},
                                      enable_compaction=False, device="cpu")
        with pytest.raises(Exception, match="num_regions"):
            await RegionedEngine.open("v1", store, num_regions=3, enable_compaction=False,
                                      serving=ServingTierConfig(enabled=False), device="cpu")

    asyncio.run(go())
    r = RangeRouter([0, 1 << 63], [0, 1], "series")
    assert r.regions_of_lanes(np.zeros(2, np.uint64),
                              np.array([5, (1 << 63) + 5], np.uint64)).tolist() == [0, 1]
