"""The port's mesh layer against the JAX package's, on the CPU.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port's mesh holds 8 CPU slots, so every step runs its kernels' plain
versions. The same numpy-seeded inputs go to both:
- `sharded_downsample` (sorted and unsorted rows, with and without a
  predicate) and the 3-axis `multisegment_downsample` on a (rows 4 x
  series 2) mesh: counts, min and max exact, sums rtol 1e-12 (the port
  folds the row shards' grids left to right, XLA's psum in its own order);
- `mesh_downsample` on prime series counts (the per-lane pads);
- `sharded_packed_merge`: indices bytewise equal to the JAX package's and
  to the port's `packed_merge` (random, skewed, single-group, all-sentinel
  and empty inputs);
- a storage scan with HORAEDB_SCAN_PATH=sharded equal to the default scan,
  through the sample sort (its scanstats note), and the mesh's refusals.
"""

import asyncio

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from horaedb_tpu.ops import filter as JF
from horaedb_tpu.parallel import merge as jmerge
from horaedb_tpu.parallel import mesh as jmesh
from horaedb_tpu.parallel import scan as jscan
from horaedb_tpu_torch.backend import u64_to_i64
from horaedb_tpu_torch.common.error import HoraeError
from horaedb_tpu_torch.objstore import MemStore
from horaedb_tpu_torch.ops import filter as F
from horaedb_tpu_torch.ops.merge import packed_merge
from horaedb_tpu_torch.parallel import merge as pmerge
from horaedb_tpu_torch.parallel import mesh as pmesh
from horaedb_tpu_torch.parallel import scan as pscan
from horaedb_tpu_torch.storage import ObjectBasedStorage, ScanRequest, TimeRange, WriteRequest
from horaedb_tpu_torch.storage import scanstats

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def meshes():
    return (jmesh.make_mesh(8, series_parallel=2),
            pmesh.make_mesh(8, series_parallel=2, devices=CPU8))


@pytest.fixture(autouse=True)
def _device_lane(monkeypatch):
    # the CPU calibration may pick the host reduceat lane; pin kernel B's
    # plain version, the lane every device name takes on the card
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "block")


def close(got: dict, want: dict, keys=("sum", "count", "min", "max", "mean")) -> None:
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in ("sum", "mean"):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True, err_msg=k)
        else:
            assert np.array_equal(g, w, equal_nan=True), k


def _rows(rng, n: int, num_series: int, sorted_rows: bool):
    sid = rng.integers(0, num_series, n).astype(np.int32)
    ts = rng.integers(-3_000, 8 * 1_000 + 3_000, n).astype(np.int64)
    if sorted_rows:
        order = np.lexsort((ts, sid))
        sid, ts = sid[order], ts[order]
    return ts, sid, rng.normal(size=n)


@pytest.mark.parametrize("sorted_rows,with_pred", [(True, False), (False, True)])
def test_sharded_downsample_matches_jax(meshes, sorted_rows, with_pred):
    jm, pm = meshes
    rng = np.random.default_rng(3 + with_pred)
    num_series, num_buckets, n = 16, 8, 4 * 611
    ts, sid, vals = _rows(rng, n, num_series, sorted_rows)
    jpred = JF.Compare("__val__", "gt", -0.25) if with_pred else None
    ppred = F.Compare("__val__", "gt", -0.25) if with_pred else None
    (jts, jsid, jv), jok = jscan.shard_rows(jm, (ts, sid, vals))
    want = jscan.sharded_downsample(jm, jts, jsid, jv, jok, 1_000, 1_000, num_series,
                                    num_buckets, predicate=jpred, sorted_input=sorted_rows)
    (pts, psid, pv), pok = pscan.shard_rows(pm, (ts, sid, vals))
    got = pscan.sharded_downsample(pm, pts, psid, pv, pok, 1_000, 1_000, num_series,
                                   num_buckets, predicate=ppred, sorted_input=sorted_rows)
    close({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()})


def test_multisegment_downsample_matches_jax():
    devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    jm3 = JaxMesh(devs, ("seg", "rows", "series"))
    slots = np.empty(8, dtype=object)
    slots[:] = [torch.device("cpu")] * 8
    pm3 = pmesh.Mesh(slots.reshape(2, 2, 2), ("seg", "rows", "series"))
    rng = np.random.default_rng(9)
    segs, rows, num_series = 2, 2 * 300, 8
    ts = rng.integers(-500, 8_500, (segs, rows)).astype(np.int64)
    sid = rng.integers(0, num_series, (segs, rows)).astype(np.int32)
    vals = rng.normal(size=(segs, rows))
    valid = rng.random((segs, rows)) > 0.1
    t0 = np.array([0, 400], np.int64)
    sh = NamedSharding(jm3, P("seg", "rows"))
    fn = jscan.build_multisegment_downsample(jm3, num_series, 8)
    want = fn(*(jax.device_put(a, sh) for a in (ts, sid, vals, valid)),
              jax.device_put(t0, NamedSharding(jm3, P("seg"))), np.int64(1_000))
    got = pscan.build_multisegment_downsample(pm3, num_series, 8)(
        *(torch.from_numpy(a) for a in (ts, sid, vals, valid)), t0, 1_000)
    close({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("num_series", [7, 13])
def test_mesh_downsample_prime_series_matches_jax(meshes, num_series):
    jm, pm = meshes
    rng = np.random.default_rng(num_series)
    ts, sid, vals = _rows(rng, 4 * 97 + 3, num_series, True)
    want = jmesh.mesh_downsample(jm, ts, sid, vals, 0, 1_000, num_series, 5)
    got = pmesh.mesh_downsample(pm, ts, sid, vals, 0, 1_000, num_series, 5)
    close(got, want, keys=("sum", "count", "min", "max"))
    assert got["sum"].shape == (num_series, 5)


# a slot's series slice and grid: series [5, 9) x 6 buckets of 1 s from t0
SLOT = dict(t0=1_000, bucket_ms=1_000, lo=5, local_series=4, num_buckets=6)


def _slot_case(case: str, sorted_rows: bool):
    """One slot's lanes (ts, sid, vals, valid, mask or None) of `case`, a
    few hundred rows (none for `empty`), in (sid, ts) order when
    `sorted_rows`."""
    rng = np.random.default_rng(len(case) * 7 + sorted_rows)
    n = 0 if case == "empty" else 311
    sid = rng.integers(5, 9, n)
    ts = rng.integers(1_000, 7_000, n)
    vals = rng.normal(size=n)
    valid = np.ones(n, bool)
    mask = None
    if case == "foreign_runs":  # rows of the slices before and after this one
        sid = rng.integers(0, 14, n)
    elif case == "outside_the_grid":  # before t0 and past the last bucket
        ts = rng.integers(-2_500, 9_500, n)
    elif case == "predicate":
        mask = rng.random(n) > 0.4
    elif case == "invalid":
        valid = rng.random(n) > 0.3
    elif case == "nan_and_negative_zero":
        vals[rng.random(n) < 0.05] = np.nan
        # cell (5, 0): -0.0 twice beside a masked row, and no other row
        sid[:3], ts[:3], vals[:3] = 5, [1_000, 1_100, 1_200], -0.0
        valid[2] = False
        sid[3:] = np.where((ts[3:] < 2_000) & (sid[3:] == 5), 6, sid[3:])
    if sorted_rows:
        order = np.lexsort((ts, sid))
        sid, ts, vals, valid = sid[order], ts[order], vals[order], valid[order]
        mask = None if mask is None else mask[order]
    lanes = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        ts.astype(np.int64), sid.astype(np.int32), vals, valid)]
    return lanes + [None if mask is None else torch.from_numpy(mask)]


def _composed_route(ts, sid, vals, valid, mask, sorted_rows: bool) -> dict:
    """The slot step as the mesh composed it before the slot pass: the cell
    keys, then kernels B and C over `safe` (sorted rows) or the scatter
    strategy and grouped_stats over `flat` (unsorted), through their
    wrappers (plain versions on the CPU; the fixture pins kernel B's)."""
    from horaedb_tpu_torch.ops import blockagg
    from horaedb_tpu_torch.ops import mesh as mesh_ops
    from horaedb_tpu_torch.ops.aggregate import grouped_stats

    cells = SLOT["local_series"] * SLOT["num_buckets"]
    safe, flat, vm, w, ok = mesh_ops.sharded_keys_plain(ts, sid, vals, valid, mask, *SLOT.values())
    if sorted_rows:
        s, c = blockagg.sorted_segment_sum_count(safe, vm, cells, weights=w)
        mn, mx = blockagg.sorted_segment_min_max(safe, vm, cells, valid=ok)
    else:
        s, c = blockagg.segment_sum_count(safe, vm, cells, impl="scatter", weights=w)
        g = grouped_stats(vm, flat, None, cells)
        mn, mx = g["min"], g["max"]
    return {"sum": s, "count": c, "min": mn, "max": mx}


@pytest.mark.parametrize("sorted_rows", [True, False])
@pytest.mark.parametrize("case", ["foreign_runs", "outside_the_grid", "predicate", "invalid",
                                  "nan_and_negative_zero", "empty"])
def test_slot_pass_plain_equals_the_composed_route(case, sorted_rows):
    """The slot pass's plain version (what CPU slots run and the card is
    held to) is bitwise the keys-then-reductions route it replaces."""
    from horaedb_tpu_torch.ops import mesh as mesh_ops

    lanes = _slot_case(case, sorted_rows)
    got = mesh_ops.slot_grids_plain(*lanes, *SLOT.values(), sorted_rows)
    want = _composed_route(*lanes, sorted_rows)
    for key in ("sum", "count", "min", "max"):
        assert np.array_equal(got[key].numpy().view(np.uint64),
                              want[key].numpy().view(np.uint64)), key
    if case == "nan_and_negative_zero":  # -0.0 twice beside a masked row sums to +0.0
        assert got["sum"][0].numpy().view(np.uint64) == 0 and got["count"][0] == 2
    if case == "empty":
        assert not got["count"].any() and bool(torch.isinf(got["min"]).all())
    on_cpu = mesh_ops.slot_grids(*lanes, *SLOT.values(), sorted_rows)  # its plain version
    assert np.array_equal(on_cpu["sum"].numpy().view(np.uint64), got["sum"].numpy().view(np.uint64))


def _packed(case: str, n: int = 50_000, seq_width: int = 8) -> np.ndarray:
    rng = np.random.default_rng(21)
    grp = rng.integers(0, 9_000, n).astype(np.uint64)
    if case == "skew":
        grp[: n * 9 // 10] = 5
    elif case == "single":
        grp[:] = 77
    seq = rng.integers(0, 1 << seq_width, n).astype(np.uint64)
    packed = (grp << np.uint64(seq_width)) | seq
    packed[rng.random(n) < 0.15] = jmerge._SENTINEL
    if case == "sentinel":
        packed[:] = jmerge._SENTINEL
    return packed


@pytest.mark.parametrize("case", ["random", "skew", "single", "sentinel", "empty"])
def test_sharded_packed_merge_matches_jax_and_packed_merge(meshes, case):
    jm, pm = meshes
    packed = _packed(case) if case != "empty" else np.empty(0, np.uint64)
    got = pmerge.sharded_packed_merge(packed, 8, True, pm)
    assert got.dtype == np.int64
    assert np.array_equal(got, jmerge.sharded_packed_merge(packed, 8, True, jm))
    idx, cnt = packed_merge(torch.from_numpy(u64_to_i64(packed)), 63, 8, True)
    assert np.array_equal(got, idx[: int(cnt)].numpy().astype(np.int64))
    deferred = pmerge.sharded_packed_merge(packed, 8, False, pm, defer=True)
    idx, cnt = packed_merge(torch.from_numpy(u64_to_i64(packed)), 63, 8, False)
    assert np.array_equal(deferred(), idx[: int(cnt)].numpy().astype(np.int64))


def test_splitters_and_capacity_are_the_jax_packages(meshes):
    jm, pm = meshes
    packed = _packed("random")
    grp = packed >> np.uint64(8)
    ok = packed != jmerge._SENTINEL
    assert np.array_equal(pmerge._splitters_from_sample(grp, ok, 8),
                          jmerge._splitters_from_sample(grp, ok, 8))
    plan = pmerge.SamplePlan(packed, 8, True, pm)
    # the pad rows (sentinels) all land in the last bucket of the last shard
    assert (plan.local_n, plan.cap) == (8192, 8192)


SEG = 3_600_000
SCHEMA = pa.schema([("pk1", pa.int64()), ("pk2", pa.int64()), ("ts", pa.int64()),
                    ("value", pa.float64())])


async def _scan(mode, mesh, monkeypatch, predicate=None):
    rng = np.random.default_rng(22)
    eng = await ObjectBasedStorage.try_new("db", MemStore(), SCHEMA, 2, SEG,
                                           enable_compaction_scheduler=False,
                                           start_background_merger=False, device="cpu")
    for _ in range(3):
        m = 3000
        batch = pa.RecordBatch.from_pydict(
            {"pk1": rng.integers(0, 600, m).astype(np.int64),
             "pk2": rng.integers(0, 4, m).astype(np.int64),
             "ts": rng.integers(0, SEG - 1, m).astype(np.int64),
             "value": rng.normal(size=m)}, schema=SCHEMA)
        await eng.write(WriteRequest(batch, TimeRange(0, SEG)))
    if mode:
        monkeypatch.setenv("HORAEDB_SCAN_PATH", mode)
    pmesh.set_active_mesh(mesh)
    try:
        with scanstats.scan_stats() as st:
            out = [b async for b in eng.scan(ScanRequest(TimeRange(0, SEG), predicate=predicate))]
    finally:
        pmesh.set_active_mesh(None)
        monkeypatch.delenv("HORAEDB_SCAN_PATH", raising=False)
    await eng.close()
    return pa.Table.from_batches(out), dict(st.counts)


@pytest.mark.parametrize("with_pred", [False, True])
def test_sharded_scan_equals_default_scan(meshes, monkeypatch, with_pred):
    _, pm = meshes
    pred = F.Compare("pk1", "lt", 300) if with_pred else None
    got, notes = asyncio.run(_scan("sharded", pm, monkeypatch, pred))
    want, _ = asyncio.run(_scan(None, None, monkeypatch, pred))
    assert notes.get("path_device_merge_sharded", 0) >= 1, notes
    assert not any(k.startswith("path_sharded_fallback") for k in notes), notes
    assert got.num_rows > 0 and got.equals(want)


def test_sharded_without_a_mesh_falls_back_visibly(monkeypatch):
    got, notes = asyncio.run(_scan("sharded", None, monkeypatch))
    want, _ = asyncio.run(_scan(None, None, monkeypatch))
    assert notes.get("path_sharded_fallback_no_mesh", 0) >= 1 and got.equals(want)


def test_mesh_shapes_and_refusals():
    m = pmesh.make_mesh(8, series_parallel=2, devices=CPU8)
    assert m.shape == {"rows": 4, "series": 2} and m.size == 8
    assert m == pmesh.make_mesh(8, series_parallel=2, devices=CPU8) and hash(m) == hash(
        pmesh.make_mesh(8, series_parallel=2, devices=CPU8))
    with pytest.raises(HoraeError, match="not divisible"):
        pmesh.make_mesh(6, series_parallel=4, devices=["cpu"] * 6)
    pmesh.set_active_mesh(pmesh.make_mesh(1, devices=["cpu"]))
    try:
        assert pmesh.active_mesh() is None  # a 1-slot mesh is degenerate
    finally:
        pmesh.set_active_mesh(None)
    (ts,), _ = pscan.shard_rows(m, (np.arange(5, dtype=np.int64),), pad_value=-1)
    assert [t.tolist() for t in ts] == [[0, 1], [2, 3], [4, -1], [-1, -1]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the plain steps run many small ops; one thread avoids contention with
    # the JAX runtime's own threads in this process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
