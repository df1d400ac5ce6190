"""The port's fused scan route vs the JAX package (CPU).

Kernels `grouped_stats`, `downsample` and `scan_kernel` run their plain
PyTorch versions here (the tensors lie on the CPU); the JAX side runs as
its own tests run it, with the aggregation dispatcher pinned to `scatter`.
Inputs are made by numpy from a seed and fed to both packages.

Tolerances: counts, min, max, masks, permutations and every gathered lane
exact (floats as u64 views where bits matter, NaN == NaN where values
do); f64 sums and means rtol=1e-12, as tests/test_agg_registry.py holds
f64 sums; integer sums exact.

Also here: the fused route end to end, `scan_segment_downsample(
packed_ok=False)` and `query_downsample` over 2^17 series (where the
packed pass declines), and the raw scan of an append-mode table with a
binary value column, each against the JAX package's answer.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from horaedb_tpu import objstore as jobjstore
from horaedb_tpu import storage as jstorage
from horaedb_tpu.ops import aggregate as jagg
from horaedb_tpu.ops import dedup as jdedup
from horaedb_tpu.ops import filter as JF
from horaedb_tpu.ops.blocks import Block as JBlock
from horaedb_tpu.storage import read as jread
from horaedb_tpu_torch import objstore as tobjstore
from horaedb_tpu_torch import storage as tstorage
from horaedb_tpu_torch.backend import host_lane
from horaedb_tpu_torch.engine_query import query_downsample
from horaedb_tpu_torch.ops import aggregate as tagg
from horaedb_tpu_torch.ops import dedup as tdedup
from horaedb_tpu_torch.ops import filter as TF
from horaedb_tpu_torch.ops import scan as tscan
from horaedb_tpu_torch.storage import read as tread

SUM_RTOL = 1e-12
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _pin_scatter(monkeypatch):
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "scatter")


def assert_stats(got: dict, want: dict, keys=("sum", "count", "min", "max", "mean")) -> None:
    """Counts, min and max exact (NaN == NaN); float sums and means to
    rtol 1e-12 with NaN in the same places; integer sums exact."""
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("sum", "mean") and w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL, atol=0, equal_nan=True, err_msg=k)
        else:
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


# -- ops/dedup.py: padding rows and num_valid = 0 -------------------------------

@pytest.mark.parametrize("num_valid", [0, 1, 5, 9])
def test_dedup_masks_match_jax_on_padding(num_valid):
    rng = np.random.default_rng(num_valid)
    pk = np.sort(rng.integers(0, 4, 12)).astype(np.int64)
    pk[num_valid:] = np.iinfo(np.int64).max  # the JAX block's padding keys
    valid = np.arange(12) < num_valid
    cols_t = {"pk": torch.from_numpy(pk)}
    starts = tdedup.run_starts([cols_t["pk"]], torch.from_numpy(valid))
    np.testing.assert_array_equal(
        starts.numpy(), np.asarray(jdedup.run_starts([jnp.asarray(pk)], jnp.asarray(valid))))
    np.testing.assert_array_equal(
        tdedup.last_in_group_mask(starts, torch.from_numpy(valid), num_valid).numpy(),
        np.asarray(jdedup.last_in_group_mask(jnp.asarray(np.asarray(starts)), jnp.asarray(valid),
                                             num_valid)))
    np.testing.assert_array_equal(
        tdedup.dedup_last_value(cols_t, ["pk"], num_valid).numpy(),
        np.asarray(jdedup.dedup_last_value({"pk": jnp.asarray(pk)}, ["pk"], num_valid)))


# -- grouped_stats and downsample ------------------------------------------------

def stats_inputs(kind: str, n: int = 3000, segments: int = 200, seed: int = 0):
    rng = np.random.default_rng(seed)
    index = rng.integers(-5, segments + 5, n).astype(np.int32)  # < 0 and >= segments drop
    index[index == 17] = 18  # an empty segment inside the range
    valid = rng.random(n) > 0.15
    if kind == "f64":
        v = rng.normal(size=n) * 100
        v[rng.choice(n, 20, replace=False)] = np.nan
        v[rng.choice(n, 20, replace=False)] = -0.0
        v[rng.choice(n, 5, replace=False)] = np.inf
    elif kind == "i64":
        v = rng.integers(-(2**62), 2**62, n).astype(np.int64) // 64
    else:  # u64, values >= 2^63 included
        v = rng.integers(0, 2**58, n, dtype=np.uint64)
        v[rng.choice(n, 30, replace=False)] = np.uint64(2**63 + 12345)
    return v, index, valid, segments


def port_values(v: np.ndarray) -> tuple[torch.Tensor, bool]:
    """A value column as the port carries it: u64 as raw int64 bits."""
    if v.dtype == np.uint64:
        return torch.from_numpy(v.view(np.int64).copy()), True
    return torch.from_numpy(v), False


def port_host(out: dict, unsigned: bool) -> dict:
    return {k: (t.numpy().view(np.uint64) if unsigned and k in ("sum", "count") else t.numpy())
            for k, t in out.items()}


@pytest.mark.parametrize("kind", ["f64", "i64", "u64"])
def test_grouped_stats_matches_jax(kind):
    v, index, valid, segments = stats_inputs(kind)
    want = jagg.grouped_stats(v, index, valid, segments)
    vt, unsigned = port_values(v)
    got = tagg.grouped_stats(vt, torch.from_numpy(index), torch.from_numpy(valid), segments,
                             unsigned=unsigned)
    assert_stats(port_host(got, unsigned), {k: np.asarray(x) for k, x in want.items()})
    assert np.asarray(want["count"])[17] == 0


def test_grouped_stats_without_rows_and_without_segments():
    for n, segments in ((0, 7), (5, 0)):
        v = np.arange(n, dtype=np.float64)
        idx = np.zeros(n, np.int32)
        ok = np.ones(n, bool)
        got = tagg.grouped_stats(torch.from_numpy(v), torch.from_numpy(idx), None, segments)
        want = jagg.grouped_stats(v, idx, ok, segments)
        assert_stats({k: t.numpy() for k, t in got.items()},
                     {k: np.asarray(x) for k, x in want.items()})


def downsample_inputs(kind: str, seed: int = 1):
    rng = np.random.default_rng(seed)
    n, num_series, num_buckets, bucket_ms, t0 = 4000, 50, 12, 60_000, 1_700_000_000_000
    ts = t0 + rng.integers(-3 * bucket_ms, (num_buckets + 2) * bucket_ms, n).astype(np.int64)
    ts[:3] = [t0 - 1, t0, t0 + num_buckets * bucket_ms]  # bucket -1, bucket 0, past the grid
    sid = rng.integers(-2, num_series + 2, n).astype(np.int32)
    v, _, valid, _ = stats_inputs(kind, n=n, seed=seed)
    return ts, sid, v, valid, t0, bucket_ms, num_series, num_buckets


@pytest.mark.parametrize("kind", ["f64", "i64", "u64"])
def test_downsample_matches_jax(kind):
    ts, sid, v, valid, t0, bucket_ms, ns, nb = downsample_inputs(kind)
    want = jagg.downsample(ts, sid, v, valid, t0, bucket_ms, num_series=ns, num_buckets=nb)
    vt, unsigned = port_values(v)
    got = tagg.downsample(torch.from_numpy(ts), torch.from_numpy(sid), vt,
                          torch.from_numpy(valid), t0, bucket_ms, ns, nb, unsigned=unsigned)
    assert got["sum"].shape == (ns, nb)
    assert_stats(port_host(got, unsigned), {k: np.asarray(x) for k, x in want.items()})


# -- scan_kernel -------------------------------------------------------------------

PK = ("metric_id", "tsid", "ts")
SORT_KEYS = PK + ("__seq__",)


def scan_rows(n: int, seed: int, presorted: bool):
    """Lanes of a segment: u64 keys >= 2^63, a constant field, duplicate
    primary keys across write sequences, NaN / -0.0 values and an int32
    side lane."""
    rng = np.random.default_rng(seed)
    cols = {
        "metric_id": rng.integers(1, 3, n).astype(np.uint64),
        "tsid": rng.integers(2**63 - 3, 2**63 + 40, n, dtype=np.uint64),
        "ts": (1_000 + rng.integers(0, 12, n) * 10).astype(np.int64),
        "__seq__": rng.integers(10**18, 10**18 + 4, n).astype(np.uint64),
        "field": np.full(n, 7, np.int64),
        "value": rng.choice(np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf]), n),
        "__sid__": rng.integers(0, 1000, n).astype(np.int32),
    }
    if presorted:
        order = np.lexsort(tuple(cols[k] for k in reversed(SORT_KEYS)))
        cols = {k: a[order] for k, a in cols.items()}
    return cols


PREDICATES = {
    "none": lambda F: None,
    "compare": lambda F: F.And(F.Compare("metric_id", "eq", 1), F.Compare("ts", "lt", 1_090)),
    "inset_200": lambda F: F.Or(F.InSet("tsid", tuple(range(2**63 - 3, 2**63 + 400, 2))),
                                F.Compare("value", "ne", 0.0)),
}


def jax_scan(cols, pred, do_dedup, presorted):
    block = JBlock.from_numpy(cols, pad_keys=SORT_KEYS)
    template, raw = JF.split_literals(pred)
    lits = JF.literal_arrays(template, raw, {k: np.dtype(v.dtype) for k, v in
                                             block.columns.items()}) if template else ()
    kernel = jread._build_scan_kernel(tuple(block.names), SORT_KEYS, PK, template, do_dedup,
                                      presorted=presorted)
    out = kernel(block.columns, lits, block.num_valid)
    return [{k: np.asarray(a) for k, a in out[0].items()}] + [np.asarray(x) for x in out[1:]]


def port_scan(cols, pred, do_dedup, presorted, host_mask=False):
    n = len(cols["ts"])
    keys, bounds, num_pk, names = tread.sort_key_lanes(cols.__getitem__, SORT_KEYS, CPU)
    lanes = tread.predicate_lanes(cols, dict(zip(names, keys)), CPU)
    program = mask = None
    if host_mask:
        mask = torch.from_numpy(TF.eval_predicate_np(pred, cols))
    elif pred is not None:
        program = TF.compile_program(pred, {k: a.dtype for k, a in cols.items()})
    return tscan.scan_kernel(lanes, keys, bounds, num_pk, program, n, do_dedup, presorted,
                             CPU, mask=mask)


def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint64) if a.dtype.itemsize == 8 else a


def assert_scan_equal(got, want, cols) -> None:
    lanes, perm, keep, starts, kept = got
    w_lanes, w_perm, w_keep, w_starts, w_kept = want
    n = len(cols["ts"])
    k = int(kept.item())
    assert k == int(w_kept)
    np.testing.assert_array_equal(perm[:k].numpy(), w_perm[:k])
    for name, a in cols.items():
        np.testing.assert_array_equal(bits(host_lane(lanes[name][:k].numpy(), a.dtype)),
                                      bits(w_lanes[name][:k]), err_msg=name)
    np.testing.assert_array_equal(keep.numpy(), w_keep[:n])
    np.testing.assert_array_equal(starts.numpy(), w_starts[:n])
    assert not w_keep[n:].any() and not w_starts[n:].any()


@pytest.mark.parametrize("do_dedup", [True, False])
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("pred", sorted(PREDICATES))
def test_scan_kernel_matches_jax(pred, presorted, do_dedup):
    cols = scan_rows(2500, seed=3, presorted=presorted)
    p_jax, p_port = PREDICATES[pred](JF), PREDICATES[pred](TF)
    want = jax_scan(cols, p_jax, do_dedup, presorted)
    assert_scan_equal(port_scan(cols, p_port, do_dedup, presorted), want, cols)
    if p_port is not None:  # the host-mask form (a predicate kernel E cannot take)
        assert_scan_equal(port_scan(cols, p_port, do_dedup, presorted, host_mask=True), want,
                          cols)


@pytest.mark.parametrize("n", [0, 1])
def test_scan_kernel_tiny_inputs_match_jax(n):
    cols = scan_rows(n, seed=4, presorted=False)
    pred = PREDICATES["compare"]
    assert_scan_equal(port_scan(cols, pred(TF), True, False),
                      jax_scan(cols, pred(JF), True, False), cols)


# -- the fused route end to end ---------------------------------------------------

SEGMENT_MS = 2 * 3600 * 1000
T0 = 40 * SEGMENT_MS
SCHEMA = pa.schema([("metric_id", pa.uint64()), ("tsid", pa.uint64()), ("field_id", pa.uint64()),
                    ("ts", pa.int64()), ("value", pa.float64())])
NUM_SERIES = 1 << 17  # the packed pass declines at 2^17 series
WINDOW = (T0 + 7 * 60_000, T0 + SEGMENT_MS + 20 * 60_000)
BUCKET_MS = 30 * 60_000


def fused_batches(seed: int = 5):
    """Writes over two segments touching 300 of the 2^17 series: shuffled
    batches, a re-send that overwrites some samples, rows of another metric
    and NaN values."""
    rng = np.random.default_rng(seed)
    tsids = np.unique(rng.integers(0, 2**64 - 1, 2 * NUM_SERIES, dtype=np.uint64, endpoint=True))
    tsids = np.sort(rng.choice(tsids, NUM_SERIES, replace=False))
    used = np.sort(rng.choice(NUM_SERIES, 300, replace=False))
    n = 2400
    sid = used[rng.integers(0, len(used), n)]
    ts = T0 + rng.integers(0, 2 * SEGMENT_MS // 60_000, n) * 60_000
    metric = np.where(rng.random(n) < 0.05, 2, 1).astype(np.uint64)
    values = rng.normal(size=n) * 10
    values[rng.choice(n, 4, replace=False)] = np.nan
    seg = (ts - T0) // SEGMENT_MS
    out = []
    for s in (0, 1):
        rows = rng.permutation(np.flatnonzero(seg == s))
        for part in np.array_split(rows, 3) + [rows[: len(rows) // 10]]:
            vals = values[part] if len(out) % 4 != 3 else rng.normal(size=len(part))
            out.append((T0 + s * SEGMENT_MS, pa.RecordBatch.from_pydict(
                {"metric_id": metric[part], "tsid": tsids[sid[part]],
                 "field_id": np.zeros(len(part), np.uint64), "ts": ts[part], "value": vals},
                schema=SCHEMA)))
    subset = np.sort(np.concatenate([tsids[used[::3]], tsids[:NUM_SERIES - 200:1000]]))
    subset = np.unique(np.concatenate([subset, tsids[-140_000:]]))  # >= 2^17 series
    return tsids, subset, out


def fused_pred(F):
    return F.And(F.Compare("metric_id", "eq", 1), F.time_range_pred("ts", *WINDOW))


async def fused_grids(pkg, batches, id_sets, **kw):
    eng = await pkg.ObjectBasedStorage.try_new(
        "db", pkg.MemStore(), SCHEMA, 4, SEGMENT_MS, enable_compaction_scheduler=False,
        start_background_merger=False, **kw)
    try:
        for start, b in batches:
            await eng.write(pkg.WriteRequest(b, pkg.TimeRange(start, start + SEGMENT_MS)))
        num_buckets = -(-(WINDOW[1] - WINDOW[0]) // BUCKET_MS)
        segs = eng.group_by_segment(eng.select_ssts(pkg.TimeRange(*WINDOW)))
        out = []
        for ids in id_sets:
            parts = [await eng.parquet_reader.scan_segment_downsample(
                seg, fused_pred(pkg.F), "ts", "value", "tsid", ids, WINDOW[0], BUCKET_MS,
                num_buckets, packed_ok=False) for seg in segs]
            out.append(parts)
        if pkg.name == "port":
            out.append([await query_downsample(eng, ids, pkg.TimeRange(*WINDOW), BUCKET_MS,
                                               fused_pred(pkg.F)) for ids in id_sets])
        return out
    finally:
        await eng.close()


class _Pkg:
    def __init__(self, name, st, objstore, F):
        self.name = name
        self.F = F
        self.MemStore = objstore.MemStore
        self.ObjectBasedStorage = st.ObjectBasedStorage
        self.WriteRequest = st.WriteRequest
        self.TimeRange = st.TimeRange
        self.ScanRequest = st.ScanRequest
        self.StorageConfig = st.StorageConfig
        self.UpdateMode = st.UpdateMode


JAX = _Pkg("jax", jstorage, jobjstore, JF)
PORT = _Pkg("port", tstorage, tobjstore, TF)


def test_fused_route_matches_jax(monkeypatch):
    """scan_segment_downsample(packed_ok=False) per segment and the
    engine-path query_downsample over 2^17 series (the packed pass
    declines) give the JAX package's grids, for all series and for a
    subset (whose misses ride the __sidok__ lane)."""
    tsids, subset, batches = fused_batches()
    assert len(subset) >= NUM_SERIES
    want = asyncio.run(fused_grids(JAX, batches, [tsids, subset]))
    calls = []
    inner = tscan.scan_kernel
    monkeypatch.setattr(tscan, "scan_kernel", lambda *a, **k: calls.append(1) or inner(*a, **k))
    got = asyncio.run(fused_grids(PORT, batches, [tsids, subset], device="cpu"))
    assert calls, "the fused route did not run the scan pass"
    for g_parts, w_parts in zip(got[:2], want):
        assert len(g_parts) == len(w_parts) == 2
        for g, w in zip(g_parts, w_parts):
            assert g["count"].sum() > 0
            assert_stats(g, w, keys=("sum", "count", "min", "max"))
    for grids, parts in zip(got[2], want):
        fold = {"sum": parts[0]["sum"] + parts[1]["sum"],
                "count": parts[0]["count"] + parts[1]["count"],
                "min": np.minimum(parts[0]["min"], parts[1]["min"]),
                "max": np.maximum(parts[0]["max"], parts[1]["max"])}
        with np.errstate(invalid="ignore", divide="ignore"):
            fold["mean"] = fold["sum"] / fold["count"]
        assert_stats(grids, fold)


# -- append mode over binary values -----------------------------------------------

APPEND_SCHEMA = pa.schema([("tsid", pa.uint64()), ("ts", pa.int64()), ("payload", pa.binary()),
                           ("v", pa.float64())])


def append_batches(seed: int = 6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(5):
        n = 300
        payload = [bytes(rng.integers(0, 256, rng.integers(0, 40), dtype=np.uint8))
                   for _ in range(n)]
        payload[0] = None
        out.append(pa.RecordBatch.from_pydict(
            {"tsid": rng.integers(2**63 - 2, 2**63 + 25, n, dtype=np.uint64),
             "ts": rng.integers(0, 15, n).astype(np.int64),
             "payload": payload, "v": rng.choice(np.array([np.nan, -0.0, 1.0, 2.5]), n)},
            schema=APPEND_SCHEMA))
    return out


async def append_scans(pkg, batches, **kw):
    eng = await pkg.ObjectBasedStorage.try_new(
        "db", pkg.MemStore(), APPEND_SCHEMA, 2, SEGMENT_MS,
        config=pkg.StorageConfig(update_mode=pkg.UpdateMode.APPEND),
        enable_compaction_scheduler=False, start_background_merger=False, **kw)
    try:
        for b in batches:
            await eng.write(pkg.WriteRequest(b, pkg.TimeRange(0, SEGMENT_MS)))
        F = pkg.F
        out = []
        for req in (dict(), dict(predicate=F.Or(F.Compare("ts", "lt", 9),
                                                F.Compare("v", "gt", 1.0))),
                    dict(predicate=F.InSet("tsid", tuple(range(2**63 - 2, 2**63 + 300, 3))),
                         projections=[0, 2])):
            bs = [b async for b in eng.scan(pkg.ScanRequest(range=pkg.TimeRange(0, SEGMENT_MS),
                                                            **req))]
            out.append(pa.Table.from_batches(bs))
        return out
    finally:
        await eng.close()


def test_append_mode_binary_scan_matches_jax():
    batches = append_batches()
    want = asyncio.run(append_scans(JAX, batches))
    got = asyncio.run(append_scans(PORT, batches, device="cpu"))
    for g, w in zip(got, want):
        assert g.schema == w.schema and g.num_rows == w.num_rows > 0
        for name in w.schema.names:
            a, b = g.column(name), w.column(name)
            if pa.types.is_binary(a.type):
                assert a.to_pylist() == b.to_pylist(), name
            else:
                np.testing.assert_array_equal(bits(a.to_numpy()), bits(b.to_numpy()),
                                              err_msg=name)
