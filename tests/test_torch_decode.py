"""The port's encoded (format-v2) SSTs and decode kernels vs the JAX package.

- the plain versions of decode_unpack, decode_dod, decode_xor and
  decode_rle (what the wrappers run on a CPU tensor) against the JAX
  package's XLA kernels (`decode_page_device`, run on the CPU), bitwise on
  u64 views, page by page and as one multi-page lane, including width 32,
  width 33 (outside the envelope: None, and the host funnel fills the
  page), pages of 1-3 rows, and the mod-2^64 wrap;
- the format: `encode_table`/`encode_blob` byte-identical to the JAX
  package's, `decode_blob` in both directions, `prune_pages` and
  `encoded_mask` equal to the JAX package's;
- the slice end to end: an encoded tree written by the JAX package scanned
  and downsampled by the port, and the port's tree read by the JAX package,
  under HORAEDB_DECODE_IMPL = host, device (the plain versions here) and
  raw, against the JAX package's parquet read; the same `.enc` bytes and
  manifest descriptors for the same writes;
- what may and may not fall back to parquet: a corrupt sidecar does, a
  kernel-layer error does not; the calibrated dispatcher.
"""

import asyncio
import itertools

import numpy as np
import pyarrow as pa
import pytest
import torch

from horaedb_tpu import objstore as jobjstore
from horaedb_tpu import storage as jstorage
from horaedb_tpu.ops import decode as jdecode
from horaedb_tpu.ops import filter as JF
from horaedb_tpu.storage import encoding as jenc
from horaedb_tpu.storage import storage as jstorage_mod
from horaedb_tpu.storage.config import EncodingConfig as JEncodingConfig
from horaedb_tpu_torch import objstore as tobjstore
from horaedb_tpu_torch import storage as tstorage
from horaedb_tpu_torch.engine_query import query_downsample
from horaedb_tpu_torch.ops import _build
from horaedb_tpu_torch.ops import decode as tdecode
from horaedb_tpu_torch.ops import filter as TF
from horaedb_tpu_torch.storage import encoding as tenc
from horaedb_tpu_torch.storage import storage as tstorage_mod
from horaedb_tpu_torch.storage.config import EncodingConfig

I64 = np.iinfo(np.int64)
SEGMENT_MS = 3_600_000
CPU = torch.device("cpu")


def bits(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return a.view(np.uint64 if a.itemsize == 8 else np.uint32)
    return a


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(bits(a), bits(b))


# -- the kernels: plain versions vs the JAX kernels ----------------------------------

def _f64_bits(b):
    return np.asarray(b, np.uint64).view(np.float64)


def kernel_cases():
    """(name, encoder name, array, page_rows, extra encoder args)."""
    rng = np.random.default_rng(5)
    ts = 1_700_000_000_000 + np.arange(9000, dtype=np.int64) * 15_000 + rng.integers(-5, 6, 9000)
    nan_low = _f64_bits(np.uint64(0x7FF8_0000_0000_0000) | rng.integers(0, 1 << 20, 3000,
                                                                        dtype=np.uint64))
    f32 = rng.normal(size=5000).astype(np.float32)
    f32[[10, 20, 30, 40, 50]] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
    f32[60] = np.array(0x7FC0_1234, np.uint32).view(np.float32)  # a NaN payload
    w32 = np.zeros(300, np.int64)
    w32[2::3] = -(2**31)  # zigzag(-2^31) = 2^32 - 1: width 32
    w33 = np.zeros(300, np.int64)
    w33[150] = 2**31  # zigzag(2^31) = 2^32: width 33, outside the envelope
    big = np.random.default_rng(15)  # the shapes past one batch and one chunk of the kernels
    low = big.integers(0, 1 << 31, 10_000, dtype=np.uint64)
    low[::2] |= np.uint64(1 << 30)  # each XOR delta sets bit 30: width 31
    low[1::2] &= np.uint64((1 << 30) - 1)
    return [
        ("dod jittered, 3 pages", "dod", ts, 4096, ()),
        ("dod width 32", "dod", w32, 128, ()),
        ("dod middle page width 33", "dod", w33, 128, ()),
        ("dod pages of 1 row", "dod", ts[:4097], 4096, ()),
        ("dod pages of 2 rows", "dod", ts[:4098], 4096, ()),
        ("dod pages of 3 rows", "dod", ts[:4099], 4096, ()),
        ("dod page_rows 10000", "dod", np.arange(25_000, dtype=np.int64) * 7 + (
            np.arange(25_000) % 3), 10_000, ()),
        ("dod wraps mod 2^64", "dod", np.asarray(
            [I64.max - 2, I64.max - 1, I64.max, I64.min, I64.min + 1, 0, 2**62, I64.min,
             2**62], np.int64), 4096, ()),
        ("dod i64 extremes", "dod", np.asarray(
            [I64.min, 0, I64.max, -1, 1, I64.min + 1], np.int64), 4096, ()),
        ("dod test_encoding wrap", "dod", np.asarray([2**62, -(2**62), 2**62 - 7, 5], np.int64),
         4096, ()),
        ("xor f64 NaN payloads, width 20", "xor", nan_low, 1000, ()),
        ("xor f64 normal (width > 32)", "xor", rng.normal(size=2000), 1000, ()),
        ("xor f64 +-0, +-inf", "xor", np.array([0.0, -0.0, np.inf, -np.inf, np.nan] * 40), 64,
         ()),
        ("xor f64 width 0", "xor", np.ones(5000), 4096, ()),
        ("xor f32 NaN, +-0, +-inf", "xor", f32, 4096, ()),
        ("dict i64 width 8", "dict", rng.integers(0, 250, 9000, dtype=np.int64) * 7919, 4096,
         (4096,)),
        ("dict u64 >= 2^63", "dict", np.uint64(2**63) + rng.integers(0, 5, 6000).astype(
            np.uint64) * np.uint64(2**61), 4096, (4096,)),
        ("dict i4", "dict", rng.integers(-3, 3, 5000).astype(np.int32), 4096, (4096,)),
        ("dict u4", "dict", rng.integers(2**31, 2**31 + 9, 5000).astype(np.uint32), 1000,
         (4096,)),
        ("dict width 0", "dict", np.full(5000, 2**64 - 1, np.uint64), 4096, (4096,)),
        ("dict width 1", "dict", rng.integers(0, 2, 5000).astype(np.int64), 4096, (4096,)),
        ("dict width 17", "dict", rng.permutation(1 << 17).astype(np.int64), 1 << 16,
         (1 << 17,)),
        ("rle u64 >= 2^63", "rle", np.repeat(np.uint64(2**64 - 1) - np.arange(80, dtype=np.uint64)
                                             * np.uint64(2**57), 111), 4096, ()),
        ("rle runs of 1", "rle", rng.integers(-9, 9, 3000).astype(np.int64), 1000, ()),
        ("rle one run across pages", "rle", np.concatenate(
            [np.zeros(10, np.int64), np.full(2500, 7, np.int64), np.ones(5, np.int64)]), 1000, ()),
        ("rle u4", "rle", np.repeat(np.arange(80, dtype=np.uint32) + np.uint32(2**31), 50), 512,
         ()),
        ("rle page_rows 10000, one run a page", "rle", np.repeat(
            np.array([2**64 - 1, 2**63], np.uint64), 10_000), 10_000, ()),
        ("rle page_rows 10000, runs of 1", "rle", np.uint64(2**63) + np.arange(
            10_000, dtype=np.uint64) * np.uint64(7), 10_000, ()),
        ("rle pages of 1 row", "rle", big.integers(-9, 9, 3).astype(np.int64), 1, ()),
        # positive floats across 2.0 also encode at width 31: one XLA kernel for both
        ("xor f32 page_rows 10000", "xor", np.abs(big.normal(3, 2, 10_000)).astype(np.float32),
         10_000, ()),
        ("xor f64 width 31, page_rows 10000", "xor",
         (np.uint64(0x4059_0000_0000_0000) ^ low).view(np.float64), 10_000, ()),
    ]


CASES = {c[0]: c[1:] for c in kernel_cases()}


def encode(pkg_enc, codec: str, arr: np.ndarray, page_rows: int, extra):
    lane = getattr(pkg_enc, f"_encode_{codec}")(arr, page_rows, *extra)
    lane.name = "x"
    return lane


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_match_jax_kernels(case):
    codec, arr, page_rows, extra = CASES[case]
    lane = encode(tenc, codec, arr, page_rows, extra)
    jlane = encode(jenc, codec, arr, page_rows, extra)
    assert lane.payload == jlane.payload and lane.dict_values == jlane.dict_values
    pages = lane.pages
    if codec == "dict" and len(pages) > 2:
        pages = [pages[0], pages[-1]]  # one XLA shape per page size
    for p in pages:
        payload = lane.payload[p.off:p.off + p.length]
        want = jdecode.decode_page_device(codec, lane.dtype, payload, p.rows, p.width, p.p0,
                                          p.p1, lane.dict_values)
        got = tdecode.decode_page_device(codec, lane.dtype, payload, p.rows, p.width, p.p0,
                                         p.p1, lane.dict_values, device="cpu")
        assert (got is None) == (want is None) == (p.width > tdecode.DEVICE_MAX_WIDTH)
        if want is not None:
            assert same_bits(got, want), f"{case}: page of {p.rows} rows"
    # the lane-level entry: every kept page in one launch, wide pages from the host
    tdecode.reset_page_counts()
    got = tenc.decode_lane(lane, impl="device", device="cpu")
    wide = sum(p.width > 32 for p in lane.pages)
    assert tdecode.page_counts() == {"x": {"device": len(lane.pages) - wide, "host": wide}}
    assert same_bits(got, arr) and same_bits(tenc.decode_lane(lane, impl="host"), arr)
    keep = list(range(0, len(lane.pages), 2))
    assert same_bits(tenc.decode_lane(lane, keep, impl="device", device="cpu"),
                     jenc.decode_lane(jlane, keep))


_U64 = np.uint64


def pair_scan_dod(payload: bytes, rows: int, width: int, first: int,
                  first_delta: int) -> np.ndarray:
    """decode_dod.cu's arithmetic in numpy u64: per 4,096-row chunk, each of
    256 threads sums its 16 rows' dd and k * dd, one exclusive scan of
    those pairs over the threads, the pair carried into the next chunk,
    and v[i] = first + i * first_delta + (i + 1) * S0[i] - S1[i]."""
    words = np.frombuffer(payload + bytes(8), "<u4").astype(_U64)
    dd = np.zeros(rows, _U64)
    if width and rows > 2:
        bit = np.arange(rows - 2, dtype=np.int64) * width
        pair = words[bit >> 5] | (words[(bit >> 5) + 1] << _U64(32))
        z = (pair >> (bit & 31).astype(_U64)) & _U64((1 << width) - 1)
        dd[2:] = (z >> _U64(1)) ^ (_U64(0) - (z & _U64(1)))
    out = np.empty(rows, _U64)
    c0, c1 = np.zeros(1, _U64), np.zeros(1, _U64)
    first, first_delta = _U64(first % 2**64), _U64(first_delta % 2**64)
    with np.errstate(over="ignore"):
        for base in range(0, rows, 4096):
            m = min(4096, rows - base)
            k = np.arange(base, base + 4096, dtype=_U64)
            d = np.zeros(4096, _U64)
            d[:m] = dd[base:base + m]
            kd = (k * d).reshape(256, 16)
            d = d.reshape(256, 16)
            a0, a1 = d.sum(1, dtype=_U64), kd.sum(1, dtype=_U64)
            e0 = np.cumsum(a0, dtype=_U64) - a0
            e1 = np.cumsum(a1, dtype=_U64) - a1
            s0 = (c0 + e0[:, None] + np.cumsum(d, 1, dtype=_U64)).ravel()
            s1 = (c1 + e1[:, None] + np.cumsum(kd, 1, dtype=_U64)).ravel()
            out[base:base + m] = (first + k * first_delta + (k + _U64(1)) * s0 - s1)[:m]
            c0 += a0.sum(dtype=_U64)
            c1 += a1.sum(dtype=_U64)
    return out.view(np.int64)


@pytest.mark.parametrize("case", ["dod wraps mod 2^64", "dod i64 extremes",
                                  "dod test_encoding wrap", "dod width 32",
                                  "dod page_rows 10000", "dod jittered, 3 pages"])
def test_pair_scan_closed_form_matches_the_jax_dod_kernel(case):
    """The one pair scan a page that decode_dod.cu runs, modelled in numpy
    u64 (its 16-row threads, 4,096-row chunks and carried pair), equals the
    JAX package's two scans bit for bit, wraps mod 2^64 included."""
    codec, arr, page_rows, extra = CASES[case]
    lane = encode(tenc, codec, arr, page_rows, extra)
    for p in (p for p in lane.pages if p.width <= tdecode.DEVICE_MAX_WIDTH):
        payload = lane.payload[p.off:p.off + p.length]
        want = jdecode.decode_page_device(codec, lane.dtype, payload, p.rows, p.width, p.p0,
                                          p.p1, lane.dict_values)
        got = pair_scan_dod(payload, p.rows, p.width, p.p0, p.p1)
        assert same_bits(got.astype(want.dtype), want), f"{case}: page of {p.rows} rows"


def test_plain_cumsum_and_shifts_wrap_mod_2_64():
    """The plain versions lean on int64 adds that wrap mod 2^64 and on a
    sign-extended high word: the pair (2^32 - 1, 2^32 - 1) reads back at
    every offset, and sums past int64 max wrap."""
    words = torch.tensor([-1, -1, 0], dtype=torch.int32)
    for off in range(32):
        got = tdecode._unpack_plain(words, torch.tensor([0]), torch.tensor([off]),
                                    torch.tensor([32]))
        assert int(got) == 2**32 - 1
    x = torch.tensor([I64.max, 1, 1], dtype=torch.int64)
    assert torch.cumsum(x, 0).tolist() == [I64.max, I64.min, I64.min + 1]


def test_stage_pages_refuses_rle_runs_that_miss_the_rows():
    """A page whose run lengths do not add up to its rows raises HoraeError
    from stage_pages, naming the first such page, before anything is
    uploaded; pages that add up stage."""
    lane = encode(tenc, "rle", np.repeat(np.arange(6, dtype=np.int64), 500), 1000, ())
    tdecode.stage_pages("rle", lane.dtype, lane.payload, lane.pages, None, "cpu")
    for rows, covered in ((999, 1000), (1001, 1000)):
        pages = [tenc.EncPage(**{**vars(p), "rows": rows}) if k == 1 else p
                 for k, p in enumerate(lane.pages)]
        with pytest.raises(tenc.HoraeError,
                           match=f"^rle page 1: runs cover {covered} rows, not {rows}$"):
            tdecode.stage_pages("rle", lane.dtype, lane.payload, pages, None, "cpu")


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    words = torch.zeros(2, dtype=torch.int32)
    table = torch.tensor([[0, 3, 0, 0, 5, 2]], dtype=torch.int64)
    before = _build.launch_counts()
    out = tdecode.decode_dod(words, table, 3, 8)
    assert out.tolist() == [5, 7, 9]
    assert _build.launch_counts() == before
    with pytest.raises(_build.KernelError, match="int32"):
        tdecode.decode_dod(words.long(), table, 3, 8)


# -- the format -----------------------------------------------------------------------

def sidecar_table(pkg_enc, n=6000):
    rng = np.random.default_rng(7)
    tsid = np.sort(rng.integers(0, 40, n, dtype=np.int64))
    return pa.table({
        "tsid": tsid,
        "big": np.repeat(np.uint64(2**63) + np.arange(n // 100, dtype=np.uint64), 100),
        "field": (np.arange(n) // 3 % 10).astype(np.uint64),
        "ts": 1_700_000_000_000 + np.arange(n, dtype=np.int64) * 10_000 + np.arange(n) % 3,
        "value": rng.normal(size=n),
        "gauge": np.ones(n, np.float32),
        "small": rng.integers(-5, 5, n).astype(np.int32),
        "nulls": pa.nulls(n, pa.uint64()),
        "partial": pa.array([None] + [1] * (n - 1), pa.int64()),
        "name": pa.array(["a"] * n),
    })


def test_encode_table_is_byte_identical_to_jax():
    table = sidecar_table(tenc)
    for kw in ({}, {"time_column": "ts"}, {"page_rows": 1000, "max_dict": 8},
               {"lanes": ["ts", "value"]}):
        mine = tenc.encode_table(table, **kw)
        ref = jenc.encode_table(table, **kw)
        assert mine.descriptor() == ref.descriptor()
        assert tenc.encode_blob(mine) == jenc.encode_blob(ref)
    codecs = dict(tenc.encode_table(table, time_column="ts").descriptor())
    assert codecs == {"tsid": "rle", "big": "rle", "field": "dict", "ts": "dod",
                      "value": "raw", "gauge": "xor", "small": "dict", "nulls": "null"}
    assert tenc.encode_table(pa.table({"s": pa.array(["x"])})) is None


def test_decode_blob_crosses_packages():
    table = sidecar_table(tenc)
    jblob = jenc.encode_blob(jenc.encode_table(table, page_rows=1000, time_column="ts"))
    tblob = tenc.encode_blob(tenc.encode_table(table, page_rows=1000, time_column="ts"))
    mine, theirs = tenc.decode_blob(jblob), jenc.decode_blob(tblob)
    assert tenc.encode_blob(mine) == jblob and jenc.encode_blob(theirs) == tblob
    for name, lane in mine.lanes.items():
        if lane.codec != "null":
            assert same_bits(tenc.decode_lane(lane, impl="device", device="cpu"),
                             jenc.decode_lane(theirs.lanes[name]))
    for bad in (jblob[:5], b"\0" * 9 + jblob[9:], jblob[:-8]):
        with pytest.raises(tenc.HoraeError):
            tenc.decode_blob(bad)


def _predicates(F):
    lo, hi = 1_700_000_000_000 + 3_000_000, 1_700_000_000_000 + 9_000_000
    return {
        "tsid eq": F.Compare("tsid", "eq", 7),
        "tsid ge": F.Compare("tsid", "ge", 30),
        "inset": F.InSet("tsid", (3, 9, 55)),
        "empty inset": F.InSet("tsid", ()),
        "ts range": F.And(F.Compare("ts", "ge", lo), F.Compare("ts", "lt", hi)),
        "value gt": F.Compare("value", "gt", 0.25),
        "composite": F.And(F.Or(F.Compare("tsid", "lt", 10), F.InSet("tsid", (40, 41))),
                           F.Not(F.Compare("value", "le", 0.0)),
                           F.Compare("ts", "ge", 1_700_000_000_000)),
        "dict lane": F.Compare("field", "eq", 3),
        "missing lane": F.Compare("absent", "eq", 1),
    }


@pytest.mark.parametrize("pred", sorted(_predicates(TF)))
def test_prune_pages_and_encoded_mask_match_jax(pred):
    rng = np.random.default_rng(14)
    n = 12_000
    table = pa.table({
        "tsid": np.sort(rng.integers(0, 60, n, dtype=np.int64)),
        "field": rng.integers(0, 5, n, dtype=np.int64) * 101,
        "ts": 1_700_000_000_000 + np.arange(n, dtype=np.int64) * 1000,
        "value": rng.normal(size=n),
    })
    mine = tenc.encode_table(table, time_column="ts")
    ref = jenc.encode_table(table, time_column="ts")
    keep, pruned = tenc.prune_pages(mine, _predicates(TF)[pred])
    assert (keep, pruned) == jenc.prune_pages(ref, _predicates(JF)[pred])
    stats, jstats = tenc.EncodedEvalStats(), jenc.EncodedEvalStats()
    got = tenc.encoded_mask(mine, _predicates(TF)[pred], keep, stats,
                            decode=lambda c: tenc.decode_lane(mine.lanes[c], keep,
                                                              impl="device", device="cpu"))
    want = jenc.encoded_mask(ref, _predicates(JF)[pred], keep, jstats)
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got, want)
    assert (stats.runs_skipped, stats.dict_rewrites) == (jstats.runs_skipped,
                                                         jstats.dict_rewrites)


# -- the slice end to end ---------------------------------------------------------------

SCHEMA = pa.schema([("metric_id", pa.uint64()), ("tsid", pa.uint64()),
                    ("field_id", pa.uint64()), ("ts", pa.int64()), ("value", pa.float64())])
WINDOW = (10 * 60_000, 2 * SEGMENT_MS - 7 * 60_000)
BUCKET_MS = 300_000
FIRST_ID = 2**63 + 12_345


def tree_batches(seed=3, series=40, per_series=90, interval=60_000):
    """Two segments of (metric, tsid, field, ts) -> value, each written in
    time order in two writes, plus a re-send; a few rows of another
    metric, NaN and -0.0 values."""
    rng = np.random.default_rng(seed)
    tsids = np.sort(rng.choice(np.unique(rng.integers(0, 2**64 - 1, 2 * series,
                                                      dtype=np.uint64, endpoint=True)),
                               series, replace=False))
    sid = np.tile(np.arange(series), per_series)
    ts = np.repeat(np.arange(per_series) * interval, series)
    vals = rng.normal(size=len(ts))
    vals[rng.choice(len(vals), 6, replace=False)] = [np.nan, -0.0, np.nan, -0.0, np.inf, 0.0]
    metric = np.where(rng.random(len(ts)) < 0.05, 2, 1).astype(np.uint64)
    seg = ts // SEGMENT_MS
    out = []
    for s in np.unique(seg):
        rows = np.flatnonzero(seg == s)
        resend = np.sort(rng.choice(rows, len(rows) // 10, replace=False))
        for part, v in ((rows[: len(rows) // 2], vals), (rows[len(rows) // 2:], vals),
                        (resend, rng.normal(size=len(vals)))):
            b = pa.RecordBatch.from_pydict({
                "metric_id": metric[part], "tsid": tsids[sid[part]],
                "field_id": (part % 3).astype(np.uint64), "ts": ts[part], "value": v[part]},
                schema=SCHEMA)
            out.append((int(s) * SEGMENT_MS, b))
    return tsids, out


def _pred(F):
    return F.And(F.Compare("metric_id", "eq", 1), F.Compare("field_id", "eq", 0),
                 F.Compare("ts", "ge", 30 * 60_000))


def _inset(F, tsids):
    return F.And(F.InSet("tsid", tuple(int(t) for t in tsids[::3])),
                 F.Compare("ts", "lt", SEGMENT_MS + 20 * 60_000))


async def _write(pkg, directory, batches):
    if pkg is tstorage:
        cfg = tstorage.StorageConfig(encoding=EncodingConfig(enabled=True, min_rows=1,
                                                             page_rows=256))
        kw = {"device": "cpu"}
    else:
        cfg = jstorage.StorageConfig(encoding=JEncodingConfig(enabled=True, min_rows=1,
                                                              page_rows=256))
        kw = {}
    eng = await pkg.ObjectBasedStorage.try_new(
        "db", (tobjstore if pkg is tstorage else jobjstore).LocalStore(directory), SCHEMA, 4,
        SEGMENT_MS, config=cfg, enable_compaction_scheduler=False,
        start_background_merger=False, time_column="ts", **kw)
    for start, b in batches:
        await eng.write(pkg.WriteRequest(b, pkg.TimeRange(start, start + SEGMENT_MS)))
    metas = sorted((s.id, s.meta.format_version, s.meta.encodings)
                   for s in eng.manifest.all_ssts())
    await eng.close()
    return metas


async def _collect(pkg, eng, pred=None):
    req = pkg.ScanRequest(range=pkg.TimeRange(0, 2 * SEGMENT_MS), predicate=pred)
    out = [b async for b in eng.scan(req)]
    return pa.Table.from_batches(out) if out else None


async def _jax_reads(directory, tsids):
    eng = await jstorage.ObjectBasedStorage.try_new(
        "db", jobjstore.LocalStore(directory), SCHEMA, 4, SEGMENT_MS,
        enable_compaction_scheduler=False, start_background_merger=False)
    out = [await _collect(jstorage, eng), await _collect(jstorage, eng, _pred(JF)),
           await _collect(jstorage, eng, _inset(JF, tsids))]
    num_buckets = -(-(WINDOW[1] - WINDOW[0]) // BUCKET_MS)
    acc = None
    for seg in eng.group_by_segment(eng.select_ssts(jstorage.TimeRange(*WINDOW))):
        part = await eng.parquet_reader.scan_segment_downsample(
            seg, predicate=_pred(JF), ts_column="ts", value_column="value",
            series_column="tsid", series_ids=tsids, t0=WINDOW[0], bucket_ms=BUCKET_MS,
            num_buckets=num_buckets, packed_ok=True)
        acc = part if acc is None else {
            "sum": acc["sum"] + part["sum"], "count": acc["count"] + part["count"],
            "min": np.minimum(acc["min"], part["min"]),
            "max": np.maximum(acc["max"], part["max"])}
    await eng.close()
    return out, acc


async def _port_reads(directory, tsids):
    eng = await tstorage.ObjectBasedStorage.try_new(
        "db", tobjstore.LocalStore(directory), SCHEMA, 4, SEGMENT_MS,
        enable_compaction_scheduler=False, start_background_merger=False, device="cpu")
    out = [await _collect(tstorage, eng), await _collect(tstorage, eng, _pred(TF)),
           await _collect(tstorage, eng, _inset(TF, tsids))]
    grids = await query_downsample(eng, tsids, tstorage.TimeRange(*WINDOW), BUCKET_MS,
                                   _pred(TF))
    reads = dict(eng.parquet_reader.sst_reads)
    await eng.close()
    return out, grids, reads


def _fixed_ids(monkeypatch):
    """Both packages allocate the same SST ids in the same order (the ids
    are the `__seq__` lane, so they are in the sidecar's bytes)."""
    monkeypatch.setattr(jstorage_mod, "allocate_id", itertools.count(FIRST_ID).__next__)
    monkeypatch.setattr(tstorage_mod, "allocate_id", itertools.count(FIRST_ID).__next__)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """An encoded tree written by each package from the same batches, and
    the JAX package's parquet reads of its own tree as the reference."""
    tsids, batches = tree_batches()
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax_enc", "port_enc"))
    with pytest.MonkeyPatch.context() as mp:
        _fixed_ids(mp)
        jmetas = asyncio.run(_write(jstorage, jdir, batches))
    with pytest.MonkeyPatch.context() as mp:
        _fixed_ids(mp)
        tmetas = asyncio.run(_write(tstorage, tdir, batches))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HORAEDB_DECODE_IMPL", "raw")
        mp.setenv("HORAEDB_AGG_IMPL", "scatter")
        scans, grids = asyncio.run(_jax_reads(jdir, tsids))
    return {"tsids": tsids, "jax": jdir, "port": tdir, "metas": (jmetas, tmetas),
            "scans": scans, "grids": grids}


def assert_same_tables(got, want):
    for g, w in zip(got, want, strict=True):
        assert g is not None and w is not None and g.num_rows > 0
        assert g.schema.names == w.schema.names and g.num_rows == w.num_rows
        for name in w.schema.names:
            a = g.column(name).to_numpy(zero_copy_only=False)
            b = w.column(name).to_numpy(zero_copy_only=False)
            assert same_bits(a, b), name


def test_same_writes_give_the_same_sidecars_and_manifest(trees):
    jmetas, tmetas = trees["metas"]
    assert jmetas == tmetas and all(fmt == 2 for _, fmt, _ in tmetas)
    codecs = dict(tmetas[0][2])
    assert codecs["ts"] == "dod" and codecs["__reserved__"] == "null"
    for sst_id, _fmt, _enc in tmetas:
        path = f"db/data/{sst_id}.enc"
        mine = asyncio.run(tobjstore.LocalStore(trees["port"]).get(path))
        assert mine == asyncio.run(jobjstore.LocalStore(trees["jax"]).get(path))


@pytest.mark.parametrize("impl", ["host", "device", "raw"])
def test_port_reads_the_jax_encoded_tree(trees, impl, monkeypatch):
    monkeypatch.setenv("HORAEDB_DECODE_IMPL", impl)
    tdecode.reset_page_counts()
    scans, grids, reads = asyncio.run(_port_reads(trees["jax"], trees["tsids"]))
    assert_same_tables(scans, trees["scans"])
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(grids[k], trees["grids"][k])
    np.testing.assert_allclose(grids["sum"], trees["grids"]["sum"], rtol=1e-12, atol=0)
    if impl == "raw":
        assert reads["encoded"] == 0 and tdecode.page_counts() == {}
    else:
        assert reads["parquet"] == 0 and reads["encoded"] > 0
        ts = tdecode.page_counts()["ts"]
        assert ts["device" if impl == "device" else "host"] > 0
        assert ts["host" if impl == "device" else "device"] == 0


@pytest.mark.parametrize("impl", ["host", "device", "raw"])
def test_jax_reads_the_port_encoded_tree(trees, impl, monkeypatch):
    monkeypatch.setenv("HORAEDB_DECODE_IMPL", impl)
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "scatter")
    scans, grids = asyncio.run(_jax_reads(trees["port"], trees["tsids"]))
    assert_same_tables(scans, trees["scans"])
    for k in ("sum", "count", "min", "max"):
        np.testing.assert_array_equal(grids[k], trees["grids"][k])


async def _mem_table(config_kw=None, **kw):
    store = tobjstore.MemStore()
    cfg = tstorage.StorageConfig(encoding=EncodingConfig(**{"enabled": True, "min_rows": 1,
                                                            **(config_kw or {})}))
    eng = await tstorage.ObjectBasedStorage.try_new(
        "db", store, SCHEMA, 4, SEGMENT_MS, config=cfg, enable_compaction_scheduler=False,
        start_background_merger=False, device="cpu", time_column="ts", **kw)
    _tsids, batches = tree_batches(seed=9, series=12, per_series=60)
    for start, b in batches:
        await eng.write(tstorage.WriteRequest(b, tstorage.TimeRange(start, start + SEGMENT_MS)))
    return store, eng


def test_corrupt_sidecar_falls_back_to_parquet(monkeypatch):
    async def run():
        store, eng = await _mem_table()
        monkeypatch.setenv("HORAEDB_DECODE_IMPL", "raw")
        want = await _collect(tstorage, eng, _pred(TF))
        monkeypatch.setenv("HORAEDB_DECODE_IMPL", "device")
        ssts = eng.manifest.all_ssts()
        good = await store.get(f"db/data/{ssts[0].id}.enc")
        await store.put(f"db/data/{ssts[0].id}.enc", good[:-16])  # truncated payload
        await store.delete(f"db/data/{ssts[1].id}.enc")  # v2 without its sidecar
        # a page whose width needs more bytes than it holds: decode_blob
        # accepts it, the page check in the decode layer does not
        enc = tenc.decode_blob(await store.get(f"db/data/{ssts[2].id}.enc"))
        enc.lanes["ts"].pages[0].width = 32
        await store.put(f"db/data/{ssts[2].id}.enc", tenc.encode_blob(enc))
        got = await _collect(tstorage, eng, _pred(TF))
        reads = dict(eng.parquet_reader.sst_reads)
        await eng.close()
        return got, want, reads, len(ssts)

    got, want, reads, n = asyncio.run(run())
    assert_same_tables([got], [want])
    assert reads["parquet"] >= 3 and reads["encoded"] == n - 3


@pytest.mark.parametrize("where", ["decode_dod", "decode_rle", "decode_unpack", "build"])
def test_kernel_errors_propagate_out_of_the_read(where, monkeypatch):
    async def run():
        _store, eng = await _mem_table()
        try:
            monkeypatch.setenv("HORAEDB_DECODE_IMPL", "device")

            def fail(*_a, **_k):
                raise _build.KernelError(f"{where}: CUDA launch failed with cudaError 700")

            if where == "build":
                monkeypatch.setattr(tdecode, "stage_pages", fail)
            else:
                monkeypatch.setattr(tdecode, where, fail)
            await _collect(tstorage, eng, _pred(TF))
        finally:
            await eng.close()

    with pytest.raises(_build.KernelError, match="cudaError 700"):
        asyncio.run(run())


def test_small_writes_and_time_column(monkeypatch):
    async def run():
        with pytest.raises(tstorage_mod.HoraeError, match="time_column"):
            await tstorage.ObjectBasedStorage.try_new(
                "db", tobjstore.MemStore(), SCHEMA, 4, SEGMENT_MS,
                enable_compaction_scheduler=False, start_background_merger=False,
                device="cpu", time_column="when")
        store, eng = await _mem_table({"min_rows": 10_000})
        fmts = {s.meta.format_version for s in eng.manifest.all_ssts()}
        objs = [m.path for m in await store.list("db/data")]
        await eng.close()
        return fmts, objs

    fmts, objs = asyncio.run(run())
    assert fmts == {1} and not any(p.endswith(".enc") for p in objs)


def test_failed_sidecar_put_reclaims_the_sst(monkeypatch):
    async def run():
        store = tobjstore.MemStore()
        eng = await tstorage.ObjectBasedStorage.try_new(
            "db", store, SCHEMA, 4, SEGMENT_MS,
            config=tstorage.StorageConfig(encoding=EncodingConfig(enabled=True, min_rows=1)),
            enable_compaction_scheduler=False, start_background_merger=False, device="cpu")
        put = store.put

        async def flaky(path, data):
            if path.endswith(".enc"):
                raise OSError("store down")
            return await put(path, data)

        monkeypatch.setattr(store, "put", flaky)
        _tsids, batches = tree_batches(seed=9, series=4, per_series=10)
        with pytest.raises(OSError, match="store down"):
            await eng.write(tstorage.WriteRequest(batches[0][1], tstorage.TimeRange(
                0, SEGMENT_MS)))
        left = [m.path for m in await store.list("db/data")]
        pending = dict(eng._pending_enc)
        await eng.close()
        return left, pending

    left, pending = asyncio.run(run())
    assert left == [] and pending == {}


# -- the dispatcher ------------------------------------------------------------------------

def test_env_pins_and_small_lanes(monkeypatch):
    monkeypatch.setenv("HORAEDB_DECODE_IMPL", "device")
    assert tdecode.choose("dod", 10, CPU) == "device" == tdecode.last_choice()
    assert tdecode.choose("raw", 10**6, CPU) == "host"
    monkeypatch.setenv("HORAEDB_DECODE_IMPL", "sideways")
    assert tdecode.scan_mode() == "auto"
    assert tdecode.choose("rle", 100, CPU) == "host"


def test_calibration_cold_then_warm(tmp_path, monkeypatch):
    monkeypatch.setenv("HORAEDB_DECODE_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("HORAEDB_DECODE_CALIB_N", "5000")
    monkeypatch.delenv("HORAEDB_DECODE_IMPL", raising=False)
    tdecode.reset_cache(memory_only=True)
    try:
        entry, src = tdecode.calibration_entry("dod", CPU)
        assert src == "calibrated" and entry["impl"] in ("host", "device")
        assert set(entry["ab"]) == {"host", "device"}
        tdecode.reset_cache(memory_only=True)
        assert tdecode.calibration_entry("dod", CPU) == (entry, "cache")
        assert tdecode.choose("dod", 10_000, CPU) == entry["impl"]
    finally:
        tdecode.reset_cache(memory_only=True)


def test_calibration_never_hides_a_failing_device(tmp_path, monkeypatch):
    monkeypatch.setenv("HORAEDB_DECODE_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("HORAEDB_DECODE_CALIB_N", "5000")
    tdecode.reset_cache(memory_only=True)

    def fail(*_a, **_k):
        raise _build.KernelError("decode_rle: CUDA launch failed with cudaError 98")

    monkeypatch.setattr(tdecode, "decode_rle", fail)
    try:
        with pytest.raises(_build.KernelError, match="cudaError 98"):
            tdecode.calibration_entry("rle", CPU)
        assert not (tmp_path / "calib.json").exists()
    finally:
        tdecode.reset_cache(memory_only=True)
