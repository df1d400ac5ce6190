"""Port ops vs the JAX package on the same seeded inputs (CPU).

The port's kernel wrappers run their plain PyTorch versions here (the
tensors lie on the CPU); the JAX side runs as its own tests run it, with
the aggregation dispatcher pinned to `scatter` so no calibration chooses.
Tolerances: permutations, counts and min/max exact (NaN == NaN); f64 sums
rtol=1e-12, as tests/test_agg_registry.py holds f64 sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horaedb_tpu.ops import aggregate as jagg
from horaedb_tpu.ops import blockagg as jblock
from horaedb_tpu.ops import sort as jsort
from horaedb_tpu_torch.backend import device_lane, i64_to_u64, order_key, u64_to_i64
from horaedb_tpu_torch.ops import aggregate as tagg
from horaedb_tpu_torch.ops import blockagg as tblock
from horaedb_tpu_torch.ops import sort as tsort
from horaedb_tpu_torch.ops.blocks import PACK_SENTINEL, sort_sentinel

SUM_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _pin_scatter(monkeypatch):
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "scatter")


def assert_same(a, b):
    """Exact by value, NaN == NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def assert_sums(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=SUM_RTOL, atol=0,
                               equal_nan=True)


# -- backend: the u64 <-> i64 order map ---------------------------------------

def test_u64_map_preserves_order_and_round_trips():
    rng = np.random.default_rng(0)
    u = np.concatenate([
        rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64, endpoint=True),
        np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1], dtype=np.uint64),
        np.array([PACK_SENTINEL, sort_sentinel(np.uint64)], dtype=np.uint64),
    ])
    m = u64_to_i64(u)
    assert m.dtype == np.int64
    np.testing.assert_array_equal(np.argsort(m, kind="stable"), np.argsort(u, kind="stable"))
    np.testing.assert_array_equal(i64_to_u64(m), u)
    # through torch, where uint64 has no ordering ops on the CPU
    order = torch.sort(torch.from_numpy(m), stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.argsort(u, kind="stable"))


def test_order_key_keeps_negative_i64():
    ts = np.array([-(2**63), -5, -1, 0, 3, 2**63 - 1], dtype=np.int64)
    np.testing.assert_array_equal(order_key(ts), ts)
    np.testing.assert_array_equal(order_key(ts.astype(np.int32)[1:5]), ts[1:5])


# -- kernel A: sort_perm -------------------------------------------------------

def _sort_cases():
    rng = np.random.default_rng(1)
    big = rng.integers(2**63, 2**64 - 1, 3000, dtype=np.uint64, endpoint=True)
    edges = np.array([2**64 - 1, 0, 2**64 - 1], dtype=np.uint64)
    n = 2048 * 2 + 17
    i64 = np.iinfo(np.int64)
    return {
        "u64_ge_2p63": [np.concatenate([big, edges])],
        "negative_i64": [rng.integers(-(2**62), 2**40, 3001).astype(np.int64)],
        "full_i64_span": [np.array([i64.min, 5, -5, i64.max, 0] * 300, dtype=np.int64)],
        "duplicates_stable": [rng.integers(0, 3, 4000).astype(np.uint64),
                              rng.integers(0, 2, 4000).astype(np.int64)],
        "constant_keys": [np.full(2100, 7, np.uint64), np.full(2100, -3, np.int64)],
        "one_row": [np.array([2**64 - 1], np.uint64)],
        "data_pk_tail_tile": [np.full(n, 1, np.uint64),
                              rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
                              np.zeros(n, np.uint64),
                              rng.integers(-(2**40), 2**40, n).astype(np.int64)],
    }


@pytest.mark.parametrize("case", sorted(_sort_cases()))
def test_sort_permutation_matches_jax(case):
    keys = _sort_cases()[case]
    got = tsort.sort_permutation(keys, device="cpu")
    assert got.dtype == torch.int32
    want = np.asarray(jsort.sort_permutation([jnp.asarray(k) for k in keys]))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.lexsort(tuple(reversed(keys))))


def test_sort_num_digits_skips_constant_bytes():
    assert tsort.num_digits(5, 5) == 0
    assert tsort.num_digits(0, 255) == 1
    assert tsort.num_digits(0, 256) == 2
    # a 2 h segment of ms timestamps spans 23 bits: three passes
    assert tsort.num_digits(1_700_000_000_000, 1_700_000_000_000 + 7_200_000 - 1) == 3
    assert tsort.num_digits(-(2**63), 2**63 - 1) == 8


def test_sort_permutation_passes_only_varying_keys(monkeypatch):
    """Constant keys (metric_id, field_id in the data schema) never reach
    the device sort; the permutation is unchanged."""
    rng = np.random.default_rng(3)
    n = 500
    keys = [np.full(n, 1, np.uint64), rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
            np.zeros(n, np.uint64), rng.integers(0, 50, n).astype(np.int64)]
    seen = []
    inner = tsort.sort_perm
    monkeypatch.setattr(tsort, "sort_perm", lambda k, b: seen.append(len(k)) or inner(k, b))
    got = tsort.sort_permutation(keys, device="cpu")
    assert seen == [2]
    np.testing.assert_array_equal(got.numpy(), np.lexsort(tuple(reversed(keys))))


# -- kernels B and C: sorted-segment reductions --------------------------------

def _segment_cases():
    """name -> (k int32 sorted, v f64, valid bool, num_cells)."""
    rng = np.random.default_rng(2)
    lens = np.concatenate([rng.integers(1, 40, 120), [2048, 5000, 1, 2047, 4097]])
    k = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    n = len(k)
    v = rng.normal(size=n) * 100
    valid = rng.random(n) > 0.1
    specials = rng.choice(n, 30, replace=False)
    v[specials] = np.resize([np.nan, np.inf, -np.inf, 0.0, -0.0], 30)
    cells = int(k.max()) + 1
    return {
        "runs_across_tiles_nan_inf_masked": (k, v, valid, cells),
        "ids_ge_num_cells_dropped": (k, v, valid, cells - 9),
        "one_cell": (np.zeros(5000, np.int32), rng.normal(size=5000), np.ones(5000, bool), 1),
        "all_cells_empty": (np.zeros(0, np.int32), np.zeros(0), np.zeros(0, bool), 64),
        "all_rows_masked": (k, v, np.zeros(n, bool), cells),
        "nan_only_cell": (np.array([0, 0, 1, 1], np.int32),
                          np.array([np.nan, 1.0, -0.0, 0.0]), np.ones(4, bool), 3),
    }


@pytest.mark.parametrize("case", sorted(_segment_cases()))
def test_sum_count_matches_jax(case):
    k, v, valid, cells = _segment_cases()[case]
    w = valid.astype(np.float64)
    vm = np.where(valid, v, 0.0)
    s, c = tblock.sorted_segment_sum_count(torch.from_numpy(k), torch.from_numpy(vm), cells,
                                           weights=torch.from_numpy(w))
    js, jc = jblock.sorted_segment_sum_count(jnp.asarray(k), jnp.asarray(vm), cells,
                                             weights=jnp.asarray(w))
    assert_same(c.numpy(), jc)
    assert_sums(s.numpy(), js)


@pytest.mark.parametrize("case", sorted(_segment_cases()))
def test_min_max_matches_jax(case):
    k, v, valid, cells = _segment_cases()[case]
    mn, mx = tblock.sorted_segment_min_max(torch.from_numpy(k), torch.from_numpy(v), cells,
                                           valid=torch.from_numpy(valid))
    jmn, jmx = jblock.sorted_segment_min_max(jnp.asarray(k), jnp.asarray(v), cells,
                                             valid=jnp.asarray(valid))
    assert_same(mn.numpy(), jmn)
    assert_same(mx.numpy(), jmx)


def test_negative_ids_drop():
    """The port drops ids < 0 as it drops ids >= num_cells (the JAX
    scatter clips them into cell 0; the downsample never makes one)."""
    k = torch.tensor([-2, -1, 0, 0, 2, 3], dtype=torch.int32)
    v = torch.tensor([5.0, 6.0, 1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    s, c = tblock.sorted_segment_sum_count(k, v, 3)
    np.testing.assert_array_equal(s.numpy(), [3.0, 0.0, 3.0])
    np.testing.assert_array_equal(c.numpy(), [2.0, 0.0, 1.0])
    mn, mx = tblock.sorted_segment_min_max(k, v, 3)
    np.testing.assert_array_equal(mn.numpy(), [1.0, np.inf, 3.0])
    np.testing.assert_array_equal(mx.numpy(), [2.0, -np.inf, 3.0])


@pytest.mark.parametrize("bad", ["k_int64", "v_float32", "ragged", "w_float32", "strided"])
def test_wrapper_rejects_bad_lanes(bad):
    k = torch.zeros(8, dtype=torch.int32)
    v = torch.zeros(8, dtype=torch.float64)
    w = torch.ones(8, dtype=torch.float64)
    if bad == "k_int64":
        k = k.long()
    elif bad == "v_float32":
        v = v.float()
    elif bad == "ragged":
        v = v[:7]
    elif bad == "w_float32":
        w = w.float()
    else:
        v = torch.zeros(16, dtype=torch.float64)[::2]
    # kernel B's wrapper; the dispatcher in front of it also takes f32
    # values and weights (the f32 lanes), and casts them for kernel B
    with pytest.raises(Exception, match="block_sum_count"):
        tblock.block_sum_count(k, v, 4, weights=w)


# -- downsample_sorted ---------------------------------------------------------

def _downsample_inputs(seed: int):
    """Rows sorted by (sid, ts), some with ts before t0 (floor bucket -1),
    after the window, sids out of range, masked rows, NaN values."""
    rng = np.random.default_rng(seed)
    t0, bucket_ms, num_series, num_buckets = 1_000_000, 60_000, 12, 9
    rows = []
    for sid in range(-1, num_series + 2):
        ts = np.sort(rng.integers(t0 - 3 * bucket_ms, t0 + (num_buckets + 2) * bucket_ms, 80))
        ts[:2] = [t0 - 1, t0]  # the floor vs truncation boundary
        rows.append((np.full(len(ts), sid), np.sort(ts)))
    sid = np.concatenate([r[0] for r in rows]).astype(np.int32)
    ts = np.concatenate([r[1] for r in rows]).astype(np.int64)
    v = rng.normal(size=len(ts)) * 10
    v[rng.choice(len(v), 4, replace=False)] = np.nan
    valid = rng.random(len(v)) > 0.2
    return ts, sid, v, valid, t0, bucket_ms, num_series, num_buckets


@pytest.mark.parametrize("seed,masked", [(3, False), (3, True), (4, True)])
def test_downsample_sorted_matches_jax(seed, masked):
    ts, sid, v, valid, t0, bucket_ms, num_series, num_buckets = _downsample_inputs(seed)
    kw = dict(num_series=num_series, num_buckets=num_buckets, valid=valid if masked else None)
    got = tagg.downsample_sorted(ts, sid, v, t0, bucket_ms, device="cpu", **kw)
    want = jagg.downsample_sorted(jnp.asarray(ts), jnp.asarray(sid), jnp.asarray(v), t0,
                                  bucket_ms, **kw)
    assert set(got) == set(want)
    assert_same(got["count"].numpy(), want["count"])
    assert_same(got["min"].numpy(), want["min"])
    assert_same(got["max"].numpy(), want["max"])
    assert_sums(got["sum"].numpy(), want["sum"])
    assert_sums(got["mean"].numpy(), want["mean"])


def test_bucket_of_floors_before_t0():
    ts = torch.tensor([999, 1000, 1059, 1060, -1], dtype=torch.int64)
    np.testing.assert_array_equal(tagg.bucket_of(ts, 1000, 60).numpy(), [-1, 0, 0, 1, -17])
    np.testing.assert_array_equal(tagg.bucket_of(ts, 1000, 60).numpy(),
                                  np.asarray(jagg.bucket_of(jnp.asarray(ts.numpy()), 1000, 60)))


# -- kernels D, E and F: the merges of a segment scan ---------------------------

from horaedb_tpu.ops import filter as jfilter  # noqa: E402
from horaedb_tpu.ops.blocks import Block  # noqa: E402
from horaedb_tpu.storage import read as jread  # noqa: E402
from horaedb_tpu_torch.common.error import HoraeError  # noqa: E402
from horaedb_tpu_torch.ops import filter as tfilter  # noqa: E402
from horaedb_tpu_torch.ops import keychain as tkeychain  # noqa: E402
from horaedb_tpu_torch.ops import merge as tmerge  # noqa: E402
from horaedb_tpu_torch.storage import read as tread  # noqa: E402

MERGE_N = 3000  # every JAX merge kernel pads to one 8192-row shape
SORT_KEYS = ("pk1", "pk2", "__seq__")


def _merge_rows(case: str):
    """Sort-key lanes and a mask: pk1 int64 with few values (runs), pk2 u64
    >= 2^63, three ns-clock write sequences."""
    rng = np.random.default_rng(12)
    n = {"no_rows": 0, "one_row": 1}.get(case, MERGE_N)
    cols = {
        "pk1": rng.integers(-20, 40, n).astype(np.int64),
        "pk2": rng.integers(2**63, 2**63 + 3, n, dtype=np.uint64),
        "__seq__": rng.choice(np.array([1_700_000_000_000_000_001, 1_700_000_000_000_000_007,
                                        1_700_000_000_000_900_000], np.uint64), n),
    }
    if case == "one_group":
        cols["pk1"][:] = 5
        cols["pk2"][:] = 2**64 - 1
    mask = rng.random(n) < 0.8
    if case == "all_rejected":
        mask[:] = False
    if case == "presorted":
        order = np.lexsort((cols["__seq__"], cols["pk2"], cols["pk1"]))
        cols = {k: v[order] for k, v in cols.items()}
    return cols, mask


MERGE_CASES = ["mixed", "presorted", "one_group", "all_rejected", "one_row", "no_rows"]


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_packed_merge_matches_jax(case, dedup):
    cols, mask = _merge_rows(case)
    n = len(mask)
    packres = tread._pack_sort_keys(cols.__getitem__, SORT_KEYS, n)
    if packres is None:  # no rows: every row of the padded block is rejected
        packed, seq_width, key_bits = np.zeros(0, np.uint64), 2, 8
    else:
        packed, seq_width, key_bits = packres
        jpacked, jwidth = jread._pack_sort_keys(cols.__getitem__, SORT_KEYS, n)
        np.testing.assert_array_equal(packed, jpacked)
        assert seq_width == jwidth
    packed = np.where(mask, packed, PACK_SENTINEL)
    block = Block.from_numpy({"p": packed}, pad_keys=("p",))
    jout, jk = jread._build_packed_index_kernel(seq_width, dedup)(block.columns["p"],
                                                                  int(mask.sum()))
    out, k = tmerge.packed_merge(torch.from_numpy(order_key(packed)), key_bits, seq_width, dedup)
    assert int(k) == int(jk)
    np.testing.assert_array_equal(out[: int(k)].numpy(), np.asarray(jout)[: int(jk)])


def _jax_index(cols, mask, template, literals, dedup, presorted):
    arrays = dict(cols)
    if template is None:
        arrays["__mask__"] = mask.astype(np.uint8)
    block = Block.from_numpy(arrays, pad_keys=SORT_KEYS)
    names = tuple(block.names)
    kernel = jread._build_index_kernel(names, SORT_KEYS, SORT_KEYS[:2], template,
                                       template is None, dedup, presorted)
    if template is None:
        lanes = {k: v for k, v in block.columns.items() if k != "__mask__"}
        out, k = kernel(lanes, block.columns["__mask__"], block.num_valid)
    else:
        out, k = kernel(block.columns, literals, block.num_valid)
    return np.asarray(out)[: int(k)], int(k)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_index_merge_mask_matches_jax(case, dedup):
    cols, mask = _merge_rows(case)
    presorted = case == "presorted"
    want, wk = _jax_index(cols, mask, None, (), dedup, presorted)
    keys, bounds, num_pk, _ = tread.sort_key_lanes(cols.__getitem__, SORT_KEYS,
                                                   torch.device("cpu"))
    out, k = tmerge.index_merge_mask(keys, bounds, num_pk, torch.from_numpy(mask), dedup,
                                     presorted)
    assert int(k) == wk
    np.testing.assert_array_equal(out[: int(k)].numpy(), want)


def _filter_preds(F):
    big = tuple(int(v) for v in np.arange(2**63, 2**63 + 600, 3, dtype=np.uint64))
    return {
        "eq_u64": F.Compare("pk2", "eq", 2**63 + 1),
        "range_and_inset": F.And(F.Compare("pk1", "ge", -3), F.Compare("pk1", "lt", 30),
                                 F.InSet("pk2", (2**63, 2**63 + 2))),
        "not_or": F.Not(F.Or(F.Compare("pk1", "gt", 10), F.InSet("pk1", (-20, -19, 0)))),
        "big_inset": F.InSet("pk2", big),
    }


@pytest.mark.parametrize("pred", sorted(_filter_preds(tfilter)))
def test_index_merge_filter_matches_jax(pred):
    cols, _mask = _merge_rows("mixed")
    template, raw = jfilter.split_literals(_filter_preds(jfilter)[pred])
    literals = jfilter.literal_arrays(template, raw, {k: v.dtype for k, v in cols.items()})
    want, wk = _jax_index(cols, None, template, literals, True, False)
    keys, bounds, num_pk, key_names = tread.sort_key_lanes(cols.__getitem__, SORT_KEYS,
                                                           torch.device("cpu"))
    p = _filter_preds(tfilter)[pred]
    names = sorted(tfilter.pred_columns(p))
    program = tfilter.compile_program(p, {c: cols[c].dtype for c in names})
    # as the planner does: the pk columns are read from their key lanes
    by_name = dict(zip(key_names, keys))
    lanes = tread.predicate_lanes({c: cols[c] for c in names}, by_name, torch.device("cpu"))
    assert all(lanes[c] is by_name[c] for c in names)
    out, k = tmerge.index_merge_filter(keys, bounds, num_pk, program, lanes, MERGE_N, True,
                                       False, "cpu")
    assert int(k) == wk and wk > 0
    np.testing.assert_array_equal(out[: int(k)].numpy(), want)


def _packed_lane_order(keys, bounds, mask) -> np.ndarray:
    """The kept rows in the order kernel F's sort gives them: pack_lanes'
    keys built here with numpy's u64 arithmetic, one stable sort per key,
    the least significant first."""
    rows = np.flatnonzero(mask)
    for lanes, shifts, digits in reversed(tkeychain.pack_lanes(bounds)):
        key = np.zeros(len(rows), np.uint64)
        for i, shift in zip(lanes, shifts):
            part = keys[i].numpy()[rows].view(np.uint64) - np.uint64(bounds[i][0] % 2**64)
            assert int(part.max(initial=0)).bit_length() + shift <= 8 * digits
            key |= part << np.uint64(shift)
        rows = rows[np.argsort(key, kind="stable")]
    return rows


def _wide_rows():
    """Lanes whose spans pack two to a key: pk1 40 bits, pk2 30, and a
    seq of 3,000 distinct values (a 12-bit rank)."""
    rng = np.random.default_rng(13)
    cols = {"pk1": rng.integers(-(2**39), 2**39, MERGE_N).astype(np.int64),
            "pk2": rng.integers(2**63, 2**63 + 2**30, MERGE_N, dtype=np.uint64),
            "__seq__": rng.permutation(MERGE_N).astype(np.uint64) + np.uint64(10**18)}
    cols["pk1"][: MERGE_N // 2] = cols["pk1"][MERGE_N // 2:]  # ties on pk1
    return cols, rng.random(MERGE_N) < 0.8


@pytest.mark.parametrize("case", ["mixed", "one_group", "all_rejected", "one_row", "wide"])
def test_pack_lanes_order_matches_jax(case):
    """Sorting by pack_lanes' keys gives the JAX kernel's order of the kept
    rows (no dedup: the whole permutation)."""
    cols, mask = _wide_rows() if case == "wide" else _merge_rows(case)
    want, wk = _jax_index(cols, mask, None, (), False, False)
    keys, bounds, _, _ = tread.sort_key_lanes(cols.__getitem__, SORT_KEYS, torch.device("cpu"))
    if case == "wide":
        assert [d for _, _, d in tkeychain.pack_lanes(bounds)] == [5, 6]
    np.testing.assert_array_equal(_packed_lane_order(keys, bounds, mask), want)
    assert len(want) == wk


def test_pack_lanes_layouts():
    """The main scan shape's lanes (a 64-bit tsid hash, 2 h of ms, 25
    write sequences) pack into a key of 8 digits and one of 4; spans of 64
    bits fill a key; constant lanes go nowhere."""
    u64 = 2**64 - 1
    assert tkeychain.pack_lanes([(-(2**63), 2**63 - 1), (0, 7_199_999), (0, 24)]) == [
        ((0,), (0,), 8), ((1, 2), (5, 0), 4)]
    assert tkeychain.pack_lanes([(0, 2**40), (5, 5), (0, 2**20)]) == [((0, 2), (21, 0), 8)]
    assert tkeychain.pack_lanes([(0, 1), (0, 2**63 - 1)]) == [((0, 1), (63, 0), 8)]
    assert tkeychain.pack_lanes([(0, u64), (0, u64)]) == [((0,), (0,), 8), ((1,), (0,), 8)]
    assert tkeychain.pack_lanes([(3, 3)]) == []
    assert tkeychain.pack_lanes([]) == []


def _packed_sort_cases():
    """Key lanes (most significant first) of 4,099 rows, u64 edges among them."""
    rng = np.random.default_rng(41)
    n = 4099
    edges = np.array([0, 2**63, 2**64 - 1], np.uint64)
    u64 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    u64[:3] = edges
    ts = 1_700_000_000_000 + rng.integers(0, 7_200_000, n).astype(np.int64)
    return {
        # the write batch: tsid (8 digits) and ts (23 bits, 3 digits), two keys
        "tsid_ts": [np.full(n, 1, np.uint64), rng.choice(u64, n), np.zeros(n, np.uint64), ts],
        "u64_edges_only": [rng.choice(edges, n), rng.integers(0, 3, n).astype(np.int64)],
        # three narrow lanes in one key, ties everywhere
        "one_packed_key": [rng.integers(0, 5, n).astype(np.uint64),
                           rng.integers(-3, 3, n).astype(np.int64),
                           rng.integers(0, 2**40, n).astype(np.int64)],
        # full spans: one key per lane, three keys
        "full_spans": [rng.permutation(u64), u64,
                       np.array([-(2**63), 2**63 - 1] * (n // 2) + [0], np.int64)],
        "one_key": [u64],
    }


@pytest.mark.parametrize("case", sorted(_packed_sort_cases()))
def test_packed_keys_order_matches_jax_sort_perm(case):
    """Sorting by the packed keys kernel A now sorts by (pack_lanes over
    the mapped keys, one stable sort per key, the least significant first)
    gives the JAX package's _sort_perm permutation."""
    keys = _packed_sort_cases()[case]
    mapped = [torch.from_numpy(order_key(k)) for k in keys]
    bounds = [(int(m.min()), int(m.max())) for m in mapped]
    got = _packed_lane_order(mapped, bounds, np.ones(len(keys[0]), bool))
    want = np.asarray(jsort._sort_perm(tuple(jnp.asarray(k) for k in keys), len(keys)))
    np.testing.assert_array_equal(got, want)


def test_index_merge_hands_the_packed_layout_to_the_kernel(monkeypatch):
    """On a card, kernel F gets pack_lanes' layout flattened: the lanes and
    shifts of each key, the keys' starts and digits, and a scratch sized
    by the most digits (a fake entry point records the call; the tensors
    stay on the CPU)."""
    seen = {}

    def kernel(name, fn_name, argtypes, restype=None):
        def scratch_bytes(n, digits):
            seen["scratch"] = (n, digits)
            return 64
        return scratch_bytes if fn_name == "index_merge_scratch_bytes" else "launch"

    def launch(name, fn, dev, *args):
        seen["launch"] = (name, fn, args)

    monkeypatch.setattr(tmerge._build, "kernel", kernel)
    monkeypatch.setattr(tmerge._build, "launch", launch)
    n = 5
    keys = [torch.zeros(n, dtype=torch.int64) for _ in range(3)]
    bounds = [(-(2**63), 2**63 - 1), (0, 7_199_999), (0, 24)]
    tmerge._launch_index("index_merge_mask", keys, bounds, 2, torch.ones(n, dtype=torch.uint8),
                         True, False)
    name, fn, args = seen["launch"]
    assert (name, fn, seen["scratch"]) == ("index_merge_mask", "launch", (n, 8))
    assert list(args[1]) == [lo for lo, _ in bounds] and args[2:4] == (3, 2)
    assert [list(a) for a in args[4:8]] == [[0, 1, 2], [0, 5, 0], [0, 1, 3], [8, 4]]
    assert (args[8], args[9], args[11], args[12]) == (2, n, 0, 1)  # keys, rows, presorted, dedup


def _pred_lanes():
    rng = np.random.default_rng(21)
    n = 1000
    f64 = rng.normal(size=n)
    f64[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan, 1.5, -1.5]
    return {
        "u64": np.concatenate([rng.integers(2**63 - 50, 2**63 + 50, n - 2, dtype=np.uint64),
                               np.array([0, 2**64 - 1], np.uint64)]),
        "i64": rng.integers(-(2**62), 2**62, n).astype(np.int64),
        "i32": rng.integers(-100, 100, n).astype(np.int32),
        "u8": rng.integers(0, 4, n).astype(np.uint8),
        "f64": f64,
        "f32": f64.astype(np.float32),
    }


def _eval_preds(F):
    members = tuple(range(2**63 - 50, 2**63 + 50))
    return {
        "nan_eq": F.Compare("f64", "eq", float("nan")),
        "nan_ne": F.Compare("f64", "ne", float("nan")),
        "neg_zero": F.And(F.Compare("f64", "le", 0.0), F.Compare("f64", "ge", -0.0)),
        "f64_order": F.Or(F.Compare("f64", "lt", -1.5), F.Compare("f64", "gt", 1.5)),
        "f32_lane": F.Compare("f32", "ge", 0.25),
        "u64_ge_2p63": F.Compare("u64", "ge", 2**63 + 10),
        "u64_lt_edges": F.Not(F.Compare("u64", "lt", 2**64 - 1)),
        "i32_u8": F.And(F.Compare("i32", "ne", 7), F.Compare("u8", "le", 2)),
        "i64_float_literal": F.Compare("i64", "lt", 4.0),
        "inset_0": F.InSet("u64", (2**65, -1)),
        "inset_1": F.InSet("u64", (2**63,)),
        "inset_128": F.InSet("u64", members[:128]),
        "inset_129": F.InSet("u64", members[:129]),
        "inset_f64_nan_negzero": F.InSet("f64", (float("nan"), 0.0, 1.5)),
        "inset_65536": F.InSet("i64", tuple(range(-(2**15), 2**15))),
    }


@pytest.mark.parametrize("pred", sorted(_eval_preds(tfilter)))
def test_eval_predicate_matches_jax(pred):
    lanes = _pred_lanes()
    template, raw = jfilter.split_literals(_eval_preds(jfilter)[pred])
    literals = jfilter.literal_arrays(template, raw, {k: v.dtype for k, v in lanes.items()})
    want = np.asarray(jfilter.eval_predicate(template, {k: jnp.asarray(v) for k, v in
                                                        lanes.items()}, literals))
    got = tfilter.eval_predicate(_eval_preds(tfilter)[pred],
                                 {k: torch.from_numpy(device_lane(v)) for k, v in lanes.items()},
                                 {k: v.dtype for k, v in lanes.items()})
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("literal", [2.5, 2**63, -(2**63) - 1])
def test_eval_predicate_rejects_unrepresentable_literals(literal):
    lanes = {"i64": np.arange(4, dtype=np.int64)}
    with pytest.raises(Exception, match="literal"):
        jfilter.literal_arrays(*jfilter.split_literals(jfilter.Compare("i64", "eq", literal)),
                               {"i64": np.dtype(np.int64)})
    with pytest.raises(HoraeError, match="literal"):
        tfilter.eval_predicate(tfilter.Compare("i64", "eq", literal),
                               {"i64": torch.from_numpy(lanes["i64"])}, {"i64": np.dtype(np.int64)})


@pytest.mark.parametrize("lanes,depth", [(16, 2), (17, 2), (1, 32), (1, 33)])
def test_program_fits_matches_compile_limits(lanes, depth):
    """`program_fits` admits exactly the predicates `compile_program` takes,
    at kernel E's 16 lanes and 32 stack slots."""
    F = tfilter
    p = F.And(*[F.Compare(f"c{i}", "gt", 0) for i in range(lanes)]) if lanes > 1 else \
        F.Compare("c0", "gt", 0)
    for _ in range(depth - (2 if lanes > 1 else 1)):
        p = F.Or(F.Compare("c0", "eq", 1), p)
    assert F._stack_depth(p) == depth
    fits = lanes <= F.MAX_LANES and depth <= F.MAX_DEPTH
    assert F.program_fits(p) == fits
    dtypes = {f"c{i}": np.dtype(np.int64) for i in range(lanes)}
    if fits:
        prog = F.compile_program(p, dtypes)
        assert len(prog.lanes) == lanes
    else:
        with pytest.raises(HoraeError, match="lanes|deep"):
            F.compile_program(p, dtypes)


def test_predicate_lanes_share_only_identical_key_lanes():
    """8-byte integer pks are read from their key lanes; a narrower pk
    (its predicate lane is int32) and the seq (its key lane is a rank) are
    uploaded as their own lanes."""
    cols = {"a": np.array([3, 1, 2], np.int32), "b": np.array([2**63, 1, 5], np.uint64),
            "__seq__": np.array([9, 7, 8], np.uint64)}
    keys, _, num_pk, names = tread.sort_key_lanes(cols.__getitem__, ("a", "b", "__seq__"),
                                                  torch.device("cpu"))
    assert names == ["a", "b", "__seq__"] and num_pk == 2
    by_name = dict(zip(names, keys))
    lanes = tread.predicate_lanes(cols, by_name, torch.device("cpu"))
    assert lanes["b"] is by_name["b"]
    assert lanes["a"] is not by_name["a"] and lanes["a"].dtype == torch.int32
    assert lanes["__seq__"] is not by_name["__seq__"]
    for c, a in cols.items():
        np.testing.assert_array_equal(lanes[c].numpy(), device_lane(a))
