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
from horaedb_tpu_torch.backend import i64_to_u64, order_key, u64_to_i64
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
    with pytest.raises(Exception, match="block_sum_count"):
        tblock.sorted_segment_sum_count(k, v, 4, weights=w)


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
