"""The port's calibrated aggregation dispatcher (ops/agg_registry.py), its
dispatch surface (ops/blockagg.py) and kernels `lane_sum_count` and
`segment_last_value` (their plain versions here) against the JAX package,
on the CPU. The calibration cache lives under `tmp_path` in every test.

Tolerances:
- `lane_segment_sum_count`: counts exact (0/1 weights); sums within
  2^-20 x the cell's L1 mass (f32 partial grids summed in another order);
- `segment_last_value`: bitwise, outputs compared as u64 views (it
  selects values, it adds nothing);
- host lanes: bitwise (the same numpy code);
- every device name on f64 values: bitwise equal to `block`;
- f32 lanes: counts exact, sums within the registry's bf16 budget
  (BF16_L1_BUDGET x L1 + BF16_ATOL against the f64 oracle), the bound
  the calibration holds every lane to.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horaedb_tpu.ops import agg_registry as JR
from horaedb_tpu.ops import aggregate as jagg
from horaedb_tpu_torch.common.error import HoraeError
from horaedb_tpu_torch.ops import agg_registry as R
from horaedb_tpu_torch.ops import aggregate as agg
from horaedb_tpu_torch.ops import blockagg
from horaedb_tpu_torch.server.metrics import GLOBAL_METRICS

DEVICE_NAMES = [n for n, i in R.SORTED_IMPLS.items() if i.kind == "device"]


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HORAEDB_AGG_CACHE", str(tmp_path / "torch_agg_calib.json"))
    monkeypatch.setenv("HORAEDB_AGG_CALIB_N", "4096")
    for var in ("HORAEDB_AGG_IMPL", "HORAEDB_SORTED_IMPL", "HORAEDB_UNSORTED_IMPL"):
        monkeypatch.delenv(var, raising=False)
    R.reset_cache(memory_only=True)
    yield
    R.reset_cache(memory_only=True)


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a.view(f"u{a.dtype.itemsize}"), b.view(f"u{b.dtype.itemsize}"))
    return np.array_equal(a, b)


# -- lane_sum_count -------------------------------------------------------------

LANE_CELLS = 50


def _lane_cases():
    rng = np.random.default_rng(3)
    c = LANE_CELLS
    return {
        "sorted, n % 8 == 3": (np.sort(rng.integers(0, c, 1003)), None),
        "unsorted, weighted": (rng.integers(0, c, 1000), (rng.random(1000) > 0.3)),
        "ids < 0 and > C, n % 8 == 5": (rng.integers(-5, c + 5, 997), None),
        "ids < 0 and > C, weighted": (rng.integers(-5, c + 5, 1001), (rng.random(1001) > 0.5)),
        "tail only": (rng.integers(0, c, 5), None),
        "empty": (np.zeros(0, np.int64), None),
    }


@pytest.mark.parametrize("case", list(_lane_cases()))
def test_lane_sum_count_plain_matches_jax(case):
    k, w = _lane_cases()[case]
    k = k.astype(np.int32)
    v = np.random.default_rng(len(k)).normal(size=len(k)).astype(np.float32) * 100
    w32 = None if w is None else w.astype(np.float32)
    s, c = agg.lane_segment_sum_count(torch.from_numpy(k), torch.from_numpy(v), LANE_CELLS,
                                      w=None if w32 is None else torch.from_numpy(w32))
    js, jc = jagg.lane_segment_sum_count(jnp.asarray(k), jnp.asarray(v), LANE_CELLS,
                                         w=None if w32 is None else jnp.asarray(w32))
    assert s.dtype == c.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    kc = np.clip(k, 0, LANE_CELLS)
    l1 = np.bincount(kc, weights=np.abs(v.astype(np.float64)),
                     minlength=LANE_CELLS + 1)[:LANE_CELLS]
    err = np.abs(s.numpy().astype(np.float64) - np.asarray(js, dtype=np.float64))
    assert np.all(err <= 2.0 ** -20 * l1), float(err.max())
    # and against the f64 oracle of the clipped ids
    want = np.bincount(kc, weights=v.astype(np.float64), minlength=LANE_CELLS + 1)[:LANE_CELLS]
    assert np.all(np.abs(s.numpy() - want) <= 2.0 ** -20 * l1)


# -- segment_last_value ---------------------------------------------------------

def _slv_cases():
    rng = np.random.default_rng(17)
    n, segs = 3000, 40
    vals = rng.normal(size=n)
    vals[rng.choice(n, 30, replace=False)] = np.resize([np.nan, -0.0, np.inf, -np.inf], 30)
    index = rng.integers(-2, segs + 2, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    big = np.uint64(2**63)
    return {
        "ties": (vals, rng.integers(0, 6, n).astype(np.uint64), index, valid, segs),
        "seq >= 2^63 (u64)": (vals, big + rng.integers(0, 50, n).astype(np.uint64)
                              - np.where(rng.random(n) > 0.5, np.uint64(60), np.uint64(0)),
                              index, valid, segs),
        "i64 seq, negative": (vals, rng.integers(-(2**62), 2**62, n), index, valid, segs),
        "empty segments": (vals, rng.integers(0, 1000, n).astype(np.uint64),
                           np.abs(index) % 7, valid, 5000),
        "all invalid": (vals, rng.integers(0, 9, n).astype(np.uint64), index,
                        np.zeros(n, bool), segs),
    }


@pytest.mark.parametrize("case", list(_slv_cases()))
def test_segment_last_value_plain_matches_jax_bitwise(case):
    vals, seq, index, valid, segs = _slv_cases()[case]
    index = index.astype(np.int32)
    got = agg.segment_last_value(torch.from_numpy(vals), torch.from_numpy(agg.seq_as_int64(seq)),
                                 torch.from_numpy(index), torch.from_numpy(valid), segs)
    want = jagg.segment_last_value(jnp.asarray(vals), jnp.asarray(seq), jnp.asarray(index),
                                   jnp.asarray(valid), segs)
    assert same_bits(got.numpy(), np.asarray(want))


def test_segment_last_value_of_no_rows_is_nan():
    """The JAX function cannot take zero rows (its gather needs one); the
    port answers every segment with NaN, as for a segment no row reaches."""
    z = torch.zeros(0, dtype=torch.int64)
    got = agg.segment_last_value(z.double(), z, z.int(), z.bool(), 4)
    assert same_bits(got.numpy(), np.full(4, np.nan))


def test_seq_cast_wraps_as_the_reference_casts():
    seq = np.array([0, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)
    np.testing.assert_array_equal(agg.seq_as_int64(seq),
                                  np.asarray(jnp.asarray(seq).astype(jnp.int64)))


# -- host lanes ------------------------------------------------------------------

def _host_inputs():
    rng = np.random.default_rng(23)
    n, cells = 2000, 120
    k = np.sort(rng.integers(-3, cells + 3, n))
    v = rng.uniform(-100, 100, n)
    w = (rng.random(n) > 0.25).astype(np.float64)
    kn = k.copy()
    kn[500:520] = 3  # a non-monotone stretch: the accumulate branch
    return k, kn, v, w, cells


@pytest.mark.parametrize("lane", ["reduceat_sum_count", "reduceat_nonmonotone",
                                  "reduceat_min_max", "bincount_sum_count",
                                  "downsample_sorted", "downsample_unsorted"])
def test_host_lanes_match_the_reference_bitwise(lane):
    k, kn, v, w, cells = _host_inputs()
    vm = v * w
    if lane == "reduceat_sum_count":
        got = R.host_reduceat_sum_count(k, vm, cells, weights=w)
        want = JR.host_reduceat_sum_count(k, vm, cells, weights=w)
    elif lane == "reduceat_nonmonotone":
        got = R.host_reduceat_sum_count(kn, v, cells)
        want = JR.host_reduceat_sum_count(kn, v, cells)
    elif lane == "reduceat_min_max":
        got = R.host_reduceat_min_max(kn, v, cells, valid=w > 0)
        want = JR.host_reduceat_min_max(kn, v, cells, valid=w > 0)
    elif lane == "bincount_sum_count":
        perm = np.random.default_rng(1).permutation(len(k))
        got = R.host_bincount_sum_count(k[perm], vm[perm], cells, weights=w[perm])
        want = JR.host_bincount_sum_count(k[perm], vm[perm], cells, weights=w[perm])
    else:
        rng = np.random.default_rng(2)
        sid = np.sort(rng.integers(-1, 12, len(k))).astype(np.int32)
        ts = np.concatenate([np.sort(rng.integers(-5000, 70_000, (sid == s).sum()))
                             for s in np.unique(sid)])
        fn = "host_" + lane
        args = (ts, sid, v, 0, 10_000, 10, 6)
        got = getattr(R, fn)(*args, valid=w > 0)
        want = getattr(JR, fn)(*args, valid=w > 0)
        assert sorted(got) == sorted(want)
        got, want = [got[x] for x in sorted(got)], [want[x] for x in sorted(want)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert same_bits(a, b)


# -- the dispatch surface --------------------------------------------------------

def _f64_sorted_inputs():
    rng = np.random.default_rng(31)
    lens = np.concatenate([rng.integers(1, 30, 60), [700, 257, 256, 1]])
    k = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    v = rng.uniform(-1e3, 1e3, len(k))
    w = (rng.random(len(k)) > 0.1).astype(np.float64)
    return torch.from_numpy(k), torch.from_numpy(v * w), torch.from_numpy(w), len(lens) + 3


@pytest.mark.parametrize("name", DEVICE_NAMES)
def test_every_device_name_on_f64_is_block_bitwise(name, monkeypatch):
    k, v, w, cells = _f64_sorted_inputs()
    s, c = blockagg.sorted_segment_sum_count(k, v, cells, impl=name, weights=w)
    bs, bc = blockagg.sorted_segment_sum_count(k, v, cells, impl="block", weights=w)
    assert s.dtype == torch.float64
    assert same_bits(s.numpy(), bs.numpy()) and same_bits(c.numpy(), bc.numpy())
    mn, mx = blockagg.sorted_segment_min_max(k, v, cells, impl=name, valid=w > 0)
    bmn, bmx = blockagg.sorted_segment_min_max(k, v, cells, impl="block", valid=w > 0)
    assert same_bits(mn.numpy(), bmn.numpy()) and same_bits(mx.numpy(), bmx.numpy())
    # and through downsample_sorted, under the pin
    rng = np.random.default_rng(5)
    sid = np.repeat(np.arange(6, dtype=np.int32), 400)
    ts = np.tile(np.sort(rng.integers(-2000, 40_000, 400)), 6)
    vals = rng.uniform(0, 100, len(ts))
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "block")
    want = agg.downsample_sorted(ts, sid, vals, 0, 10_000, 5, 3, device="cpu")
    monkeypatch.setenv("HORAEDB_AGG_IMPL", name)
    got = agg.downsample_sorted(ts, sid, vals, 0, 10_000, 5, 3, device="cpu")
    for x in ("sum", "count", "mean", "min", "max"):
        assert same_bits(got[x].numpy(), want[x].numpy()), x


def test_f64_never_reaches_the_lane_kernel(monkeypatch):
    """HORAEDB_AGG_IMPL=lanes on f64 rows runs kernel B (its plain version
    here); on f32 rows the pin runs the lane."""
    calls = {"block": 0, "lanes": 0}
    real_block, real_lanes = blockagg.block_sum_count, agg.lane_segment_sum_count

    def block(*a, **kw):
        calls["block"] += 1
        return real_block(*a, **kw)

    def lanes(*a, **kw):
        calls["lanes"] += 1
        return real_lanes(*a, **kw)

    monkeypatch.setattr(blockagg, "block_sum_count", block)
    monkeypatch.setattr(agg, "lane_segment_sum_count", lanes)
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "lanes")
    ts = np.arange(100, dtype=np.int64) * 1000
    sid = np.zeros(100, np.int32)
    out = agg.downsample_sorted(ts, sid, np.linspace(0, 1, 100), 0, 10_000, 1, 10, device="cpu")
    assert calls == {"block": 1, "lanes": 0}
    assert out["sum"].dtype == torch.float64
    assert R.last_choice() == "lanes"
    k, v, w, cells = _f64_sorted_inputs()
    s, _c = blockagg.sorted_segment_sum_count(k, v.float(), cells)
    assert calls == {"block": 1, "lanes": 1} and s.dtype == torch.float32


def _oracle(k, v, cells):
    s = np.bincount(k, weights=v.astype(np.float64), minlength=cells)
    l1 = np.bincount(k, weights=np.abs(v.astype(np.float64)), minlength=cells)
    return s, np.bincount(k, minlength=cells), l1


@pytest.mark.parametrize("kind,name", [("sorted", n) for n in R.sorted_impl_names("cpu")]
                         + [("unsorted", n) for n in R.unsorted_impl_names("cpu")])
def test_f32_lanes_within_the_bf16_budget(kind, name):
    rng = np.random.default_rng(8)
    cells = 700
    k = np.sort(rng.integers(0, cells, 20_000)).astype(np.int32)
    if kind == "unsorted":
        k = rng.permutation(k)
    v = rng.normal(size=len(k)).astype(np.float32)
    run = R.run_sorted if kind == "sorted" else R.run_unsorted
    s, c = run(name, torch.from_numpy(k), torch.from_numpy(v), cells)
    es, ec, l1 = _oracle(k, v, cells)
    np.testing.assert_array_equal(c.numpy().astype(np.int64), ec)
    err = np.abs(s.numpy().astype(np.float64) - es)
    assert np.all(err <= R.BF16_L1_BUDGET * l1 + R.BF16_ATOL), float(err.max())
    if name == "block_bf16":  # kernel B's plain version of the same rounding
        rounded = torch.from_numpy(v).to(torch.bfloat16).to(torch.float64).numpy()
        np.testing.assert_allclose(s.numpy(), np.bincount(k, weights=rounded, minlength=cells),
                                   rtol=1e-6, atol=1e-4)


def test_host_lanes_are_cpu_only():
    assert "reduceat" not in R.sorted_impl_names("cuda")
    assert "bincount" not in R.unsorted_impl_names("cuda")
    assert set(R.sorted_impl_names("cpu")) == set(R.SORTED_IMPLS) == set(JR.SORTED_IMPLS)
    assert set(R.UNSORTED_IMPLS) == set(JR.UNSORTED_IMPLS)


@pytest.mark.parametrize("var,name", [("HORAEDB_AGG_IMPL", "reduceat"),
                                      ("HORAEDB_SORTED_IMPL", "reduceat"),
                                      ("HORAEDB_UNSORTED_IMPL", "bincount")])
def test_host_pin_is_refused_off_the_cpu(var, name, monkeypatch):
    """A host lane never takes data off the card: a pin naming one raises
    for a cuda device (and for tensors not on the CPU; `meta` tensors stand
    in for the card's here), and still runs on the CPU."""
    monkeypatch.setenv(var, name)
    choose = R.choose_unsorted if name == "bincount" else R.choose_sorted
    with pytest.raises(HoraeError, match="host lane"):
        choose(1000, 100, device="cuda")
    assert choose(1000, 100, device="cpu") == name
    run = blockagg.segment_sum_count if name == "bincount" else blockagg.sorted_segment_sum_count
    k = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(HoraeError, match="host lane"):
        run(k, torch.zeros(4, dtype=torch.float64, device="meta"), 3, impl=name)
    if name == "reduceat":
        with pytest.raises(HoraeError, match="host lane"):
            blockagg.sorted_segment_min_max(k, torch.zeros(4, device="meta"), 3, impl=name)
    s, c = run(torch.tensor([0, 0, 2, 2], dtype=torch.int32),
               torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64), 3, impl=name)
    assert s.tolist() == [3.0, 0.0, 7.0] and c.tolist() == [2.0, 0.0, 2.0]


# -- calibration -----------------------------------------------------------------

def test_cold_calibration_persists_every_cpu_impl():
    name = R.choose_sorted(100_000, 5_000, device="cpu")
    data = json.loads(open(R.cache_path(), encoding="utf-8").read())
    assert R.cache_path().endswith("torch_agg_calib.json")
    assert data["version"] == R.CALIB_VERSION
    entry = data["entries"]["cpu/sorted/dense"]
    assert entry["impl"] == name and not entry["rejected"]
    assert set(entry["ab"]) == set(R.sorted_impl_names("cpu"))
    assert R.SORTED_IMPLS[entry["device_impl"]].kind == "device"
    R.choose_unsorted(100, 5_000, device="cpu")
    data = json.loads(open(R.cache_path(), encoding="utf-8").read())
    assert set(data["entries"]["cpu/unsorted/sparse"]["ab"]) == set(R.unsorted_impl_names("cpu"))


def test_warm_cache_skips_the_micro_ab(monkeypatch):
    first = R.choose_sorted(100_000, 5_000, device="cpu")
    R.reset_cache(memory_only=True)

    def boom(*a, **kw):
        raise AssertionError("a warm cache must not calibrate again")

    monkeypatch.setattr(R, "_calibrate", boom)
    assert R.choose_sorted(100_000, 5_000, device="cpu") == first
    assert R.calibration_entry("sorted", 100_000, 5_000, device="cpu")[1] == "cache"


@pytest.mark.parametrize("var", ["HORAEDB_AGG_IMPL", "HORAEDB_SORTED_IMPL"])
def test_pin_bypasses_calibration(var, monkeypatch):
    monkeypatch.setenv(var, "scatter_fused")
    monkeypatch.setattr(R, "_calibrate", lambda *a, **kw: pytest.fail("pinned: no calibration"))
    assert R.choose_sorted(100_000, 5_000, device="cpu") == "scatter_fused"
    assert R.last_choice() == "scatter_fused"
    assert not os.path.exists(R.cache_path())


def test_unknown_pin_raises(monkeypatch):
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "pallas")
    with pytest.raises(HoraeError):
        R.choose_sorted(100_000, 5_000, device="cpu")
    monkeypatch.delenv("HORAEDB_AGG_IMPL")
    with pytest.raises(HoraeError, match="unknown sorted impl"):
        blockagg.sorted_segment_sum_count(torch.zeros(2, dtype=torch.int32),
                                          torch.zeros(2, dtype=torch.float64), 1, impl="pallas")


def test_inventory_change_recalibrates():
    R.choose_sorted(100_000, 5_000, device="cpu")
    path = R.cache_path()
    data = json.loads(open(path, encoding="utf-8").read())
    data["sorted_impls"] = ["scatter"]
    open(path, "w", encoding="utf-8").write(json.dumps(data))
    R.reset_cache(memory_only=True)
    _entry, source = R.calibration_entry("sorted", 100_000, 5_000, device="cpu")
    assert source == "calibrated"


def test_sweep_covers_every_implementation(capsys):
    R.main(["--sweep", "8192", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["metric"] == "agg_registry_sweep" and out["platform"] == "cpu"
    assert set(out["sorted_ab"]) == set(R.sorted_impl_names("cpu"))
    assert set(out["unsorted_ab"]) == set(R.unsorted_impl_names("cpu"))
    assert all(isinstance(r, int) for r in [*out["sorted_ab"].values(),
                                            *out["unsorted_ab"].values()])


def test_agg_impl_total_counts_each_dispatch(monkeypatch):
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "block_r32")
    fam = GLOBAL_METRICS.get("horaedb_agg_impl_total")
    before = fam.labels("block_r32").value
    ts = np.arange(50, dtype=np.int64) * 1000
    agg.downsample_sorted(ts, np.zeros(50, np.int32), np.ones(50), 0, 10_000, 1, 5,
                          device="cpu")
    assert fam.labels("block_r32").value == before + 1  # one dispatch, both reductions
    assert 'horaedb_agg_impl_total{impl="block_r32"}' in GLOBAL_METRICS.render()
