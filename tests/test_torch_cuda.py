"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device. On the H100:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` because the suite's conftest imports jax, which the card's
machine lacks; this file imports nothing of it.) Tolerances: permutations,
counts and min/max exact (NaN == NaN); f64 sums rtol=1e-12.
"""

import numpy as np
import pytest
import torch

from horaedb_tpu_torch.backend import order_key
from horaedb_tpu_torch.ops import blockagg, sort as sort_ops
from horaedb_tpu_torch.ops.aggregate import downsample_sorted

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,keys", [(1, 1), (2047, 1), (2049, 2), (70_001, 4), (300_000, 4)])
def test_sort_perm_matches_plain(dev, n, keys):
    rng = np.random.default_rng(n)
    lanes = [rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
             rng.integers(-(2**40), 2**40, n).astype(np.int64),
             rng.integers(0, 3, n).astype(np.uint64),
             np.full(n, 5, np.int64)][:keys]
    mapped = [torch.from_numpy(order_key(a)).to(dev) for a in lanes]
    bounds = [(int(m.min()), int(m.max())) for m in mapped]
    got = sort_ops.sort_perm(mapped, bounds)
    assert torch.equal(got, sort_ops.sort_perm_plain(mapped))


TILE = 4096  # rows of a look-back tile (onesweep.cuh)


def _sort_perm_matches_plain(dev, lanes: list, bounds=None) -> torch.Tensor:
    """sort_perm over the mapped lanes (bounds from the data unless given)
    bitwise equal to its plain version; returns the permutation."""
    mapped = [torch.from_numpy(order_key(a)).to(dev) for a in lanes]
    if bounds is None:
        bounds = [(int(m.min()), int(m.max())) if m.numel() else (0, 0) for m in mapped]
    got = sort_ops.sort_perm(mapped, bounds)
    assert got.dtype == torch.int32
    assert torch.equal(got, sort_ops.sort_perm_plain(mapped))
    return got


@pytest.mark.parametrize("n", [0, 1, TILE - 1, TILE, TILE + 1])
def test_sort_perm_row_counts_around_a_tile_match_plain(dev, n):
    """The write batch's two keys (a 64-bit tsid, 2 h of ms) over row counts
    around one tile; fewer than two rows give the identity."""
    rng = np.random.default_rng(n + 11)
    tsid = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    tsid = rng.choice(tsid, n) if n else tsid  # ties on the tsid
    _sort_perm_matches_plain(dev, [tsid, rng.integers(0, 7_200_000, n).astype(np.int64)])


def _chain_lanes(case: str, n: int, rng) -> tuple[list, list | None]:
    """(lanes, bounds or None) of an edge of the packed-key chain."""
    edges = np.array([0, 2**63, 2**64 - 1], np.uint64)
    u64 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    u64[:3] = edges
    if case == "full_64_bit":  # no two lanes pack: two keys of 8 digits
        return [rng.choice(u64[:500], n), rng.permutation(u64)], None
    if case == "three_keys":  # spans of 60 bits: three keys, ties in each
        return [rng.choice(rng.integers(0, 2**60, 40), n).astype(np.int64) for _ in range(3)], None
    if case == "equal_keys":  # wider bounds than the data: the chain runs
        return [np.full(n, 7, np.int64), np.full(n, 2**63, np.uint64)], [(0, 2**40), (0, 2**20)]
    lanes = [rng.integers(0, 50, n).astype(np.uint64), rng.integers(-(2**40), 2**40, n)]
    order = np.lexsort(tuple(reversed(lanes)))
    return [a[order] for a in lanes], None  # "presorted"


@pytest.mark.parametrize("case", ["full_64_bit", "three_keys", "equal_keys", "presorted"])
def test_sort_perm_chain_edges_match_plain(dev, case):
    """Keys that cannot pack, three packed keys, keys equal everywhere (the
    order from the row alone: the identity) and rows already in order."""
    lanes, bounds = _chain_lanes(case, 70_001, np.random.default_rng(len(case)))
    if case == "three_keys":
        mapped = [(int(a.min()), int(a.max())) for a in lanes]
        assert len(keychain.pack_lanes(mapped)) == 3
    got = _sort_perm_matches_plain(dev, lanes, bounds)
    if case in ("equal_keys", "presorted"):
        assert torch.equal(got.cpu(), torch.arange(len(lanes[0]), dtype=torch.int32))


def test_sort_perm_single_key_of_the_sort_strategy_matches_plain(dev):
    """blockagg's `sort` strategy: one key of clamped cell ids, its bounds
    (0, num_cells) wider than the ids it gets."""
    rng = np.random.default_rng(17)
    ids = rng.integers(0, 5000, 300_001).astype(np.int64)
    _sort_perm_matches_plain(dev, [ids], [(0, 65_536)])


@pytest.mark.parametrize("n,cells", [(1, 1), (2048, 7), (4097, 3), (100_003, 5000),
                                     (1_000_000, 40_000)])
def test_segment_kernels_match_plain(dev, n, cells):
    rng = np.random.default_rng(cells)
    k = np.sort(rng.integers(-1, cells + 2, n)).astype(np.int32)
    v = rng.integers(-1000, 1000, n).astype(np.float64)
    m = min(n, 6)
    v[rng.choice(n, m, replace=False)] = np.resize([np.nan, np.inf, -np.inf, -0.0], m)
    ok = rng.random(n) > 0.2
    kt, vt, okt = (torch.from_numpy(a).to(dev) for a in (k, v, ok))
    wt = okt.to(torch.float64)
    vm = torch.where(okt, vt, 0.0)
    s, c = blockagg.sorted_segment_sum_count(kt, vm, cells, weights=wt)
    ps, pc = blockagg.sum_count_plain(kt, vm, wt, cells)
    assert torch.equal(c, pc)
    torch.testing.assert_close(s, ps, rtol=1e-12, atol=0.0, equal_nan=True)
    mn, mx = blockagg.sorted_segment_min_max(kt, vt, cells, valid=okt)
    pmn, pmx = blockagg.min_max_plain(kt, vt, okt, cells)
    for a, b in ((mn, pmn), (mx, pmx)):
        assert bool(((a == b) | (a.isnan() & b.isnan())).all())


def test_downsample_sorted_excluded_series_match_the_host(dev):
    """Rows of series outside the query keep the clipped index of a
    neighbour (the scan's dense series map), so their cell ids repeat a kept
    series' cells; the grids must still equal the plain versions'."""
    rng = np.random.default_rng(6)
    per = 360
    # hosts A (kept, 0), B (excluded, shares 1), C (kept, 1), D and E (excluded, past the end)
    sid = np.repeat(np.array([0, 1, 1, 1, 1], np.int32), per)
    valid = np.repeat(np.array([True, False, True, False, False]), per)
    ts = np.tile(np.arange(per) * 10_000, 5).astype(np.int64)
    v = rng.uniform(0, 100, len(ts))
    got = downsample_sorted(ts, sid, v, 0, 300_000, 2, 12, valid=valid, device=dev)
    want = downsample_sorted(ts, sid, v, 0, 300_000, 2, 12, valid=valid, device="cpu")
    for key in ("count", "min", "max"):
        assert torch.equal(got[key].cpu(), want[key])
    assert torch.equal(got["count"].cpu(), torch.full((2, 12), 30.0, dtype=torch.float64))
    torch.testing.assert_close(got["sum"].cpu(), want["sum"], rtol=1e-12, atol=0.0)


def test_downsample_is_bitwise_repeatable(dev):
    rng = np.random.default_rng(5)
    sid = np.repeat(np.arange(300), 700).astype(np.int32)
    ts = np.tile(np.arange(700) * 10_000, 300).astype(np.int64)
    v = rng.uniform(0, 100, len(ts))
    a = downsample_sorted(ts, sid, v, 0, 300_000, 300, 24, device=dev)
    b = downsample_sorted(ts, sid, v, 0, 300_000, 300, 24, device=dev)
    for key in a:
        assert torch.equal(a[key].view(torch.int64), b[key].view(torch.int64))


# -- kernels D, E and F ---------------------------------------------------------

from horaedb_tpu_torch.backend import device_lane  # noqa: E402
from horaedb_tpu_torch.ops import filter as F  # noqa: E402
from horaedb_tpu_torch.ops import keychain  # noqa: E402
from horaedb_tpu_torch.ops import merge  # noqa: E402
from horaedb_tpu_torch.storage.read import _pack_sort_keys, sort_key_lanes  # noqa: E402

SORT_KEYS = ("pk1", "pk2", "__seq__")


def _rows(n: int, seed: int, presorted: bool = False):
    rng = np.random.default_rng(seed)
    cols = {"pk1": rng.integers(-(2**40), 2**40, n).astype(np.int64) % 5000,
            "pk2": rng.integers(2**63, 2**63 + 4, n, dtype=np.uint64),
            "__seq__": rng.integers(1_700_000_000_000_000_000, 1_700_000_000_000_000_000 + 9,
                                    n).astype(np.uint64)}
    if presorted:
        order = np.lexsort((cols["__seq__"], cols["pk2"], cols["pk1"]))
        cols = {k: v[order] for k, v in cols.items()}
    return cols, rng.random(n) < 0.7


def _same_survivors(a, b):
    (out, k), (pout, pk) = a, b
    assert int(k) == int(pk)
    assert torch.equal(out[: int(k)].cpu(), pout[: int(pk)].cpu())


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("n,rejected", [(0, False), (1, False), (2049, True), (2049, False),
                                        (100_003, False)])
def test_packed_merge_matches_plain(dev, n, rejected, dedup):
    cols, mask = _rows(n, n)
    if rejected:
        mask[:] = False
    if n:
        packed, seq_width, bits = _pack_sort_keys(cols.__getitem__, SORT_KEYS, n)
    else:
        packed, seq_width, bits = np.zeros(0, np.uint64), 1, 8
    key = torch.from_numpy(order_key(np.where(mask, packed, np.uint64(2**64 - 1)))).to(dev)
    _same_survivors(merge.packed_merge(key, bits, seq_width, dedup),
                    merge.packed_merge_plain(key, seq_width, dedup))


def _packed_keys(kind: str, n: int, key_bits: int, seed: int):
    """Mapped packed keys of `key_bits` bits (rejected rows: the sentinel)
    and a seq width below them. kind: "random" (groups of several rows,
    30 % rejected), "rejected" (every row), "presorted" (ascending raw
    keys, rejected rows among them), "straddle" (distinct keys but one run
    of equal keys across rows 4,000-4,199: the look-back sort's 4,096-row
    tile and the compaction's 2,048-row tiles split it)."""
    rng = np.random.default_rng(seed)
    hi = 2**key_bits
    pool = rng.integers(0, hi, max(1, n // 3), dtype=np.uint64, endpoint=False)
    raw = rng.choice(pool, n) if n else np.zeros(0, np.uint64)
    keep = rng.random(n) < 0.7
    if kind == "rejected":
        keep[:] = False
    elif kind == "presorted":
        raw = np.sort(raw)
    elif kind == "straddle":
        raw = rng.permutation(np.arange(n, dtype=np.uint64) * np.uint64(hi // max(n, 1) or 1)
                              % np.uint64(hi))
        raw[4000:4200] = raw[4000]
        keep[4000:4200] = True
    packed = np.where(keep, raw, np.uint64(2**64 - 1))
    return order_key(packed), min(3, key_bits - 1)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("kind,n,key_bits", [
    *[("random", 100_003, b) for b in (1, 8, 9, 42, 63)],
    *[("random", n, 42) for n in (0, 1, 4095, 4096, 4097, 100_003)],
    ("rejected", 4097, 42), ("presorted", 100_003, 42), ("presorted", 100_003, 9),
    ("straddle", 10_000, 42), ("straddle", 10_000, 63)])
def test_packed_merge_on_the_look_back_sort_matches_plain(dev, kind, n, key_bits, dedup):
    """Kernel D (a partition, onesweep.cuh's sort of the valid rows, the
    keep-last compaction) equals its plain version, survivors and count,
    at every key width, around the tiles, presorted and with ties."""
    mapped, seq_width = _packed_keys(kind, n, key_bits, seed=n + key_bits)
    key = torch.from_numpy(mapped).to(dev)
    _same_survivors(merge.packed_merge(key, key_bits, seq_width, dedup),
                    merge.packed_merge_plain(key, seq_width, dedup))


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("n,presorted", [(1, False), (2048, True), (4097, False),
                                         (300_001, False), (300_001, True)])
def test_index_merge_mask_matches_plain(dev, n, presorted, dedup):
    cols, mask = _rows(n, n + 1, presorted)
    keys, bounds, num_pk, _ = sort_key_lanes(cols.__getitem__, SORT_KEYS, dev)
    mask_t = torch.from_numpy(mask.astype(np.uint8)).to(dev)
    _same_survivors(merge.index_merge_mask(keys, bounds, num_pk, mask_t, dedup, presorted),
                    merge.index_merge_plain(keys, num_pk, mask_t, dedup, presorted))


def _lanes_on_card(dev, lanes: list):
    """Mapped int64 lanes on the card and their (min, max) bounds."""
    mapped = [torch.from_numpy(order_key(a)).to(dev) for a in lanes]
    return mapped, [(int(m.min()), int(m.max())) if m.numel() else (0, 0) for m in mapped]


@pytest.mark.parametrize("dedup", [True, False])
def test_index_merge_full_64_bit_tsid_lane_matches_plain(dev, dedup):
    """A tsid lane spanning all 64 bits takes one key of 8 digits."""
    rng = np.random.default_rng(31)
    n = 200_003
    tsid = rng.choice(rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64, endpoint=True), n)
    tsid[:2] = [0, 2**64 - 1]
    ts = rng.integers(0, 7_200_000, n).astype(np.int64)
    seq = rng.integers(0, 25, n).astype(np.int64)
    keys, bounds = _lanes_on_card(dev, [tsid, ts, seq])
    assert [d for _, _, d in keychain.pack_lanes(bounds)] == [8, 4]
    mask = torch.from_numpy((rng.random(n) < 0.6).astype(np.uint8)).to(dev)
    _same_survivors(merge.index_merge_mask(keys, bounds, 2, mask, dedup, False),
                    merge.index_merge_plain(keys, 2, mask, dedup, False))


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("kept", [0, 1, 4095, 4096, 4097])
def test_index_merge_kept_counts_around_a_tile_match_plain(dev, kept, dedup):
    """Kept counts around the look-back sort's 4,096-row tile, of 20,011 rows."""
    rng = np.random.default_rng(kept)
    n = 20_011
    cols, _ = _rows(n, kept + 7)
    keys, bounds, num_pk, _ = sort_key_lanes(cols.__getitem__, SORT_KEYS, dev)
    mask = np.zeros(n, np.uint8)
    mask[rng.choice(n, kept, replace=False)] = 1
    mask_t = torch.from_numpy(mask).to(dev)
    _same_survivors(merge.index_merge_mask(keys, bounds, num_pk, mask_t, dedup, False),
                    merge.index_merge_plain(keys, num_pk, mask_t, dedup, False))


def test_index_merge_rows_equal_in_every_lane_keep_row_order(dev):
    """Rows equal in every lane come out in row order (no dedup: the whole
    permutation), bitwise the plain version's."""
    rng = np.random.default_rng(33)
    n = 50_001
    lanes = [rng.integers(0, 2, n).astype(np.int64),
             rng.integers(2**63, 2**63 + 2, n, dtype=np.uint64),
             rng.integers(0, 2, n).astype(np.int64)]
    keys, bounds = _lanes_on_card(dev, lanes)
    mask = torch.from_numpy((rng.random(n) < 0.9).astype(np.uint8)).to(dev)
    got = merge.index_merge_mask(keys, bounds, 2, mask, False, False)
    _same_survivors(got, merge.index_merge_plain(keys, 2, mask, False, False))
    out, k = got
    key = sum(lane.astype(np.int64) << (2 - i) for i, lane in
              enumerate([lanes[0], (lanes[1] - np.uint64(2**63)).astype(np.int64), lanes[2]]))
    rows = out[: int(k)].cpu().numpy()
    run = key[rows]
    assert np.all(np.diff(run) >= 0)
    assert np.all(np.diff(rows)[np.diff(run) == 0] > 0)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("spans", [(40, 30, 20), (30, 30, 30), (64, 1, 63), (8, 8, 8)])
def test_index_merge_three_lanes_lexicographic_match_plain(dev, spans, dedup):
    """Three lanes of the given bit spans, packed as pack_lanes says (two
    per key where they fit), in the lexicographic order of the plain
    version."""
    rng = np.random.default_rng(sum(spans))
    n = 100_003
    lanes = []
    for bits in spans:
        pool = rng.integers(0, 2**bits - 1, 3000, dtype=np.uint64, endpoint=True)
        lane = rng.choice(pool, n)
        lane[:2] = [0, 2**bits - 1]
        lanes.append(lane)
    keys, bounds = _lanes_on_card(dev, lanes)
    mask = torch.from_numpy((rng.random(n) < 0.7).astype(np.uint8)).to(dev)
    _same_survivors(merge.index_merge_mask(keys, bounds, 2, mask, dedup, False),
                    merge.index_merge_plain(keys, 2, mask, dedup, False))


def _pred_cases():
    members = tuple(range(2**63, 2**63 + 2))
    return {
        "nan_negzero": F.Or(F.Compare("v", "eq", 0.0), F.Compare("v", "ne", float("nan"))),
        "u64_ge_2p63": F.And(F.Compare("pk2", "ge", 2**63 + 1), F.Not(F.Compare("pk1", "lt", 9))),
        "inset_0": F.InSet("pk1", (-1.5,)),
        "inset_1": F.InSet("pk2", members[:1]),
        "inset_128": F.InSet("pk1", tuple(range(0, 256, 2))),
        "inset_129": F.InSet("pk1", tuple(range(0, 258, 2))),
        "inset_65536": F.InSet("pk1", tuple(range(-(2**15), 2**15))),
        "inset_f64": F.InSet("v", (float("nan"), -0.0, 0.5)),
    }


@pytest.mark.parametrize("case", sorted(_pred_cases()))
def test_predicate_and_index_merge_filter_match_plain(dev, case):
    n = 70_001
    cols, _ = _rows(n, 3)
    rng = np.random.default_rng(4)
    v = rng.choice(np.array([np.nan, -0.0, 0.0, 0.5, -np.inf, 1.0]), n)
    host = {"pk1": cols["pk1"], "pk2": cols["pk2"], "v": v}
    dtypes = {k: a.dtype for k, a in host.items()}
    lanes = {k: torch.from_numpy(device_lane(a)).to(dev) for k, a in host.items()}
    pred = _pred_cases()[case]
    got = F.eval_predicate(pred, lanes, dtypes)
    prog = F.compile_program(pred, dtypes)
    assert torch.equal(got.cpu(), F.eval_program_plain(prog, lanes, n).cpu())
    keys, bounds, num_pk, _ = sort_key_lanes(cols.__getitem__, SORT_KEYS, dev)
    _same_survivors(
        merge.index_merge_filter(keys, bounds, num_pk, prog, lanes, n, True, False, dev),
        merge.index_merge_plain(keys, num_pk, F.eval_program_plain(prog, lanes, n), True, False))


# -- the fused route: grouped_stats, downsample, scan_kernel --------------------

from horaedb_tpu_torch.ops import aggregate  # noqa: E402
from horaedb_tpu_torch.ops import scan as scan_ops  # noqa: E402


def _same_stats(got: dict, want: dict) -> None:
    for k in ("count", "min", "max"):
        a, b = got[k].cpu(), want[k].cpu()
        assert a.dtype == b.dtype and bool(((a == b) | (a.isnan() & b.isnan())).all()), k
    for k in ("sum", "mean"):
        a, b = got[k].cpu(), want[k].cpu()
        if a.dtype == torch.float64:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=0.0, equal_nan=True)
        else:
            assert torch.equal(a, b), k


def _values(kind: str, n: int, rng) -> torch.Tensor:
    if kind == "f64":  # integer-valued: the sums are exact in any order
        v = rng.integers(-1000, 1000, n).astype(np.float64)
        m = min(n, 8)
        v[rng.choice(n, m, replace=False)] = np.resize([np.nan, -0.0, np.inf, -np.inf], m)
        return torch.from_numpy(v)
    if kind == "i64":
        return torch.from_numpy(rng.integers(-(2**56), 2**56, n).astype(np.int64))
    u = rng.integers(0, 2**58, n, dtype=np.uint64)
    u[: n // 7] = np.uint64(2**63 + 99)  # bit 63 set: unsigned min/max and mean
    return torch.from_numpy(u.view(np.int64).copy())


@pytest.mark.parametrize("kind", ["f64", "i64", "u64"])
@pytest.mark.parametrize("n,segments", [(0, 5), (1, 1), (2049, 7), (100_003, 5000),
                                        (1_000_000, 300_000)])
def test_grouped_stats_matches_plain(dev, kind, n, segments):
    rng = np.random.default_rng(n + segments)
    idx = torch.from_numpy(rng.integers(-3, segments + 3, n).astype(np.int32)).to(dev)
    ok = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    v = _values(kind, n, rng).to(dev)
    unsigned = kind == "u64"
    got = aggregate.grouped_stats(v, idx, ok, segments, unsigned=unsigned)
    want = aggregate.grouped_stats_plain(v, idx, ok, segments, unsigned=unsigned)
    _same_stats(got, want)
    again = aggregate.grouped_stats(v, idx.long(), ok, segments, unsigned=unsigned)
    for k in got:  # no atomics: bitwise repeatable, int32 and int64 ids alike
        assert torch.equal(got[k].view(torch.int64), again[k].view(torch.int64)), k


@pytest.mark.parametrize("n", [1, 4097, 300_001])
def test_downsample_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    t0, bucket_ms, ns, nb = 1_700_000_000_000, 60_000, 997, 10
    ts = t0 + rng.integers(-2 * bucket_ms, (nb + 2) * bucket_ms, n).astype(np.int64)
    ts[0] = t0 - 1  # floor division: bucket -1
    sid = rng.integers(-1, ns + 1, n).astype(np.int32)
    ok = rng.random(n) > 0.2
    args = [torch.from_numpy(a).to(dev) for a in (ts, sid)]
    v = _values("f64", n, rng).to(dev)
    okt = torch.from_numpy(ok).to(dev)
    got = aggregate.downsample(*args, v, okt, t0, bucket_ms, ns, nb)
    want = aggregate.downsample_plain(*args, v, okt, t0, bucket_ms, ns, nb)
    _same_stats(got, {k: t.reshape(ns, nb) for k, t in want.items()})


# -- grouped_stats' sort (csrc/onesweep.cuh): both paths against the plain
#    version on CPU copies, bitwise

def _same_bits(got: dict, want: dict) -> None:
    """Counts, min and max exact (NaN == NaN); sums and means bitwise as
    u64 views, but NaN cells compared as NaN (the card's additions return
    another NaN payload than the CPU's) and zero cells by value (the plain
    fold starts from +0.0, the kernel's from the cell's first row)."""
    for k in ("count", "min", "max"):
        a, b = got[k].cpu(), want[k].cpu()
        assert a.dtype == b.dtype and bool(((a == b) | (a.isnan() & b.isnan())).all()), k
    for k in ("sum", "mean"):
        a, b = got[k].cpu(), want[k].cpu()
        assert a.dtype == b.dtype, k
        if a.dtype != torch.float64:
            assert torch.equal(a, b), k
            continue
        nan = b.isnan()
        assert torch.equal(a.isnan(), nan), k
        a, b = a[~nan], b[~nan]
        assert torch.equal(a == 0, b == 0), k
        nz = b != 0
        assert np.array_equal(_u64(a[nz]), _u64(b[nz])), k


def _grouped_on_card(dev, v, idx, ok, segments, unsigned=False, path=None):
    """grouped_stats on the card against its plain version on the CPU,
    bitwise, and again on the card (repeatable bitwise); `path`, when
    given, is the sort's expected route (True: the presorted partition)."""
    cv, ci = v.to(dev), idx.to(dev)
    cok = None if ok is None else ok.to(dev)
    got, scratch = aggregate.grouped_stats_cuda(cv, ci, cok, segments, unsigned)
    want = aggregate.grouped_stats_plain(
        v, idx, torch.ones(len(idx), dtype=torch.bool) if ok is None else ok, segments, unsigned)
    _same_bits(got, want)
    if path is not None:
        assert aggregate.took_presorted_path(scratch, len(idx)) is path
    again = aggregate.grouped_stats(cv, ci, cok, segments, unsigned=unsigned)
    for k in got:
        assert np.array_equal(_u64(got[k]), _u64(again[k])), k


def _ids(rng, n: int, segments: int, order: str):
    """Ids, mask and the sort path they should take: `presorted` (kept ids
    non-decreasing, no dropped row), `presorted_dropped` (dropped rows with
    stray ids interleaved among sorted kept rows, as the fused scan hands
    them over) or `shuffled`."""
    idx = rng.integers(0, segments, n)
    ok = np.ones(n, bool)
    if order != "shuffled":
        idx = np.sort(idx)
    if order != "presorted":
        drop = rng.random(n) < 0.15
        ok[drop & (rng.random(n) < 0.5)] = False
        idx[drop & ok] = rng.choice([-1, segments, segments + 7], int((drop & ok).sum()))
    if order == "shuffled" and n > 1:
        idx[:2], ok[:2] = [1, 0], True  # kept and out of order: never presorted
    return idx, ok, order != "shuffled" or n < 2


def _f64(rng, n: int):
    return rng.uniform(-1e3, 1e3, n)  # non-dyadic: the association shows in the bits


@pytest.mark.parametrize("order", ["presorted", "presorted_dropped", "shuffled"])
@pytest.mark.parametrize("segments", [255, 256, 257, 2**16, 2**24, 2**24 + 1])
def test_grouped_stats_digit_edges_match_plain_bitwise(dev, segments, order):
    """Segment counts at the edges of the 8-bit digits (1 to 4 passes),
    over presorted rows (the partition), presorted rows with dropped rows
    interleaved, and shuffled rows (the look-back digit passes)."""
    rng = np.random.default_rng(segments)
    n = 300_001
    idx, ok, presorted = _ids(rng, n, segments, order)
    _grouped_on_card(dev, torch.from_numpy(_f64(rng, n)), torch.from_numpy(idx.astype(np.int32)),
                     torch.from_numpy(ok), segments, path=presorted)


@pytest.mark.parametrize("order", ["presorted_dropped", "shuffled"])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 2**20 + 3])
def test_grouped_stats_row_counts_match_plain_bitwise(dev, n, order):
    """Row counts at 0, 1, one tile of the sort (4,096 rows) +-1 and past
    2^20."""
    rng = np.random.default_rng(n + 11)
    idx, ok, presorted = _ids(rng, n, 1000, order)
    _grouped_on_card(dev, torch.from_numpy(_f64(rng, n)), torch.from_numpy(idx.astype(np.int32)),
                     torch.from_numpy(ok), 1000, path=presorted if n > 0 else None)


@pytest.mark.parametrize("how", ["masked", "out_of_range"])
def test_grouped_stats_every_row_dropped(dev, how):
    rng = np.random.default_rng(3)
    n = 50_000
    idx = rng.integers(0, 100, n) if how == "masked" else rng.integers(100, 10**6, n)
    ok = np.zeros(n, bool) if how == "masked" else np.ones(n, bool)
    _grouped_on_card(dev, torch.from_numpy(_f64(rng, n)), torch.from_numpy(idx.astype(np.int32)),
                     torch.from_numpy(ok), 100, path=True)


@pytest.mark.parametrize("order", ["presorted", "shuffled"])
@pytest.mark.parametrize("segments", [1, 4_097, 49_999, 50_000, 50_001])
def test_grouped_stats_mostly_masked_matches_plain_bitwise(dev, segments, order):
    """About 90 % of 50,000 rows masked, the kept ones bunched in the first
    tenth of the segments: every other segment reads the empty value,
    whether the key pass writes it (no more segments than rows, an equal
    share a block) or the fill launch (more segments than rows)."""
    rng = np.random.default_rng(segments)
    n = 50_000
    idx = rng.integers(0, segments, n)
    if order == "presorted":
        idx = np.sort(idx)
    ok = idx < max(1, segments // 10)
    _grouped_on_card(dev, torch.from_numpy(_f64(rng, n)), torch.from_numpy(idx.astype(np.int32)),
                     torch.from_numpy(ok), segments, path=True if order == "presorted" else None)


def test_grouped_stats_int64_ids_past_2_32_drop(dev):
    """int64 ids at and past 2^32 (and 2^32 + a valid id) are out of range
    and drop: none may alias into the u32 keys."""
    rng = np.random.default_rng(17)
    n = 100_000
    idx = rng.integers(0, 1000, n).astype(np.int64)
    far = rng.random(n) < 0.3
    idx[far] += rng.choice([2**32, 2**33, 2**40, -(2**32)], int(far.sum()))
    _grouped_on_card(dev, torch.from_numpy(_f64(rng, n)), torch.from_numpy(idx),
                     torch.from_numpy(rng.random(n) > 0.1), 1000, path=False)


@pytest.mark.parametrize("order", ["alone", "interleaved"])
def test_grouped_stats_one_cell_of_a_million_rows(dev, order):
    """A cell of 10^6 rows (segreduce.cuh folds it block-wide in chunks from
    its head): alone (presorted) and interleaved among other cells' rows
    (the digit passes bring its rows together in input order)."""
    rng = np.random.default_rng(23)
    big = 10**6
    if order == "alone":
        idx = np.full(big, 1, np.int32)
    else:
        idx = rng.integers(0, 5000, big + 300_000).astype(np.int32)
        idx[rng.choice(len(idx), big, replace=False)] = 1
    n = len(idx)
    _grouped_on_card(dev, torch.from_numpy(_f64(rng, n)), torch.from_numpy(idx), None, 5000,
                     path=order == "alone")


def _special(kind: str, rng, n: int):
    """Values that probe the rules: f64 NaN payloads, +-0.0 and +-inf; int64
    and uint64 sums that wrap past 2^64."""
    if kind == "f64":
        v = _f64(rng, n)
        nans = np.array([0x7FF8000000000123, 0xFFF8000000000456, 0x7FF0000000000001],
                        np.uint64).view(np.float64)
        pick = rng.choice(n, n // 50, replace=False)
        v[pick] = np.resize(np.concatenate([nans, [0.0, -0.0, np.inf, -np.inf, -0.0]]),
                            len(pick))
        return torch.from_numpy(v), False
    if kind == "i64":
        return torch.from_numpy(rng.integers(2**62, 2**63 - 1, n).astype(np.int64)
                                * rng.choice([-1, 1], n)), False
    u = rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    return torch.from_numpy(u.view(np.int64).copy()), True


@pytest.mark.parametrize("order", ["presorted_dropped", "shuffled"])
@pytest.mark.parametrize("kind", ["f64", "i64", "u64"])
def test_grouped_stats_special_values_match_plain_bitwise(dev, kind, order):
    rng = np.random.default_rng(len(kind) + len(order))
    n = 200_003
    idx, ok, presorted = _ids(rng, n, 3000, order)
    v, unsigned = _special(kind, rng, n)
    _grouped_on_card(dev, v, torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(ok), 3000,
                     unsigned=unsigned, path=presorted)


def _down_rows(rng, n: int, ns: int, nb: int, order: str, t0: int, bucket_ms: int):
    """Downsample rows sorted by (series, ts) as the fused scan hands them
    over, with rows before t0, past the grid, of series out of range and
    masked interleaved (`presorted_dropped`), or shuffled."""
    sid = np.sort(rng.integers(0, ns, n)).astype(np.int32)
    ts = t0 + rng.integers(0, nb * bucket_ms, n).astype(np.int64)
    order_ix = np.lexsort((ts, sid))
    sid, ts = sid[order_ix], ts[order_ix]
    ok = np.ones(n, bool)
    stray = rng.integers(0, 30, n)
    ts[stray == 0] = t0 - 1  # bucket -1
    ts[stray == 1] = t0 + nb * bucket_ms  # past the grid
    ts[stray == 2] = t0 - 10**12
    ok[rng.random(n) < 0.05] = False
    sid[rng.random(n) < 0.01] = ns  # a series past the grid (a scan's miss)
    if order == "shuffled":
        perm = rng.permutation(n)
        sid, ts, ok = sid[perm], ts[perm], ok[perm]
        if n > 1:
            sid[:2], ts[:2], ok[:2] = [1, 0], t0, True
    return ts, sid, ok


@pytest.mark.parametrize("order", ["presorted_dropped", "shuffled"])
@pytest.mark.parametrize("kind", ["f64", "i64", "u64"])
@pytest.mark.parametrize("ns,nb", [(255, 1), (4096, 16), (65281, 257)])
def test_downsample_both_paths_match_plain_bitwise(dev, ns, nb, kind, order):
    """downsample's key pass (the cell ids) into both sort paths, with
    255, 2^16 and 2^24 + 1 cells."""
    rng = np.random.default_rng(ns + nb)
    t0, bucket_ms, n = 1_700_000_000_000, 60_000, 250_000
    ts, sid, ok = _down_rows(rng, n, ns, nb, order, t0, bucket_ms)
    v, unsigned = (torch.from_numpy(_f64(rng, n)), False) if kind == "f64" else _special(
        kind, rng, n)
    lanes = [torch.from_numpy(a) for a in (ts, sid)]
    okt = torch.from_numpy(ok)
    got, scratch = aggregate.downsample_cuda(*(a.to(dev) for a in lanes), v.to(dev), okt.to(dev),
                                             t0, bucket_ms, ns, nb, unsigned)
    want = aggregate.downsample_plain(*lanes, v, okt, t0, bucket_ms, ns, nb, unsigned)
    _same_bits(got, want)
    assert aggregate.took_presorted_path(scratch, n) is (order != "shuffled")
    again = aggregate.downsample(*(a.to(dev) for a in lanes), v.to(dev), okt.to(dev), t0,
                                 bucket_ms, ns, nb, unsigned=unsigned)
    for k in got:
        assert np.array_equal(_u64(got[k]), _u64(again[k].reshape(-1))), k


def _scan_lanes(n: int, seed: int, presorted: bool):
    cols, mask = _rows(n, seed, presorted)
    rng = np.random.default_rng(seed + 1)
    cols["v"] = rng.choice(np.array([np.nan, -0.0, 0.0, 0.5, -np.inf, 1.0]), n)
    cols["side"] = rng.integers(-5, 5, n).astype(np.int32)
    cols["flag"] = (rng.random(n) < 0.5).astype(np.uint8)
    return cols, mask


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("how", ["none", "program", "mask"])
@pytest.mark.parametrize("n", [0, 1, 4097, 300_001])
def test_scan_kernel_matches_plain(dev, n, how, presorted, dedup):
    cols, mask = _scan_lanes(n, n + 7, presorted)
    keys, bounds, num_pk, names = sort_key_lanes(cols.__getitem__, SORT_KEYS, dev)
    lanes = {k: torch.from_numpy(device_lane(a)).to(dev) for k, a in cols.items()}
    prog, mask_t = None, None
    if how == "program":
        pred = F.Or(F.InSet("pk1", tuple(range(0, 400, 3))), F.Compare("v", "ne", 0.0))
        prog = F.compile_program(pred, {k: a.dtype for k, a in cols.items()})
    elif how == "mask":
        mask_t = torch.from_numpy(mask.astype(np.uint8)).to(dev)
    got = scan_ops.scan_kernel(lanes, keys, bounds, num_pk, prog, n, dedup, presorted, dev,
                               mask=mask_t)
    plain_mask = (F.eval_program_plain(prog, lanes, n) if prog is not None
                  else mask_t if mask_t is not None else torch.ones(n, dtype=torch.bool,
                                                                     device=dev))
    want = scan_ops.scan_kernel_plain(lanes, keys, num_pk, plain_mask, dedup, presorted)
    _same_scan(got, want)


def _same_scan(got, want) -> int:
    """kept, perm[:kept], every gathered lane's first kept rows (as raw
    bits), keep and starts all equal; returns kept."""
    k = int(got[4].item())
    assert k == int(want[4].item())
    assert torch.equal(got[1][:k].cpu(), want[1][:k].cpu())
    for name in got[0]:
        a, b = got[0][name][:k].cpu(), want[0][name][:k].cpu()
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)  # NaN payloads, -0.0
        assert torch.equal(a, b), name
    assert torch.equal(got[2].cpu(), want[2].cpu()) and torch.equal(got[3].cpu(), want[3].cpu())
    return k


def _scan_matches_plain(dev, key_lanes: list, num_pk: int, mask, dedup: bool, presorted: bool,
                        bounds=None) -> int:
    """scan_kernel over the mapped key lanes (gathered too, beside an f64
    and a uint8 lane) and a host mask (None: every row) against its plain
    version; returns kept."""
    n = len(key_lanes[0])
    rng = np.random.default_rng(n + num_pk)
    keys = [torch.from_numpy(order_key(a)).to(dev) for a in key_lanes]
    if bounds is None:
        bounds = [(int(k.min()), int(k.max())) if n else (0, 0) for k in keys]
    lanes = {f"k{i}": k for i, k in enumerate(keys)}
    lanes["v"] = torch.from_numpy(rng.choice(np.array([np.nan, -0.0, 0.0, 1.5]), n)).to(dev)
    lanes["f"] = torch.from_numpy((rng.random(n) < 0.5).astype(np.uint8)).to(dev)
    mask_t = None if mask is None else torch.from_numpy(mask.astype(np.uint8)).to(dev)
    got = scan_ops.scan_kernel(lanes, keys, bounds, num_pk, None, n, dedup, presorted, dev,
                               mask=mask_t)
    plain_mask = mask_t if mask_t is not None else torch.ones(n, dtype=torch.bool, device=dev)
    return _same_scan(got, scan_ops.scan_kernel_plain(lanes, keys, num_pk, plain_mask, dedup,
                                                      presorted))


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("kept", ["none", "some", "all"])
@pytest.mark.parametrize("n", [0, 1, TILE - 1, TILE, TILE + 1])
def test_scan_kernel_row_counts_around_a_tile_match_plain(dev, n, kept, dedup):
    """Row counts around one tile, with every row rejected, some, and every
    row kept (no mask)."""
    rng = np.random.default_rng(n + 3)
    lanes = [rng.integers(0, 300, n).astype(np.uint64), rng.integers(0, 7_200_000, n),
             rng.integers(0, 4, n)]
    mask = {"none": np.zeros(n, bool), "some": rng.random(n) < 0.6, "all": None}[kept]
    k = _scan_matches_plain(dev, lanes, 2, mask, dedup, False)
    assert k == {"none": 0, "some": int(mask.sum()) if mask is not None else 0, "all": n}[kept]


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("case", ["full_64_bit", "three_keys", "equal_keys", "presorted",
                                  "sorted_unflagged"])
def test_scan_kernel_chain_edges_match_plain(dev, case, dedup):
    """Key lanes that cannot pack, three packed keys, keys equal everywhere
    (the order from the row alone), and rows in key order, flagged
    presorted (the partition alone) or not (the sort finds them in order)."""
    rng = np.random.default_rng(len(case))
    n = 70_001
    lanes, bounds = _chain_lanes("presorted" if case == "sorted_unflagged" else case, n, rng)
    mask = rng.random(n) < 0.7
    _scan_matches_plain(dev, lanes, 1, mask, dedup, case == "presorted", bounds)


def _decode_lanes():
    """(codec, array, page_rows, extra encoder args): every kernel at widths
    0, 1, 17, 31/32, a width-33 page among device pages, pages of 1-3 rows
    and more than a block, wraps mod 2^64, NaN payloads, u64 >= 2^63, i4/u4."""
    rng = np.random.default_rng(21)
    i64 = np.iinfo(np.int64)
    w32 = np.zeros(3000, np.int64)
    w32[2::3] = -(2**31)
    w33 = np.zeros(3000, np.int64)
    w33[1500] = 2**31
    nan_low = (np.uint64(0x7FF8_0000_0000_0000) | rng.integers(
        0, 1 << 31, 9000, dtype=np.uint64)).view(np.float64)
    f32 = rng.normal(size=9000).astype(np.float32)
    f32[:4] = [np.nan, -0.0, np.inf, -np.inf]
    big = np.random.default_rng(22)  # the shapes past a batch and a chunk
    low = big.integers(0, 1 << 31, 20_000, dtype=np.uint64)
    low[::2] |= np.uint64(1 << 30)  # each XOR delta sets bit 30: width 31
    low[1::2] &= np.uint64((1 << 30) - 1)
    return [
        ("dod", 1_700_000_000_000 + np.arange(9003) * 10_000 + rng.integers(-5, 6, 9003), 4096,
         ()),
        ("dod", w32, 1000, ()),
        ("dod", w33, 1000, ()),
        ("dod", np.arange(25_000, dtype=np.int64) * 7 + np.arange(25_000) % 5, 10_000, ()),
        ("dod", np.asarray([i64.max - 1, i64.max, i64.min, i64.min + 1, 0, 2**62, i64.min],
                           np.int64), 4096, ()),
        ("xor", nan_low, 4096, ()),
        ("xor", np.ones(9001), 4096, ()),
        ("xor", f32, 4096, ()),
        ("dict", rng.integers(0, 2, 9000).astype(np.int64), 4096, (4096,)),
        ("dict", rng.permutation(1 << 17).astype(np.int64), 4096, (1 << 17,)),
        ("dict", np.uint64(2**63) + rng.integers(0, 7, 9000).astype(np.uint64), 4096, (4096,)),
        ("dict", rng.integers(-3, 3, 9000).astype(np.int32), 4096, (4096,)),
        ("rle", np.repeat(np.uint64(2**64 - 1) - np.arange(900, dtype=np.uint64), 11), 4096, ()),
        ("rle", rng.integers(-9, 9, 9000).astype(np.int64), 4096, ()),
        ("rle", np.repeat(np.arange(300, dtype=np.uint32) + np.uint32(2**31), 30), 4096, ()),
        # runs and rows past one batch and one chunk of the kernels
        ("rle", np.repeat(np.array([2**64 - 1, 2**63], np.uint64), 10_000), 10_000, ()),
        ("rle", np.uint64(2**63) + np.arange(10_000, dtype=np.uint64) * np.uint64(7), 10_000,
         ()),
        ("rle", big.integers(-9, 9, 5).astype(np.int64), 1, ()),
        ("xor", big.normal(size=20_000).astype(np.float32), 10_000, ()),
        ("xor", (np.uint64(0x4059_0000_0000_0000) ^ low).view(np.float64), 10_000, ()),
    ]


@pytest.mark.parametrize("case", range(20))
def test_decode_kernels_match_plain(dev, case):
    from horaedb_tpu_torch.ops import decode
    from horaedb_tpu_torch.storage import encoding as enc

    codec, arr, page_rows, extra = _decode_lanes()[case]
    lane = getattr(enc, f"_encode_{codec}")(arr, page_rows, *extra)
    lane.name = "x"
    dt = np.dtype(lane.dtype)
    pages = [p for p in lane.pages if decode.in_envelope(codec, dt, p, lane.dict_values)]
    s = decode.stage_pages(codec, dt, lane.payload, pages, lane.dict_values, dev)
    itemsize = dt.itemsize
    if codec == "dict":
        got, bad = decode.decode_unpack(s.words, s.table, s.dict_bits, s.rows)
        want, pbad = decode.decode_unpack_plain(s.words, s.table, s.dict_bits, s.rows)
        assert int(bad.item()) == int(pbad.item()) == 0
    else:
        kern = getattr(decode, f"decode_{codec}")
        got = kern(s.words, s.table, s.rows, itemsize)
        want = getattr(decode, f"decode_{codec}_plain")(s.words, s.table, s.rows, itemsize)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    out = enc.decode_lane(lane, impl="device", device=dev)
    assert out.dtype == arr.dtype and np.array_equal(out.view(np.uint8), arr.view(np.uint8))


def _dod_lane(rows: int, width: int, dtype) -> np.ndarray:
    """Two pages of `rows` rows and one of a single row whose zigzag second
    differences need `width` bits (each page of 3 rows or more holds
    -2^(width-1)), from a first value and delta that wrap mod 2^64; an
    int32 lane stays within int32 (its widths are the encoder's)."""
    rng = np.random.default_rng(rows * 33 + (width or 0))
    n = 2 * rows + 1
    if np.dtype(dtype) == np.int32:
        return rng.integers(-(2**28), 2**28, n).astype(np.int32)
    half = 1 << max(width - 1, 0)
    dd = rng.integers(-half, half, n).astype(np.int64) if width else np.zeros(n, np.int64)
    if width and rows >= 3:
        dd[rows - 1::rows] = -half  # the last row of each page: row 2 or later
    with np.errstate(over="ignore"):
        d = np.cumsum(dd.view(np.uint64), dtype=np.uint64) + np.uint64(2**62 + 12_345)
        return (np.cumsum(d, dtype=np.uint64) + np.uint64(2**63 - 7)).view(np.int64)


@pytest.mark.parametrize("width,dtype", [(0, np.int64), (1, np.int64), (17, np.int64),
                                         (31, np.int64), (32, np.int64), (None, np.int32)])
@pytest.mark.parametrize("rows", [1, 2, 3, 4095, 4096, 4097, 10_000])
def test_decode_dod_pair_scan_matches_plain(dev, rows, width, dtype):
    """decode_dod's one pair scan a page equals its plain version bitwise
    (u64 views): pages of 1-3 rows, a tile +-1 and 10,000 rows (a carried
    pair), widths 0-32, values that wrap mod 2^64, int32 lanes (whose
    widths are the encoder's)."""
    from horaedb_tpu_torch.ops import decode
    from horaedb_tpu_torch.storage import encoding as enc

    arr = _dod_lane(rows, width, dtype)
    lane = enc._encode_dod(arr, rows)
    lane.name = "ts"
    dt = np.dtype(lane.dtype)
    pages = [p for p in lane.pages if decode.in_envelope("dod", dt, p, None)]
    assert len(pages) == len(lane.pages)
    if dtype == np.int64:
        assert {p.width for p in pages if p.rows >= 3} <= {width}
    s = decode.stage_pages("dod", dt, lane.payload, pages, None, dev)
    got = decode.decode_dod(s.words, s.table, s.rows, dt.itemsize)
    want = decode.decode_dod_plain(s.words, s.table, s.rows, dt.itemsize)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    out = enc.decode_lane(lane, impl="device", device=dev)
    assert np.array_equal(out.view(np.uint8), arr.view(np.uint8))


def _u64(t) -> np.ndarray:
    return np.ascontiguousarray(t.cpu().numpy() if torch.is_tensor(t) else t).view(np.uint64)


# runs straddling 8-row thread spans and 2048-row tiles of the reduction
# as it stood before the left fold, and 13-row thread spans and 3,328-row
# tiles of the staged one (segreduce.cuh): 300 runs of 30 rows, the main
# path's 5-minute buckets of 10 s scrapes, cross tiles at every offset
_RUN_LENS = [1, 7, 9, 300, 2047, 2500, 4099] + [30] * 300 + [13, 26, 255, 256]
SEG_TILE = 3328  # rows of a segreduce.cuh tile


def _fold(x: np.ndarray) -> float:
    """segreduce.cuh's association of a run's f64 sum: a left fold of its
    rows for runs of up to 256 rows; longer runs left-fold chunks of 16
    rows counted from the head, then groups of 32 chunk partials, then the
    group partials (np.add.accumulate adds in order)."""
    if len(x) <= 256:
        return np.add.accumulate(x)[-1]
    chunks = np.array([np.add.accumulate(x[i:i + 16])[-1] for i in range(0, len(x), 16)])
    groups = np.array([np.add.accumulate(chunks[i:i + 32])[-1]
                       for i in range(0, len(chunks), 32)])
    return np.add.accumulate(groups)[-1]


@pytest.mark.parametrize("offset", [0, 3, 8, 2045, 2048, 2049, 6141, SEG_TILE - 29, SEG_TILE - 1,
                                    SEG_TILE, SEG_TILE + 12])
def test_segreduce_sums_are_left_folds_whatever_the_offset(dev, offset):
    """The same cells, non-dyadic values, placed after `offset` rows of
    another cell: kernel B and grouped_stats give every cell the left fold
    of its own rows in row order (in chunks from the head past 256 rows,
    `_fold`), bitwise, at every offset (a tree over threads and tiles
    associates a run's rows by their offset instead)."""
    from horaedb_tpu_torch.ops.aggregate import grouped_stats

    rng = np.random.default_rng(31)
    target = [rng.uniform(-1e3, 1e3, n) for n in _RUN_LENS]
    prefix = np.random.default_rng(offset).uniform(-1e3, 1e3, offset)
    k = np.concatenate([np.zeros(offset, np.int32)]
                       + [np.full(n, i + 1, np.int32) for i, n in enumerate(_RUN_LENS)])
    v = np.concatenate([prefix] + target)
    want = np.array([_fold(t) for t in target])
    cells = len(_RUN_LENS) + 1
    kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    s, c = blockagg.sorted_segment_sum_count(kt, vt, cells)
    g = grouped_stats(vt, kt, None, cells)
    torch.cuda.synchronize()
    assert np.array_equal(_u64(s)[1:], _u64(want))
    assert np.array_equal(_u64(g["sum"])[1:], _u64(want))
    assert c.cpu().tolist()[1:] == [float(n) for n in _RUN_LENS]


# a few cells of 1e5 rows and more (1-day buckets over 1 s scrapes hold
# 86,400 rows a cell), beside runs at the short/long threshold of 256 rows
# and 30-row runs that straddle the staged tiles
_LONG_RUN_LENS = [100_000, 86_400, 256, 257, 131_073, 3, 4096] + [30] * 250 + [257, 1]


@pytest.mark.parametrize("offset", [0, 5, 4095, 4397, SEG_TILE - 200, SEG_TILE + 3])
def test_segreduce_long_runs_match_plain_whatever_the_offset(dev, offset):
    """Few cells of many rows each, non-dyadic values with NaN and +-inf
    in one cell and masked rows, after `offset` rows of another cell:
    kernels B and C and grouped_stats give counts, min and max equal to
    their plain versions and every sum equal to `_fold` of its own rows,
    bitwise, at every offset."""
    from horaedb_tpu_torch.ops.aggregate import grouped_stats, grouped_stats_plain

    rng = np.random.default_rng(47)
    target = [rng.uniform(-1e3, 1e3, n) for n in _LONG_RUN_LENS]
    target[4][[7, 50_000, 131_072]] = [np.nan, np.inf, -np.inf]
    prefix = np.random.default_rng(offset).uniform(-1e3, 1e3, offset)
    k = np.concatenate([np.zeros(offset, np.int32)]
                       + [np.full(n, i + 1, np.int32) for i, n in enumerate(_LONG_RUN_LENS)])
    v = np.concatenate([prefix] + target)
    ok = np.random.default_rng(offset + 1).random(len(v)) > 0.1
    cells = len(_LONG_RUN_LENS) + 1
    kt, vt, okt = (torch.from_numpy(a).to(dev) for a in (k, v, ok))
    s, c = blockagg.sorted_segment_sum_count(kt, vt, cells)
    mn, mx = blockagg.sorted_segment_min_max(kt, vt, cells, valid=okt)
    pmn, pmx = blockagg.min_max_plain(kt, vt, okt, cells)
    g = grouped_stats(vt, kt, okt, cells)
    want = grouped_stats_plain(vt, kt, okt, cells)
    torch.cuda.synchronize()

    def same_sums(got, want):  # bitwise, and NaN where the other is NaN
        got, want = got.cpu().numpy()[1:], np.asarray(want)
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(_u64(got[~nan]), _u64(want[~nan]))

    def exact(got, want):
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=0, equal_nan=True)

    same_sums(s, [_fold(t) for t in target])
    assert c.cpu().tolist()[1:] == [float(n) for n in _LONG_RUN_LENS]
    exact(mn, pmn)
    exact(mx, pmx)
    starts = np.cumsum([offset] + _LONG_RUN_LENS)
    same_sums(g["sum"], [_fold(v[a:b][ok[a:b]]) if ok[a:b].any() else 0.0
                         for a, b in zip(starts[:-1], starts[1:])])
    for key in ("count", "min", "max"):
        exact(g[key], want[key])


def _lane_cases():
    """(name, sorted int32 ids, num_cells): the main path's 30-row runs over
    a few tiles with empty cells between them, long runs, ids out of range."""
    rng = np.random.default_rng(5)
    thirty = np.repeat(np.arange(0, 2 * 800, 2), 30).astype(np.int32)
    mixed = np.repeat(np.arange(400), rng.integers(1, 600, 400)).astype(np.int32)
    edges = np.concatenate([np.full(9, -2), np.arange(7000) // 7, np.full(30, 5000)])
    return [("runs of 30, empty cells between", thirty, 1600),
            ("runs of 1 to 600 rows", mixed, 400),
            ("ids out of range", edges.astype(np.int32), 1000)]


@pytest.mark.parametrize("case", range(3))
def test_absent_lanes_equal_lanes_of_ones_bitwise(dev, case):
    """Kernel B with no weights equals B with weights of ones, and kernel C
    with no valid mask equals C with an all-true one, bitwise (sums and
    counts as u64 views), on the card; and both equal their plain
    versions."""
    _, k, cells = _lane_cases()[case]
    v = np.random.default_rng(case).uniform(-1e3, 1e3, len(k))
    v[::97] = np.nan
    kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    ones, ok = torch.ones_like(vt), torch.ones(len(k), dtype=torch.bool, device=dev)
    pairs = [(blockagg.block_sum_count(kt, vt, cells),
              blockagg.block_sum_count(kt, vt, cells, weights=ones)),
             (blockagg.block_min_max(kt, vt, cells),
              blockagg.block_min_max(kt, vt, cells, valid=ok))]
    plain = [blockagg.sum_count_plain(kt.cpu(), vt.cpu(), ones.cpu(), cells),
             blockagg.min_max_plain(kt.cpu(), vt.cpu(), ok.cpu(), cells)]
    torch.cuda.synchronize()
    for (absent, given), want in zip(pairs, plain):
        for a, b, w in zip(absent, given, want):
            assert np.array_equal(_u64(a), _u64(b))
            torch.testing.assert_close(a.cpu(), w, rtol=1e-12, atol=0, equal_nan=True)


def _one_query(rng, num_series, num_buckets, bucket_ms, t0):
    """Rows of one downsample query sorted by (series, ts), uniform values."""
    per = rng.integers(0, 3 * num_buckets, num_series)
    sid = np.repeat(np.arange(num_series, dtype=np.int32), per)
    ts = t0 + rng.integers(0, num_buckets * bucket_ms, len(sid)).astype(np.int64)
    order = np.lexsort((ts, sid))
    return ts[order], sid[order], rng.uniform(0, 100, len(sid))


@pytest.mark.parametrize("lane", [0, 2, 15])
def test_stacked_equals_solo_bitwise(dev, lane):
    """One query through the solo route (downsample_sorted, kernels B and
    C) and through stacked_downsample in lane `lane` of 16 (a non-zero
    offset for lanes 2 and 15), among other queries and padding: every
    grid bitwise equal, sums as u64 views."""
    from horaedb_tpu_torch.ops.aggregate import downsample_sorted, stacked_downsample

    rng = np.random.default_rng(lane)
    S, T, bucket_ms, t0 = 100, 30, 60_000, 1_700_000_040_000
    ts, sid, vals = _one_query(rng, S, T, bucket_ms, t0)
    solo = downsample_sorted(ts, sid, vals, t0, bucket_ms, S, T, device=dev)
    B, R, spad = 16, 8192, 128
    ts_b = np.zeros((B, R), np.int64)
    sid_b = np.zeros((B, R), np.int32)
    val_b = np.zeros((B, R))
    ok_b = np.zeros((B, R), bool)
    t0_b = np.zeros(B, np.int64)
    for q in range(B):
        if q == lane:
            qt, qs, qv, qt0 = ts, sid, vals, t0
        else:
            qt0 = t0 + int(q) * bucket_ms
            qt, qs, qv = _one_query(rng, int(rng.integers(1, spad)), T, bucket_ms, qt0)
        n = len(qt)
        ts_b[q, :n], sid_b[q, :n], val_b[q, :n], ok_b[q, :n], t0_b[q] = qt, qs, qv, True, qt0
    got = stacked_downsample(*(torch.from_numpy(a).to(dev) for a in (ts_b, sid_b, val_b, ok_b,
                                                                       t0_b)),
                             bucket_ms, spad, T)
    torch.cuda.synchronize()
    for key in ("sum", "count", "min", "max", "mean"):
        assert np.array_equal(_u64(got[key][lane, :S]), _u64(solo[key])), key


def _stacked_cases():
    rng = np.random.default_rng(77)
    out = {}

    def lanes(B, R, S, T, fill=0.8):
        ts = rng.integers(-2 * 1000, (T + 2) * 1000, (B, R)).astype(np.int64)
        sid = rng.integers(-1, S + 1, (B, R)).astype(np.int32)
        v = rng.uniform(-1e3, 1e3, (B, R))
        ok = rng.random((B, R)) < fill
        t0 = rng.integers(-500, 500, B).astype(np.int64)
        return ts + t0[:, None], sid, v, ok, t0

    out["B=1"] = (*lanes(1, 4096, 40, 12), 40, 12)
    ts, sid, v, ok, t0 = lanes(16, 2048, 64, 30)
    ok[3:] = False  # empty lanes past the third
    out["B=16, empty lanes"] = (ts, sid, v, ok, t0, 64, 30)
    ts, sid, v, ok, t0 = lanes(4, 3000, 8, 5)
    ok[1] = False  # an all-masked lane
    v.flat[rng.choice(v.size, 30, replace=False)] = np.resize([np.nan, np.inf, -np.inf], 30)
    out["NaN, +-inf, a masked lane"] = (ts, sid, v, ok, t0, 8, 5)
    # long runs straddling 8- and 2048-row boundaries at odd lane offsets
    B, R = 3, 6151
    sid = np.zeros((B, R), np.int32)
    sid[:, 2500:] = 1
    ts = np.tile(np.arange(R, dtype=np.int64) % 1000, (B, 1))
    out["runs across tiles"] = (ts, sid, rng.uniform(0, 1, (B, R)), np.ones((B, R), bool),
                                np.zeros(B, np.int64), 2, 1)
    return out


@pytest.mark.parametrize("case", sorted(_stacked_cases()))
def test_stacked_downsample_matches_plain(dev, case):
    """Kernel against the plain version on CPU copies (each cell's rows
    summed in the kernel's association there): bitwise, sums as u64 views."""
    from horaedb_tpu_torch.ops.aggregate import stacked_downsample

    ts, sid, v, ok, t0, S, T = _stacked_cases()[case]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ts, sid, v, ok, t0)]
    got = stacked_downsample(*(a.to(dev) for a in args), 1000, S, T)
    want = stacked_downsample(*args, 1000, S, T)
    torch.cuda.synchronize()
    for key in ("sum", "count", "min", "max", "mean"):
        assert np.array_equal(_u64(got[key]), _u64(want[key])), key


def _interleave(cells: np.ndarray, rng) -> np.ndarray:
    """A row order that shuffles the cells of rows sorted by cell but keeps
    each cell's rows in their order: a stable sort by cell undoes it."""
    slot_cells = cells[rng.permutation(len(cells))]
    order = np.empty(len(cells), np.int64)
    order[np.argsort(slot_cells, kind="stable")] = np.arange(len(cells))
    return order


def _stacked_query(case: str, rng):
    """(ts, sid, vals, t0, S, T, bucket_ms) of one query in (series, ts)
    order, and the row order its stacked lane takes."""
    S, T, bucket_ms, t0 = 6, 4, 1000, 50_000
    if case.startswith("shuffled"):
        S, T = 40, 30
        ts, sid, vals = _one_query(rng, S, T, bucket_ms, t0)
    else:  # series 1's first cell holds 700 rows, with rows before t0 and past the grid
        parts = []
        for s_ in range(S):
            n_in = 700 if s_ == 1 else int(rng.integers(0, 90))
            ts = np.concatenate([rng.integers(t0 - 3000, t0, 37), rng.integers(t0, t0 + 1000, n_in),
                                 rng.integers(t0 + 1000, t0 + T * 1000, 40),
                                 rng.integers(t0 + T * 1000, t0 + 9000, 41)])
            parts.append((np.full(len(ts), s_, np.int32), np.sort(ts).astype(np.int64)))
        sid = np.concatenate([p[0] for p in parts])
        ts = np.concatenate([p[1] for p in parts])
        vals = rng.uniform(-1e3, 1e3, len(ts))
    if case.endswith("-0.0"):
        vals[sid == 2] = -0.0
    if "shuffled" in case:
        bucket = np.clip((ts - t0) // bucket_ms, -1, T)
        order = _interleave(sid.astype(np.int64) * (T + 2) + bucket + 1, rng)
    else:
        order = np.arange(len(ts))
    return ts, sid, vals, t0, S, T, bucket_ms, order


@pytest.mark.parametrize("case", ["shuffled", "long cell, out-of-grid rows",
                                  "long cell, out-of-grid rows, shuffled",
                                  "shuffled, a cell of -0.0"])
@pytest.mark.parametrize("lane", [0, 3])
def test_stacked_downsample_against_plain_and_solo(dev, case, lane):
    """One query in lane `lane` of 5 (the others random queries and
    padding) through stacked_downsample: bitwise equal (u64 views) to its
    solo downsample_sorted grids and, unless a cell's kept values are all
    -0.0 (the plain version sums them to +0.0; the kernels to -0.0, as the
    solo route does), to the plain version on CPU copies. Shuffled cases
    interleave the lane's cells (each cell's rows in order), so the sort's
    digit passes run instead of its presorted partition."""
    from horaedb_tpu_torch.ops.aggregate import stacked_downsample

    rng = np.random.default_rng(sum(map(ord, case)) + lane)
    ts, sid, vals, t0, S, T, bucket_ms, order = _stacked_query(case, rng)
    solo = downsample_sorted(ts, sid, vals, t0, bucket_ms, S, T, device=dev)
    B, R = 5, len(ts) + 257
    lanes = [np.zeros((B, R), np.int64), np.zeros((B, R), np.int32), np.zeros((B, R)),
             np.zeros((B, R), bool), np.full(B, t0, np.int64)]
    for q in range(B):
        if q == lane:
            rows = (ts[order], sid[order], vals[order])
        else:
            n = int(rng.integers(0, R))
            rows = (t0 + rng.integers(-2000, (T + 1) * bucket_ms, n),
                    rng.integers(-1, S + 1, n).astype(np.int32), rng.uniform(-1e3, 1e3, n))
        n = len(rows[0])
        for a, r in zip(lanes, rows):
            a[q, :n] = r
        lanes[3][q, :n] = rng.random(n) < 0.9 if q != lane else True
    host = [torch.from_numpy(a) for a in lanes]
    got = stacked_downsample(*(a.to(dev) for a in host), bucket_ms, S, T)
    want = stacked_downsample(*host, bucket_ms, S, T)
    torch.cuda.synchronize()
    for key in ("sum", "count", "min", "max", "mean"):
        assert np.array_equal(_u64(got[key][lane]), _u64(solo[key])), key
        if not case.endswith("-0.0"):
            assert np.array_equal(_u64(got[key]), _u64(want[key])), key
    if case.endswith("-0.0"):
        filled = solo["count"][2].cpu().numpy() > 0
        assert np.signbit(got["sum"][lane, 2].cpu().numpy()[filled]).all()


# -- the calibrated dispatcher, lane_sum_count and segment_last_value -----------

@pytest.fixture(scope="module", autouse=True)
def _agg_cache(tmp_path_factory):
    """The aggregation dispatcher's calibration file under a temp path."""
    import os

    from horaedb_tpu_torch.ops import agg_registry

    saved = os.environ.get("HORAEDB_AGG_CACHE")
    os.environ["HORAEDB_AGG_CACHE"] = str(tmp_path_factory.mktemp("agg") / "calib.json")
    agg_registry.reset_cache(memory_only=True)
    yield
    if saved is None:
        os.environ.pop("HORAEDB_AGG_CACHE", None)
    else:
        os.environ["HORAEDB_AGG_CACHE"] = saved
    agg_registry.reset_cache(memory_only=True)


def test_out_of_grid_rows_keep_solo_bitwise_equal_to_stacked(dev):
    """downsample_sorted drops rows outside the grid before kernel B, as the
    stacked lane does: a cell of 700 rows with 37 rows of its series before
    t0 ahead of it sums in the stacked association (sums as u64 views)."""
    from horaedb_tpu_torch.ops.aggregate import stacked_downsample

    rng = np.random.default_rng(5)
    S, T, bucket_ms, t0 = 2, 3, 1000, 10_000
    parts = []
    for s in range(S):
        ts = np.concatenate([rng.integers(t0 - 3000, t0, 37), rng.integers(t0, t0 + 1000, 700),
                             rng.integers(t0 + 1000, t0 + T * 1000, 300),
                             rng.integers(t0 + T * 1000, t0 + 9000, 41)])
        parts.append((np.full(len(ts), s, np.int32), np.sort(ts).astype(np.int64)))
    sid = np.concatenate([p[0] for p in parts])
    ts = np.concatenate([p[1] for p in parts])
    vals = rng.uniform(-1e3, 1e3, len(ts))
    solo = downsample_sorted(ts, sid, vals, t0, bucket_ms, S, T, device=dev)
    ok = np.ones(len(ts), bool)
    stacked = stacked_downsample(*(torch.from_numpy(a[None]).to(dev) for a in (ts, sid, vals, ok)),
                                 torch.tensor([t0], dtype=torch.int64, device=dev), bucket_ms,
                                 S, T)
    torch.cuda.synchronize()
    assert float(solo["count"][0, 0]) == 700.0
    for key in ("sum", "count", "min", "max", "mean"):
        assert np.array_equal(_u64(solo[key]), _u64(stacked[key][0])), key


def _lane_case(n, cells, weighted, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-3, cells + 3, n).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32) * 100
    w = (rng.random(n) > 0.3).astype(np.float32) if weighted else None
    return k, v, w


@pytest.mark.parametrize("n,cells,weighted", [(0, 16, False), (5, 16, True), (1003, 50, False),
                                              (262_144, 16_384, False),
                                              (262_147, 524_288, True)])
def test_lane_sum_count_matches_plain(dev, n, cells, weighted):
    """Counts exact; sums within 2^-20 x the cell's L1 mass (the kernel adds
    with f32 atomics, in no fixed order)."""
    from horaedb_tpu_torch.ops.aggregate import lane_segment_sum_count

    k, v, w = _lane_case(n, cells, weighted, n)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    wt = None if w is None else torch.from_numpy(w)
    s, c = lane_segment_sum_count(kt.to(dev), vt.to(dev), cells,
                                  w=None if wt is None else wt.to(dev))
    ps, pc = lane_segment_sum_count(kt, vt, cells, w=wt)
    torch.cuda.synchronize()
    assert s.dtype == c.dtype == torch.float32
    assert torch.equal(c.cpu(), pc)
    l1 = np.bincount(np.clip(k, 0, cells), weights=np.abs(v.astype(np.float64)),
                     minlength=cells + 1)[:cells]
    err = np.abs(s.cpu().numpy().astype(np.float64) - ps.numpy())
    assert np.all(err <= 2.0 ** -20 * l1)


def _calib_lane_case(klass: str, kind: str, weighted: bool):
    """The calibration stream of `klass` in `kind` order with 3 ids < 0, 4
    ids >= num_cells and 5 more rows (n % 8 = 5); sorted ids stay sorted."""
    from horaedb_tpu_torch.ops import agg_registry

    k, v, cells = agg_registry.calib_inputs(klass, kind)
    rng = np.random.default_rng(len(klass) * 10 + len(kind))
    extra = rng.integers(0, cells, 5).astype(np.int32)
    k = np.concatenate([np.array([-1, -7, -2**31], np.int32), k, extra,
                        np.array([cells, cells + 1, 2**31 - 1, cells], np.int32)])
    if kind == "sorted":
        k = np.sort(k)
    v = np.concatenate([v, rng.normal(size=12).astype(np.float32)])
    w = (rng.random(len(k)) > 0.3).astype(np.float32) if weighted else None
    return k, v, w, cells


def _lanes_within_budget(s, c, k, v, w, cells):
    """Counts equal to the plain version's; sums within 2^-20 x the cell's
    L1 mass of the plain version's."""
    from horaedb_tpu_torch.ops.aggregate import lane_sum_count_plain

    ps, pc = lane_sum_count_plain(torch.from_numpy(k), torch.from_numpy(v), cells,
                                  w=None if w is None else torch.from_numpy(w))
    assert s.dtype == c.dtype == torch.float32 and s.shape == c.shape == (cells,)
    assert torch.equal(c.cpu(), pc)
    l1 = np.bincount(np.clip(k, 0, cells), weights=np.abs(v.astype(np.float64)),
                     minlength=cells + 1)[:cells]
    err = np.abs(s.cpu().numpy().astype(np.float64) - ps.numpy().astype(np.float64))
    assert np.all(err <= 2.0 ** -20 * l1)


@pytest.mark.parametrize("klass", ["dense", "sparse"])
@pytest.mark.parametrize("kind", ["sorted", "unsorted"])
@pytest.mark.parametrize("weighted", [False, True])
def test_lane_sum_count_calibration_shapes_match_plain(dev, klass, kind, weighted):
    """2^18 + 12 rows into 16,384 or 524,288 cells, sorted and shuffled ids,
    ids < 0 (cell 0) and >= num_cells (dropped), an n % 8 tail."""
    from horaedb_tpu_torch.ops.aggregate import lane_segment_sum_count

    k, v, w, cells = _calib_lane_case(klass, kind, weighted)
    s, c = lane_segment_sum_count(torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev), cells,
                                  w=None if w is None else torch.from_numpy(w).to(dev))
    torch.cuda.synchronize()
    _lanes_within_budget(s, c, k, v, w, cells)


def _on_side_stream(dev, fn) -> list:
    """fn()'s tensors, computed under a new stream while the default stream
    sleeps and copied to pinned host memory on that stream; read before the
    default stream is done. Had a launch gone to the default stream, the
    copy would have read its output before it was written."""
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    with torch.cuda.stream(side):
        host = []
        for t in fn():
            host.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
            host[-1].copy_(t, non_blocking=True)
    side.synchronize()
    assert not torch.cuda.default_stream(dev).query()
    torch.cuda.synchronize()
    return host


def test_lane_sum_count_on_a_side_stream(dev):
    from horaedb_tpu_torch.ops.aggregate import lane_segment_sum_count

    k, v, w, cells = _calib_lane_case("dense", "sorted", True)
    kt, vt, wt = (torch.from_numpy(a).to(dev) for a in (k, v, w))
    s0, c0 = lane_segment_sum_count(kt, vt, cells, w=wt)
    s1, c1 = _on_side_stream(dev, lambda: lane_segment_sum_count(kt, vt, cells, w=wt))
    assert torch.equal(c1, c0.cpu())
    _lanes_within_budget(s1, c1, k, v, w, cells)


def test_lane_sum_count_on_a_device_that_is_not_current():
    """A launch on cuda:1 from a thread whose current device is cuda:0 goes
    to cuda:1."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from horaedb_tpu_torch.ops.aggregate import lane_segment_sum_count

    k, v, w, cells = _calib_lane_case("sparse", "unsorted", False)
    torch.cuda.set_device(0)
    other = torch.device("cuda", 1)
    s, c = lane_segment_sum_count(torch.from_numpy(k).to(other), torch.from_numpy(v).to(other),
                                  cells)
    torch.cuda.synchronize(other)
    assert s.device == c.device == other and torch.cuda.current_device() == 0
    _lanes_within_budget(s, c, k, v, w, cells)


def _slv_case(name):
    rng = np.random.default_rng(len(name))
    n, segs = 1_000_003, 300_000
    vals = rng.normal(size=n)
    vals[rng.choice(n, 60, replace=False)] = np.resize([np.nan, -0.0, np.inf, -np.inf], 60)
    index = rng.integers(-2, segs + 2, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    seq = rng.integers(0, 4, n).astype(np.uint64)  # many ties
    if name == "seq >= 2^63":
        seq = seq + np.uint64(2**63) - np.where(rng.random(n) > 0.5, np.uint64(2), np.uint64(0))
    elif name == "empty segments":
        segs = 4_000_000
    elif name == "all invalid":
        valid[:] = False
    elif name == "no rows":
        vals, seq, index, valid = vals[:0], seq[:0], index[:0], valid[:0]
    return vals, seq, index, valid, segs


@pytest.mark.parametrize("name", ["ties", "seq >= 2^63", "empty segments", "all invalid",
                                  "no rows"])
def test_segment_last_value_matches_plain_bitwise(dev, name):
    from horaedb_tpu_torch.ops.aggregate import seq_as_int64, segment_last_value

    vals, seq, index, valid, segs = _slv_case(name)
    args = [torch.from_numpy(a) for a in (vals, seq_as_int64(seq), index, valid)]
    got = segment_last_value(*(a.to(dev) for a in args), segs)
    want = segment_last_value(*args, segs)
    torch.cuda.synchronize()
    assert np.array_equal(_u64(got), _u64(want))


def _slv_edge(name: str, route: str):
    """(values, int64 seq, index, valid, segments) of an edge of the row
    pass, on the route `route`: "u32" keeps the kept seq range narrow, so
    every (seq, position) packs into a u32 key; "u64" widens it by 2^33
    (two kept rows at min + 2^33); "wide" past what packs into a u64 (one
    kept row of seq INT64_MAX, one of INT64_MIN)."""
    rng = np.random.default_rng(len(name) + len(route))
    if name == "1M rows into 1,000 segments":
        n, segs = 1_000_000, 1_000
        index = rng.integers(0, segs, n).astype(np.int32)
        seq = rng.integers(0, 50, n).astype(np.int64)
    elif name == "ties at the max seq over many blocks":
        n, segs = 600_000, 7
        index = rng.integers(0, segs, n).astype(np.int32)
        seq = np.where(rng.random(n) < 0.5, 9, rng.integers(0, 9, n)).astype(np.int64)
    elif name == "a lone row of seq INT64_MIN":  # at position 0: the pair (0, 1)
        n, segs = 1_000, 100
        index = np.full(n, 5, np.int32)
        index[0] = 60
        seq = -(2**63) + rng.integers(0, 5, n).astype(np.int64)
        seq[0] = -(2**63)
    else:  # a segment reached only by invalid rows
        n, segs = 20_000, 50
        index = rng.integers(0, segs, n).astype(np.int32)
        seq = rng.integers(0, 3, n).astype(np.int64)
    vals = rng.normal(size=n)
    valid = rng.random(n) > 0.05
    if name == "a segment reached only by invalid rows":
        index[:3] = 13
        valid[index == 13] = False
    valid[0] = name != "a segment reached only by invalid rows"
    spare = np.flatnonzero(valid & (index != 60))[1:3]
    if route == "wide":
        seq[spare] = [2**63 - 1, -(2**63)]
    elif route == "u64":
        seq[spare] = seq.min() + 2**33
    return vals, seq, index, valid, segs


@pytest.mark.parametrize("route", ["u32", "u64", "wide"])
@pytest.mark.parametrize("name", ["1M rows into 1,000 segments",
                                  "ties at the max seq over many blocks",
                                  "a lone row of seq INT64_MIN",
                                  "a segment reached only by invalid rows"])
def test_segment_last_value_edges_match_plain_bitwise(dev, name, route):
    """Each route of the row pass (the atomic max of u32 or u64 keys, the
    16-byte CAS) on the edges of its atomics, bitwise (u64 views) against
    the plain version on CPU copies."""
    from horaedb_tpu_torch.ops.aggregate import segment_last_value

    vals, seq, index, valid, segs = _slv_edge(name, route)
    args = [torch.from_numpy(a) for a in (vals, seq, index, valid)]
    got = segment_last_value(*(a.to(dev) for a in args), segs)
    want = segment_last_value(*args, segs)
    torch.cuda.synchronize()
    assert np.array_equal(_u64(got), _u64(want))
    if name == "a lone row of seq INT64_MIN":
        assert _u64(got)[60] == _u64(vals[:1])[0]
    if name == "a segment reached only by invalid rows":
        assert np.isnan(got[13].item())


def test_block_bf16_flag_matches_plain_bitwise(dev):
    """Kernel B with values rounded to bf16 on load against its plain
    version (torch's round-to-nearest-even f32 -> bf16), sums as u64 views."""
    rng = np.random.default_rng(12)
    k = np.sort(rng.integers(0, 3000, 200_000)).astype(np.int32)
    v = rng.normal(size=len(k)).astype(np.float32).astype(np.float64) * 1e3
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = blockagg.block_sum_count(kt.to(dev), vt.to(dev), 3000, bf16=True)
    want = blockagg.block_sum_count(kt, vt, 3000, bf16=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert np.array_equal(_u64(a), _u64(b))


def test_every_device_pin_gives_block_grids_on_f64(dev, monkeypatch):
    """On f64 values every device name runs kernel B (and C): grids bitwise
    equal to `block`'s; HORAEDB_AGG_IMPL=lanes launches no lane kernel."""
    from horaedb_tpu_torch import launch_counts
    from horaedb_tpu_torch.ops import agg_registry

    rng = np.random.default_rng(3)
    sid = np.repeat(np.arange(500, dtype=np.int32), 400)
    ts = np.tile(np.sort(rng.integers(-20_000, 320_000, 400)), 500).astype(np.int64)
    vals = rng.uniform(0, 100, len(ts))
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "block")
    want = downsample_sorted(ts, sid, vals, 0, 60_000, 500, 5, device=dev)
    for name in agg_registry.SORTED_IMPLS:
        if agg_registry.SORTED_IMPLS[name].kind != "device":
            continue
        monkeypatch.setenv("HORAEDB_AGG_IMPL", name)
        before = launch_counts()
        got = downsample_sorted(ts, sid, vals, 0, 60_000, 500, 5, device=dev)
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["lane_sum_count"] == before["lane_sum_count"], name
        assert after["block_sum_count"] == before["block_sum_count"] + 1, name
        for key in ("sum", "count", "min", "max", "mean"):
            assert np.array_equal(_u64(got[key]), _u64(want[key])), (name, key)


def test_cuda_calibration_times_every_device_impl(dev, monkeypatch):
    """A cold calibration on the card: every device implementation in `ab`,
    none rejected, no host lane eligible."""
    from horaedb_tpu_torch.ops import agg_registry

    monkeypatch.delenv("HORAEDB_AGG_IMPL", raising=False)
    monkeypatch.delenv("HORAEDB_SORTED_IMPL", raising=False)
    for kind, names in (("sorted", agg_registry.sorted_impl_names("cuda")),
                        ("unsorted", agg_registry.unsorted_impl_names("cuda"))):
        entry = agg_registry._calibrate(kind, dev, "dense")
        assert entry["rejected"] == {} and set(entry["ab"]) == set(names), entry
        assert not any(agg_registry.is_host_impl(x) for x in entry["ab"])


@pytest.mark.parametrize("var,name", [("HORAEDB_AGG_IMPL", "reduceat"),
                                      ("HORAEDB_SORTED_IMPL", "reduceat"),
                                      ("HORAEDB_UNSORTED_IMPL", "bincount")])
def test_host_pin_is_refused_on_the_card(dev, var, name, monkeypatch):
    """A pin naming a host lane raises for data on the card instead of
    copying it to the host: through `downsample_sorted` and through the
    reductions called with the name."""
    from horaedb_tpu_torch.common.error import HoraeError

    monkeypatch.delenv("HORAEDB_AGG_IMPL", raising=False)
    monkeypatch.setenv(var, name)
    k = torch.tensor([0, 0, 2], dtype=torch.int32, device=dev)
    v = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, device=dev)
    if name == "bincount":
        with pytest.raises(HoraeError, match="host lane"):
            blockagg.segment_sum_count(k, v, 3)
        return
    with pytest.raises(HoraeError, match="host lane"):
        downsample_sorted(np.array([0, 1, 2]), np.array([0, 0, 0]), np.array([1.0, 2.0, 3.0]),
                          0, 10, 1, 1, device=dev)
    with pytest.raises(HoraeError, match="host lane"):
        blockagg.sorted_segment_sum_count(k, v, 3, impl=name)
    with pytest.raises(HoraeError, match="host lane"):
        blockagg.sorted_segment_min_max(k, v, 3, impl=name)


# -- the mesh slice: grid_fold, sharded_downsample, multisegment_downsample,
# sample_sort_merge (several slots of one card) ----------------------------------

from horaedb_tpu_torch.ops import _build  # noqa: E402
from horaedb_tpu_torch.ops import mesh as mesh_ops  # noqa: E402
from horaedb_tpu_torch.parallel import merge as pmerge  # noqa: E402
from horaedb_tpu_torch.parallel import scan as pscan  # noqa: E402
from horaedb_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_downsample  # noqa: E402


def _edge_grids(rng, k: int, cells: int) -> dict:
    """k partial grids with NaN payloads, +-0.0, subnormals and infinities."""
    specials = np.array([0x7FF8000000000001, 0x7FF0000000000005, 0xFFF8000000000002,
                         0x8000000000000000, 0x0, 0x1, 0x800FFFFFFFFFFFFF, 0x0010000000000000,
                         0x7FF0000000000000, 0xFFF0000000000000], np.uint64).view(np.float64)
    out = {}
    for key in mesh_ops.FOLD_KEYS:
        a = rng.normal(size=(k, cells)) * 1e-300 if key == "sum" else rng.normal(size=(k, cells))
        hit = rng.random((k, cells)) < 0.3
        a[hit] = rng.choice(specials, int(hit.sum()))
        out[key] = a
    return out


@pytest.mark.parametrize("k,cells", [(1, 1), (1, 257), (2, 4096), (5, 30_001)])
def test_grid_fold_matches_plain_bitwise(dev, k, cells):
    grids = _edge_grids(np.random.default_rng(k * cells), k, cells)
    got = mesh_ops.grid_fold({key: torch.from_numpy(a).to(dev) for key, a in grids.items()})
    want = mesh_ops.grid_fold_plain({key: torch.from_numpy(a) for key, a in grids.items()})
    for key in mesh_ops.FOLD_KEYS:
        assert np.array_equal(_u64(got[key]), _u64(want[key])), key


def _fold_on_card(dev, grids: dict, offset: int = 0) -> dict:
    """grid_fold of `grids` on the card; with `offset`, each lane is a view
    `offset` doubles into a larger allocation (a misaligned base)."""
    lanes = {}
    for key, a in grids.items():
        t = torch.empty(a.size + offset, dtype=torch.float64, device=dev)
        t[offset:] = torch.from_numpy(a.reshape(-1)).to(dev)
        lanes[key] = t[offset:].view(a.shape)
    return mesh_ops.grid_fold(lanes)


@pytest.mark.parametrize("k,cells,offset,keys", [
    (3, 75_001, 0, 4), (4, 75_002, 0, 4), (4, 75_000, 1, 4), (8, 1_002, 0, 4),
    (9, 999, 0, 4), (12, 30_002, 1, 4), (6, 4_097, 0, 2), (2, 2, 1, 2)])
def test_grid_fold_vector_edges_match_plain_bitwise(dev, k, cells, offset, keys):
    """Odd cell counts (every other partial 8 bytes off 16), counts of 2 mod
    4, misaligned views, the unrolled k <= 8 and the loop past it, sum and
    count alone; NaN payloads, +-0.0, subnormals, infinities."""
    grids = _edge_grids(np.random.default_rng(k + cells + offset), k, cells)
    grids = {key: grids[key] for key in mesh_ops.FOLD_KEYS[:keys]}
    got = _fold_on_card(dev, grids, offset)
    want = mesh_ops.grid_fold_plain({key: torch.from_numpy(a) for key, a in grids.items()})
    assert list(got) == list(want)
    for key in got:
        assert got[key].shape == (cells,)
        assert np.array_equal(_u64(got[key]), _u64(want[key])), key


def test_grid_fold_at_the_slot_shape_matches_plain_bitwise(dev):
    """Phase 4's slot of the scatter-gather fold, [4, 2,500, 30]."""
    k, s, b = 4, 2_500, 30
    grids = {key: a.reshape(k, s, b) for key, a in
             _edge_grids(np.random.default_rng(2500), k, s * b).items()}
    got = _fold_on_card(dev, grids)
    want = mesh_ops.grid_fold_plain({key: torch.from_numpy(a) for key, a in grids.items()})
    for key in mesh_ops.FOLD_KEYS:
        assert got[key].shape == (s, b) and got[key].is_contiguous()
        assert np.array_equal(_u64(got[key]), _u64(want[key])), key


def test_grid_fold_on_a_side_stream_is_bitwise_the_default_streams(dev):
    grids = _edge_grids(np.random.default_rng(77), 4, 75_000)
    lanes = {key: torch.from_numpy(a).to(dev) for key, a in grids.items()}
    on_default = mesh_ops.grid_fold(lanes)
    on_side = _on_side_stream(dev, lambda: mesh_ops.grid_fold(lanes).values())
    for key, got in zip(mesh_ops.FOLD_KEYS, on_side):
        assert np.array_equal(_u64(got), _u64(on_default[key])), key


def test_grid_fold_keeps_subnormals_on_the_card(dev):
    mesh = make_mesh(4, series_parallel=2, devices=[dev] * 4)
    assert pmerge.device_fold_safe(mesh)


def _slot_lanes(rng, n: int, case: str, nan: bool = False):
    """One slot's lanes (ts, sid, vals, valid, mask or None) around the
    slice of 13 series from sid 17 (rows of other slices before and after
    it), sorted by (sid, ts) unless `case` says shuffled; `long` puts runs
    of thousands of rows in the 2 x 2 cells of series 17 and 18 (fold_long);
    -0.0 among the values, NaN too with `nan`, masked rows inside the
    runs."""
    if case == "long":
        sid = rng.integers(15, 20, n).astype(np.int32)
        ts = rng.integers(-3_000, 2 * 7_000, n).astype(np.int64)
    else:
        sid = rng.integers(-2, 40, n).astype(np.int32)
        ts = rng.integers(-5_000, 90_000, n).astype(np.int64)
    if case != "shuffled":
        order = np.lexsort((ts, sid))
        sid, ts = sid[order], ts[order]
    vals = rng.normal(size=n)
    if nan:
        vals[rng.random(n) < 0.01] = np.nan
    vals[rng.random(n) < 0.02] = -0.0
    valid = rng.random(n) > 0.1
    mask = (rng.random(n) > 0.3).astype(np.uint8) if case == "predicate" else None
    return [torch.from_numpy(a) for a in (ts, sid, vals, valid)] + [
        None if mask is None else torch.from_numpy(mask)]


def _parent_route(ts, sid, vals, valid, mask, t0, bucket_ms, lo, series, buckets,
                  sorted_input) -> dict:
    """The route the slot pass replaced, on the card: the cell keys, then
    kernels B and C over them (sorted rows) or grouped_stats over the
    clipped keys (values, weights) and over the dropping keys (min, max)."""
    from horaedb_tpu_torch.ops.aggregate import grouped_stats

    cells = series * buckets
    safe, flat, vm, w, ok = mesh_ops.sharded_keys_plain(ts, sid, vals, valid, mask, t0,
                                                        bucket_ms, lo, series, buckets)
    if mesh_ops.sorted_route(sorted_input, cells):
        s, c = blockagg.block_sum_count(safe, vm, cells, weights=w)
        mn, mx = blockagg.block_min_max(safe, vm, cells, valid=ok)
        return {"sum": s, "count": c, "min": mn, "max": mx}
    kc = torch.clamp(safe, 0, cells)
    g = grouped_stats(vm, flat, None, cells)
    return {"sum": grouped_stats(vm, kc, None, cells)["sum"],
            "count": grouped_stats(w, kc, None, cells)["sum"], "min": g["min"], "max": g["max"]}


@pytest.mark.parametrize("case,sorted_input,n", [
    ("sorted", True, 70_001), ("predicate", True, 70_001), ("long", True, 40_009),
    ("shuffled", False, 70_001), ("predicate", False, 70_001), ("long", False, 40_009),
    ("sorted", True, 0), ("shuffled", False, 1)])
def test_slot_pass_matches_plain_bitwise(dev, case, sorted_input, n):
    """The slot pass, sorted (one fold) and unsorted (one sort, one fold),
    against its plain version on CPU copies (where index_add_ folds in row
    order): a prime slice of 13 series x 12 buckets (or 2 x 2 with runs
    past 256 rows), a predicate's mask, -0.0 among the values, masked and
    foreign rows; and, with NaN among the values too, against the route it
    replaced on the same card tensors."""
    series, buckets = (2, 2) if case == "long" else (13, 12)
    for nan in (False, True):
        host = _slot_lanes(np.random.default_rng(n + len(case)), n, case, nan)
        lanes = [t if t is None else t.to(dev) for t in host]
        args = (1_000, 7_000, 17, series, buckets, sorted_input)
        before = _build.launch_counts()["sharded_downsample"]
        got = mesh_ops.slot_grids(*lanes, *args)
        assert _build.launch_counts()["sharded_downsample"] == before + 1
        want = _parent_route(*lanes, *args) if nan else mesh_ops.slot_grids_plain(*host, *args)
        for key in mesh_ops.FOLD_KEYS:
            assert got[key].shape == (series * buckets,)
            assert np.array_equal(_u64(got[key]), _u64(want[key])), (key, nan)


@pytest.mark.parametrize("sorted_input", [True, False])
def test_slot_pass_on_a_side_stream_is_bitwise_the_default_streams(dev, sorted_input):
    lanes = [t if t is None else t.to(dev)
             for t in _slot_lanes(np.random.default_rng(3), 200_003, "predicate", nan=True)]
    args = (*lanes, 1_000, 7_000, 17, 13, 12, sorted_input)
    on_default = mesh_ops.slot_grids(*args)
    on_side = _on_side_stream(dev, lambda: mesh_ops.slot_grids(*args).values())
    for key, got in zip(mesh_ops.FOLD_KEYS, on_side):
        assert np.array_equal(_u64(got), _u64(on_default[key])), key


def test_slot_pass_writes_into_given_grids(dev):
    """`out` views of one stacked buffer (the fold's) receive the grids; the
    unsorted pass without min and max writes sum and count only."""
    host = _slot_lanes(np.random.default_rng(4), 30_011, "shuffled")
    lanes = [t if t is None else t.to(dev) for t in host]
    stacked = torch.full((2, 2, 13 * 12), 7.0, dtype=torch.float64, device=dev)
    out = {"sum": stacked[0, 1], "count": stacked[1, 1]}
    got = mesh_ops.slot_grids(*lanes, 1_000, 7_000, 17, 13, 12, False, with_minmax=False,
                              out=out)
    want = mesh_ops.slot_grids_plain(*host, 1_000, 7_000, 17, 13, 12, False, with_minmax=False)
    assert list(got) == ["sum", "count"] and got["sum"].data_ptr() == stacked[0, 1].data_ptr()
    for key in ("sum", "count"):
        assert np.array_equal(_u64(got[key]), _u64(want[key])), key
    assert bool((stacked[:, 0] == 7.0).all())


def _grids_equal(got: dict, want: dict) -> None:
    for key in ("sum", "count", "min", "max"):
        assert np.array_equal(_u64(got[key]), _u64(want[key])), key


@pytest.mark.parametrize("num_series,sorted_input", [(7, True), (13, True), (13, False)])
def test_sharded_downsample_matches_plain_on_prime_series(dev, num_series, sorted_input,
                                                          monkeypatch):
    """Four slots of one card (rows 2 x series 2): prime series counts pad
    the series axis; kernel and plain grids are bitwise equal."""
    mesh = make_mesh(4, series_parallel=2, devices=[dev] * 4)
    rng = np.random.default_rng(num_series)
    n = 20_011
    sid = rng.integers(0, num_series, n).astype(np.int32)
    ts = rng.integers(-2_000, 60_000, n).astype(np.int64)
    if sorted_input:
        order = np.lexsort((ts, sid))
        sid, ts = sid[order], ts[order]
    vals = rng.normal(size=n)
    padded = num_series + 1
    host_lanes = (ts, sid, vals, np.ones(n, bool))
    pads = (0, padded, 0, False)
    lanes, _ = pscan.shard_rows(mesh, host_lanes, pad_value=pads)
    got = pscan.sharded_downsample(mesh, *lanes, 0, 5_000, padded, 12, sorted_input=sorted_input)
    # the step on CPU slots runs every kernel's plain version (index_add_
    # folds in row order there); the pin keeps the dispatcher off the host
    # reduceat lane
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "block")
    cpu_mesh = make_mesh(4, series_parallel=2, devices=["cpu"] * 4)
    cpu_lanes, _ = pscan.shard_rows(cpu_mesh, host_lanes, pad_value=pads)
    want = pscan.sharded_downsample(cpu_mesh, *cpu_lanes, 0, 5_000, padded, 12,
                                    sorted_input=sorted_input)
    _grids_equal(got, want)
    host = mesh_downsample(cpu_mesh, ts, sid, vals, 0, 5_000, num_series, 12,
                           sorted_input=sorted_input)
    assert np.array_equal(got["count"].cpu().numpy()[:num_series], host["count"])


def test_multisegment_downsample_matches_plain(dev):
    def mesh3(d):
        slots = np.empty(8, dtype=object)
        slots[:] = [d] * 8
        return Mesh(slots.reshape(2, 2, 2), ("seg", "rows", "series"))

    rng = np.random.default_rng(5)
    lanes = [torch.from_numpy(a) for a in (
        rng.integers(0, 80_000, (2, 10_000)).astype(np.int64),
        rng.integers(0, 16, (2, 10_000)).astype(np.int32),
        rng.normal(size=(2, 10_000)), rng.random((2, 10_000)) > 0.2)]
    t0 = np.array([0, 3_000], np.int64)
    got = pscan.build_multisegment_downsample(mesh3(dev), 16, 8)(
        *[t.to(dev) for t in lanes], t0, 10_000)
    want = pscan.build_multisegment_downsample(mesh3(torch.device("cpu")), 16, 8)(
        *lanes, t0, 10_000)
    _grids_equal(got, want)


def _packed_case(rng, case: str, n: int, seq_width: int = 8,
                 key_bits: int | None = None) -> np.ndarray:
    if key_bits is None:
        grp = rng.integers(0, 9_000, n).astype(np.uint64)
    else:  # groups over the whole key, its largest among them
        grp = rng.integers(0, 2**(key_bits - seq_width), n).astype(np.uint64)
        grp[:1] = 2**(key_bits - seq_width) - 1
    if case == "skew":
        grp[: n * 9 // 10] = 5
    elif case == "single":
        grp[:] = 77
    seq = rng.integers(0, 1 << seq_width, n).astype(np.uint64)
    packed = (grp << np.uint64(seq_width)) | seq
    packed[rng.random(n) < 0.15] = pmerge._SENTINEL
    if case == "sentinel":
        packed[:] = pmerge._SENTINEL
    return packed


@pytest.mark.parametrize("case", ["random", "skew", "single", "sentinel"])
@pytest.mark.parametrize("do_dedup", [True, False])
@pytest.mark.parametrize("key_bits", [None, 42, 63])
def test_sample_sort_merge_matches_packed_merge(dev, case, do_dedup, key_bits):
    """Eight slots of one card, keys of the plan's own width and of 42 and
    63 bits (6 and 8 digit sweeps a step): the survivors equal kernel D's
    bytewise and the plain version's."""
    from horaedb_tpu_torch.backend import u64_to_i64

    mesh = make_mesh(8, series_parallel=2, devices=[dev] * 8)
    packed = _packed_case(np.random.default_rng(21), case, 200_003, key_bits=key_bits)
    got = pmerge.sharded_packed_merge(packed, 8, do_dedup, mesh, key_bits=key_bits)
    idx, cnt = merge.packed_merge(torch.from_numpy(u64_to_i64(packed)).to(dev), 63, 8, do_dedup)
    assert np.array_equal(got, idx[: int(cnt.item())].cpu().numpy().astype(np.int64))
    assert np.array_equal(got, pmerge.sharded_packed_merge_plain(packed, 8, do_dedup, mesh))


# -- the default device ------------------------------------------------------------

DD_SEGMENT_MS = 2 * 3600 * 1000
DD_T0 = 40 * DD_SEGMENT_MS
DD_SERIES = 1 << 17  # the packed pass declines at 2^17 series: the fused route


def _default_device_batches(pa, seed: int = 5):
    """One segment of writes touching 300 of 2^17 series: three shuffled
    batches and a re-send, rows of a second metric and NaN values."""
    rng = np.random.default_rng(seed)
    tsids = np.unique(rng.integers(0, 2**64 - 1, 2 * DD_SERIES, dtype=np.uint64, endpoint=True))
    tsids = np.sort(rng.choice(tsids, DD_SERIES, replace=False))
    used = np.sort(rng.choice(DD_SERIES, 300, replace=False))
    n = 3000
    sid = used[rng.integers(0, len(used), n)]
    ts = DD_T0 + rng.integers(0, DD_SEGMENT_MS // 60_000, n) * 60_000
    metric = np.where(rng.random(n) < 0.05, 2, 1).astype(np.uint64)
    values = rng.normal(size=n) * 10
    values[rng.choice(n, 4, replace=False)] = np.nan
    schema = pa.schema([("metric_id", pa.uint64()), ("tsid", pa.uint64()),
                        ("field_id", pa.uint64()), ("ts", pa.int64()), ("value", pa.float64())])
    rows = rng.permutation(n)
    batches = [pa.RecordBatch.from_pydict(
        {"metric_id": metric[part], "tsid": tsids[sid[part]],
         "field_id": np.zeros(len(part), np.uint64), "ts": ts[part],
         "value": values[part] if i < 3 else rng.normal(size=len(part))}, schema=schema)
        for i, part in enumerate(np.array_split(rows, 3) + [rows[: n // 10]])]
    return schema, tsids, tsids[used[::3]], batches


async def _default_device_reads(pa, device_kw: dict) -> dict:
    """The InSet raw scan on the device route (kernels E and F) and the
    fused downsample over all 2^17 series (scan_kernel), on storage opened
    with `device_kw`; the launches each made."""
    from horaedb_tpu_torch import launch_counts, reset_launch_counts
    from horaedb_tpu_torch.engine_query import query_downsample
    from horaedb_tpu_torch.objstore import MemStore
    from horaedb_tpu_torch.storage import ObjectBasedStorage, ScanRequest, TimeRange, WriteRequest

    schema, tsids, subset, batches = _default_device_batches(pa)
    st = await ObjectBasedStorage.try_new("db", MemStore(), schema, 4, DD_SEGMENT_MS,
                                          enable_compaction_scheduler=False,
                                          start_background_merger=False, **device_kw)
    try:
        seg = TimeRange(DD_T0, DD_T0 + DD_SEGMENT_MS)
        for b in batches:
            await st.write(WriteRequest(b, seg))
        pred = F.And(F.InSet("tsid", tuple(int(t) for t in subset)),
                     F.time_range_pred("ts", DD_T0 + 600_000, DD_T0 + DD_SEGMENT_MS - 600_000))
        reset_launch_counts()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HORAEDB_SCAN_PATH", "device")
            scan = pa.Table.from_batches(
                [b async for b in st.scan(ScanRequest(seg, predicate=pred))])
        scan_launches = launch_counts()
        fpred = F.And(F.Compare("metric_id", "eq", 1),
                      F.time_range_pred("ts", seg.start, seg.end))
        reset_launch_counts()
        grids = await query_downsample(st, tsids, seg, 30 * 60_000, fpred)
        return {"scan": scan, "grids": grids, "scan_launches": scan_launches,
                "fused_launches": launch_counts(), "device": st._device}
    finally:
        await st.close()


def test_default_device_storage_equals_cuda0_bitwise(dev, monkeypatch):
    """Storage opened with the default device (a bare "cuda") keeps the
    current device with its index, and its InSet raw scan and fused
    downsample equal those of storage opened on cuda:0, bitwise."""
    import asyncio

    import pyarrow as pa

    monkeypatch.setenv("HORAEDB_AGG_IMPL", "block")
    got = asyncio.run(_default_device_reads(pa, {}))
    want = asyncio.run(_default_device_reads(pa, {"device": torch.device("cuda", 0)}))
    assert got["device"] == dev == want["device"]
    assert got["scan_launches"]["index_merge_filter"] > 0
    assert got["fused_launches"]["scan_kernel"] > 0
    assert got["scan"].num_rows > 0 and got["scan"].schema == want["scan"].schema
    pairs = [(got["scan"].column(c).to_numpy(), want["scan"].column(c).to_numpy())
             for c in want["scan"].column_names]
    pairs += [(np.asarray(got["grids"][k]), np.asarray(w)) for k, w in want["grids"].items()]
    for a, b in pairs:  # raw bits: NaN payloads and -0.0 too
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
