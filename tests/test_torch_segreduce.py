"""A numpy model of segreduce.cuh's tile, on the CPU.

Kernels B (`block_sum_count`), C (`block_min_max`) and grouped_stats'
reduction share `ops/csrc/segreduce.cuh`, which cannot run here. The model
below repeats its `run_kernel` step by step: which thread owns which run
(heads flagged from neighbouring staged ids, a run ended by the thread's
next head, else the first head a later thread publishes, else the halo),
which runs go to the block-wide long fold, and the association of every
fold. It reads the kernel's constants from the header itself. The model's
grids are held bitwise against `fold_sums`, the plain versions and the JAX
package, with every cell stored by exactly one thread; a bank model of the
staged layout holds a warp's shared-memory reads at most 2-way conflicted
where the header says they are. The wrappers' absent lanes (no weights, no
valid mask) are held bitwise against lanes of ones on the CPU route.
"""

import re
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horaedb_tpu.ops import blockagg as jblock
from horaedb_tpu_torch.ops import blockagg

HEADER = Path(blockagg.__file__).resolve().parent / "csrc" / "segreduce.cuh"


def _header_constants() -> dict:
    """segreduce.cuh's namespace-level `constexpr int NAME = expr;` values."""
    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", HEADER.read_text(), re.M):
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))
    return out


C = _header_constants()
THREADS, ITEMS, TILE, LONG = C["THREADS"], C["ITEMS"], C["TILE"], C["LONG"]
ROWS, SLOTS, CHUNK, ROUND, NONE = C["ROWS"], C["SLOTS"], C["CHUNK"], C["ROUND"], C["NONE"]
WARPS = THREADS // 32


def test_header_constants_are_the_ones_the_model_assumes():
    assert (TILE, ROWS, ROUND) == (THREADS * ITEMS, TILE + C["HALO"], THREADS * CHUNK)
    assert ITEMS % 2 == 1 and C["HALO"] >= LONG and ROWS % 16 == 0
    assert (blockagg.LONG_RUN, blockagg.CHUNK) == (LONG, CHUNK)


class Grid:
    """The cells a model run stores, and how often each is stored."""

    def __init__(self, identity):
        self.cells, self.writes, self.identity = {}, Counter(), identity

    def store(self, cell: int, acc) -> None:
        self.cells[cell] = acc
        self.writes[cell] += 1

    def lanes(self, m: int) -> list[np.ndarray]:
        return [np.array([self.cells.get(c, self.identity)[i] for c in range(m)])
                for i in range(len(self.identity))]


def fold_long(k, n: int, head: int, load, combine, grid: Grid) -> None:
    """segreduce.cuh's fold_long: chunks of CHUNK rows from the head, groups
    of 32 chunk partials, then the group partials, each left to right,
    round after round of ROUND rows."""
    key = k[head]
    acc = None
    base = head
    while True:
        parts = []
        for t in range(THREADS):
            p = None
            for q in range(base + t * CHUNK, base + (t + 1) * CHUNK):
                if q < n and k[q] == key:
                    p = load(q) if p is None else combine(p, load(q))
            parts.append(p)
        for w in range(WARPS):
            g = None
            for p in parts[32 * w:32 * w + 32]:
                if p is None:
                    break
                g = p if g is None else combine(g, p)
            if g is None:
                break
            acc = g if acc is None else combine(acc, g)
        nxt = base + ROUND
        if not (nxt < n and k[nxt] == key):
            break
        base = nxt
    grid.store(int(key), acc)


def run_tile(k, ts: int, num_cells: int, load, combine, grid: Grid, owners: dict) -> None:
    """One block of run_kernel over the tile at row `ts`; `owners` maps each
    run folded by one thread to (tile, thread), and each long run to
    (tile, "block")."""
    n = len(k)
    length, cnt = min(TILE, n - ts), min(ROWS, n - ts)
    ks = k[ts:ts + cnt]  # the staged ids: the tile and its halo
    heads, first = [], []
    for t in range(THREADS):
        r0 = t * ITEMS
        mine = [r for r in range(r0, min(r0 + ITEMS, length))
                if (ks[r] != (ks[r - 1] if r > 0 else k[ts - 1]) if ts + r > 0 else True)]
        heads.append(mine)
        first.append(mine[0] if mine else NONE)
    longs = [-1] * SLOTS
    for t, mine in enumerate(heads):
        for i, h in enumerate(mine):
            key = ks[h]
            if not 0 <= key < num_cells:
                continue
            end, is_long = NONE, False
            if i + 1 < len(mine):
                end = mine[i + 1]
            else:
                u = t + 1
                while True:
                    lo = u * ITEMS
                    if lo >= length:
                        break
                    if lo - h > LONG:
                        is_long = True
                        break
                    if first[u] != NONE:
                        end = first[u]
                        break
                    u += 1
                if end == NONE and not is_long:
                    end = length
                    while end < cnt and end - h <= LONG and ks[end] == key:
                        end += 1
            if is_long or end - h > LONG:
                assert longs[h // LONG] == -1, "two long heads in one slot"
                longs[h // LONG] = h
                continue
            assert end <= cnt, "a short run read past the staged rows"
            acc = load(ts + h)
            for p in range(ts + h + 1, ts + end):
                acc = combine(acc, load(p))
            grid.store(int(key), acc)
            owners[ts + h] = (ts // TILE, t)
    for h in longs:
        if h >= 0:
            fold_long(k, n, ts + h, load, combine, grid)
            owners[ts + h] = (ts // TILE, "block")


def model(k, num_cells: int, load, combine, identity):
    """run_kernel over every tile: (the grid's lanes, write counts, owners)."""
    grid, owners = Grid(identity), {}
    for ts in range(0, len(k), TILE):
        run_tile(k, ts, num_cells, load, combine, grid, owners)
    return grid.lanes(num_cells), grid.writes, owners


def sum_count_model(k, v, w, num_cells: int):
    def load(i):
        return (float(v[i]), 1.0 if w is None else float(w[i]))

    def combine(x, y):
        return (x[0] + y[0], x[1] + y[1])

    return model(k, num_cells, load, combine, (0.0, 0.0))


def nan_min(x, y):
    return x if x != x else y if y != y else (y if y < x else x)


def nan_max(x, y):
    return x if x != x else y if y != y else (y if y > x else x)


def min_max_model(k, v, valid, num_cells: int):
    def load(i):
        x = float(v[i])
        return (x, x) if valid is None or valid[i] else (np.inf, -np.inf)

    def combine(x, y):
        return (nan_min(x[0], y[0]), nan_max(x[1], y[1]))

    return model(k, num_cells, load, combine, (np.inf, -np.inf))


def _runs(lengths, first_id: int = 0, gap: int = 0) -> np.ndarray:
    """Sorted ids: run i of lengths[i] rows, ids first_id + i * (gap + 1)."""
    ids = first_id + np.arange(len(lengths)) * (gap + 1)
    return np.repeat(ids, lengths).astype(np.int32)


def _cases():
    rng = np.random.default_rng(13)
    # 30-row runs from row 0: a run crosses thread 0's rows into thread 1's
    # (ITEMS is 13) and, every TILE rows, a tile's end into its halo
    thirty = _runs([30] * (2 * TILE // 30 + 3))
    k_edges = _runs([1, 30, 255, 256, 257, 3, LONG + 40, 1, 30], gap=2)
    mixed = _runs(rng.integers(1, 70, 260))
    # a long run whose head lies in the last rows of a tile, and one of more
    # than ROUND rows (two rounds of the block's fold)
    across = np.concatenate([_runs([TILE - 20]), _runs([300, ROUND + 500, 7], first_id=1)])
    oob = np.concatenate([np.full(40, -3), np.full(9, -1), _runs([5, 300, 30], first_id=0),
                          np.full(50, 7), np.full(20, 2**30)]).astype(np.int32)
    return {
        "runs of 30, across threads and tiles": (thirty, int(thirty[-1]) + 1),
        "runs of 1, 30, 255, 256, 257 rows, gaps of empty cells": (k_edges,
                                                                  int(k_edges[-1]) + 4),
        "random short runs across tiles": (mixed, int(mixed[-1]) + 1),
        "long runs across a tile and over two rounds": (across, int(across[-1]) + 1),
        "negative ids and ids >= num_cells": (oob, 5),
        "no rows": (np.zeros(0, np.int32), 6),
        "one cell": (np.zeros(40, np.int32), 1),
    }


CASES = _cases()


def _lanes(k, seed: int):
    rng = np.random.default_rng(seed)
    n = len(k)
    v = rng.uniform(-1e3, 1e3, n)  # sums that depend on the association
    valid = rng.random(n) > 0.15
    some = min(n, 6)
    v[rng.choice(n, some, replace=False)] = np.resize([np.nan, np.inf, -np.inf, -0.0], some)
    return v, valid


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64)).view(np.uint64)


def _written_once(writes: Counter, k, num_cells: int) -> None:
    have = {int(x) for x in k if 0 <= x < num_cells}
    assert set(writes) == have, "a cell with rows was not stored, or an empty one was"
    assert set(writes.values()) <= {1}, "a cell was stored twice"


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("weighted", [False, True])
def test_sum_count_model_is_the_plain_fold_bitwise(case, weighted):
    k, m = CASES[case]
    v, valid = _lanes(k, 1)
    v = np.where(np.isfinite(v), v, 0.0)  # finite sums: compared bit for bit
    w = valid.astype(np.float64) if weighted else None
    if weighted:
        v = np.where(valid, v, 0.0)
    (s, c), writes, _ = sum_count_model(k, v, w, m)
    _written_once(writes, k, m)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    wt = torch.ones_like(vt) if w is None else torch.from_numpy(w)
    ps, pc = blockagg.sum_count_plain(kt, vt, wt, m)
    keep = (kt >= 0) & (kt < m)
    np.testing.assert_array_equal(_bits(s), _bits(ps.numpy()))
    np.testing.assert_array_equal(_bits(s), _bits(blockagg.fold_sums(vt[keep],
                                                                     kt[keep].long(), m)))
    np.testing.assert_array_equal(_bits(c), _bits(pc.numpy()))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_min_max_model_is_the_plain_version(case, masked):
    k, m = CASES[case]
    v, valid = _lanes(k, 2)
    (mn, mx), writes, _ = min_max_model(k, v, valid if masked else None, m)
    _written_once(writes, k, m)
    ok = torch.from_numpy(valid if masked else np.ones(len(k), bool))
    pmn, pmx = blockagg.min_max_plain(torch.from_numpy(k), torch.from_numpy(v), ok, m)
    np.testing.assert_array_equal(mn, pmn.numpy())
    np.testing.assert_array_equal(mx, pmx.numpy())


def test_runs_are_owned_by_the_thread_of_their_head():
    """30-row runs: the thread whose ITEMS rows hold the head folds the run,
    and the tile's last run, which crosses into the next tile, stays with
    its tile; runs of more than LONG rows go to the block."""
    k, m = CASES["runs of 30, across threads and tiles"]
    _, _, owners = sum_count_model(k, np.ones(len(k)), None, m)
    for head, (tile, thread) in owners.items():
        assert (tile, thread) == (head // TILE, head % TILE // ITEMS)
    crossing = [h for h in owners if h // TILE != (h + 29) // TILE]
    assert crossing, "no run crosses a tile's end"
    k, m = CASES["runs of 1, 30, 255, 256, 257 rows, gaps of empty cells"]
    _, _, owners = sum_count_model(k, np.ones(len(k)), None, m)
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    lengths = np.diff(np.r_[starts, len(k)])
    for head, n in zip(starts, lengths):
        assert (owners[head][1] == "block") == (n > LONG), (head, n)


# -- the staged layout's banks ------------------------------------------------

def conflicts(addrs: list[int], width: int) -> int:
    """The most distinct words one shared-memory bank serves in one
    warp-wide load of `width`-byte elements at byte offsets `addrs` (one per
    active thread; 1 = conflict-free). 8-byte loads go as two half-warps,
    each over 16 banks of 8 bytes; narrower ones over 32 banks of 4 bytes."""
    if width == 8:
        halves = [addrs[:16], addrs[16:]]
        return max((max(Counter((a // 8) % 16 for a in set(x // 8 * 8 for x in h)).values(),
                        default=1) for h in halves), default=1)
    words = {a // 4 for a in addrs}
    return max(Counter(w % 32 for w in words).values(), default=1)


def lane_offsets(widths: list[int]) -> list[int]:
    """Byte offsets of the ids and each present lane in the staged block."""
    out, off = [], ROWS * 4
    for w in widths:
        out.append(off)
        off += ROWS * w
    return [0] + out


def test_staged_lanes_start_on_bank_zero():
    """Every staged region starts at a multiple of 128 bytes, so a row's
    bank depends on the row alone (the bank model below takes row * width)."""
    for widths in ([8, 8], [8], [8, 1], [8]):
        assert all(off % 128 == 0 for off in lane_offsets(widths))


def test_head_flags_and_one_row_runs_read_distinct_banks():
    """Each thread reads its own ITEMS rows (the head flags' ids; runs of
    one row fold one row each): stride ITEMS, odd, so no conflict for the
    4 B ids or the 8 B lanes; the 1 B mask's bytes share words, at most 2
    on one bank."""
    for j in range(ITEMS):
        for warp in range(WARPS):
            rows = [(warp * 32 + lane) * ITEMS + j for lane in range(32)]
            assert conflicts([4 * r for r in rows], 4) == 1
            assert conflicts([8 * r for r in rows], 8) == 1
            assert conflicts([r for r in rows], 1) <= 2


def _fold_reads(run: int, phase: int, step: int) -> dict[int, list[int]]:
    """Rows each warp's threads read at `step` of their first run's fold,
    runs of `run` rows whose heads sit at rows = phase (mod run)."""
    out = {}
    for warp in range(WARPS):
        rows = []
        for lane in range(32):
            r0 = (warp * 32 + lane) * ITEMS
            heads = [h for h in range(r0, r0 + ITEMS) if h % run == phase % run]
            if heads and step < run:
                rows.append(heads[0] + step)
        out[warp] = rows
    return out


@pytest.mark.parametrize("phase", range(0, 30, 7))
def test_main_path_runs_fold_at_most_2_way_conflicted(phase):
    """The main path's 30-row runs (5-minute buckets of 10 s scrapes), at
    any offset from the tile: a warp folding them reads the 8 B lanes and
    the 4 B ids on at most 2-way conflicted banks (the ids only at a
    head)."""
    for step in range(30):
        for rows in _fold_reads(30, phase, step).values():
            assert conflicts([8 * r for r in rows], 8) <= 2
            assert conflicts([4 * r for r in rows], 4) <= 2
            assert conflicts([r for r in rows], 1) <= 2


# -- the wrappers' absent lanes ------------------------------------------------

@pytest.fixture
def _pin_scatter(monkeypatch):
    monkeypatch.setenv("HORAEDB_AGG_IMPL", "scatter")


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_weights_is_weights_of_ones_bitwise(case, _pin_scatter):
    k, m = CASES[case]
    v, _ = _lanes(k, 3)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    s, c = blockagg.block_sum_count(kt, vt, m)
    s1, c1 = blockagg.block_sum_count(kt, vt, m, weights=torch.ones_like(vt))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s1.numpy()))
    np.testing.assert_array_equal(_bits(c.numpy()), _bits(c1.numpy()))
    # and the JAX package's w=None on the same in-range rows (it clips ids)
    keep = (k >= 0) & (k < m)
    js, jc = jblock.sorted_segment_sum_count(jnp.asarray(k[keep]), jnp.asarray(v[keep]), m)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-12, atol=0, equal_nan=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_valid_is_all_valid_bitwise(case, _pin_scatter):
    k, m = CASES[case]
    v, _ = _lanes(k, 4)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = blockagg.block_min_max(kt, vt, m)
    want = blockagg.block_min_max(kt, vt, m, valid=torch.ones(len(k), dtype=torch.bool))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
    keep = (k >= 0) & (k < m)
    jmn, jmx = jblock.sorted_segment_min_max(jnp.asarray(k[keep]), jnp.asarray(v[keep]), m)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jmx))
