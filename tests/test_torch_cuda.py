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


def test_downsample_is_bitwise_repeatable(dev):
    rng = np.random.default_rng(5)
    sid = np.repeat(np.arange(300), 700).astype(np.int32)
    ts = np.tile(np.arange(700) * 10_000, 300).astype(np.int64)
    v = rng.uniform(0, 100, len(ts))
    a = downsample_sorted(ts, sid, v, 0, 300_000, 300, 24, device=dev)
    b = downsample_sorted(ts, sid, v, 0, 300_000, 300, 24, device=dev)
    for key in a:
        assert torch.equal(a[key].view(torch.int64), b[key].view(torch.int64))
