"""The port's partial-grid codec and canonical fold against the JAX
package's, on the CPU.

- the wire: the port's bytes equal the JAX package's for the same parts,
  and each package decodes the other's, bit for bit (NaN payloads, -0.0);
- numpy's element rules of `np.add.at` / `np.minimum.at` /
  `np.maximum.at`, derived here, are the rules `grid_fold.cu` and its
  plain version follow (a NaN operand wins: in the sum the partial's
  first, quieted; in min/max the accumulator's first, not quieted; on a
  +-0.0 tie min/max take the partial);
- `merge_grids` / `merge_partials` with a mesh of CPU slots (the grid
  fold's plain version) bitwise equal to the port's host fold and to the
  JAX package's host fold, with NaN payloads, +-0.0 and subnormals. The
  JAX device fold is not the oracle: XLA:CPU flushes subnormals.
"""

import numpy as np
import pytest
import torch

from horaedb_tpu.cluster import partial as jpartial
from horaedb_tpu_torch.cluster import partial as ppartial
from horaedb_tpu_torch.ops import mesh as mesh_ops
from horaedb_tpu_torch.parallel import merge as pmerge
from horaedb_tpu_torch.parallel.mesh import make_mesh

SPECIALS = np.array([0x7FF8000000000001, 0x7FF0000000000005, 0xFFF8000000000002,
                     0x8000000000000000, 0x0, 0x1, 0x800FFFFFFFFFFFFF, 0x0010000000000000,
                     0x7FF0000000000000, 0xFFF0000000000000], np.uint64).view(np.float64)


def _parts(seed: int, k: int = 4, n_buckets: int = 6, specials: bool = True) -> list:
    """k region fragments over overlapping tsid sets, grids with NaN
    payloads, +-0.0, subnormals and infinities."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(k):
        tsids = sorted(rng.choice(40, 25, replace=False).tolist())
        grids = {}
        for key in ("sum", "count", "min", "max"):
            a = rng.normal(size=(len(tsids), n_buckets))
            if key == "sum":
                a *= 1e-308  # sums of subnormal size
            if specials:
                hit = rng.random(a.shape) < 0.25
                a[hit] = rng.choice(SPECIALS, int(hit.sum()))
            grids[key] = a
        with np.errstate(invalid="ignore", divide="ignore"):
            grids["mean"] = grids["sum"] / grids["count"]
        out.append((r, tsids, grids))
    return out


def _bits(grids: dict) -> dict:
    return {k: np.asarray(v).view(np.uint64) for k, v in grids.items()}


def _same(a, b) -> None:
    assert a[0] == b[0]
    ab, bb = _bits(a[1]), _bits(b[1])
    assert ab.keys() == bb.keys()
    for k in ab:
        assert np.array_equal(ab[k], bb[k]), k


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(4, series_parallel=2, devices=["cpu"] * 4)


def test_wire_bytes_equal_and_cross_decode():
    parts = _parts(1)
    prov = {"regions": [0, 1, 2, 3], "epoch": 7}
    ours = ppartial.encode_partials("node-a", parts, prov)
    theirs = jpartial.encode_partials("node-a", parts, prov)
    assert ours == theirs
    for decode, buf in ((ppartial.decode_partials, theirs), (jpartial.decode_partials, ours)):
        header, got = decode(buf)
        assert header == {"node": "node-a", "provenance": prov, "regions": header["regions"]}
        for (r, t, g), (r2, t2, g2) in zip(got, parts):
            assert (r, t) == (r2, t2)
            assert all(np.array_equal(np.asarray(g[k]).view(np.uint64), g2[k].view(np.uint64))
                       for k in g2)
    assert ppartial.MAGIC == jpartial.MAGIC and \
        ppartial.WIRE_CONTENT_TYPE == jpartial.WIRE_CONTENT_TYPE
    with pytest.raises(ValueError, match="bad magic"):
        ppartial.decode_partials(b"nope" + ours)


@pytest.mark.parametrize("x,y", [(1, 2), (2, 1), (1, "s5"), ("s5", 1), (1, "one"), ("one", 1),
                                 ("+0", "-0"), ("-0", "+0"), ("s5", "one"), ("one", "s5"),
                                 ("inf", "-inf")])
def test_numpy_at_rules_are_the_fold_rules(x, y):
    """np.*.at on this host, as the host fold applies it (rows of a 2-D
    grid), against the element rules of grid_fold (`ops/mesh.py::np_add`,
    `np_min`, `np_max`). numpy takes another inner loop for 1-D targets,
    where the add's NaN rule differs, so the shape matters."""
    named = {1: 0x7FF8000000000001, 2: 0xFFF8000000000002, "s5": 0x7FF0000000000005,
             "+0": 0x0, "-0": 0x8000000000000000, "one": 0x3FF0000000000000,
             "inf": 0x7FF0000000000000, "-inf": 0xFFF0000000000000}
    a, b = (np.full((3, 4), np.array([named[v]], np.uint64).view(np.float64)[0])
            for v in (x, y))
    for ufunc, rule in ((np.add, mesh_ops.np_add), (np.minimum, mesh_ops.np_min),
                        (np.maximum, mesh_ops.np_max)):
        acc = a.copy()
        with np.errstate(invalid="ignore"):
            ufunc.at(acc, np.arange(3), b)
        got = rule(torch.from_numpy(a.copy()), torch.from_numpy(b.copy())).numpy()
        assert np.array_equal(acc.view(np.uint64), got.view(np.uint64)), ufunc.__name__


def test_device_fold_safe_on_cpu_slots(mesh):
    assert pmerge.device_fold_safe(mesh)


def test_a_broken_fold_kernel_raises_and_is_not_cached(monkeypatch):
    """A grid_fold that fails to build or launch propagates out of the
    probe and out of merge_grids; it is never read as an unsafe platform
    (a silent host fold), and no verdict is cached from it."""
    from horaedb_tpu_torch.ops._build import KernelError

    mesh = make_mesh(2, series_parallel=1, devices=["cpu"] * 2)

    def broken(stacked):
        raise KernelError("grid_fold: CUDA launch failed with cudaError 209")

    monkeypatch.setattr(mesh_ops, "grid_fold", broken)
    pmerge.device_fold_safe.cache_clear()
    with pytest.raises(KernelError):
        pmerge.device_fold_safe(mesh)
    results = [(t, g) for _, t, g in _parts(4, k=2)]
    with pytest.raises(KernelError):
        ppartial.merge_grids(results, device_mesh=mesh)
    monkeypatch.undo()
    assert pmerge.device_fold_safe(mesh)


@pytest.mark.parametrize("seed", [2, 3])
def test_merge_grids_on_a_mesh_is_the_host_fold_bitwise(mesh, seed):
    parts = _parts(seed)
    results = [(t, g) for _, t, g in parts]
    host = ppartial.merge_grids(results)
    _same(ppartial.merge_grids(results, device_mesh=mesh), host)
    _same(host, jpartial.merge_grids(results))


def test_merge_partials_order_and_shortcut(mesh):
    parts = _parts(4, k=3)
    order = [2, 0, 1]
    shuffled = [parts[1], parts[2], parts[0]]
    got = ppartial.merge_partials(shuffled, order=order, device_mesh=mesh)
    _same(got, jpartial.merge_partials(parts, order=order))
    _same(ppartial.merge_partials(parts[:1]), (parts[0][1], parts[0][2]))
    assert ppartial.merge_partials([]) is None


def test_sharded_grid_fold_pads_and_matches_plain(mesh):
    """Series counts that do not divide over the slots pad with the
    identity; the fold equals the plain fold of the whole stack."""
    rng = np.random.default_rng(5)
    stacked = {k: rng.normal(size=(3, 11, 4)) for k in mesh_ops.FOLD_KEYS}
    got = pmerge.sharded_grid_fold(mesh, stacked)
    want = mesh_ops.grid_fold_plain({k: torch.from_numpy(v) for k, v in stacked.items()})
    for k in mesh_ops.FOLD_KEYS:
        assert np.array_equal(got[k].view(np.uint64), want[k].numpy().view(np.uint64)), k
