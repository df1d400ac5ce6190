"""The launch path of kernels `grid_fold`, `lane_sum_count`, the other
mesh steps, `sort_perm`, `scan_kernel`, `packed_merge`, the four decoders
and kernels B and C, and the device the entry points resolve, on the CPU.

Each wrapper checks its inputs before it picks a route: malformed input
raises `HoraeError` with the texts below, whatever device the lanes are on.
`meta` tensors stand in for a device that is neither the CPU nor a card.
`_build.kernel` binds an entry point once and serves later lookups from its
cache without the build lock.
"""

import ctypes

import pytest
import torch

from horaedb_tpu_torch.backend import resolve_device
from horaedb_tpu_torch.common.error import HoraeError
from horaedb_tpu_torch.ops import _build, blockagg, decode, keychain, merge
from horaedb_tpu_torch.ops import scan as scan_ops
from horaedb_tpu_torch.ops import sort as sort_ops
from horaedb_tpu_torch.ops.aggregate import lane_segment_sum_count
from horaedb_tpu_torch.ops import mesh
from horaedb_tpu_torch.ops.mesh import grid_fold


def _grids(k=2, cells=3, **change):
    out = {key: torch.zeros(k, cells, dtype=torch.float64)
           for key in ("sum", "count", "min", "max")}
    out.update(change)
    return {key: t for key, t in out.items() if t is not None}


F64 = "torch.float64"
GRID_CASES = {
    "missing max": (
        _grids(max=None),
        "grid_fold: needs sum and count, and min with max, got ['count', 'min', 'sum']"),
    "min without max or count": (
        _grids(count=None, max=None),
        "grid_fold: needs sum and count, and min with max, got ['min', 'sum']"),
    "no partials": (_grids(k=0), "grid_fold: needs k >= 1 partials"),
    "0-d sum": (_grids(sum=torch.tensor(1.0, dtype=torch.float64)),
                "grid_fold: needs k >= 1 partials"),
    "wrong dtype": (_grids(count=torch.zeros(2, 3, dtype=torch.float32)),
                    "grid_fold: count must be a contiguous f64 (2, 3) on cpu, "
                    "got torch.float32(2, 3) on cpu"),
    "wrong shape": (_grids(min=torch.zeros(2, 4, dtype=torch.float64)),
                    f"grid_fold: min must be a contiguous f64 (2, 3) on cpu, "
                    f"got {F64}(2, 4) on cpu"),
    "non-contiguous": (_grids(max=torch.zeros(3, 2, dtype=torch.float64).t()),
                       f"grid_fold: max must be a contiguous f64 (2, 3) on cpu, "
                       f"got {F64}(2, 3) on cpu"),
    "another device": (_grids(count=torch.zeros(2, 3, dtype=torch.float64, device="meta")),
                       f"grid_fold: count must be a contiguous f64 (2, 3) on cpu, "
                       f"got {F64}(2, 3) on meta"),
    "unsupported device": ({key: torch.zeros(2, 3, dtype=torch.float64, device="meta")
                            for key in ("sum", "count")},
                           "grid_fold: unsupported device meta"),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grid_fold_refuses_malformed_input(case):
    stacked, text = GRID_CASES[case]
    with pytest.raises(HoraeError) as err:
        grid_fold(stacked)
    assert str(err.value) == text


def _lanes(n=5, **change):
    out = {"k": torch.zeros(n, dtype=torch.int32), "v": torch.zeros(n, dtype=torch.float32),
           "w": None}
    out.update(change)
    return out


LANE_CASES = {
    "ids not int32": (_lanes(k=torch.zeros(5, dtype=torch.int64)), 16,
                      "lane_sum_count: ids must be int32, got torch.int64"),
    "short values": (_lanes(v=torch.zeros(4)), 16,
                     "lane_sum_count: v must be a contiguous 1-D lane of 5 rows on cpu, "
                     "got torch.float32(4,) on cpu"),
    "2-D ids": (_lanes(k=torch.zeros(5, 2, dtype=torch.int32)), 16,
                "lane_sum_count: k must be a contiguous 1-D lane of 5 rows on cpu, "
                "got torch.int32(5, 2) on cpu"),
    "non-contiguous ids": (_lanes(k=torch.zeros(10, dtype=torch.int32)[::2]), 16,
                           "lane_sum_count: k must be a contiguous 1-D lane of 5 rows on cpu, "
                           "got torch.int32(5,) on cpu"),
    "long weights": (_lanes(w=torch.ones(6)), 16,
                     "lane_sum_count: w must be a contiguous 1-D lane of 5 rows on cpu, "
                     "got torch.float32(6,) on cpu"),
    "values on another device": (_lanes(v=torch.zeros(5, device="meta")), 16,
                                 "lane_sum_count: v must be a contiguous 1-D lane of 5 rows on "
                                 "cpu, got torch.float32(5,) on meta"),
    "negative cell count": (_lanes(), -1, "lane_sum_count: num_cells -1 outside [0, 2^31)"),
    "too many cells": (_lanes(), 2**31, "lane_sum_count: num_cells 2147483648 outside [0, 2^31)"),
    "unsupported device": ({"k": torch.zeros(5, dtype=torch.int32, device="meta"),
                            "v": torch.zeros(5, device="meta"), "w": None}, 16,
                           "lane_sum_count: unsupported device meta"),
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_lane_sum_count_refuses_malformed_input(case):
    lanes, cells, text = LANE_CASES[case]
    with pytest.raises(HoraeError) as err:
        lane_segment_sum_count(lanes["k"], lanes["v"], cells, w=lanes["w"])
    assert str(err.value) == text


def test_well_formed_input_takes_the_plain_version_on_the_cpu():
    stacked = _grids(k=3, cells=4)
    stacked["sum"] = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    out = grid_fold(stacked)
    assert torch.equal(out["sum"], stacked["sum"].sum(0))
    s, c = lane_segment_sum_count(torch.tensor([0, 1, 1, -4, 9], dtype=torch.int32),
                                  torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]), 4)
    assert s.tolist() == [5.0, 5.0, 0.0, 0.0] and c.tolist() == [2.0, 2.0, 0.0, 0.0]


class _NoLock:
    def __enter__(self):
        raise AssertionError("a cached entry point took the build lock")

    def __exit__(self, *exc):
        return False


def test_kernel_binds_an_entry_point_once(monkeypatch):
    """The first lookup binds argtypes and restype under the lock; a later
    one returns the same bound entry without the lock, whatever it asks."""
    monkeypatch.setattr(_build, "_libs", {"grid_fold": ctypes.CDLL(None)})
    monkeypatch.setattr(_build, "_fns", {})
    fn = _build.kernel("grid_fold", "labs", [ctypes.c_long], ctypes.c_long)
    assert fn(-7) == 7 and fn.argtypes == [ctypes.c_long]
    monkeypatch.setattr(_build, "_lock", _NoLock())
    assert _build.kernel("grid_fold", "labs", [ctypes.c_long], ctypes.c_long) is fn


class _Card:
    """Stands in for torch.cuda on a box without a card: `current` is the
    thread's current device; `entered` records torch.cuda.device entries;
    the raw stream handle of device i is 1000 + i."""

    def __init__(self, monkeypatch, current: int):
        self.current, self.entered = current, []
        card = self

        class Device:
            def __init__(self, dev):
                self.index = dev.index

            def __enter__(self):
                card.entered.append(self.index)
                card.current, self.prev = self.index, card.current

            def __exit__(self, *exc):
                card.current = self.prev
                return False

        monkeypatch.setattr(torch.cuda, "current_device", lambda: card.current)
        monkeypatch.setattr(torch.cuda, "device", Device)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                            raising=False)

    def kernel(self, rc: int = 0):
        calls = []

        def fn(*args):
            calls.append((self.current, args))
            return rc

        return fn, calls


@pytest.mark.parametrize("current,target,entered", [(0, 0, []), (0, 1, [1]), (1, 1, [])])
def test_launch_runs_on_the_tensors_device_and_its_stream(monkeypatch, current, target, entered):
    """The entry point gets the target device's stream, with the target
    current during the call; torch.cuda.device is entered only when the
    target is not already current, and the thread's device is restored."""
    card = _Card(monkeypatch, current)
    fn, calls = card.kernel()
    before = _build.launch_counts()["grid_fold"]
    _build.launch("grid_fold", fn, torch.device("cuda", target), 7, None)
    assert calls == [(target, (7, None, 1000 + target))]
    assert card.entered == entered and card.current == current
    assert _build.launch_counts()["grid_fold"] == before + 1


def test_launch_raises_kernel_error_on_a_failed_launch(monkeypatch):
    card = _Card(monkeypatch, 0)
    fn, _ = card.kernel(rc=700)
    before = _build.launch_counts()["lane_sum_count"]
    with pytest.raises(_build.KernelError, match="lane_sum_count: CUDA launch failed"):
        _build.launch("lane_sum_count", fn, torch.device("cuda", 0))
    assert _build.launch_counts()["lane_sum_count"] == before


def _meta(n, dtype):
    return torch.zeros(n, dtype=dtype, device="meta")


MESH_STEPS = {
    "slot_grids": (lambda: mesh.slot_grids(
        _meta(4, torch.int64), _meta(4, torch.int32), _meta(4, torch.float64),
        _meta(4, torch.bool), None, 0, 10, 0, 2, 3, False), "sharded_downsample"),
    "ssm_local": (lambda: mesh.ssm_local(_meta(4, torch.int64), 8, 2, _meta(1, torch.int64),
                                         2, 4, 0), "sample_sort_merge"),
    "ssm_merge": (lambda: mesh.ssm_merge(_meta(0, torch.int64), _meta(0, torch.int32), 8, 2,
                                         True), "sample_sort_merge"),
    "sort_perm": (lambda: sort_ops.sort_perm([_meta(4, torch.int64)] * 2, [(0, 9), (-3, 3)]),
                  "sort_perm"),
    "scan_kernel": (lambda: scan_ops.scan_kernel(
        {"v": _meta(4, torch.float64)}, [_meta(4, torch.int64)], [(0, 9)], 1, None, 4, True,
        False, torch.device("meta")), "scan_kernel"),
}


@pytest.mark.parametrize("step", list(MESH_STEPS))
def test_mesh_steps_refuse_an_unsupported_device_before_the_build(monkeypatch, step):
    """A lane on neither the CPU nor a card raises before any library is
    built or looked up."""
    def no_build(*a, **kw):
        raise AssertionError("looked up a kernel for a meta tensor")

    monkeypatch.setattr(_build, "kernel", no_build)
    call, name = MESH_STEPS[step]
    with pytest.raises(HoraeError) as err:
        call()
    assert str(err.value) == f"{name}: unsupported device meta"


# the main scan shape's key lanes: a 64-bit tsid hash, 2 h of ms, 25 seqs
MAIN_BOUNDS = [(-(2**63), 2**63 - 1), (0, 7_199_999), (0, 24)]
MAIN_LAYOUT = [[0, 1, 2], [0, 5, 0], [0, 1, 3], [8, 4]]  # lanes, shifts, starts, digits


def _fake_build(monkeypatch, scratch_fn: str) -> dict:
    """Stands in for the build: records the scratch request and the launch."""
    seen = {}

    def kernel(name, fn_name, argtypes, restype=None):
        def scratch_bytes(n, digits):
            seen["scratch"] = (name, n, digits)
            return 64
        return scratch_bytes if fn_name == scratch_fn else f"{name}.{fn_name}"

    def launch(name, fn, dev, *args):
        seen["launch"] = (name, fn, args)

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "launch", launch)
    return seen


def test_sort_perm_hands_the_packed_layout_to_the_kernel(monkeypatch):
    """On a card, kernel A gets pack_lanes' layout flattened after the key
    pointers and minimums, and a scratch sized by the most digits (a fake
    entry point records the call; the tensors stay on the CPU)."""
    seen = _fake_build(monkeypatch, "sort_perm_scratch_bytes")
    n = 5
    keys = [torch.zeros(n, dtype=torch.int64) for _ in MAIN_BOUNDS]
    perm = sort_ops._launch(keys, MAIN_BOUNDS)
    name, fn, args = seen["launch"]
    assert (name, fn, seen["scratch"]) == ("sort_perm", "sort_perm.sort_perm_launch",
                                           ("sort_perm", n, 8))
    assert list(args[1]) == [lo for lo, _ in MAIN_BOUNDS] and args[2] == 3
    assert [list(a) for a in args[3:7]] == MAIN_LAYOUT
    assert (args[7], args[8], args[9]) == (2, n, perm.data_ptr())  # keys, rows, the output


def test_scan_kernel_hands_the_packed_layout_to_the_kernel(monkeypatch):
    """On a card, scan_kernel gets the same flattened layout after the key
    pointers, their minimums and the primary-key count."""
    seen = _fake_build(monkeypatch, "scan_scratch_bytes")
    n = 5
    keys = [torch.zeros(n, dtype=torch.int64) for _ in MAIN_BOUNDS]
    lanes = {"v": torch.zeros(n, dtype=torch.float64), "f": torch.zeros(n, dtype=torch.uint8)}
    scan_ops._launch(lanes, keys, MAIN_BOUNDS, 2, n, None, True, False, torch.device("cpu"))
    name, fn, args = seen["launch"]
    assert (name, fn, seen["scratch"]) == ("scan_kernel", "scan_kernel.scan_launch",
                                           ("scan_kernel", n, 8))
    assert list(args[1]) == [lo for lo, _ in MAIN_BOUNDS] and args[2:4] == (3, 2)
    assert [list(a) for a in args[4:8]] == MAIN_LAYOUT
    assert args[8:13] == (2, n, 0, 0, 1)  # keys, rows, no mask, presorted, dedup
    assert list(args[15]) == [8, 1] and args[16] == 2  # the gathered lanes' widths


def test_packed_merge_hands_its_key_width_to_the_kernel(monkeypatch):
    """On a card, kernel D gets the key, its row count, key_bits and
    seq_width, and a scratch sized by key_bits (the look-back sort's
    digits)."""
    seen = _fake_build(monkeypatch, "packed_merge_scratch_bytes")
    key = torch.zeros(5, dtype=torch.int64)
    out_idx, count = merge._launch_packed(key, 42, 8, True)
    name, fn, args = seen["launch"]
    assert (name, fn, seen["scratch"]) == ("packed_merge", "packed_merge.packed_merge_launch",
                                           ("packed_merge", 5, 42))
    assert args[:7] == (key.data_ptr(), 5, 42, 8, 1, out_idx.data_ptr(), count.data_ptr())
    assert len(args) == len(merge._PACKED_ARGTYPES) - 1  # the stream comes from launch


def _meta_table(pages=2):
    return torch.zeros(pages, decode.PAGE_FIELDS, dtype=torch.int64, device="meta")


# name: (a call on meta lanes, its rows' dtype, the arguments after the
# two lane pointers: pointers read 0 on meta lanes, the page count is 2)
DECODERS = {
    "decode_unpack": (lambda: decode.decode_unpack(_meta(3, torch.int32), _meta_table(),
                                                   _meta(4, torch.int64), 5)[0],
                      torch.int64, (2, 0, 4, 8, 0, 0)),
    "decode_dod": (lambda: decode.decode_dod(_meta(3, torch.int32), _meta_table(), 5, 8),
                   torch.int64, (2, 8, 0)),
    "decode_xor": (lambda: decode.decode_xor(_meta(3, torch.int32), _meta_table(), 5, 4),
                   torch.int32, (2, 4, 0)),
    "decode_rle": (lambda: decode.decode_rle(_meta(3, torch.int32), _meta_table(), 5, 8),
                   torch.int64, (2, 8, 0)),
}


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoders_hand_their_launch_to_build_launch(monkeypatch, name):
    """Each decoder wrapper launches through `_build.launch` (the stream
    handle and the device switch are its), with its entry point's
    arguments but the stream. Meta lanes take the wrappers' device branch;
    a fake entry point records the call."""
    seen = []

    def kernel(lib, fn_name, argtypes, restype=ctypes.c_int):
        return (lib, fn_name, len(argtypes))

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "launch", lambda *a: seen.append(a))
    call, dtype, tail = DECODERS[name]
    rows = call()
    [(launched, fn, dev, *args)] = seen
    assert (launched, fn, dev) == (name, (name, f"{name}_launch", len(args) + 1),
                                   torch.device("meta"))
    assert tuple(args[2:]) == tail
    assert rows.shape == (5,) and rows.dtype == dtype


def _segment_call(name: str, side: bool):
    """Kernel B or C on meta lanes of 6 rows into 9 cells, with its side
    lane (weights, valid) or without."""
    k, v = _meta(6, torch.int32), _meta(6, torch.float64)
    if name == "block_sum_count":
        return blockagg.block_sum_count(k, v, 9, weights=_meta(6, torch.float64) if side else None)
    return blockagg.block_min_max(k, v, 9, valid=_meta(6, torch.bool) if side else None)


@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("name", ["block_sum_count", "block_min_max"])
def test_segment_reductions_hand_their_launch_to_build_launch(monkeypatch, name, side):
    """Kernels B and C launch through `_build.launch` with their entry
    point's arguments but the stream; an absent weight or valid lane goes
    to the kernel as a null pointer (None), never as a lane of ones built
    for it. Meta lanes stand in for the card: the device check is lifted
    and a fake entry point records the call."""
    seen = []

    def kernel(lib, fn_name, argtypes, restype=ctypes.c_int):
        return (lib, fn_name, len(argtypes))

    monkeypatch.setattr(blockagg, "_require_card", lambda name, dev: None)
    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "launch", lambda *a: seen.append(a))
    out_a, out_b = _segment_call(name, side)
    [(launched, fn, dev, *args)] = seen
    assert (launched, fn, dev) == (name, (name, f"{name}_launch", len(args) + 1),
                                   torch.device("meta"))
    assert (args[2] is None) == (not side)
    assert tuple(args[3:5]) == (6, 9)  # rows, cells
    assert args[7:] == ([0] if name == "block_sum_count" else [])  # the bf16 flag
    assert out_a.shape == out_b.shape == (9,) and out_a.dtype == torch.float64


@pytest.mark.parametrize("name", ["block_sum_count", "block_min_max"])
def test_segment_reductions_refuse_an_unsupported_device_before_the_build(monkeypatch, name):
    def no_build(*a, **kw):
        raise AssertionError("looked up a kernel for a meta tensor")

    monkeypatch.setattr(_build, "kernel", no_build)
    with pytest.raises(HoraeError) as err:
        _segment_call(name, False)
    assert str(err.value) == f"{name}: unsupported device meta"


@pytest.mark.parametrize("bounds,digits", [([(5, 5), (-3, -3)], 1), ([(0, 0)], 1),
                                           ([(0, 2**64 - 1), (0, 2**64 - 1)], 8),
                                           ([(0, 255), (0, 1)], 2)])
def test_layout_counts_keys_and_the_most_digits(bounds, digits):
    """Constant keys pack into no key (the kernels return the identity and
    launch no sweep); the scratch is sized by the widest key, one digit at
    least."""
    args, most = keychain.layout(bounds)
    assert most == digits
    assert args[-1] == len(keychain.pack_lanes(bounds))


@pytest.mark.parametrize("asked,current,want", [
    ("cuda", 0, "cuda:0"), ("cuda", 1, "cuda:1"), (torch.device("cuda"), 1, "cuda:1"),
    ("cuda:1", 0, "cuda:1"), (torch.device("cuda", 0), 1, "cuda:0"), ("cpu", 1, "cpu")])
def test_resolve_device_gives_a_bare_cuda_the_current_index(monkeypatch, asked, current, want):
    """A bare "cuda" resolves to the current device with its index, so it
    equals the device of the tensors made on it; an index given stays, and
    the CPU stays the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    dev = resolve_device(asked)
    assert dev == torch.device(want) and str(dev) == want
