"""The fused per-segment scan pass: kernel `scan_kernel`.

The JAX package's fused route (`storage/read.py::_build_scan_kernel`)
runs one XLA kernel over a segment's lanes: the predicate mask, a stable
sort by (~mask, pk..., __seq__, row) or, for presorted rows, a stable
partition, every lane gathered through the permutation, the overwrite-mode
keep-last mask and the run starts over the primary key among the kept
rows, and the kept count. Here `csrc/scan.cu` (with the predicate kernel E
of `csrc/predicate.cu`, and the sort of `csrc/keychain.cuh`) computes the
same on CUDA tensors, and `scan_kernel_plain` on CPU ones.

Contract of `scan_kernel`'s outputs `(sorted_lanes, perm, keep, starts,
kept)`:
- `kept`: the number of rows the predicate keeps, an int32 tensor of one
  element on the device (reading it synchronises; the caller decides when);
- `perm[:kept]` (int32): the kept rows' indices in (pk..., seq, row)
  order, or in row order when `presorted`;
- `sorted_lanes[name][:kept]`: lane `name` gathered through `perm`, bit
  for bit;
- `keep`, `starts` (bool, all n rows): the last row of every primary-key
  run (every row without dedup) and the first, among the first `kept`
  rows; both false from row `kept` on.
Rows of `perm` and of the gathered lanes past `kept` are unspecified: the
kernel leaves them unwritten (the plain version holds the rejected rows
in order there). No caller reads them; the JAX callers read `perm[:kept]`,
`starts[:kept]` and `keep`.

Sort keys are the scan planner's (`storage/read.py::sort_key_lanes`):
mapped int64 lanes, most significant first, the primary-key lanes first,
`__seq__` as its dense rank, keys constant over the rows left out (they
change neither the order nor the runs).
"""

from __future__ import annotations

import ctypes

import torch

from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import _build, keychain
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops.dedup import last_in_group_mask, run_starts
from horaedb_tpu_torch.ops.sort import sort_perm_plain

MAX_KEYS = keychain.MAX_KEYS  # sort-key lanes scan.cu takes

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def scan_kernel_plain(lanes: dict[str, torch.Tensor], keys: list[torch.Tensor], num_pk: int,
                      mask: torch.Tensor, do_dedup: bool, presorted: bool):
    """Plain version of kernel `scan_kernel` over a bool/uint8 `mask`."""
    mask = mask.to(torch.bool)
    n = mask.shape[0]
    kept = int(mask.sum())
    rows = torch.arange(n, device=mask.device)
    if presorted or not keys:
        perm = torch.cat([rows[mask], rows[~mask]])
    else:
        perm = sort_perm_plain([(~mask).to(torch.int64), *keys]).to(torch.int64)
    sorted_lanes = {name: lane[perm] for name, lane in lanes.items()}
    valid = rows < kept
    pk = [keys[i][perm] for i in range(num_pk)]
    starts = run_starts(pk, valid) if pk else (rows == 0) & valid
    keep = last_in_group_mask(starts, valid, kept) if do_dedup else valid
    count = torch.tensor([kept], dtype=torch.int32, device=mask.device)
    return sorted_lanes, perm.to(torch.int32), keep, starts, count


def scan_kernel(lanes: dict[str, torch.Tensor], keys: list[torch.Tensor],
                bounds: list[tuple[int, int]], num_pk: int,
                program: "filter_ops.Program | None", n: int, do_dedup: bool, presorted: bool,
                device, mask: torch.Tensor | None = None):
    """The fused scan pass over `n` rows (module docstring for the outputs).
    `lanes`: every lane to gather (`backend.device_lane` form), the
    predicate's lanes among them; `keys`, `bounds`, `num_pk`: the sort-key
    lanes, each key's (min, max) over all rows, and how many lead as the
    primary key. The mask is `program` evaluated on the lanes (kernel E on
    the card), or the host's `mask` (bool or uint8) for a predicate kernel
    E cannot take, or every row when both are None. Kernel `scan_kernel` on
    the card, `scan_kernel_plain` on the CPU; counted once per call."""
    dev = torch.device(device)
    ensure(program is None or mask is None, "scan_kernel: a program or a mask, not both")
    ensure(len(keys) == len(bounds) and 0 <= num_pk <= len(keys) <= MAX_KEYS,
           f"scan_kernel: {len(keys)} keys, {len(bounds)} bounds, {num_pk} pk (at most "
           f"{MAX_KEYS} keys)")
    named = [(f"key {i}", k) for i, k in enumerate(keys)] + list(lanes.items())
    if mask is not None:
        named.append(("mask", mask))
    for name, t in named:
        ensure(t.dim() == 1 and t.shape[0] == n and t.is_contiguous() and t.device == dev,
               f"scan_kernel: {name} must be a contiguous 1-D lane of {n} rows on {dev}, "
               f"got {t.dtype}{tuple(t.shape)} on {t.device}")
    ensure(all(k.dtype == torch.int64 for k in keys), "scan_kernel: sort keys must be int64")
    ensure(mask is None or mask.dtype in (torch.bool, torch.uint8),
           "scan_kernel: the mask must be bool or uint8")
    if dev.type == "cpu":
        if program is not None:
            mask = filter_ops.eval_program_plain(program, lanes, n)
        elif mask is None:
            mask = torch.ones(n, dtype=torch.bool)
        return scan_kernel_plain(lanes, keys, num_pk, mask, do_dedup, presorted)
    if dev.type != "cuda":
        raise HoraeError(f"scan_kernel: unsupported device {dev}")
    ensure(n < 2**31, f"scan_kernel: {n} rows exceed int32 indices")
    if program is not None:
        mask = torch.empty(n, dtype=torch.uint8, device=dev)
        filter_ops.launch_program(program, lanes, n, mask, library="scan_kernel")
    return _launch(lanes, keys, bounds, num_pk, n, mask, do_dedup, presorted, dev)


def _launch(lanes: dict[str, torch.Tensor], keys: list[torch.Tensor],
            bounds: list[tuple[int, int]], num_pk: int, n: int, mask: torch.Tensor | None,
            do_dedup: bool, presorted: bool, dev: torch.device):
    sorted_lanes = {name: torch.empty_like(lane) for name, lane in lanes.items()}
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    starts = torch.empty(n, dtype=torch.bool, device=dev)
    kept = torch.empty(1, dtype=torch.int32, device=dev)
    chain, digits = keychain.layout(bounds)
    nbytes = _build.kernel("scan_kernel", "scan_scratch_bytes", [ctypes.c_int64, ctypes.c_int32],
                           ctypes.c_int64)(n, digits)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    k = len(keys)
    names = list(lanes)
    m = len(names)
    key_ptrs = (ctypes.c_void_p * max(k, 1))(*[key.data_ptr() for key in keys])
    los = (ctypes.c_int64 * max(k, 1))(*[lo for lo, _ in bounds])
    ins = (ctypes.c_void_p * max(m, 1))(*[lanes[c].data_ptr() for c in names])
    outs = (ctypes.c_void_p * max(m, 1))(*[sorted_lanes[c].data_ptr() for c in names])
    widths = (ctypes.c_int32 * max(m, 1))(*[lanes[c].element_size() for c in names])
    fn = _build.kernel("scan_kernel", "scan_launch", _ARGTYPES)
    _build.launch("scan_kernel", fn, dev, key_ptrs, los, k, num_pk, *chain, n,
                  0 if mask is None else mask.data_ptr(), int(presorted), int(do_dedup), ins,
                  outs, widths, m, perm.data_ptr(), keep.data_ptr(), starts.data_ptr(),
                  kept.data_ptr(), scratch.data_ptr())
    return sorted_lanes, perm, keep, starts, kept
