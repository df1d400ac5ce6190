"""Device merges of a segment scan: kernels D (`packed_merge`) and F
(`index_merge_mask`, `index_merge_filter`).

The JAX package merges a scan's rows on the device with two XLA kernels
built in `storage/read.py`: `_build_packed_index_kernel` sorts one packed
u64 key per row, and `_build_index_kernel` sorts (~mask, pk..., __seq__,
iota) or, for presorted rows, stably partitions by the mask. Both keep the
last row of every primary-key group (overwrite mode) and return the
compacted survivor row indices and their count. Here the same contract is
met by hand-written CUDA kernels (`csrc/packed_merge.cu`,
`csrc/index_merge.cu`, with `csrc/predicate.cu` evaluating the predicate
of `index_merge_filter`) on CUDA tensors, and by the plain PyTorch versions
beside them on CPU tensors.

Every function returns `(out_idx, count)`: int32 `out_idx` of the input's
length whose first `count` entries are the survivors' row indices in key
order, and `count` as an int32 tensor of one element on the same device
(reading it synchronises; the caller decides when).

Lanes are int64 whose signed order is the wanted order
(`backend.order_key`: u64 keys flip bit 63), so the packed sentinel
(all ones) arrives as INT64_MAX.
"""

from __future__ import annotations

import ctypes

import torch

from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import _build
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops import keychain
from horaedb_tpu_torch.ops.dedup import dedup_last_value
from horaedb_tpu_torch.ops.sort import sort_perm_plain

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1  # the mapped packed sentinel


def _compacted(perm: torch.Tensor, keep: torch.Tensor):
    """Kept rows of `perm` first (in order), then the rest, and the count."""
    out = torch.cat([perm[keep], perm[~keep]]).to(torch.int32)
    count = keep.sum().to(torch.int32).reshape(1)
    return out, count


def _check_lane(name: str, t: torch.Tensor, n: int, dtypes) -> None:
    ensure(t.dtype in dtypes and t.dim() == 1 and t.shape[0] == n and t.is_contiguous(),
           f"{name}: lanes must be contiguous 1-D {dtypes} of length {n}, "
           f"got {t.dtype}{tuple(t.shape)}")


# -- kernel D: packed_merge ----------------------------------------------------

def packed_merge_plain(key: torch.Tensor, seq_width: int, do_dedup: bool):
    """Plain version of kernel D: one stable sort of the mapped key; valid
    rows (every key but the sentinel) come first; keep the last row of each
    group `raw key >> seq_width` among them."""
    n = key.shape[0]
    perm = torch.sort(key, stable=True).indices
    pos = torch.arange(n, device=key.device)
    nv = int((key != I64_MAX).sum())
    keep = pos < nv
    if do_dedup and n:
        grp = (key[perm] ^ I64_MIN) >> seq_width  # raw bits; valid keys are < 2^63
        nxt = torch.cat([grp[1:], grp[-1:]])
        keep &= (pos == nv - 1) | (nxt != grp)
    return _compacted(perm, keep)


def packed_merge(key: torch.Tensor, key_bits: int, seq_width: int, do_dedup: bool):
    """Merge rows by one packed key (mapped int64; the sentinel marks a
    rejected row), keep-last per `key >> seq_width` when `do_dedup`.
    `key_bits` bounds the valid keys' width (it sets the digit sweeps).
    Kernel D on a CUDA tensor, `packed_merge_plain` on a CPU one."""
    n = key.shape[0]
    _check_lane("packed_merge", key, n, (torch.int64,))
    ensure(1 <= key_bits <= 63 and 0 <= seq_width < key_bits or n == 0,
           f"packed_merge: key_bits {key_bits}, seq_width {seq_width} out of range")
    if key.device.type == "cpu":
        return packed_merge_plain(key, seq_width, do_dedup)
    if key.device.type != "cuda":
        raise HoraeError(f"packed_merge: unsupported device {key.device}")
    ensure(n < 2**31, f"packed_merge: {n} rows exceed int32 indices")
    return _launch_packed(key, max(1, key_bits), seq_width, do_dedup)


_PACKED_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _launch_packed(key: torch.Tensor, key_bits: int, seq_width: int, do_dedup: bool):
    n = key.shape[0]
    dev = key.device
    out_idx = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    nbytes = _build.kernel("packed_merge", "packed_merge_scratch_bytes",
                           [ctypes.c_int64, ctypes.c_int32], ctypes.c_int64)(n, key_bits)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = _build.kernel("packed_merge", "packed_merge_launch", _PACKED_ARGTYPES)
    _build.launch("packed_merge", fn, dev, key.data_ptr(), n, key_bits, seq_width,
                  int(do_dedup), out_idx.data_ptr(), count.data_ptr(), scratch.data_ptr())
    return out_idx, count


# -- kernel F: index_merge_mask / index_merge_filter --------------------------

def index_merge_plain(keys: list[torch.Tensor], num_pk: int, mask: torch.Tensor,
                      do_dedup: bool, presorted: bool):
    """Plain version of kernel F: stable partition by the mask (presorted
    rows) or a stable sort of (~mask, keys...), then keep-last per run of
    equal `keys[:num_pk]` among the kept rows."""
    mask = mask.to(torch.bool)
    n = mask.shape[0]
    kept = int(mask.sum())
    if presorted or not keys:
        rows = torch.arange(n, device=mask.device)
        perm = torch.cat([rows[mask], rows[~mask]])
    else:
        perm = sort_perm_plain([(~mask).to(torch.int64), *keys]).to(torch.int64)
    if do_dedup and num_pk:
        sorted_pk = {str(i): keys[i][perm] for i in range(num_pk)}
        keep = dedup_last_value(sorted_pk, list(sorted_pk), kept)
    elif do_dedup:
        keep = torch.arange(n, device=mask.device) == kept - 1
    else:
        keep = torch.arange(n, device=mask.device) < kept
    return _compacted(perm, keep)


MAX_KEYS = keychain.MAX_KEYS  # sort-key lanes kernel F takes (index_merge.cu)
_INDEX_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]


def _check_keys(name: str, keys, bounds, num_pk: int, n: int, dev) -> None:
    ensure(len(keys) == len(bounds), f"{name}: one (min, max) bound per key")
    ensure(0 <= num_pk <= len(keys) <= MAX_KEYS, f"{name}: {len(keys)} keys, {num_pk} pk")
    for key in keys:
        _check_lane(name, key, n, (torch.int64,))
        ensure(key.device == dev, f"{name}: keys and mask must share one device")


def _launch_index(name: str, keys, bounds, num_pk: int, mask: torch.Tensor,
                  do_dedup: bool, presorted: bool):
    n = mask.shape[0]
    dev = mask.device
    ensure(n < 2**31, f"{name}: {n} rows exceed int32 indices")
    chain, digits = keychain.layout(bounds)
    out_idx = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    nbytes = _build.kernel(name, "index_merge_scratch_bytes", [ctypes.c_int64, ctypes.c_int32],
                           ctypes.c_int64)(n, digits)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    k = len(keys)
    ptrs = (ctypes.c_void_p * max(k, 1))(*[key.data_ptr() for key in keys])
    los = (ctypes.c_int64 * max(k, 1))(*[lo for lo, _ in bounds])
    fn = _build.kernel(name, "index_merge_launch", _INDEX_ARGTYPES)
    _build.launch(name, fn, dev, ptrs, los, k, num_pk, *chain, n, mask.data_ptr(),
                  int(presorted), int(do_dedup), out_idx.data_ptr(), count.data_ptr(),
                  scratch.data_ptr())
    return out_idx, count


def index_merge_mask(keys: list[torch.Tensor], bounds: list[tuple[int, int]], num_pk: int,
                     mask: torch.Tensor, do_dedup: bool, presorted: bool):
    """Merge the rows a host mask keeps, by the sort-key lanes `keys`
    (mapped int64, most significant first, `bounds[i]` = (min, max) of key
    i over all rows); keep-last per run of `keys[:num_pk]` when `do_dedup`.
    `presorted`: the rows are already in key order, so only the partition
    runs. Keys constant over the rows may be left out: they change neither
    the order nor the runs. Kernel F on CUDA tensors (`mask` uint8),
    `index_merge_plain` on CPU ones."""
    n = mask.shape[0]
    _check_keys("index_merge_mask", keys, bounds, num_pk, n, mask.device)
    if mask.device.type == "cpu":
        return index_merge_plain(keys, num_pk, mask, do_dedup, presorted)
    if mask.device.type != "cuda":
        raise HoraeError(f"index_merge_mask: unsupported device {mask.device}")
    _check_lane("index_merge_mask", mask, n, (torch.uint8,))
    return _launch_index("index_merge_mask", keys, bounds, num_pk, mask, do_dedup, presorted)


def index_merge_filter(keys: list[torch.Tensor], bounds: list[tuple[int, int]], num_pk: int,
                       program: "filter_ops.Program | None", lanes: dict[str, torch.Tensor],
                       n: int, do_dedup: bool, presorted: bool, device: torch.device):
    """`index_merge_mask` with the mask evaluated on the device from a
    predicate program (`filter_ops.compile_program`; None keeps every row)
    over `lanes` (`backend.device_lane` form): kernels E then F on the
    card, their plain versions on the CPU. Counted once per call."""
    dev = torch.device(device)
    _check_keys("index_merge_filter", keys, bounds, num_pk, n, dev)
    if dev.type == "cpu":
        mask = (filter_ops.eval_program_plain(program, lanes, n) if program is not None
                else torch.ones(n, dtype=torch.bool))
        return index_merge_plain(keys, num_pk, mask, do_dedup, presorted)
    if dev.type != "cuda":
        raise HoraeError(f"index_merge_filter: unsupported device {dev}")
    if program is None:
        mask = torch.ones(n, dtype=torch.uint8, device=dev)
    else:
        mask = torch.empty(n, dtype=torch.uint8, device=dev)
        filter_ops.launch_program(program, lanes, n, mask)
    return _launch_index("index_merge_filter", keys, bounds, num_pk, mask, do_dedup, presorted)
