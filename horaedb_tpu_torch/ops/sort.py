"""Stable multi-key sort permutation: kernel A (`sort_perm`).

The JAX package sorts the write batch's primary key with one variadic
stable `lax.sort` (`horaedb_tpu/ops/sort.py::_sort_perm`). Here the same
permutation comes from a hand-written chain of look-back sorts over packed
u64 keys (`csrc/sort_perm.cu`, `csrc/keychain.cuh`) on a CUDA tensor, or
from its plain version (a chain of stable `torch.sort` passes, least
significant key first) on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, order_key, resolve_device, to_device
from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import _build, keychain


def sort_perm_plain(keys: list[torch.Tensor]) -> torch.Tensor:
    """Plain version: stable sorts, least significant key first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for key in reversed(keys):
        order = torch.sort(key[perm], stable=True).indices
        perm = perm[order]
    return perm.to(torch.int32)


def num_digits(lo: int, hi: int) -> int:
    """8-bit digits that separate every key in [lo, hi]."""
    return -(-(hi - lo).bit_length() // 8)


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]


def sort_perm(keys: list[torch.Tensor], bounds: list[tuple[int, int]]) -> torch.Tensor:
    """Stable permutation (int32) ordering rows by `keys`, most significant
    first. Keys are 1-D int64 tensors whose signed order is the wanted order
    (`backend.order_key`); `bounds[i]` is (min, max) of key i, which sets
    how keys pack and how many digits they take, so it must bound the key."""
    ensure(len(keys) > 0 and len(keys) == len(bounds), "one (min, max) bound per key")
    n = keys[0].shape[0]
    dev = keys[0].device
    for key in keys:
        ensure(key.dtype == torch.int64 and key.dim() == 1 and key.shape[0] == n,
               f"sort keys must be 1-D int64 of length {n}, got {key.dtype} {tuple(key.shape)}")
        ensure(key.device == dev and key.is_contiguous(), "sort keys: one device, contiguous")
    if dev.type == "cpu":
        return sort_perm_plain(keys)
    if dev.type != "cuda":
        raise HoraeError(f"sort_perm: unsupported device {dev}")
    return _launch(keys, bounds)


def _launch(keys: list[torch.Tensor], bounds: list[tuple[int, int]]) -> torch.Tensor:
    n = keys[0].shape[0]
    dev = keys[0].device
    ensure(n < 2**31, f"sort_perm: {n} rows exceed int32 indices")
    chain, digits = keychain.layout(bounds)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    nbytes = _build.kernel("sort_perm", "sort_perm_scratch_bytes", [ctypes.c_int64, ctypes.c_int32],
                           ctypes.c_int64)(n, digits)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    k = len(keys)
    ptrs = (ctypes.c_void_p * k)(*[key.data_ptr() for key in keys])
    los = (ctypes.c_int64 * k)(*[lo for lo, _ in bounds])
    fn = _build.kernel("sort_perm", "sort_perm_launch", _ARGTYPES)
    _build.launch("sort_perm", fn, dev, ptrs, los, k, *chain, n, perm.data_ptr(),
                  scratch.data_ptr())
    return perm


def sort_permutation(keys: list[np.ndarray], device=DEFAULT_DEVICE) -> torch.Tensor:
    """Stable permutation ordering host rows by `keys` (most significant
    first, any integer dtype, u64 included), computed on `device`. A key
    that is constant over the batch cannot change a stable order, so it
    never goes to the device; with no other key the order is the identity."""
    ensure(len(keys) > 0, "sort_permutation: no keys")
    dev = resolve_device(device)
    n = len(keys[0])
    varying = []
    for key in keys:
        m = order_key(key)
        bound = (int(m.min()), int(m.max())) if len(m) else (0, 0)
        if num_digits(*bound) > 0:
            varying.append((m, bound))
    if not varying:
        return torch.arange(n, dtype=torch.int32, device=dev)
    return sort_perm([to_device(m, dev) for m, _ in varying], [b for _, b in varying])
