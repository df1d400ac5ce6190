"""Device choice and the numpy -> torch boundary of the port.

Every entry point takes `device=` and defaults to "cuda". Without a card,
the default raises instead of quietly running on the host; `device="cpu"`
is an explicit request for the plain PyTorch versions of the kernels.

Unsigned 64-bit lanes (tsid, metric_id, the packed-key sentinel) cross the
boundary through an order-preserving map to int64: flipping bit 63 sends
0 to the int64 minimum and 2^64-1 to the int64 maximum, so signed order on
the mapped lane equals unsigned order on the original. torch's uint64
tensors lack `<`, `>>`, `searchsorted` and `max` on the CPU, so no uint64
tensor is ever made.
"""

from __future__ import annotations

import numpy as np
import torch

from horaedb_tpu_torch.common.error import HoraeError

DEFAULT_DEVICE = "cuda"
_SIGN = np.uint64(1 << 63)


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The torch device for `device`; raises when a CUDA device is asked
    for and none is present (no silent fallback to the CPU). A bare "cuda"
    gets the index of the current device: tensors made on it report
    `cuda:<index>`, and the wrappers compare devices with `==`, under which
    `cuda` and `cuda:0` differ."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise HoraeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise HoraeError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def u64_to_i64(a: np.ndarray) -> np.ndarray:
    """Order-preserving u64 -> i64 (flip bit 63)."""
    return (np.asarray(a, dtype=np.uint64) ^ _SIGN).view(np.int64)


def i64_to_u64(a: np.ndarray) -> np.ndarray:
    """Inverse of `u64_to_i64`."""
    return np.asarray(a, dtype=np.int64).view(np.uint64) ^ _SIGN


def order_key(a: np.ndarray) -> np.ndarray:
    """An integer lane as int64 whose signed order is the lane's own order:
    u64 goes through `u64_to_i64`, narrower integers widen."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        return u64_to_i64(a)
    if not np.issubdtype(a.dtype, np.integer):
        raise HoraeError(f"sort keys must be integers, got {a.dtype}")
    return a.astype(np.int64, copy=False)


def device_lane(a: np.ndarray) -> np.ndarray:
    """A host column as the lane the predicate kernel reads: u64 through
    `u64_to_i64` and uint32 widened (both int64), narrower integers as
    int32, bool and uint8 as uint8, floats as float64 (exact)."""
    a = np.asarray(a)
    dt = a.dtype
    if dt == np.uint64:
        return u64_to_i64(a)
    if np.issubdtype(dt, np.floating):
        return a.astype(np.float64, copy=False)
    if dt in (np.bool_, np.uint8):
        return a.astype(np.uint8, copy=False)
    if dt in (np.int8, np.int16, np.uint16, np.int32):
        return a.astype(np.int32, copy=False)
    if dt in (np.int64, np.uint32):
        return a.astype(np.int64, copy=False)
    raise HoraeError(f"no device lane for dtype {dt}")


def host_lane(a: np.ndarray, dtype) -> np.ndarray:
    """Inverse of `device_lane` for a column of host `dtype`: exact, since
    every device lane holds its column's values unchanged or widened."""
    dt = np.dtype(dtype)
    if dt == np.uint64:
        return i64_to_u64(a)
    return np.asarray(a).astype(dt, copy=False)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host lane -> tensor on `device` (a CUDA copy through pinned memory,
    queued on the current stream). u64 lanes must be mapped first."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        raise HoraeError("map u64 lanes through order_key before the device")
    if device.type == "cpu":
        return torch.from_numpy(a if a.flags.writeable else a.copy())
    # one copy into pinned staging (PyTorch's caching host allocator keeps
    # it alive until the copy on the current stream is done), then a DMA
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    staged = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    staged.numpy()[...] = a
    return staged.to(device, non_blocking=True)
