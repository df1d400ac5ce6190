"""Sort sentinels shared by the port's host and device lanes.

Copied from the JAX package's `ops/blocks.py`; the arrow conversions and
the padded `Block` stay behind, since the port's lanes are numpy arrays and
its kernels mask their own ragged edges instead of padding.
"""

from __future__ import annotations

import numpy as np


def sort_sentinel(dtype) -> np.generic:
    """Key that sorts after every valid key of `dtype`."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.inf)
    return np.iinfo(dt).max


# The packed-u64 merge sentinel: masked rows sink to all-ones, which sorts
# after every valid (<= 63-bit) packed key.
PACK_SENTINEL = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
