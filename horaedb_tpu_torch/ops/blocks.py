"""Sort sentinels and the arrow -> numpy lane conversion of the port.

Copied from the JAX package's `ops/blocks.py`. Its padded device `Block`
stays behind: the port's kernels mask their own ragged edges, so lanes go
to the card at their true length.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common.error import HoraeError

_ARROW_TO_NP = {
    pa.int64(): np.int64,
    pa.int32(): np.int32,
    pa.uint64(): np.uint64,
    pa.uint32(): np.uint32,
    pa.float64(): np.float64,
    pa.float32(): np.float32,
    pa.timestamp("ms"): np.int64,
}


def sort_sentinel(dtype) -> np.generic:
    """Key that sorts after every valid key of `dtype`."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.inf)
    return np.iinfo(dt).max


# The packed-u64 merge sentinel: masked rows sink to all-ones, which sorts
# after every valid (<= 63-bit) packed key.
PACK_SENTINEL = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def numpy_dtype(t: pa.DataType) -> np.dtype:
    """The numpy dtype `arrow_column_to_numpy` gives a column of type `t`."""
    if t in _ARROW_TO_NP:
        return np.dtype(_ARROW_TO_NP[t])
    raise HoraeError(f"unsupported device column type: {t}")


def arrow_column_to_numpy(col) -> np.ndarray:
    """Lossless numeric conversion of an arrow array or chunked array;
    nulls become 0 (only `__reserved__` is nullable in the storage schema,
    and it is unused)."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if col.null_count:
        col = col.fill_null(0)
    return col.to_numpy(zero_copy_only=False).astype(numpy_dtype(col.type), copy=False)
