"""The packed sort keys of the look-back chain (`csrc/keychain.cuh`).

Kernels `sort_perm`, `scan_kernel`, `index_merge_mask` and
`index_merge_filter` sort rows lexicographically by mapped int64 lanes
(`backend.order_key`) as a chain of stable u64-key sorts. `pack_lanes`
decides which lanes share a key; `layout` flattens that into the arguments
their C entry points take.
"""

from __future__ import annotations

import ctypes
import itertools

MAX_KEYS = 16  # lanes a packed key may hold (keychain.cuh)


def pack_lanes(bounds: list[tuple[int, int]]) -> list[tuple[tuple[int, ...], tuple[int, ...], int]]:
    """The u64 keys the chain sorts by, most significant first: each
    `(lanes, shifts, digits)` packs the lanes (indices into `bounds`, most
    significant first) into one key, the sum of `(lane - lo) << shift`,
    of `digits` 8-bit digits. Filled from the least significant lane,
    adjacent lanes share a key while their spans fit 64 bits together and
    the key holds fewer than MAX_KEYS lanes; a constant lane (span 0) is in
    no key, as it orders nothing. The lexicographic order of the keys is
    that of the lanes."""
    keys, lanes, shifts, used = [], [], [], 0
    for i in reversed(range(len(bounds))):
        lo, hi = bounds[i]
        bits = (hi - lo).bit_length()
        if bits == 0:
            continue
        if used + bits > 64 or len(lanes) == MAX_KEYS:
            keys.append((tuple(lanes), tuple(shifts), -(-used // 8)))
            lanes, shifts, used = [], [], 0
        lanes.insert(0, i)
        shifts.insert(0, used)
        used += bits
    if lanes:
        keys.append((tuple(lanes), tuple(shifts), -(-used // 8)))
    return keys[::-1]


def _ints(xs: list[int]):
    """A ctypes int32 array of `xs` (one element at least)."""
    return (ctypes.c_int32 * max(len(xs), 1))(*xs)


def layout(bounds: list[tuple[int, int]]) -> tuple[tuple, int]:
    """`pack_lanes(bounds)` as the C entry points take it (`keychain::
    Layout` after the lanes and their minimums): ctypes int32 arrays of
    each packed lane's index and shift, each key's first packed lane (and
    one past the last), each key's digits, then the number of keys; and
    the most digits of any key (1 when there is none), which sizes the
    scratch."""
    packed = pack_lanes(bounds)
    lane_of = [i for lanes, _, _ in packed for i in lanes]
    shift_of = [sh for _, shifts, _ in packed for sh in shifts]
    starts = list(itertools.accumulate((len(lanes) for lanes, _, _ in packed), initial=0))
    digits = [d for _, _, d in packed]
    args = (_ints(lane_of), _ints(shift_of), _ints(starts), _ints(digits), len(packed))
    return args, max(digits, default=1)
