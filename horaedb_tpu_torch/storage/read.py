"""Scan pipeline of the port: parquet SSTs -> merge plan -> record batches.

A port of the JAX package's `storage/read.py`:

  1. host: row-group-pruned parquet reads per SST (`ParquetReader.read_sst`),
     fanned out over worker threads. A format-v2 SST is read from its
     `.enc` sidecar instead (`_read_encoded`): pages pruned on their zone
     maps, the predicate evaluated on the encoded form (run skipping on
     rle lanes, a dictionary rewrite on dict lanes), and the kept pages of
     each lane decoded through the calibrated dispatcher
     (`ops/decode.py::choose`): on the device by the four decode kernels,
     or by the host funnel. `HORAEDB_DECODE_IMPL=raw` reads the parquet
     object instead;
  2. merge: `_plan_and_merge` routes each segment's merge to the host
     (numpy: filter, stable sort, keep-last) or to the device, where one of
     three hand-written kernels returns only the survivors' row indices:
     `packed_merge` (kernel D) over one packed u64 key per row,
     `index_merge_mask` (kernel F) over the sort-key lanes with a host mask,
     `index_merge_filter` (kernels E + F) with the predicate evaluated on
     the device. The route never changes a result, only which code runs;
     `HORAEDB_SCAN_PATH` (auto/host/device) pins it;
  3. host: one arrow take materializes every column of the survivors,
     builtin columns stripped unless `keep_builtin`, sliced into batches.

Segments above `scan_block_rows` take the chunked scan: per-chunk merges
whose sorted, deduped runs merge again until one remains.

The fused route (`_fused_pass`) uploads every numeric lane of a segment
and runs the `scan_kernel` pass on it (filter, stable sort, gather of
every lane, keep-last and run-start flags). It serves the downsample
pushdown (`scan_segment_downsample`) when the packed pass declines (2^17
series or more, more than 4,096 write sequences, a span of 2^34 ms or
more, append mode): the gathered lanes then go straight to the
`downsample` / `grouped_stats` kernels. And it serves the raw scan in
append mode over binary values, whose groups concatenate their bytes on
the host (`_materialize_append_mode`). The downsample's other routes are
the packed pass and, above `scan_block_rows`, the chunked scan.

Ordering contract: output sorted by (pk..., __seq__), duplicates collapsed
per UpdateMode; the filter runs BEFORE dedup, so a newest-version row
rejected by the predicate exposes the older surviving version.

With a mesh installed (`parallel/mesh.py::set_active_mesh`), the packed
merge runs as the cross-slot sample sort (`parallel/merge.py`, kernel
`sample_sort_merge`) under `HORAEDB_SCAN_PATH=sharded` or, in auto, past
`HORAEDB_SHARDED_MIN_ROWS` rows; and the packed and chunked downsamples
fold each sorted run over the mesh (`parallel/mesh.py::mesh_downsample`).

Not ported yet, and refused with `NotPortedError` instead of running
something else: binary primary keys and device merges over non-integer
sort keys. Bloom-filter sidecars, the
block and file-handle caches, and retention and tombstone masking of the
JAX package's reader are not here either.
"""

from __future__ import annotations

import asyncio
import io
import logging
import os
import struct
import threading
import time
from collections import OrderedDict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from horaedb_tpu_torch.backend import device_lane, host_lane, order_key, to_device
from horaedb_tpu_torch.common.error import HoraeError, NotPortedError
from horaedb_tpu_torch.objstore import NotFound, ObjectStore
from horaedb_tpu_torch.ops import agg_registry
from horaedb_tpu_torch.ops import aggregate as agg_ops
from horaedb_tpu_torch.ops import decode as decode_ops
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops import merge as merge_ops
from horaedb_tpu_torch.ops import scan as scan_ops
from horaedb_tpu_torch.ops._build import KernelError
from horaedb_tpu_torch.ops.blocks import PACK_SENTINEL, arrow_column_to_numpy, numpy_dtype
from horaedb_tpu_torch.ops.filter import Predicate
from horaedb_tpu_torch.ops.sort import num_digits
from horaedb_tpu_torch.storage import encoding as enc_mod
from horaedb_tpu_torch.storage import scanstats
from horaedb_tpu_torch.storage.config import UpdateMode
from horaedb_tpu_torch.storage.sst import SstFile, SstPathGenerator
from horaedb_tpu_torch.storage.types import (
    RESERVED_COLUMN_NAME,
    SEQ_COLUMN_NAME,
    StorageSchema,
)

__all__ = ["NotPortedError", "ParquetReader"]

logger = logging.getLogger(__name__)

DEFAULT_SCAN_BATCH_SIZE = 8192
SCAN_PATHS = ("auto", "host", "device", "sharded")
LINK_PROFILES = ("host", "device", "skip")

# Block size past which an installed mesh upgrades the packed merge to the
# cross-slot sample sort (parallel/merge.py) in auto mode. Read per call
# like HORAEDB_SCAN_PATH, so harnesses can flip it after import.
def _sharded_min_rows() -> int:
    return int(os.environ.get("HORAEDB_SHARDED_MIN_ROWS", 4_000_000))


_warned_sharded_no_mesh = False

# Device merge cost per row that the planner charges on the card: kernel
# F's time over one segment at the main path's shape (17.57 ms for 7.56M
# rows; tsid, ts and seq-rank keys), measured by chip_smoke.py on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit.
DEVICE_SORT_S_PER_ROW = 2.3e-9


def _is_binary_like(t: pa.DataType) -> bool:
    """The single definition of 'cannot ride a device lane'."""
    return pa.types.is_binary(t) or pa.types.is_large_binary(t) or pa.types.is_string(t)


def scan_path_mode() -> str:
    """`HORAEDB_SCAN_PATH`, read per call; an unknown value fails loudly
    (falling through to auto would silently measure the wrong path)."""
    mode = os.environ.get("HORAEDB_SCAN_PATH", "auto")
    if mode not in SCAN_PATHS:
        raise HoraeError(f"HORAEDB_SCAN_PATH={mode!r} is not one of auto/host/device/sharded")
    return mode


def link_profile_override() -> str | None:
    """`HORAEDB_LINK_PROFILE`: host/skip pin the host-favouring numbers,
    device the trusted PCIe-class ones; unset or auto measures. Unknown
    values fail loudly."""
    mode = os.environ.get("HORAEDB_LINK_PROFILE", "").strip().lower()
    if not mode or mode == "auto":
        return None
    if mode not in LINK_PROFILES:
        raise ValueError(f"HORAEDB_LINK_PROFILE={mode!r} is not one of "
                         f"{'/'.join(LINK_PROFILES)} (or auto/unset)")
    return mode


# ---------------------------------------------------------------------------
# host<->device link profile + scan-path cost model
# ---------------------------------------------------------------------------


class _LinkProfile:
    """Measured host<->device transfer characteristics, one probe per
    process and device: one launch with a synchronise (dispatch), and a
    pinned 8 MB copy each way. The device sort rate is the constant
    DEVICE_SORT_S_PER_ROW, measured on the card. A CPU device (the plain
    versions) charges the host's own sort rate, so the host route wins."""

    _cached: dict[str, dict] = {}
    _lock = threading.Lock()

    # pessimistic-link plan: every device route loses the cost model
    _WEDGED = {"h2d_bw": 1e6, "d2h_bw": 1e6, "dispatch_s": 1.0, "sort_s_per_row": 1.2e-6}
    # the operator vouches for the link: PCIe-class numbers, card sort rate
    _TRUSTED = {"h2d_bw": 16e9, "d2h_bw": 16e9, "dispatch_s": 1e-4,
                "sort_s_per_row": DEVICE_SORT_S_PER_ROW}
    # plain versions on the host: a memcpy "link" and torch's CPU sort
    _CPU = {"h2d_bw": 8e9, "d2h_bw": 8e9, "dispatch_s": 1e-4, "sort_s_per_row": 1.2e-6}

    @classmethod
    def get(cls, device: torch.device) -> dict:
        mode = link_profile_override()
        if mode in ("host", "skip"):
            return dict(cls._WEDGED)
        if mode == "device":
            return dict(cls._TRUSTED)
        key = str(device)
        with cls._lock:
            if key not in cls._cached:
                cls._cached[key] = cls._measure(device) if device.type == "cuda" else dict(cls._CPU)
            return dict(cls._cached[key])

    @staticmethod
    def _measure(device: torch.device) -> dict:
        with torch.cuda.device(device):
            x = torch.zeros(1, device=device)
            x.add_(1)  # first launch outside the clock
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            x.add_(1)
            torch.cuda.synchronize(device)
            dispatch = max(time.perf_counter() - t0, 1e-6)
            probe = torch.empty(8 << 20, dtype=torch.uint8).pin_memory()
            t0 = time.perf_counter()
            d = probe.to(device, non_blocking=True)
            torch.cuda.synchronize(device)
            h2d = probe.numel() / max(time.perf_counter() - t0 - dispatch, 1e-6)
            back = torch.empty(probe.shape, dtype=probe.dtype, pin_memory=True)
            t0 = time.perf_counter()
            back.copy_(d, non_blocking=True)
            torch.cuda.synchronize(device)
            d2h = probe.numel() / max(time.perf_counter() - t0 - dispatch, 1e-6)
        return {"h2d_bw": h2d, "d2h_bw": d2h, "dispatch_s": dispatch,
                "sort_s_per_row": DEVICE_SORT_S_PER_ROW}


# host merge cost priors: stable u64 argsort + pack + dedup per SURVIVING
# row, vectorized predicate eval per row and term. They only steer the
# host/device choice.
_HOST_SORT_S_PER_ROW = 200e-9
_HOST_EVAL_S_PER_ROW = 2e-9


class _HostCalib:
    """Self-calibrating host-cost estimates: every sizable host merge and
    host predicate eval is timed in place and folded into a per-process
    EWMA. `HORAEDB_PLANNER_CALIB=off` freezes the priors."""

    ALPHA = 0.25
    MIN_ROWS = 50_000
    _sort = _HOST_SORT_S_PER_ROW
    _eval = _HOST_EVAL_S_PER_ROW

    @staticmethod
    def enabled() -> bool:
        return os.environ.get("HORAEDB_PLANNER_CALIB", "on") != "off"

    @classmethod
    def sort_s_per_row(cls) -> float:
        return cls._sort

    @classmethod
    def eval_s_per_row(cls) -> float:
        return cls._eval

    @classmethod
    def observe_sort(cls, rows: int, secs: float) -> None:
        if rows >= cls.MIN_ROWS and secs > 0 and cls.enabled():
            cls._sort += cls.ALPHA * (secs / rows - cls._sort)

    @classmethod
    def observe_eval(cls, rows_terms: int, secs: float) -> None:
        if rows_terms >= cls.MIN_ROWS and secs > 0 and cls.enabled():
            cls._eval += cls.ALPHA * (secs / rows_terms - cls._eval)


def _seq_rank(a: np.ndarray) -> tuple[np.ndarray, int]:
    """Dense rank of the write sequences (ns-clock ids: ranking saves ~50
    bits of sort key) and the number of distinct values."""
    uniq = np.unique(a)
    return np.searchsorted(uniq, a), len(uniq)


def _pack_sort_keys(col, sort_keys: tuple[str, ...], n: int):
    """Pack the (pk..., __seq__) sort keys into ONE u64 per row: pk columns
    offset to their min, __seq__ replaced by its dense rank. Returns
    (packed, seq_width, total_width) or None when a key is non-integer or
    the widths exceed 63 bits (bit 63 stays free for the sentinel). Shared
    by the host merge and kernel D, so both orders are the same."""
    if n == 0:
        return None
    encs: list[tuple[np.ndarray, int]] = []
    for name in sort_keys:
        a = col(name)
        if not np.issubdtype(a.dtype, np.integer):
            return None
        if name == SEQ_COLUMN_NAME:
            rank, nuniq = _seq_rank(a)
            enc = rank.astype(np.uint64)
            width = max(1, int(nuniq - 1).bit_length())
        else:
            lo, hi = int(a.min()), int(a.max())
            span = hi - lo
            if span >= (1 << 63):
                return None
            if a.dtype == np.uint64:
                enc = a - np.uint64(lo)
            else:
                enc = (a.astype(np.int64) - lo).astype(np.uint64)
            width = max(1, span.bit_length())
        encs.append((enc, width))
    total = sum(w for _, w in encs)
    if total > 63:
        return None
    packed = np.zeros(n, np.uint64)
    for enc, width in encs:
        packed = (packed << np.uint64(width)) | enc
    return packed, encs[-1][1], total


def sort_key_lanes(col_of, sort_keys: tuple[str, ...], device: torch.device):
    """(lanes, bounds, num_pk, names) for kernel F: every sort key as a
    mapped int64 lane on `device` (the seq as its dense rank) with its
    (min, max), leaving out keys constant over the rows, which change
    neither the order nor the runs; num_pk counts the primary-key lanes
    kept, and names[i] is the column of lanes[i]."""
    lanes, bounds, num_pk, names = [], [], 0, []
    for name in sort_keys:
        a = np.asarray(col_of(name))
        if not np.issubdtype(a.dtype, np.integer):
            raise NotPortedError(
                f"not ported yet: device merge over the non-integer sort key {name!r}")
        m = _seq_rank(a)[0].astype(np.int64) if name == SEQ_COLUMN_NAME else order_key(a)
        lo, hi = (int(m.min()), int(m.max())) if len(m) else (0, 0)
        if num_digits(lo, hi) == 0:
            continue
        lanes.append(to_device(m, device))
        bounds.append((lo, hi))
        names.append(name)
        num_pk += name != SEQ_COLUMN_NAME
    return lanes, bounds, num_pk, names


_I64_MIN = -(1 << 63)

# host dtypes whose `device_lane` is int64, the form `order_key` gives them
_I64_LANE_DTYPES = (np.dtype(np.int64), np.dtype(np.uint64), np.dtype(np.uint32))


def predicate_lanes(host: dict[str, np.ndarray], keys: dict[str, torch.Tensor],
                    device: torch.device) -> dict[str, torch.Tensor]:
    """Device lanes for the host columns `host`: kernel E's, and every lane
    the fused pass gathers. A primary key whose lane `keys` already holds
    on the device is read from there, since `order_key` and `device_lane`
    map 8-byte integer columns (and uint32) to the same int64 bytes; every
    other column is uploaded. (The seq lane holds a rank, not the
    column.)"""
    out = {}
    for c, a in host.items():
        shared = keys.get(c) if c != SEQ_COLUMN_NAME and a.dtype in _I64_LANE_DTYPES else None
        out[c] = shared if shared is not None else to_device(device_lane(a), device)
    return out


def _rows_presorted(arrays: dict, sort_keys: tuple) -> bool:
    """O(n) host check: nondecreasing lexicographic (pk..., __seq__) order."""
    n = len(arrays[sort_keys[0]])
    if n <= 1:
        return True
    tie = np.ones(n - 1, dtype=bool)
    for k in sort_keys:
        a = np.asarray(arrays[k])
        hd, tl = a[:-1], a[1:]
        if not np.all(~tie | (hd < tl) | (hd == tl)):
            return False
        tie = tie & (hd == tl)
        if not tie.any():
            return True
    return True


def _host_merge_indices(col_of, n_rows: int, sort_keys: tuple[str, ...], num_pk: int,
                        mask: np.ndarray | None, do_dedup: bool) -> np.ndarray:
    """Host merge: filter -> stable sort by (pk..., __seq__) -> last-value
    dedup. Returns row indices (into the unfiltered input) in output order.
    Rows compact through `mask` first, so the sort runs on survivors only.
    Presorted rows need no sort; otherwise one stable argsort of the packed
    key, or np.lexsort when the keys do not pack."""
    if mask is not None:
        base = np.nonzero(mask)[0]
        n = len(base)
    else:
        base = None
        n = n_rows
    if n == 0:
        return np.empty(0, np.int64)

    def col(name: str) -> np.ndarray:
        a = np.asarray(col_of(name))
        return a[base] if base is not None else a

    if _rows_presorted({k: np.asarray(col_of(k)) for k in sort_keys}, sort_keys):
        if do_dedup:
            keep = np.zeros(n, dtype=bool)
            keep[-1] = True
            for name in sort_keys[:num_pk]:
                a = col(name)
                keep[:-1] |= a[:-1] != a[1:]
            return base[keep] if base is not None else np.nonzero(keep)[0]
        return base if base is not None else np.arange(n)

    packres = _pack_sort_keys(col, sort_keys, n)
    if packres is not None:
        packed, seq_width, _ = packres
        order = np.argsort(packed, kind="stable")
        if do_dedup:
            group = packed[order] >> np.uint64(seq_width)
            keep = np.empty(n, dtype=bool)
            keep[:-1] = group[:-1] != group[1:]
            keep[-1] = True
        else:
            keep = None
    else:
        order = np.lexsort(tuple(col(k) for k in reversed(sort_keys)))
        if do_dedup:
            keep = np.zeros(n, dtype=bool)
            keep[-1] = True
            for name in sort_keys[:num_pk]:
                a = col(name)[order]
                keep[:-1] |= a[:-1] != a[1:]
        else:
            keep = None
    final = base[order] if base is not None else order
    return final[keep] if keep is not None else final


def _collect(out_idx: torch.Tensor, count: torch.Tensor) -> np.ndarray:
    """Sync point of a device merge: the survivors' row indices on the host."""
    k = int(count.item())
    if k == 0:
        return np.empty(0, np.int64)
    return out_idx[:k].cpu().numpy().astype(np.int64)


def _plan_and_merge(schema: StorageSchema, n: int, col_of, predicate: Predicate | None,
                    host_mask_fn, binary_pred: bool, itemsize_of, device: torch.device,
                    defer_device: bool = False):
    """Decide host vs device for one materializing merge and run it; returns
    the surviving row indices in output order, or, with `defer_device` and a
    device route, a zero-argument closure that returns them (the kernel is
    already queued, so the caller can overlap host work with it).

    Cost model: the device pays key-lane H2D, its sort rate, 4 B per
    survivor D2H and launch latency; the host pays a vectorized predicate
    eval over all rows plus sort/dedup over SURVIVING rows only. When the
    device wins even at worst-case selectivity, the predicate evaluates on
    the device (kernel E) and the host never evaluates it.
    `HORAEDB_SCAN_PATH` in {auto, host, device} pins the route; `sharded`
    forces the cross-slot sample sort over the installed mesh (the
    predicate, if any, evaluates on the host into the packed sentinel);
    in auto an installed mesh takes blocks of `_sharded_min_rows()` rows
    or more whose keys are not presorted. Binary-column predicates, and
    predicates beyond kernel E's limits (`filter_ops.program_fits`), always
    evaluate on the host, but may still merge on the device. Auto merges on
    the host when the sort keys outnumber kernel F's lanes
    (`merge_ops.MAX_KEYS`); the device route then refuses them."""
    pk_names = tuple(schema.primary_key_names)
    sort_keys = pk_names + (SEQ_COLUMN_NAME,)
    do_dedup = schema.update_mode == UpdateMode.OVERWRITE
    if n == 0:
        return np.empty(0, np.int64)
    pred_cols = filter_ops.pred_columns(predicate)
    host_pred = binary_pred or not filter_ops.program_fits(predicate)
    mode = scan_path_mode()
    link = _LinkProfile.get(device)
    dispatch = link["dispatch_s"]
    _presorted: list[bool] = []

    def keys_presorted() -> bool:
        if not _presorted:
            _presorted.append(_rows_presorted({k: np.asarray(col_of(k)) for k in sort_keys},
                                              sort_keys))
        return _presorted[0]

    def host_merge(mask: np.ndarray | None) -> np.ndarray:
        sel_rows = int(np.count_nonzero(mask)) if mask is not None else n
        t0 = time.perf_counter()
        res = _host_merge_indices(col_of, n, sort_keys, len(pk_names), mask, do_dedup)
        if _presorted and not _presorted[0]:  # the O(n) shortcut would poison the rate
            _HostCalib.observe_sort(sel_rows, time.perf_counter() - t0)
        return res

    key_bytes = sum(itemsize_of(name) for name in sort_keys)

    def finish(out_idx, count):
        if defer_device:
            return lambda: _collect(out_idx, count)
        return _collect(out_idx, count)

    def device_merge_packed(mask):
        """Kernel D over one packed key per row, or None when packing does
        not pay (a fast link) or the keys do not pack. With a mesh
        installed and the sharded route wanted, the cross-slot sample sort
        instead (kernel `sample_sort_merge`)."""
        from horaedb_tpu_torch.parallel import merge as mesh_merge
        from horaedb_tpu_torch.parallel.mesh import active_mesh

        mesh = active_mesh()
        if mode == "sharded" and mesh is None:
            # the likeliest harness mistake: the downgrade must be visible
            # (noted every time, logged once per process)
            scanstats.note("path_sharded_fallback_no_mesh")
            global _warned_sharded_no_mesh
            if not _warned_sharded_no_mesh:
                _warned_sharded_no_mesh = True
                logger.warning("HORAEDB_SCAN_PATH=sharded but no mesh is active; "
                               "falling back to the single-device kernel (n=%d)", n)
        # the size upgrade only in auto: an explicit device pin keeps the
        # single-device kernel even with a mesh installed
        want_sharded = mesh is not None and (
            mode == "sharded" or (mode == "auto" and n >= _sharded_min_rows()))
        if not want_sharded and (key_bytes - 8) / link["h2d_bw"] < 30e-9:
            return None
        packres = _pack_sort_keys(col_of, sort_keys, n)
        if packres is None:
            if want_sharded:
                scanstats.note("path_sharded_fallback_unpackable")
                logger.warning("sharded merge requested but sort keys do not pack into "
                               "u64; falling back to the single-device kernels (n=%d)", n)
            return None
        packed, seq_width, key_bits = packres
        if mask is not None:
            packed = np.where(mask, packed, PACK_SENTINEL)
        if want_sharded:
            scanstats.note("path_device_merge_sharded")
            return mesh_merge.sharded_packed_merge(packed, seq_width, do_dedup, mesh,
                                                   defer=defer_device, key_bits=key_bits)
        key = to_device(order_key(packed), device)
        return finish(*merge_ops.packed_merge(key, key_bits, seq_width, do_dedup))

    def device_merge(mask):
        if mask is not None or predicate is None:
            res = device_merge_packed(mask)
            if res is not None:
                return res
        keys, bounds, num_pk, key_names = sort_key_lanes(col_of, sort_keys, device)
        presorted = keys_presorted()
        if mask is not None:
            mask_t = to_device(mask.astype(np.uint8), device)
            return finish(*merge_ops.index_merge_mask(keys, bounds, num_pk, mask_t, do_dedup,
                                                      presorted))
        host = {c: np.asarray(col_of(c)) for c in sorted(pred_cols)}
        program = filter_ops.compile_program(predicate, {c: a.dtype for c, a in host.items()})
        lanes = predicate_lanes(host, dict(zip(key_names, keys)), device)
        return finish(*merge_ops.index_merge_filter(keys, bounds, num_pk, program, lanes, n,
                                                    do_dedup, presorted, device))

    # kernel E reads 8-byte primary keys from their sort-key lanes
    tmpl_bytes = key_bytes + sum(itemsize_of(c) for c in pred_cols
                                 if c not in pk_names or itemsize_of(c) != 8)

    def dev_cost(lane_bytes: int, sel: int) -> float:
        return (n * lane_bytes / link["h2d_bw"] + n * link["sort_s_per_row"]
                + sel * 4 / link["d2h_bw"] + 8 * dispatch)

    def host_cost(sel: int) -> float:
        # the arrow take of the survivors is paid by both routes alike
        return sel * _HostCalib.sort_s_per_row()

    n_terms = max(1, len(list(filter_ops.iter_nodes(predicate)))) if predicate is not None else 1

    def eval_mask() -> np.ndarray | None:
        if predicate is None:
            return None
        t0 = time.perf_counter()
        mask = host_mask_fn()
        _HostCalib.observe_eval(n * n_terms, time.perf_counter() - t0)
        return mask

    if mode == "device":
        return device_merge(eval_mask() if host_pred else None)
    if mode == "sharded":
        # force the cross-slot route: the predicate evaluates on the host
        # into a mask, so the packed merge (the only sharded one) applies
        return device_merge(eval_mask())
    if mode == "host" or len(sort_keys) > merge_ops.MAX_KEYS:
        return host_merge(eval_mask())
    # the mesh's auto upgrade: past the sharded threshold the cross-slot
    # merge supersedes the one-device cost compare; presorted blocks keep
    # their O(n) host shortcut
    if n >= _sharded_min_rows() and not keys_presorted():
        from horaedb_tpu_torch.parallel.mesh import active_mesh

        if active_mesh() is not None:
            return device_merge(eval_mask())
    if predicate is None:
        if not keys_presorted() and dev_cost(key_bytes, n) < host_cost(n):
            return device_merge(None)
        return host_merge(None)
    # auto with a predicate: if the device wins even at worst-case
    # selectivity, skip the host eval entirely
    eval_cost = n * _HostCalib.eval_s_per_row() * n_terms
    if not host_pred and dev_cost(tmpl_bytes, n) < eval_cost and not keys_presorted():
        return device_merge(None)
    mask = eval_mask()
    sel = int(np.count_nonzero(mask))
    if sel == 0:
        return np.empty(0, np.int64)
    if keys_presorted() or host_cost(sel) <= dev_cost(key_bytes + 1, sel):
        return host_merge(mask)
    return device_merge(mask)


def _order_tables_by_first_key(tables: list, sort_keys) -> list:
    """Order per-SST tables by their first row's sort key (each SST is
    sorted, so that row is its minimum): disjoint SSTs then concatenate into
    a sorted run, and the presorted shortcut applies."""
    if len(tables) <= 1:
        return tables
    return sorted(tables, key=lambda t: tuple(t.column(k)[0].as_py() for k in sort_keys))


# ---------------------------------------------------------------------------
# parquet IO with row-group pruning
# ---------------------------------------------------------------------------


# what a malformed sidecar raises: decode_blob's checks and its JSON
# header (a missing or mistyped field), and page metadata that does not add
# up (short payloads, dict ids past the dictionary, dictionary values
# outside the lane's dtype). Only these let a read fall back to the parquet
# object; a kernel that fails to build or launch (KernelError) and any CUDA
# error propagate.
_MALFORMED_SIDECAR = (HoraeError, ValueError, struct.error, KeyError, TypeError, IndexError,
                      OverflowError)


class ParquetReader:
    """Per-SST parquet and sidecar access and the per-segment scans.
    Merges and decodes run on `device` (the plain versions when it is the
    CPU). `sst_reads` counts SST reads by the branch they took (`encoded`
    or `parquet`)."""

    def __init__(self, store: ObjectStore, sst_path_gen: SstPathGenerator,
                 schema: StorageSchema, device: torch.device,
                 scan_block_rows: int = 32 * 1024 * 1024,
                 enc_cache_bytes: int = 32 * 1024 * 1024):
        self._store = store
        self._path_gen = sst_path_gen
        self._schema = schema
        self._device = device
        self._scan_block_rows = scan_block_rows
        # decoded `.enc` sidecars, LRU by resident bytes, and the fetches in
        # flight (single-flight: concurrent reads of one SST share a fetch)
        self._enc_lock = threading.Lock()
        self._enc_cache: OrderedDict[int, tuple] = OrderedDict()
        self._enc_inflight: dict[int, tuple] = {}
        self._enc_cache_bytes = 0
        self._enc_cache_cap = enc_cache_bytes
        self.sst_reads = {"encoded": 0, "parquet": 0}

    async def read_sst(self, sst: SstFile, columns: list[str] | None,
                       predicate: Predicate | None) -> pa.Table:
        """One SST's projected columns. A format-v2 SST is served from its
        encoded sidecar where the sidecar covers the columns (a missing or
        malformed sidecar reads the parquet object, which stays
        authoritative); otherwise row groups whose min/max statistics
        cannot satisfy the predicate are skipped. Decode runs in a worker
        thread."""
        if sst.meta.format_version >= 2 and decode_ops.scan_mode() != "raw":
            enc = await self._enc_sidecar(sst)
            if enc is not None:
                try:
                    table = await asyncio.to_thread(self._read_encoded, enc, columns, predicate)
                except KernelError:
                    raise
                except _MALFORMED_SIDECAR:
                    logger.warning("encoded read failed for sst %d; reading parquet", sst.id,
                                   exc_info=True)
                    table = None
                if table is not None:
                    self.sst_reads["encoded"] += 1
                    return table
        self.sst_reads["parquet"] += 1
        path = self._path_gen.generate(sst.id)
        local = self._store.local_path(path)
        if local is not None:
            def _read() -> pa.Table:
                try:
                    with pq.ParquetFile(local) as pf:
                        return _read_pruned(pf, columns, predicate)
                except FileNotFoundError as e:
                    raise NotFound(f"sst object vanished: {path}") from e

            return await asyncio.to_thread(_read)
        data = await self._store.get(path)

        def _read_bytes() -> pa.Table:
            with pq.ParquetFile(io.BytesIO(data)) as pf:
                return _read_pruned(pf, columns, predicate)

        return await asyncio.to_thread(_read_bytes)

    async def _enc_sidecar(self, sst: SstFile) -> "enc_mod.EncodedSst | None":
        """The cached decoded `.enc` sidecar of a format-v2 SST, or None
        (absent or corrupt: the parquet path covers it)."""
        loop = asyncio.get_running_loop()
        fut = None
        while True:
            with self._enc_lock:
                hit = self._enc_cache.get(sst.id)
                if hit is not None:
                    self._enc_cache.move_to_end(sst.id)
                    return hit[0]
                flight = self._enc_inflight.get(sst.id)
                if flight is None:
                    fut = loop.create_future()
                    self._enc_inflight[sst.id] = (loop, fut)
                    break
            f_loop, f_fut = flight
            if f_loop is not loop:
                break  # a caller on another loop: duplicate the fetch for this read
            # single-flight: the leader resolves the future with its verdict
            # (None on a transient failure: this read falls back to parquet)
            return await f_fut
        enc, cacheable = None, False
        try:
            enc, cacheable = await self._fetch_enc_sidecar(sst)
        finally:
            if fut is not None:
                if cacheable:
                    self._enc_cache_put(sst.id, enc)
                with self._enc_lock:
                    entry = self._enc_inflight.get(sst.id)
                    if entry is not None and entry[1] is fut:
                        del self._enc_inflight[sst.id]
                if not fut.done():
                    fut.set_result(enc)
        if fut is None and cacheable:
            self._enc_cache_put(sst.id, enc)
        return enc

    def _enc_cache_put(self, sst_id: int, enc) -> None:
        if self._enc_cache_cap <= 0:
            return
        nbytes = 64 if enc is None else enc.footprint_bytes() + 64
        with self._enc_lock:
            if sst_id not in self._enc_cache:
                self._enc_cache[sst_id] = (enc, nbytes)
                self._enc_cache_bytes += nbytes
                while self._enc_cache_bytes > self._enc_cache_cap and self._enc_cache:
                    _, (_, nb) = self._enc_cache.popitem(last=False)
                    self._enc_cache_bytes -= nb

    async def _fetch_enc_sidecar(self, sst: SstFile):
        """One store fetch and decode of an SST's `.enc` object: (sidecar or
        None, cacheable). A transient store failure is not cacheable (the
        SST is immutable; a cached None would send it to parquet for the
        entry's lifetime); NotFound and corrupt bytes are deterministic
        verdicts and are."""
        try:
            data = await self._store.get(self._path_gen.generate_enc(sst.id))
        except NotFound:
            return None, True
        except Exception:  # noqa: BLE001 - a transient store failure
            logger.warning("enc sidecar fetch failed for sst %d (transient; reading parquet)",
                           sst.id)
            return None, False
        try:
            enc = enc_mod.decode_blob(data)
            if enc.num_rows != sst.meta.num_rows:
                raise HoraeError(f"enc sidecar rows {enc.num_rows} != sst {sst.meta.num_rows}")
        except _MALFORMED_SIDECAR:
            logger.warning("unreadable enc sidecar for sst %d", sst.id)
            enc = None
        return enc, True

    def _read_encoded(self, enc: "enc_mod.EncodedSst", columns: list[str] | None,
                      predicate: Predicate | None) -> pa.Table | None:
        """One SST read served from its encoded sidecar: per-page zone
        pruning, the predicate on the encoded form, then the decode of the
        kept pages of each lane through the dispatcher's impl on this
        reader's device. None when the sidecar does not cover the columns
        (the caller reads parquet). The predicate filters rows here, before
        the merge, which drops only rows the merge's filter would drop."""
        schema = self._schema.arrow_schema
        names = [f.name for f in schema if columns is None or f.name in columns]
        if any(n not in enc.lanes for n in names):
            return None
        fields = [schema.field(n) for n in names]
        out_schema = pa.schema(fields)
        keep_pages, _ = enc_mod.prune_pages(enc, predicate)
        if not keep_pages:
            return out_schema.empty_table()

        def lane_decode(n: str) -> np.ndarray:
            lane = enc.lanes[n]
            rows = sum(lane.pages[p].rows for p in keep_pages)
            impl = decode_ops.choose(lane.codec, rows, self._device)
            return enc_mod.decode_lane(lane, keep_pages, impl=impl, device=self._device)

        decoded: dict[str, np.ndarray] = {}
        mask = None
        if predicate is not None:
            mask = enc_mod.encoded_mask(enc, predicate, keep_pages, None, decoded,
                                        decode=lane_decode)
            if mask is not None and bool(mask.all()):
                mask = None  # nothing rejected: skip the take
        sel = np.nonzero(mask)[0] if mask is not None else None
        if sel is not None and len(sel) == 0:
            return out_schema.empty_table()
        arrays = []
        for n, f in zip(names, fields):
            lane = enc.lanes[n]
            if lane.codec == "null":
                count = len(sel) if sel is not None else sum(
                    lane.pages[p].rows for p in keep_pages)
                arrays.append(pa.nulls(count, f.type))
                continue
            arr = decoded.get(n)
            if arr is None:
                arr = lane_decode(n)
            if sel is not None:
                arr = arr[sel]
            arrays.append(_np_to_arrow(arr, f.type))
        return pa.Table.from_arrays(arrays, schema=out_schema)

    async def _read_tables(self, ssts: list[SstFile], read_names: list[str],
                           predicate: Predicate | None) -> list[pa.Table]:
        tables = await asyncio.gather(*(self.read_sst(s, read_names, predicate) for s in ssts))
        return [t for t in tables if t.num_rows > 0]

    def _check_numeric_pk(self) -> None:
        if any(_is_binary_like(self._schema.arrow_schema.field(n).type)
               for n in self._schema.primary_key_names):
            raise NotPortedError("not ported yet: binary primary keys (the host scan route)")

    async def scan_segment(self, ssts: list[SstFile], predicate: Predicate | None,
                           projections: list[int] | None, keep_builtin: bool,
                           batch_size: int = DEFAULT_SCAN_BATCH_SIZE) -> list[pa.RecordBatch]:
        """Merged, deduped record batches of one time segment."""
        self._check_numeric_pk()
        schema = self._schema
        read_names = self._resolve_read_names(projections, keep_builtin)
        has_binary = any(_is_binary_like(schema.arrow_schema.field(n).type) for n in read_names)
        total_rows = sum(s.meta.num_rows for s in ssts)
        if total_rows > self._scan_block_rows and len(ssts) > 1 and not has_binary:
            return await self._scan_segment_chunked(ssts, predicate, projections,
                                                    keep_builtin, batch_size)
        tables = await self._read_tables(ssts, read_names, predicate)
        if not tables:
            return []
        tables = _order_tables_by_first_key(
            tables, tuple(schema.primary_key_names) + (SEQ_COLUMN_NAME,))
        table = pa.concat_tables(tables)
        out_names = self._output_names(read_names, keep_builtin)
        # append mode with binary values (every non-key column is a value
        # here): the fused pass sorts and flags the runs on the device, and
        # each run's bytes concatenate on the host
        if schema.update_mode == UpdateMode.APPEND and has_binary:
            sorted_cols, perm, _keep, starts, kept, numeric, binary = self._fused_pass(
                table, predicate)
            k = int(kept.item())
            host = {c: host_lane(sorted_cols[c][:k].cpu().numpy(),
                                 numpy_dtype(table.schema.field(c).type))
                    for c in numeric if c in out_names}
            result = await asyncio.to_thread(
                self._materialize_append_mode, table, host, perm[:k].cpu().numpy(),
                starts[:k].cpu().numpy(), k, binary, out_names)
            return self._slice_batches(result, batch_size)
        idx = self._merge_table(table, predicate)
        if len(idx) == 0:
            return []
        result = table.select(out_names).take(pa.array(idx)).combine_chunks()
        return [b for b in result.to_batches(max_chunksize=batch_size) if b.num_rows > 0]

    def _merge_table(self, table: pa.Table, predicate: Predicate | None) -> np.ndarray:
        """_plan_and_merge over a decoded arrow table; each lane the merge
        touches converts to numpy once."""
        lanes: dict[str, np.ndarray] = {}

        def col_of(name: str) -> np.ndarray:
            if name not in lanes:
                lanes[name] = arrow_column_to_numpy(table.column(name))
            return lanes[name]

        pred_cols = filter_ops.pred_columns(predicate)
        binary_pred = any(_is_binary_like(table.schema.field(c).type)
                          for c in pred_cols if c in table.schema.names)

        def host_mask_fn() -> np.ndarray:
            if binary_pred:
                return filter_ops.eval_predicate_host(predicate, table)
            return filter_ops.eval_predicate_np(predicate, {c: col_of(c) for c in pred_cols})

        def itemsize_of(name: str) -> int:
            t = table.schema.field(name).type
            try:
                return max(1, t.bit_width // 8)
            except (ValueError, AttributeError):
                return 16  # variable-width: rough planning estimate

        return _plan_and_merge(self._schema, table.num_rows, col_of, predicate, host_mask_fn,
                               binary_pred, itemsize_of, self._device)

    async def _scan_segment_chunked(self, ssts: list[SstFile], predicate: Predicate | None,
                                    projections: list[int] | None, keep_builtin: bool,
                                    batch_size: int) -> list[pa.RecordBatch]:
        """Chunked scan: per-chunk merges (filter + merge + dedup) of at most
        `scan_block_rows` rows, then merges of the sorted runs until one is
        left. Last-value dedup is idempotent across levels; append mode
        never dedups. The next chunk's parquet decode runs while the current
        chunk's device merge is in flight."""
        schema = self._schema
        all_names = schema.arrow_schema.names
        read_names = self._resolve_read_names(projections, keep_builtin)
        sort_keys = tuple(schema.primary_key_names) + (SEQ_COLUMN_NAME,)
        cap = self._scan_block_rows

        def greedy_partition(items: list, rows_of) -> list[list]:
            out, cur, cur_rows = [], [], 0
            for it in items:
                r = rows_of(it)
                if cur and cur_rows + r > cap:
                    out.append(cur)
                    cur, cur_rows = [], 0
                cur.append(it)
                cur_rows += r
            if cur:
                out.append(cur)
            return out

        def run_block(arrays: dict[str, np.ndarray], pred, defer: bool = False):
            """Merge one block: the planner routes host vs device; survivors
            gather from the host arrays. With `defer`, a device-routed
            merge returns a closure producing the gathered block."""
            n = len(arrays[sort_keys[0]])
            p_cols = filter_ops.pred_columns(pred)

            def host_mask_fn() -> np.ndarray:
                return filter_ops.eval_predicate_np(pred, {c: arrays[c] for c in p_cols})

            res = _plan_and_merge(schema, n, arrays.__getitem__, pred, host_mask_fn, False,
                                  lambda name: arrays[name].dtype.itemsize, self._device,
                                  defer_device=defer)
            if callable(res):
                return lambda: {k: a[res()] for k, a in arrays.items()}
            return {k: a[res] for k, a in arrays.items()}

        level: list[dict[str, np.ndarray]] = []
        chunks = greedy_partition(ssts, lambda s: s.meta.num_rows)
        next_task = asyncio.ensure_future(
            self._read_tables(chunks[0], read_names, predicate)) if chunks else None
        pending = None  # the previous chunk's deferred device merge

        def settle() -> None:
            nonlocal pending
            if pending is not None:
                out = pending()
                pending = None
                if len(out[sort_keys[0]]):
                    level.append(out)

        try:
            for i in range(len(chunks)):
                tables = await next_task
                next_task = None
                if i + 1 < len(chunks):
                    next_task = asyncio.ensure_future(
                        self._read_tables(chunks[i + 1], read_names, predicate))
                    await asyncio.sleep(0)  # let the prefetch reach its threads
                if not tables:
                    continue
                table = pa.concat_tables(_order_tables_by_first_key(tables, sort_keys))
                arrays = {name: arrow_column_to_numpy(table.column(name))
                          for name in table.schema.names}
                out = run_block(arrays, predicate, defer=True)
                settle()
                if callable(out):
                    pending = out
                elif len(out[sort_keys[0]]):
                    level.append(out)
            settle()
        except BaseException:
            if next_task is not None:
                next_task.cancel()
                try:
                    await next_task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            raise
        while len(level) > 1:
            next_level = []
            for group in greedy_partition(level, lambda r: len(r[sort_keys[0]])):
                if len(group) == 1:
                    next_level.append(group[0])
                    continue
                cat = {k: np.concatenate([g[k] for g in group]) for k in group[0]}
                next_level.append(run_block(cat, None))
            if len(next_level) == len(level):
                # every pair exceeds the cap: merge the two smallest runs
                next_level.sort(key=lambda r: len(r[sort_keys[0]]))
                a, b = next_level[0], next_level[1]
                cat = {k: np.concatenate([a[k], b[k]]) for k in a}
                next_level = [run_block(cat, None)] + next_level[2:]
            level = next_level
        if not level:
            return []
        final = level[0]
        out_names = self._output_names(read_names, keep_builtin)
        fields = [schema.arrow_schema.field(all_names.index(n)) for n in out_names]
        cols = [_np_to_arrow(final[f.name], f.type) for f in fields]
        result = pa.RecordBatch.from_arrays(cols, schema=pa.schema(fields))
        return self._slice_batches(result, batch_size)

    async def scan_segment_downsample(
        self,
        ssts: list[SstFile],
        predicate: Predicate | None,
        ts_column: str,
        value_column: str,
        series_column: str,
        series_ids: np.ndarray,
        t0: int,
        bucket_ms: int,
        num_buckets: int,
        with_minmax: bool = True,
        packed_ok: bool = False,
    ) -> dict:
        """Reduce one segment to host [num_series, num_buckets] grids of sum
        and count (plus min/max when `with_minmax`; no mean: callers derive
        it after folding segments). `series_ids` is SORTED; grid row i is
        series_ids[i], rows of other series drop.

        Segments above `scan_block_rows` take the chunked scan and reduce
        its merged, sorted batches; others take the packed pass when
        `packed_ok` (the caller pins every primary-key column but series and
        time), and the fused route (`_fused_pass`, then kernels `downsample`
        and `grouped_stats` on the gathered lanes) when the packed pass
        declines or is not asked for. Integer value columns give integer
        sum and count grids (uint64 for unsigned columns)."""
        num_series = len(series_ids)
        grids = {"sum": np.zeros((num_series, num_buckets)),
                 "count": np.zeros((num_series, num_buckets))}
        if with_minmax:
            grids["min"] = np.full((num_series, num_buckets), np.inf)
            grids["max"] = np.full((num_series, num_buckets), -np.inf)

        def dense_sid(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            """(dense position, hit mask). Misses keep their monotone
            searchsorted position, not -1, and are excluded by the mask."""
            pos = np.searchsorted(series_ids, col)
            pos_c = np.clip(pos, 0, max(0, num_series - 1))
            return pos_c.astype(np.int32), series_ids[pos_c] == col

        from horaedb_tpu_torch.parallel.mesh import active_mesh

        mesh = active_mesh()

        def accumulate_sorted(ts_np, sid_np, val_np, valid_np=None) -> None:
            """Fold one sorted run into the grids. With a mesh installed the
            rows shard over "rows" and the grid over "series"
            (`mesh_downsample`: the key kernel, B and C per slot, then
            `grid_fold`); otherwise the single-device sorted reduction."""
            if mesh is not None:
                out = self._sharded_accumulate(mesh, ts_np, sid_np, val_np, t0, bucket_ms,
                                               num_series, num_buckets, with_minmax,
                                               valid_np=valid_np)
            else:
                out = agg_ops.downsample_sorted(
                    ts_np, sid_np, val_np, t0, bucket_ms, num_series=num_series,
                    num_buckets=num_buckets, with_minmax=with_minmax, valid=valid_np,
                    device=self._device)
                # lane attribution: the registry impl the calibrated dispatcher
                # chose for this fold, before the dtype routing; the engine's
                # f64 values run kernel B (or its plain version) whatever the
                # choice
                scanstats.note("agg_impl_" + agg_registry.last_choice())
                out = {k: v.cpu().numpy() for k, v in out.items()}
            grids["sum"] += out["sum"]
            grids["count"] += out["count"]
            if with_minmax:
                grids["min"] = np.minimum(grids["min"], out["min"])
                grids["max"] = np.maximum(grids["max"], out["max"])

        total_rows = sum(s.meta.num_rows for s in ssts)
        if total_rows > self._scan_block_rows and len(ssts) > 1:
            batches = await self._scan_segment_chunked(ssts, predicate, None, False,
                                                       batch_size=self._scan_block_rows)
            for b in batches:
                sp, hit = dense_sid(arrow_column_to_numpy(b.column(series_column)))
                accumulate_sorted(arrow_column_to_numpy(b.column(ts_column)), sp,
                                  arrow_column_to_numpy(b.column(value_column)),
                                  valid_np=hit if not hit.all() else None)
            return grids

        read_names = self._resolve_read_names(None, False)
        tables = await self._read_tables(ssts, read_names, predicate)
        if not tables:
            return grids
        tables = _order_tables_by_first_key(
            tables, tuple(self._schema.primary_key_names) + (SEQ_COLUMN_NAME,))
        table = pa.concat_tables(tables)
        sid, sid_hit = dense_sid(arrow_column_to_numpy(table.column(series_column)))
        fast = (packed_downsample_pass(table, predicate, sid, sid_hit, ts_column, value_column,
                                       num_series, self._schema.update_mode)
                if packed_ok else None)
        if fast is not None:
            ts_s, sid_s, val_s = fast
            if len(ts_s):
                accumulate_sorted(ts_s, sid_s, val_s)
            return grids

        # the fused route: the dense series index rides the scan pass's
        # permutation as a lane, and the hit mask too when some rows belong
        # to series outside the query (skipped when every row hits)
        extra = {"__sid__": sid}
        all_hit = bool(sid_hit.all())
        if not all_hit:
            extra["__sidok__"] = sid_hit.astype(np.int32)
        sorted_cols, _perm, keep, _starts, _kept, _num, _bin = self._fused_pass(
            table, predicate, extra_arrays=extra)
        row_ok = keep if all_hit else keep & (sorted_cols["__sidok__"] != 0)
        vtype = table.schema.field(value_column).type
        unsigned = pa.types.is_unsigned_integer(vtype)
        values = sorted_cols[value_column]
        if vtype == pa.uint64():
            values = values ^ _I64_MIN  # the mapped lane back to the raw u64 bits
        out = agg_ops.downsample(sorted_cols[ts_column].to(torch.int64), sorted_cols["__sid__"],
                                 values, row_ok, t0, bucket_ms, num_series, num_buckets,
                                 unsigned=unsigned)
        for k in list(grids):
            g = out[k].cpu().numpy()
            grids[k] = g.view(np.uint64) if unsigned and k in ("sum", "count") else g
        return grids

    @staticmethod
    def _sharded_accumulate(mesh, ts_np, sid_np, val_np, t0, bucket_ms, num_series: int,
                            num_buckets: int, with_minmax: bool, valid_np=None) -> dict:
        """One sorted run reduced over the mesh (`parallel/mesh.py::
        mesh_downsample`, which owns the series padding, the per-lane row
        pads and the dtype rule)."""
        from horaedb_tpu_torch.parallel.mesh import mesh_downsample

        return mesh_downsample(mesh, ts_np, sid_np, val_np, t0, bucket_ms, num_series,
                               num_buckets, with_minmax=with_minmax, valid_np=valid_np,
                               sorted_input=True)

    def _fused_pass(self, table: pa.Table, predicate: Predicate | None,
                    extra_arrays: dict[str, np.ndarray] | None = None):
        """The shared fused device pass: the numeric/binary split, every
        numeric column (and `extra_arrays`, host lanes such as the dense
        series index) uploaded once as a device lane, and kernel
        `scan_kernel` (filter -> sort -> gather -> flags; `ops/scan.py` has
        the output contract). Returns (sorted lanes, perm, keep, starts,
        kept, numeric names, binary names), all device tensors but the
        names. The predicate runs on the device, or on the host when kernel
        E cannot take it (a binary column, or past `program_fits`)."""
        schema = self._schema
        pk_names = tuple(schema.primary_key_names)
        sort_keys = pk_names + (SEQ_COLUMN_NAME,)
        numeric_names, binary_names = [], []
        for name in table.schema.names:
            (binary_names if _is_binary_like(table.schema.field(name).type)
             else numeric_names).append(name)
        if not all(k in numeric_names for k in sort_keys):
            raise HoraeError("primary key and seq columns must be numeric for the device path")
        arrays = {name: arrow_column_to_numpy(table.column(name)) for name in numeric_names}
        if extra_arrays:
            arrays.update(extra_arrays)
        n = table.num_rows
        dev = self._device
        keys, bounds, num_pk, key_names = sort_key_lanes(arrays.__getitem__, sort_keys, dev)
        lanes = predicate_lanes(arrays, dict(zip(key_names, keys)), dev)
        pred_cols = filter_ops.pred_columns(predicate)
        program, mask = None, None
        if predicate is not None:
            if any(c not in arrays for c in pred_cols) or not filter_ops.program_fits(predicate):
                mask = to_device(filter_ops.eval_predicate_host(predicate, table).astype(np.uint8),
                                 dev)
            else:
                program = filter_ops.compile_program(
                    predicate, {c: a.dtype for c, a in arrays.items()})
        do_dedup = schema.update_mode == UpdateMode.OVERWRITE and not binary_names
        sorted_cols, perm, keep, starts, kept = scan_ops.scan_kernel(
            lanes, keys, bounds, num_pk, program, n, do_dedup,
            _rows_presorted(arrays, sort_keys), dev, mask=mask)
        return sorted_cols, perm, keep, starts, kept, numeric_names, binary_names

    # -- shared prologue/epilogue ---------------------------------------------
    def _resolve_read_names(self, projections: list[int] | None, keep_builtin: bool) -> list[str]:
        """Columns to fetch: the projection plus the primary key and
        __seq__, plus __reserved__ when builtins are kept."""
        proj = self._schema.fill_required_projections(projections)
        all_names = self._schema.arrow_schema.names
        read_names = list(all_names) if proj is None else [all_names[i] for i in sorted(proj)]
        if keep_builtin and RESERVED_COLUMN_NAME not in read_names:
            read_names.append(RESERVED_COLUMN_NAME)
        return read_names

    @staticmethod
    def _output_names(read_names: list[str], keep_builtin: bool) -> list[str]:
        """Everything fetched minus builtins unless keep_builtin."""
        return [n for n in read_names if keep_builtin or not StorageSchema.is_builtin_name(n)]

    @staticmethod
    def _slice_batches(result: pa.RecordBatch, batch_size: int) -> list[pa.RecordBatch]:
        if result.num_rows == 0:
            return []
        return [result.slice(i, batch_size) for i in range(0, result.num_rows, batch_size)]

    def _materialize_append_mode(self, table: pa.Table, sorted_cols: dict[str, np.ndarray],
                                 perm: np.ndarray, starts: np.ndarray, kept: int,
                                 binary_names: list[str], out_names: list[str]) -> pa.RecordBatch:
        """Append mode with binary values: each primary-key run collapses to
        one row whose binary value columns concatenate the run's bytes in
        (pk, seq) order, as the JAX package's BytesMergeOperator does; every other
        column takes the run's first row. The runs come from the device's
        run-start flags; `sorted_cols` holds the gathered numeric lanes'
        first `kept` rows as host columns."""
        value_names = {self._schema.arrow_schema.names[i] for i in self._schema.value_idxes}
        start_idx = np.nonzero(starts[:kept])[0]
        ends = np.append(start_idx[1:], kept)
        cols = []
        for name in out_names:
            f = table.schema.field(name)
            if name in binary_names:
                src = table.column(name).combine_chunks().take(pa.array(perm[:kept]))
                if name in value_names:
                    vals = src.to_pylist()
                    cols.append(pa.array(
                        [b"".join(v for v in vals[lo:hi] if v is not None)
                         for lo, hi in zip(start_idx, ends)], type=f.type))
                else:
                    cols.append(src.take(pa.array(start_idx)))
            else:
                cols.append(_np_to_arrow(sorted_cols[name][start_idx], f.type))
        return pa.RecordBatch.from_arrays(
            cols, schema=pa.schema([table.schema.field(n) for n in out_names]))


# packed-key budget of the downsample pass: sid | ts-offset | seq-rank must
# fit below bit 63
PACK_SID_BITS = 17
PACK_TS_BITS = 34   # ~198 days of ms offsets within one scan
PACK_SEQ_BITS = 12  # distinct write sequences per segment


def packed_downsample_pass(table: pa.Table, predicate, sid, sid_valid, ts_column: str,
                           value_column: str, num_series: int, update_mode: UpdateMode):
    """(dense sid, ts, seq-rank) packed into one u64 per row; the predicate
    evaluates on the host, rejected rows sink to PACK_SENTINEL, one stable
    argsort merges, and the last row of each (sid, ts) group among the
    surviving rows wins (highest seq-rank). Returns (ts, sid, values) as
    sorted, deduped host lanes, or None when a budget is exceeded (too
    many series, write sequences or ms of span) or in append mode.

    Dedup is by (sid, ts), not the full primary key: the caller pins every
    other primary-key column (the engine pins metric_id with an eq
    predicate; field_id is constant)."""
    if update_mode != UpdateMode.OVERWRITE:
        return None
    if num_series >= (1 << PACK_SID_BITS):
        return None
    ts_np = arrow_column_to_numpy(table.column(ts_column))
    n = len(ts_np)
    if n == 0:
        return (np.empty(0, np.int64),) * 3
    seq_np = arrow_column_to_numpy(table.column(SEQ_COLUMN_NAME))
    uniq_seq = np.unique(seq_np)
    if len(uniq_seq) > (1 << PACK_SEQ_BITS):
        return None
    ts_min = int(ts_np.min())
    if int(ts_np.max()) - ts_min >= (1 << PACK_TS_BITS):
        return None
    mask = sid_valid.copy()
    if predicate is not None:
        mask &= filter_ops.eval_predicate_host(predicate, table)
    srank = (np.searchsorted(uniq_seq, seq_np).astype(np.uint64)
             if len(uniq_seq) > 1 else np.zeros(n, np.uint64))
    shift_ts = np.uint64(PACK_SEQ_BITS)
    shift_sid = np.uint64(PACK_SEQ_BITS + PACK_TS_BITS)
    packed = ((sid.astype(np.int64).astype(np.uint64) << shift_sid)
              | ((ts_np - ts_min).astype(np.uint64) << shift_ts)
              | srank)
    packed = np.where(mask, packed, PACK_SENTINEL)
    perm = np.argsort(packed, kind="stable")
    packed_s = packed[perm]
    group = packed_s >> shift_ts
    keep = np.empty(n, dtype=bool)
    keep[:-1] = group[:-1] != group[1:]
    keep[-1] = True
    keep &= packed_s != PACK_SENTINEL
    idx = perm[keep]
    return ts_np[idx], sid[idx].astype(np.int32), arrow_column_to_numpy(
        table.column(value_column))[idx]


def _select_row_groups(meta, arrow_schema, predicate) -> list[int]:
    """Row groups whose min/max statistics can satisfy the predicate."""
    keep_groups = []
    unsigned = {name for name in arrow_schema.names
                if pa.types.is_unsigned_integer(arrow_schema.field(name).type)}
    for rg in range(meta.num_row_groups):
        stats: dict[str, tuple] = {}
        g = meta.row_group(rg)
        for ci in range(g.num_columns):
            col = g.column(ci)
            st = col.statistics
            if st is not None and st.has_min_max:
                name = col.path_in_schema
                lo = _stat_value(st.min, name in unsigned)
                hi = _stat_value(st.max, name in unsigned)
                if lo > hi:  # u64 range straddling 2**63 wrapped; stats unusable
                    continue
                stats[name] = (lo, hi)
        if filter_ops.prune_range(predicate, stats):
            keep_groups.append(rg)
    return keep_groups


def _read_pruned(pf: pq.ParquetFile, columns: list[str] | None,
                 predicate: Predicate | None) -> pa.Table:
    keep_groups = _select_row_groups(pf.metadata, pf.schema_arrow, predicate)
    if not keep_groups:
        schema = pf.schema_arrow
        if columns is not None:
            schema = pa.schema([schema.field(c) for c in columns])
        return schema.empty_table()
    return pf.read_row_groups(keep_groups, columns=columns, use_threads=True)


def _stat_value(v, is_unsigned: bool = False):
    """Normalize parquet statistics to the numeric domain predicates use:
    timestamp columns report datetime (literals are epoch ms), and uint64
    columns are stored as signed int64, so ids >= 2**63 come back negative
    and must re-wrap."""
    import calendar
    import datetime

    if isinstance(v, datetime.datetime):
        return calendar.timegm(v.utctimetuple()) * 1000 + v.microsecond // 1000
    if is_unsigned and isinstance(v, int) and v < 0:
        return v + (1 << 64)
    return v


def _np_to_arrow(arr: np.ndarray, t: pa.DataType) -> pa.Array:
    if t == pa.timestamp("ms"):
        return pa.array(arr.astype("datetime64[ms]"))
    return pa.array(arr, type=t)
