"""Partial-grid wire schema and the canonical distributed merge.

A port of the JAX package's `cluster/partial.py`, byte-compatible with
its wire: each computing node runs its region shards through the engine's
scan and answers with per-region (sum, count, min, max, mean) grids per
(series, bucket); the coordinator folds them. Bit-exactness of the
distributed result rests on two invariants this module owns:

- **Wire fidelity.** Grid arrays cross the wire as raw little-endian
  buffers with their dtype, so NaN payloads and -0.0 survive. The
  single-partial shortcut in `merge_grids` returns the decoded part as is,
  so the wire carries every grid key the engine produced.
- **Fixed fold order.** `merge_partials` sorts fragments into the
  coordinator's canonical region order (`list(engine.engines)`) and folds
  left exactly like the single-node merge. Same order and same
  elementwise rules give bit-identical grids.

`merge_grids` is the single implementation of the fold; the regioned
engine's merge delegates here. With a mesh it folds on the slots (kernel
`grid_fold`), bitwise equal to the host fold.
"""

from __future__ import annotations

import json
import struct

import numpy as np

MAGIC = b"HDPG1\n"
WIRE_CONTENT_TYPE = "application/x-horaedb-partial-grids"
# grid keys in canonical wire order (extra keys append after, sorted)
_KNOWN_KEYS = ("sum", "count", "min", "max", "mean")


def _key_order(grids: dict) -> "list[str]":
    known = [k for k in _KNOWN_KEYS if k in grids]
    extra = sorted(set(grids) - set(_KNOWN_KEYS))
    return known + extra


def _little_endian(a: np.ndarray) -> np.ndarray:
    if a.dtype.byteorder == ">":  # pragma: no cover — big-endian hosts
        return a.byteswap().view(a.dtype.newbyteorder("<"))
    return a


def encode_partials(
    node: str,
    parts: "list[tuple[int, list, dict]]",
    provenance: "dict | None" = None,
) -> bytes:
    """Serialize per-region partial grids to wire bytes.

    `parts` is [(region_id, tsids, grids)] as `query_partial_grids` returns
    them. Layout: MAGIC, u32 header length, JSON header (node, provenance
    and a per-region array directory), then the raw array payload: tsids
    as little-endian u64, each grid in its own dtype's little-endian bytes.
    The header carries offsets into the payload."""
    blobs: list[bytes] = []
    offset = 0

    def _append(buf: bytes) -> int:
        nonlocal offset
        blobs.append(buf)
        start = offset
        offset += len(buf)
        return start

    regions = []
    for region_id, tsids, grids in parts:
        t = _little_endian(np.ascontiguousarray(np.asarray(list(tsids), dtype=np.uint64)))
        entry = {
            "region_id": int(region_id),
            "n_series": int(t.shape[0]),
            "tsids": {"offset": _append(t.tobytes()), "nbytes": t.nbytes},
            "grids": {},
        }
        n_buckets = None
        for key in _key_order(grids):
            g = _little_endian(np.ascontiguousarray(np.asarray(grids[key])))
            n_buckets = int(g.shape[1]) if g.ndim == 2 else 0
            entry["grids"][key] = {
                "offset": _append(g.tobytes()),
                "nbytes": g.nbytes,
                "dtype": g.dtype.str,
            }
        entry["n_buckets"] = n_buckets
        regions.append(entry)

    header = {
        "node": str(node),
        "provenance": dict(provenance or {}),
        "regions": regions,
    }
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return b"".join([MAGIC, struct.pack("<I", len(hdr)), hdr, *blobs])


def decode_partials(buf: bytes) -> "tuple[dict, list[tuple[int, list, dict]]]":
    """Inverse of `encode_partials`: (header dict, parts). Grid arrays come
    back with their exact wire dtype and bytes (views of `buf`); tsids as
    Python ints, the engine-local (tsids, grids) shape the fold takes."""
    if buf[: len(MAGIC)] != MAGIC:
        raise ValueError("not a partial-grid payload (bad magic)")
    pos = len(MAGIC)
    (hdr_len,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    header = json.loads(buf[pos: pos + hdr_len])
    payload = memoryview(buf)[pos + hdr_len:]
    parts = []
    for entry in header.get("regions", ()):
        toff = entry["tsids"]["offset"]
        tsids = np.frombuffer(
            payload[toff: toff + entry["tsids"]["nbytes"]], dtype="<u8"
        ).tolist()
        n = entry["n_series"]
        grids = {}
        for key, spec in entry["grids"].items():
            g = np.frombuffer(
                payload[spec["offset"]: spec["offset"] + spec["nbytes"]],
                dtype=np.dtype(spec["dtype"]),
            )
            nb = entry.get("n_buckets") or 0
            grids[key] = g.reshape(n, nb) if n * nb == g.size else g
        parts.append((int(entry["region_id"]), tsids, grids))
    return header, parts


def merge_grids(results: list, device_mesh=None):
    """THE distributed / regioned grid fold: union the series axis, add
    sums and counts, min/max elementwise, recompute mean; left to right in
    the caller's order. A single partial returns as is (dtype and mean
    untouched: one region's own output is the answer).

    `device_mesh` routes the elementwise fold through the mesh's grid fold
    (parallel/merge.py::sharded_grid_fold, kernel `grid_fold` on the card)
    when every grid is f64 and `device_fold_safe` holds for the mesh; the
    per-cell left fold is order-identical, so the mesh route is bitwise
    equal to the host route."""
    if len(results) == 1:
        return results[0]
    all_tsids = sorted({t for tsids, _ in results for t in tsids})
    pos = {t: i for i, t in enumerate(all_tsids)}
    n_buckets = next(iter(results[0][1].values())).shape[1]
    shape = (len(all_tsids), n_buckets)
    use_device = device_mesh is not None and all(
        np.asarray(part[k]).dtype == np.float64
        for _, part in results for k in ("sum", "count", "min", "max")
    )
    if use_device:
        # bitwise precondition: a platform that flushes f64 subnormals
        # would launder denormal cells the host fold keeps; probe once
        from horaedb_tpu_torch.parallel.merge import device_fold_safe

        use_device = device_fold_safe(device_mesh)
    if use_device:
        # align each partial into a stacked [k, S, B] lane (identity rows
        # where a partial lacks the series), then fold on the slots
        stacked = {
            "sum": np.zeros((len(results),) + shape),
            "count": np.zeros((len(results),) + shape),
            "min": np.full((len(results),) + shape, np.inf),
            "max": np.full((len(results),) + shape, -np.inf),
        }
        for j, (tsids, part) in enumerate(results):
            idx = np.asarray([pos[t] for t in tsids], dtype=np.int64)
            for k in ("sum", "count", "min", "max"):
                stacked[k][j, idx] = np.asarray(part[k])
        from horaedb_tpu_torch.parallel.merge import sharded_grid_fold

        grids = sharded_grid_fold(device_mesh, stacked)
    else:
        grids = {
            "sum": np.zeros(shape),
            "count": np.zeros(shape),
            "min": np.full(shape, np.inf),
            "max": np.full(shape, -np.inf),
        }
        for tsids, part in results:
            idx = np.asarray([pos[t] for t in tsids], dtype=np.int64)
            np.add.at(grids["sum"], idx, np.asarray(part["sum"]))
            np.add.at(grids["count"], idx, np.asarray(part["count"]))
            np.minimum.at(grids["min"], idx, np.asarray(part["min"]))
            np.maximum.at(grids["max"], idx, np.asarray(part["max"]))
    with np.errstate(invalid="ignore", divide="ignore"):
        grids["mean"] = grids["sum"] / grids["count"]
    return all_tsids, grids


def merge_partials(
    parts: "list[tuple[int, list, dict]]",
    order: "list[int] | None" = None,
    device_mesh=None,
):
    """Coordinator entry: fold fragments gathered from any number of nodes
    in the CANONICAL region order. `order` is the coordinator's region-id
    iteration order (`list(engine.engines)`); fragments for unknown regions
    sort after, by id. Returns (tsids, grids), or None when no region
    produced rows."""
    if not parts:
        return None
    if order is not None:
        rank = {int(r): i for i, r in enumerate(order)}
        parts = sorted(
            parts, key=lambda p: (rank.get(int(p[0]), len(rank)), int(p[0]))
        )
    else:
        parts = sorted(parts, key=lambda p: int(p[0]))
    return merge_grids([(tsids, grids) for _, tsids, grids in parts],
                       device_mesh=device_mesh)
