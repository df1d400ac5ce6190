"""Lightweight columnar encodings for SST lanes + the compressed-domain
scan helpers (LSM-OPD arXiv:2508.11862).

A copy of the JAX package's `storage/encoding.py`, byte-compatible both
ways: the same table encodes to the same sidecar bytes in either package,
and either package decodes the other's. `decode_lane` takes the device the
`device` impl decodes on (ops/decode.py: the hand-written kernels on the
card, their plain versions on the CPU).

An encoded SST is a `.enc` sidecar object next to the parquet file (the
same pattern as the bloom sidecar): per-lane encoded PAGES with min/max
zone maps, self-described by a JSON header. The parquet object remains the
durable, universally-readable representation — the sidecar is the scan
accelerator, and a reader that cannot use it (v1 SST, missing lane,
unsupported dtype) falls back to the parquet path with identical results.

Codecs (chosen per lane by measured encoded size, never guessed):

  rle    sorted/run-heavy integer lanes (tsid): (run values, run lengths);
         predicates evaluate PER RUN and expand — run skipping instead of
         row-wise masks.
  dict   low-cardinality integer lanes (tag/id): lane-level dictionary +
         bit-packed ids; predicates rewrite to dict-id comparisons (the
         predicate runs over the dictionary, not the rows).
  dod    timestamps: per-page (first, first_delta) + zigzag bit-packed
         second-order deltas (Gorilla-style). Regular scrape intervals
         pack to ~0 bits/row.
  xor    float values: per-page first raw bits + bit-packed XOR stream of
         consecutive bit patterns (Gorilla's float trick, fixed-width per
         page instead of per-value varint — vectorizable on both ends).
  null   all-null lanes (__reserved__): zero payload.
  raw    passthrough bytes (still pages + zone maps, so pruning works).

Page boundaries are SHARED across lanes (page i covers the same rows in
every lane), so a page pruned by one lane's zone map drops that row range
from every lane before any decode.

Bit-exactness contract: decode(encode(x)) == x for every codec, verified
bit-for-bit by tests/test_encoding.py (floats compare on their u64 bit
patterns, so NaN payloads and -0.0 survive).

This module and ops/decode.py (the device kernels) are the only decode
funnels, reached through ParquetReader's encoded read path.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.backend import DEFAULT_DEVICE
from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import decode as decode_ops
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops.blocks import arrow_column_to_numpy

# sidecar wire format: magic | version u8 | header_len u32 | header JSON
# | payload bytes
ENC_MAGIC = 0xE27C_0DEC
ENC_VERSION = 1
_HEADER = struct.Struct("<IBI")

# FileMeta.format_version values: v1 = plain parquet SST (no sidecar),
# v2 = parquet + encoded-lane sidecar
SST_FORMAT_V1 = 1
SST_FORMAT_V2 = 2

DEFAULT_PAGE_ROWS = 4096

_U64_ONE = np.uint64(1)
_U64_63 = np.uint64(63)

_DTYPES = {"<i8", "<i4", "<u8", "<u4", "<f8", "<f4"}


# ---------------------------------------------------------------------------
# bit packing (LSB-first within the stream; payload padded to u32 words so
# the device kernel can view it as a word lane)
# ---------------------------------------------------------------------------


def pack_bits(vals: np.ndarray, width: int) -> bytes:
    """Pack u64 `vals` (each < 2**width) into an LSB-first bitstream,
    padded to a multiple of 4 bytes (u32 word alignment for the device
    unpack kernel)."""
    if width == 0 or len(vals) == 0:
        return b""
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((vals[:, None] >> shifts) & _U64_ONE).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    pad = (-len(packed)) % 4
    return packed + b"\x00" * pad


def unpack_bits(buf: bytes, n: int, width: int) -> np.ndarray:
    """Inverse of pack_bits -> u64 array of length n.

    width <= 32 takes the vectorized word-gather (the host mirror of the
    device kernel's two-word bit-window read: O(n), no per-bit matrix);
    wider values can span three u32 words, so they fall back to the
    unpackbits matrix — rare in practice (only near-incompressible lanes
    pack wider than 32, and those lose to raw at codec choice)."""
    if width == 0 or n == 0:
        return np.zeros(n, np.uint64)
    if width <= 32:
        words = np.frombuffer(buf, "<u4").astype(np.uint64)
        w = np.empty(len(words) + 1, np.uint64)  # +1 guard word: the
        w[:-1] = words                           # last straddle read
        w[-1] = 0
        bit = np.arange(n, dtype=np.uint64) * np.uint64(width)
        wi = (bit >> np.uint64(5)).astype(np.int64)
        off = bit & np.uint64(31)
        comb = w[wi] | (w[wi + 1] << np.uint64(32))
        return (comb >> off) & np.uint64((1 << width) - 1)
    bits = np.unpackbits(
        np.frombuffer(buf, np.uint8), count=n * width, bitorder="little"
    ).reshape(n, width).astype(np.uint64)
    shifts = np.arange(width, dtype=np.uint64)
    return (bits << shifts).sum(axis=1, dtype=np.uint64)


def zigzag(v: np.ndarray) -> np.ndarray:
    """i64 -> u64 zigzag (small magnitudes -> small codes), mod-2^64 safe."""
    uv = np.ascontiguousarray(v, dtype=np.int64).view(np.uint64)
    return (uv << _U64_ONE) ^ (np.uint64(0) - (uv >> _U64_63))


def unzigzag(z: np.ndarray) -> np.ndarray:
    uv = (z >> _U64_ONE) ^ (np.uint64(0) - (z & _U64_ONE))
    return uv.view(np.int64)


def _bit_width(vals: np.ndarray) -> int:
    if len(vals) == 0:
        return 0
    m = int(vals.max())
    return m.bit_length()


# ---------------------------------------------------------------------------
# encoded representation
# ---------------------------------------------------------------------------


@dataclass
class EncPage:
    """One page of one lane. `p0`/`p1` are codec parameters:
    dod: (first, first_delta); xor: (first value's u64 bits, 0);
    rle: (number of runs, 0); dict/raw/null: unused."""

    rows: int
    off: int
    length: int
    lo: "int | float | None"
    hi: "int | float | None"
    width: int = 0
    p0: int = 0
    p1: int = 0


@dataclass
class EncLane:
    name: str
    codec: str  # rle | dict | dod | xor | null | raw
    dtype: str  # numpy dtype str of the decoded lane
    rows: int
    pages: list[EncPage]
    dict_values: "list[int] | None" = None
    payload: bytes = b""

    def encoded_bytes(self) -> int:
        n = sum(p.length for p in self.pages)
        if self.dict_values is not None:
            # the dictionary ships as decimal text inside the sidecar's
            # JSON header (encode_blob), not as fixed-width words — charge
            # the wire what it actually pays so the >=_MIN_WIN codec race
            # and the bytes/row bench stay honest for large-id dicts
            n += len(json.dumps(self.dict_values, separators=(",", ":")))
        return n

    def decoded_bytes(self) -> int:
        return self.rows * np.dtype(self.dtype).itemsize


@dataclass
class EncodedSst:
    """Decoded sidecar: lanes share page boundaries (`page_rows`)."""

    num_rows: int
    page_rows: int
    lanes: dict[str, EncLane] = field(default_factory=dict)

    @property
    def num_pages(self) -> int:
        if self.num_rows == 0:
            return 0
        return -(-self.num_rows // self.page_rows)

    def descriptor(self) -> tuple[tuple[str, str], ...]:
        """(lane, codec) pairs — the FileMeta/manifest-pb encoding
        descriptor and the EXPLAIN provenance payload."""
        return tuple((n, l.codec) for n, l in self.lanes.items())

    def footprint_bytes(self) -> int:
        """Resident size of this decoded sidecar — what the reader's
        byte-bounded cache charges per entry: lane payloads (the dominant
        term; held as bytes) + dictionaries + per-page header objects."""
        n = 0
        for lane in self.lanes.values():
            n += len(lane.payload)
            if lane.dict_values is not None:
                n += len(lane.dict_values) * 8
            n += len(lane.pages) * 96  # EncPage object overhead
        return n


# ---------------------------------------------------------------------------
# per-codec encode (host, vectorized numpy)
# ---------------------------------------------------------------------------


def _page_slices(n: int, page_rows: int) -> list[tuple[int, int]]:
    return [(i, min(i + page_rows, n)) for i in range(0, n, page_rows)]


def _zone(arr: np.ndarray) -> tuple:
    """(lo, hi) page statistics; None when unusable (NaN present)."""
    if len(arr) == 0:
        return None, None
    if np.issubdtype(arr.dtype, np.floating):
        if np.isnan(arr).any():
            return None, None
        return float(arr.min()), float(arr.max())
    return int(arr.min()), int(arr.max())


def _encode_rle(arr: np.ndarray, page_rows: int) -> EncLane | None:
    pages, parts, off = [], [], 0
    for s, e in _page_slices(len(arr), page_rows):
        page = arr[s:e]
        change = np.flatnonzero(page[1:] != page[:-1])
        starts = np.concatenate(([0], change + 1))
        values = page[starts]
        lengths = np.diff(np.concatenate((starts, [len(page)]))).astype("<u4")
        blob = values.astype(arr.dtype.newbyteorder("<")).tobytes() + lengths.tobytes()
        lo, hi = _zone(values)
        pages.append(EncPage(rows=len(page), off=off, length=len(blob),
                             lo=lo, hi=hi, p0=len(values)))
        parts.append(blob)
        off += len(blob)
    return EncLane("", "rle", arr.dtype.str, len(arr), pages, payload=b"".join(parts))


def _encode_dict(arr: np.ndarray, page_rows: int, max_dict: int) -> EncLane | None:
    uniq, inv = np.unique(arr, return_inverse=True)
    if len(uniq) > max_dict:
        return None
    width = _bit_width(np.asarray([max(0, len(uniq) - 1)], np.uint64))
    inv = inv.astype(np.uint64)
    pages, parts, off = [], [], 0
    for s, e in _page_slices(len(arr), page_rows):
        blob = pack_bits(inv[s:e], width)
        lo, hi = _zone(arr[s:e])
        pages.append(EncPage(rows=e - s, off=off, length=len(blob),
                             lo=lo, hi=hi, width=width))
        parts.append(blob)
        off += len(blob)
    return EncLane("", "dict", arr.dtype.str, len(arr), pages,
                   dict_values=[int(v) for v in uniq], payload=b"".join(parts))


def _encode_dod(arr: np.ndarray, page_rows: int) -> EncLane | None:
    if not np.issubdtype(arr.dtype, np.signedinteger):
        return None
    a = arr.astype(np.int64, copy=False)
    pages, parts, off = [], [], 0
    for s, e in _page_slices(len(a), page_rows):
        page = a[s:e]
        lo, hi = _zone(page)
        first = int(page[0])
        if len(page) >= 2:
            # deltas mod 2^64 (u64 wrap), exact on decode by the same wrap
            d = (page.view(np.uint64)[1:] - page.view(np.uint64)[:-1]).view(np.int64)
            first_delta = int(d[0])
            dd = zigzag((d.view(np.uint64)[1:] - d.view(np.uint64)[:-1]).view(np.int64))
            width = _bit_width(dd)
            blob = pack_bits(dd, width)
        else:
            first_delta, width, blob = 0, 0, b""
        pages.append(EncPage(rows=len(page), off=off, length=len(blob),
                             lo=lo, hi=hi, width=width, p0=first, p1=first_delta))
        parts.append(blob)
        off += len(blob)
    return EncLane("", "dod", arr.dtype.str, len(a), pages, payload=b"".join(parts))


def _encode_xor(arr: np.ndarray, page_rows: int) -> EncLane | None:
    if arr.dtype not in (np.float64, np.float32):
        return None
    wide = arr.dtype == np.float64
    bits = arr.view(np.uint64 if wide else np.uint32).astype(np.uint64)
    pages, parts, off = [], [], 0
    for s, e in _page_slices(len(arr), page_rows):
        page = bits[s:e]
        lo, hi = _zone(arr[s:e])
        first = int(page[0])
        if len(page) >= 2:
            x = page[1:] ^ page[:-1]
            width = _bit_width(x)
            blob = pack_bits(x, width)
        else:
            width, blob = 0, b""
        pages.append(EncPage(rows=len(page), off=off, length=len(blob),
                             lo=lo, hi=hi, width=width, p0=first))
        parts.append(blob)
        off += len(blob)
    return EncLane("", "xor", arr.dtype.str, len(arr), pages, payload=b"".join(parts))


def _encode_raw(arr: np.ndarray, page_rows: int) -> EncLane:
    pages, parts, off = [], [], 0
    little = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    for s, e in _page_slices(len(arr), page_rows):
        blob = little[s:e].tobytes()
        lo, hi = _zone(arr[s:e])
        pages.append(EncPage(rows=e - s, off=off, length=len(blob), lo=lo, hi=hi))
        parts.append(blob)
        off += len(blob)
    return EncLane("", "raw", arr.dtype.str, len(arr), pages, payload=b"".join(parts))


# A non-raw codec must beat raw by this factor to be chosen: decoding
# costs real scan-time work, so a near-tie (xor over incompressible
# values packs to ~1.0x) must lose to raw's free frombuffer decode.
_MIN_WIN = 0.8


def encode_lane(name: str, arr: np.ndarray, page_rows: int = DEFAULT_PAGE_ROWS,
                max_dict: int = 4096, prefer_ts: bool = False) -> EncLane:
    """Encode one lane, choosing the codec by MEASURED encoded size: the
    smallest wins, but a non-raw codec must be at least 1/_MIN_WIN
    smaller than raw (decode is paid per scan; a size near-tie decodes
    strictly slower than raw's frombuffer). Raw is always a candidate,
    so encoding never inflates beyond the page/zone-map overhead.
    `prefer_ts` (the time column) drops dict from the candidate list —
    range predicates probe time lanes per page, and a dict-encoded ts
    page answers them only after a full dictionary gather, so even a
    size win there would lose the scan; among the remaining candidates
    size still decides."""
    ensure(arr.ndim == 1, f"lane {name!r} must be 1-D")
    if arr.dtype.str not in _DTYPES:
        raise HoraeError(f"lane {name!r} dtype {arr.dtype} not encodable")
    candidates: list[EncLane] = []
    if np.issubdtype(arr.dtype, np.integer) and len(arr):
        n_runs = 1 + int(np.count_nonzero(arr[1:] != arr[:-1]))
        if n_runs * 2 <= len(arr):
            c = _encode_rle(arr, page_rows)
            if c is not None:
                candidates.append(c)
        if not prefer_ts:
            c = _encode_dict(arr, page_rows, max_dict)
            if c is not None:
                candidates.append(c)
        if np.issubdtype(arr.dtype, np.signedinteger):
            c = _encode_dod(arr, page_rows)
            if c is not None:
                candidates.append(c)
    elif len(arr):
        c = _encode_xor(arr, page_rows)
        if c is not None:
            candidates.append(c)
    raw = _encode_raw(arr, page_rows)
    budget = raw.encoded_bytes() * _MIN_WIN
    winners = [c for c in candidates if c.encoded_bytes() <= budget]
    best = min(winners, key=lambda c: c.encoded_bytes()) if winners else raw
    best.name = name
    return best


# ---------------------------------------------------------------------------
# per-codec decode (host, vectorized numpy — the sanctioned host funnel)
# ---------------------------------------------------------------------------


def _page_payload(lane: EncLane, p: EncPage) -> bytes:
    return lane.payload[p.off:p.off + p.length]


def dict_array(dict_values, dt: np.dtype) -> np.ndarray:
    """Lane dictionary as a typed array (u64 values survive the JSON
    round trip as Python ints above 2^63). Shared with the device
    kernels in ops/decode.py, which upload its bits: ONE materialization
    of the JSON-int convention, so host and device can never drift."""
    if np.issubdtype(dt, np.unsignedinteger):
        vals = np.asarray([np.uint64(v) for v in dict_values], np.uint64)
    else:
        vals = np.asarray(dict_values, np.int64)
    return vals.astype(dt, copy=False)


def _decode_page_host(lane: EncLane, p: EncPage) -> np.ndarray:
    dt = np.dtype(lane.dtype)
    if lane.codec == "raw":
        return np.frombuffer(_page_payload(lane, p), dtype=dt.newbyteorder("<"),
                             count=p.rows).astype(dt, copy=False)
    if lane.codec == "rle":
        blob = _page_payload(lane, p)
        vals = np.frombuffer(blob, dtype=dt.newbyteorder("<"), count=p.p0)
        lengths = np.frombuffer(blob, dtype="<u4", count=p.p0,
                                offset=p.p0 * dt.itemsize)
        return np.repeat(vals.astype(dt, copy=False), lengths.astype(np.int64))
    if lane.codec == "dict":
        ids = unpack_bits(_page_payload(lane, p), p.rows, p.width).astype(np.int64)
        return dict_array(lane.dict_values, dt)[ids]
    if lane.codec == "dod":
        if p.rows == 1:
            return np.asarray([p.p0], dtype=np.int64).astype(dt, copy=False)
        first = np.uint64(p.p0 & 0xFFFF_FFFF_FFFF_FFFF)
        first_delta = np.uint64(p.p1 & 0xFFFF_FFFF_FFFF_FFFF)
        dd = unzigzag(unpack_bits(_page_payload(lane, p), p.rows - 2, p.width))
        d = np.empty(p.rows - 1, np.uint64)
        d[0] = first_delta
        np.cumsum(dd.view(np.uint64), out=d[1:])  # mod-2^64 prefix sum
        d[1:] += first_delta
        out = np.empty(p.rows, np.uint64)
        out[0] = first
        np.cumsum(d, out=out[1:])
        out[1:] += first
        return out.view(np.int64).astype(dt, copy=False)
    if lane.codec == "xor":
        wide = dt == np.float64
        if p.rows == 1:
            bits = np.asarray([p.p0], np.uint64)
        else:
            x = unpack_bits(_page_payload(lane, p), p.rows - 1, p.width)
            bits = np.empty(p.rows, np.uint64)
            bits[0] = np.uint64(p.p0)
            np.bitwise_xor.accumulate(
                np.concatenate((bits[:1], x)), out=bits
            )
        if wide:
            return bits.view(np.float64)
        return bits.astype(np.uint32).view(np.float32)
    raise HoraeError(f"unknown codec {lane.codec!r}")


def decode_lane(lane: EncLane, page_idxs: "list[int] | None" = None,
                impl: str = "host", device=DEFAULT_DEVICE) -> np.ndarray:
    """Decode a lane (or a subset of its pages, in page order) to the exact
    original array. `impl="device"` decodes every page inside the device
    envelope on `device` in one launch (ops/decode.py::decode_pages) and
    serves each page outside it (width > 32) from the host funnel. The
    pages of a codec the kernels take are counted per lane, by where they
    were decoded (decode_ops.page_counts)."""
    pages = lane.pages if page_idxs is None else [lane.pages[i] for i in page_idxs]
    dt = np.dtype(lane.dtype)
    if not pages:
        return np.empty(0, dt)
    if impl == "device" and lane.codec in decode_ops.DEVICE_CODECS:
        ok = [decode_ops.in_envelope(lane.codec, dt, p, lane.dict_values) for p in pages]
        on_dev = [p for p, k in zip(pages, ok) if k]
        decode_ops.note_pages(lane.name, len(on_dev), len(pages) - len(on_dev))
        got = decode_ops.decode_pages(lane.codec, dt, lane.payload, on_dev, lane.dict_values,
                                      device) if on_dev else None
        if len(on_dev) == len(pages):
            return got
        parts, at = [], 0
        for p, k in zip(pages, ok):
            if k:
                parts.append(got[at:at + p.rows])
                at += p.rows
            else:
                parts.append(_decode_page_host(lane, p))
    else:
        if lane.codec in decode_ops.DEVICE_CODECS:
            decode_ops.note_pages(lane.name, 0, len(pages))
        parts = [_decode_page_host(lane, p) for p in pages]
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


# ---------------------------------------------------------------------------
# table <-> sidecar blob
# ---------------------------------------------------------------------------


def encode_table(table: pa.Table, page_rows: int = DEFAULT_PAGE_ROWS,
                 max_dict: int = 4096, time_column: "str | None" = None,
                 lanes: "list[str] | None" = None) -> "EncodedSst | None":
    """Encode every eligible column of `table` into an EncodedSst; None
    when no lane qualifies (all-binary schema). A lane with partial nulls
    is skipped (readers needing it fall back to parquet); an ALL-null lane
    encodes as codec `null` (zero payload)."""
    enc = EncodedSst(num_rows=table.num_rows, page_rows=page_rows)
    for field_ in table.schema:
        name = field_.name
        if lanes is not None and name not in lanes:
            continue
        col = table.column(name)
        if col.null_count == table.num_rows and table.num_rows > 0:
            pages = [EncPage(rows=e - s, off=0, length=0, lo=None, hi=None)
                     for s, e in _page_slices(table.num_rows, page_rows)]
            enc.lanes[name] = EncLane(name, "null", "<u8", table.num_rows, pages)
            continue
        if col.null_count > 0:
            continue
        try:
            arr = arrow_column_to_numpy(col.combine_chunks())
        except (HoraeError, KeyError, pa.ArrowInvalid):
            continue  # binary/unsupported lane: parquet remains its home
        if arr.dtype.str not in _DTYPES:
            continue
        is_ts = time_column is not None and name == time_column
        enc.lanes[name] = encode_lane(name, arr, page_rows=page_rows,
                                      max_dict=max_dict, prefer_ts=is_ts)
    return enc if enc.lanes else None


def encode_blob(enc: EncodedSst) -> bytes:
    header = {
        "num_rows": enc.num_rows,
        "page_rows": enc.page_rows,
        "lanes": [
            {
                "name": l.name, "codec": l.codec, "dtype": l.dtype,
                "rows": l.rows, "dict": l.dict_values, "payload_off": 0,
                "pages": [
                    [p.rows, p.off, p.length, p.lo, p.hi, p.width, p.p0, p.p1]
                    for p in l.pages
                ],
            }
            for l in enc.lanes.values()
        ],
    }
    # assign payload offsets lane by lane
    off = 0
    payloads = []
    for lane_hdr, lane in zip(header["lanes"], enc.lanes.values()):
        lane_hdr["payload_off"] = off
        payloads.append(lane.payload)
        off += len(lane.payload)
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(ENC_MAGIC, ENC_VERSION, len(hj)) + hj + b"".join(payloads)


def decode_blob(data: bytes) -> EncodedSst:
    ensure(len(data) >= _HEADER.size, "enc sidecar shorter than header")
    magic, version, hlen = _HEADER.unpack_from(data, 0)
    ensure(magic == ENC_MAGIC, "invalid enc sidecar magic")
    ensure(version == ENC_VERSION, f"unsupported enc sidecar version {version}")
    ensure(len(data) >= _HEADER.size + hlen, "enc sidecar header truncated")
    header = json.loads(data[_HEADER.size:_HEADER.size + hlen])
    body = data[_HEADER.size + hlen:]
    enc = EncodedSst(num_rows=header["num_rows"], page_rows=header["page_rows"])
    for lh in header["lanes"]:
        pages = [EncPage(rows=r, off=o, length=ln, lo=lo, hi=hi, width=w,
                         p0=a, p1=b)
                 for r, o, ln, lo, hi, w, a, b in lh["pages"]]
        size = sum(p.length for p in pages)
        poff = lh["payload_off"]
        # extent + row-count validation: a TRUNCATED payload behind an
        # intact header must fail HERE (one deterministic, cacheable
        # verdict at load) — never as a short-buffer ValueError inside a
        # per-page np.frombuffer mid-query
        ensure(poff + size <= len(body),
               f"enc sidecar payload truncated: lane {lh['name']!r} needs "
               f"[{poff}, {poff + size}) of {len(body)} payload bytes")
        ensure(sum(p.rows for p in pages) == lh["rows"],
               f"enc sidecar page rows disagree for lane {lh['name']!r}")
        enc.lanes[lh["name"]] = EncLane(
            lh["name"], lh["codec"], lh["dtype"], lh["rows"], pages,
            dict_values=lh["dict"], payload=body[poff:poff + size],
        )
    return enc


# ---------------------------------------------------------------------------
# compressed-domain predicate evaluation
# ---------------------------------------------------------------------------


def page_stats(enc: EncodedSst, page: int) -> dict[str, tuple]:
    """Zone map of one page across lanes, in filter_ops.prune_range form."""
    out = {}
    for name, lane in enc.lanes.items():
        p = lane.pages[page]
        if p.lo is not None and p.hi is not None:
            out[name] = (p.lo, p.hi)
    return out


def prune_pages(enc: EncodedSst, predicate) -> tuple[list[int], int]:
    """(kept page indices, pruned count) by per-page min/max zone maps —
    the page analog of parquet row-group pruning, conservative for any
    predicate shape."""
    if predicate is None:
        return list(range(enc.num_pages)), 0
    keep = [
        p for p in range(enc.num_pages)
        if filter_ops.prune_range(predicate, page_stats(enc, p))
    ]
    return keep, enc.num_pages - len(keep)


class EncodedEvalStats:
    """Provenance of one compressed-domain predicate evaluation."""

    def __init__(self) -> None:
        self.runs_skipped = 0
        self.dict_rewrites = 0


def _run_expand(run_mask: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return np.repeat(run_mask, lengths.astype(np.int64))


def encoded_mask(enc: EncodedSst, predicate, keep_pages: list[int],
                 stats: "EncodedEvalStats | None" = None,
                 decoded: "dict[str, np.ndarray] | None" = None,
                 decode=None) -> "np.ndarray | None":
    """Row mask of `predicate` over the concatenated kept pages, computed
    in the compressed domain where the codec allows:

    - rle lanes: the compare runs PER RUN (one compare per run, not per
      row) and expands; runs rejected whole are `runs_skipped`;
    - dict lanes: the compare runs over the DICTIONARY, then the packed
      ids probe a boolean LUT — the tsid-predicate-to-dict-id rewrite;
    - everything else decodes the lane (into `decoded`, shared with the
      caller so materialization never decodes twice; via the caller's
      `decode(name)` hook when given — the reader threads the calibrated
      dispatcher through it — else the host funnel) and evaluates with
      the exact same numpy semantics as filter_ops.eval_predicate_np.

    Returns None when the predicate references a lane the sidecar does
    not carry (caller falls back to the parquet path)."""
    if predicate is None:
        return None
    if decoded is None:
        decoded = {}

    def lane_values(name: str) -> np.ndarray:
        a = decoded.get(name)
        if a is None:
            a = (decode(name) if decode is not None
                 else decode_lane(enc.lanes[name], keep_pages))
            decoded[name] = a
        return a

    def ev(p) -> np.ndarray:
        if isinstance(p, filter_ops.And):
            m = ev(p.children[0])
            for c in p.children[1:]:
                m = m & ev(c)
            return m
        if isinstance(p, filter_ops.Or):
            m = ev(p.children[0])
            for c in p.children[1:]:
                m = m | ev(c)
            return m
        if isinstance(p, filter_ops.Not):
            return ~ev(p.child)
        if isinstance(p, (filter_ops.Compare, filter_ops.InSet)):
            name = p.column
            lane = enc.lanes[name]
            if lane.codec == "rle":
                return _rle_node_mask(lane, p, keep_pages, stats)
            if lane.codec == "dict":
                return _dict_node_mask(lane, p, keep_pages, stats)
            cols = {name: lane_values(name)}
            return filter_ops.eval_predicate_np(p, cols)
        raise HoraeError(f"unsupported predicate node {type(p).__name__}")

    for col in filter_ops.pred_columns(predicate):
        if col not in enc.lanes or enc.lanes[col].codec == "null":
            return None
    try:
        return ev(predicate)
    except HoraeError:
        return None


def _node_mask_on_values(node, values: np.ndarray) -> np.ndarray:
    return filter_ops.eval_predicate_np(node, {node.column: values})


def _rle_node_mask(lane: EncLane, node, keep_pages: list[int],
                   stats: "EncodedEvalStats | None") -> np.ndarray:
    dt = np.dtype(lane.dtype)
    parts = []
    for pi in keep_pages:
        p = lane.pages[pi]
        blob = _page_payload(lane, p)
        vals = np.frombuffer(blob, dtype=dt.newbyteorder("<"), count=p.p0).astype(dt, copy=False)
        lengths = np.frombuffer(blob, dtype="<u4", count=p.p0, offset=p.p0 * dt.itemsize)
        run_mask = _node_mask_on_values(node, vals)
        if stats is not None:
            stats.runs_skipped += int(len(run_mask) - np.count_nonzero(run_mask))
        parts.append(_run_expand(run_mask, lengths))
    return np.concatenate(parts) if parts else np.empty(0, bool)


def _dict_node_mask(lane: EncLane, node, keep_pages: list[int],
                    stats: "EncodedEvalStats | None") -> np.ndarray:
    dt = np.dtype(lane.dtype)
    lut = _node_mask_on_values(node, dict_array(lane.dict_values, dt))
    if stats is not None:
        stats.dict_rewrites += 1
    parts = []
    for pi in keep_pages:
        p = lane.pages[pi]
        ids = unpack_bits(_page_payload(lane, p), p.rows, p.width).astype(np.int64)
        parts.append(lut[ids])
    return np.concatenate(parts) if parts else np.empty(0, bool)
