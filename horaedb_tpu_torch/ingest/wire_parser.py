"""Remote-write wire decoder, vectorized over messages with numpy.

A port of the JAX package's `ingest/wire_parser.py`, the hand-rolled
decoder without the protobuf runtime: the same columnar output, zero-copy
(label names and values are (offset, length) slices of the caller's
payload), and the same strictness (groups, field number 0, truncated and
overlong varints and out-of-bounds lengths are malformed; unknown fields
and known fields of another wire type are skipped; a repeated scalar
field keeps its last value). The JAX decoder walks every field in Python;
this one walks the top-level message in Python and every nested level for
all its messages at once: each numpy step reads the next field of every
message still open, so a level costs one step per field of its longest
message (14 for a TSBS series of 11 labels and 3 samples), not one per
field in the payload.

It also records each series' label byte range (`series_key_lo`/`_hi`),
the engine's id-cache key.
"""

from __future__ import annotations

import numpy as np

from horaedb_tpu_torch.common.error import HoraeError
from horaedb_tpu_torch.ingest.types import ParsedWriteRequest

_PAD = 10  # the longest varint: reads past the end land in zero padding
_SHIFTS = (7 * np.arange(10)).astype(np.uint64)


def _malformed() -> HoraeError:
    return HoraeError("malformed remote-write payload")


def _varint(buf: bytes, i: int, end: int) -> tuple[int, int]:
    """(value, next_index); raises on truncation/overlong."""
    shift = 0
    v = 0
    while i < end:
        b = buf[i]
        i += 1
        if shift == 63:
            if b > 1:
                raise _malformed()
            return v | (b << 63), i
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7
    raise _malformed()


def _varints(u8: np.ndarray, pos: np.ndarray, end: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(values u64, next positions) of the varints at `pos`, each of which
    must end at or before its `end`. One-byte varints (most tags and
    lengths) take one gather; the rest read a 10-byte window."""
    b0 = u8[pos]
    val = b0.astype(np.uint64)
    nxt = pos + 1
    multi = np.flatnonzero(b0 >= 0x80)
    if len(multi):
        p = pos[multi]
        win = u8[p[:, None] + np.arange(10)]
        cont = win >= 0x80
        if cont.all(axis=1).any():
            raise _malformed()
        n = np.argmin(cont, axis=1) + 1  # bytes up to the first without continuation
        tenth = n == 10
        if tenth.any() and (win[tenth, 9] > 1).any():
            raise _malformed()
        keep = np.arange(10) < n[:, None]
        parts = np.where(keep, win & 0x7F, 0).astype(np.uint64) << _SHIFTS
        val[multi] = np.bitwise_or.reduce(parts, axis=1)
        nxt[multi] = p + n
    if (nxt > end).any():
        raise _malformed()
    return val, nxt


class _Fields:
    """Every field of a set of messages, in message order and, within a
    message, in wire order: owning message, field number, wire type, tag
    position, body position (after the tag, and after the length for a
    length-delimited field), varint value or length, and field end."""

    __slots__ = ("msg", "field", "wt", "tag", "body", "val", "end")

    def __init__(self, u8: np.ndarray, starts: np.ndarray, ends: np.ndarray):
        cols = {k: [] for k in self.__slots__}
        msg = np.arange(len(starts), dtype=np.int64)
        cur = np.asarray(starts, dtype=np.int64)
        lim = np.asarray(ends, dtype=np.int64)
        live = cur < lim
        msg, cur, lim = msg[live], cur[live], lim[live]
        while len(msg):
            tag, body = _varints(u8, cur, lim)
            field = (tag >> np.uint64(3)).astype(np.int64)
            wt = (tag & np.uint64(7)).astype(np.int64)
            if (field == 0).any() or ((wt != 0) & (wt != 1) & (wt != 2) & (wt != 5)).any():
                raise _malformed()
            val = np.zeros(len(msg), dtype=np.uint64)
            fend = body.copy()
            for w, width in ((1, 8), (5, 4)):
                sel = wt == w
                fend[sel] = body[sel] + width
            for w in (0, 2):
                sel = np.flatnonzero(wt == w)
                if len(sel):
                    v, nxt = _varints(u8, body[sel], lim[sel])
                    val[sel] = v
                    if w == 0:
                        fend[sel] = nxt
                    else:
                        if (v > (lim[sel] - nxt).astype(np.uint64)).any():
                            raise _malformed()
                        body[sel] = nxt
                        fend[sel] = nxt + v.astype(np.int64)
            if (fend > lim).any():
                raise _malformed()
            for k, a in (("msg", msg), ("field", field), ("wt", wt), ("tag", cur),
                         ("body", body), ("val", val), ("end", fend)):
                cols[k].append(a)
            live = fend < lim
            msg, cur, lim = msg[live], fend[live], lim[live]
        if not cols["msg"]:
            for k in self.__slots__:
                setattr(self, k, np.zeros(0, dtype=np.uint64 if k == "val" else np.int64))
            return
        # steps ran in wire order: a stable sort by message keeps it
        order = np.argsort(np.concatenate(cols["msg"]), kind="stable")
        for k in self.__slots__:
            setattr(self, k, np.concatenate(cols[k])[order])

    def of(self, field: int, wt: int) -> np.ndarray:
        return np.flatnonzero((self.field == field) & (self.wt == wt))


def _last(n: int, f: _Fields, sel: np.ndarray, lane: np.ndarray, dtype) -> np.ndarray:
    """Per message, `lane` at its last field of `sel` (fields run in wire
    order, so a later assignment wins), zero where it has none."""
    out = np.zeros(n, dtype=dtype)
    out[f.msg[sel]] = lane[sel].astype(dtype)
    return out


def _labels(u8, starts, ends):
    """(name_off, name_len, value_off, value_len) of Label messages."""
    n = len(starts)
    f = _Fields(u8, starts, ends)
    name, value = f.of(1, 2), f.of(2, 2)
    return (_last(n, f, name, f.body, np.int64), _last(n, f, name, f.val, np.int64),
            _last(n, f, value, f.body, np.int64), _last(n, f, value, f.val, np.int64))


def _f64_at(u8: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(u8[pos[:, None] + np.arange(8)]).view("<f8").reshape(-1)


def _count_starts(owner: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    count = np.bincount(owner, minlength=n).astype(np.int64)
    return np.cumsum(count) - count, count


class WireParser:
    """Stateless decoder with the same columnar output as the JAX
    package's WireParser, plus the per-series label byte ranges."""

    def parse(self, payload: bytes) -> ParsedWriteRequest:
        end = len(payload)
        ts_lo, ts_hi, md_lo, md_hi = [], [], [], []
        i = 0
        while i < end:  # the top level: one message, walked in Python
            tag = payload[i]
            if tag < 0x80:
                i += 1
            else:
                tag, i = _varint(payload, i, end)
            field, wt = tag >> 3, tag & 7
            if field == 0:
                raise _malformed()
            if wt == 0:
                _, i = _varint(payload, i, end)
            elif wt == 1 or wt == 5:
                i += 8 if wt == 1 else 4
                if i > end:
                    raise _malformed()
            elif wt == 2:
                ln, i = _varint(payload, i, end)
                if i + ln > end:
                    raise _malformed()
                if field == 1:
                    ts_lo.append(i)
                    ts_hi.append(i + ln)
                elif field == 3:
                    md_lo.append(i)
                    md_hi.append(i + ln)
                i += ln
            else:
                raise _malformed()  # groups unsupported
        u8 = np.frombuffer(payload + b"\x00" * _PAD, dtype=np.uint8)
        a64 = lambda xs: np.asarray(xs, dtype=np.int64)  # noqa: E731
        n_series = len(ts_lo)

        # TimeSeries: labels (1), samples (2), exemplars (3)
        ts = _Fields(u8, a64(ts_lo), a64(ts_hi))
        lab, smp, exm = ts.of(1, 2), ts.of(2, 2), ts.of(3, 2)
        sls, slc = _count_starts(ts.msg[lab], n_series)
        sss, ssc = _count_starts(ts.msg[smp], n_series)
        lno, lnl, lvo, lvl = _labels(u8, ts.body[lab], ts.end[lab])

        # each series' label byte range, where its label fields are adjacent
        key_lo = np.full(n_series, -1, dtype=np.int64)
        key_hi = np.full(n_series, -1, dtype=np.int64)
        has = slc > 0
        if has.any():
            first = sls[has]
            last = first + slc[has] - 1
            lo, hi = ts.tag[lab][first], ts.end[lab][last]
            span = np.add.reduceat(ts.end[lab] - ts.tag[lab], first)
            adjacent = span == hi - lo
            key_lo[np.flatnonzero(has)[adjacent]] = lo[adjacent]
            key_hi[np.flatnonzero(has)[adjacent]] = hi[adjacent]

        # Sample: value (1, fixed64), timestamp (2, varint)
        sf = _Fields(u8, ts.body[smp], ts.end[smp])
        n_smp = len(smp)
        val_f = sf.of(1, 1)
        sval = np.zeros(n_smp, dtype=np.float64)
        sval[sf.msg[val_f]] = _f64_at(u8, sf.body[val_f])
        sts = _last(n_smp, sf, sf.of(2, 0), sf.val, np.uint64).view(np.int64)

        # Exemplar: labels (1), value (2, fixed64), timestamp (3, varint)
        ef = _Fields(u8, ts.body[exm], ts.end[exm])
        n_ex = len(exm)
        elab = ef.of(1, 2)
        exls, exlc = _count_starts(ef.msg[elab], n_ex)
        exno, exnl, exvo, exvl = _labels(u8, ef.body[elab], ef.end[elab])
        ev_f = ef.of(2, 1)
        exv = np.zeros(n_ex, dtype=np.float64)
        exv[ef.msg[ev_f]] = _f64_at(u8, ef.body[ev_f])
        ext = _last(n_ex, ef, ef.of(3, 0), ef.val, np.uint64).view(np.int64)

        # MetricMetadata: type (1, varint), metric_family_name (2)
        mf = _Fields(u8, a64(md_lo), a64(md_hi))
        n_md = len(md_lo)
        name_f = mf.of(2, 2)
        return ParsedWriteRequest(
            payload=payload,
            series_label_start=sls, series_label_count=slc,
            series_sample_start=sss, series_sample_count=ssc,
            label_name_off=lno, label_name_len=lnl,
            label_value_off=lvo, label_value_len=lvl,
            sample_value=sval, sample_ts=sts, sample_series=ts.msg[smp],
            exemplar_value=exv, exemplar_ts=ext, exemplar_series=ts.msg[exm],
            exemplar_label_start=exls, exemplar_label_count=exlc,
            ex_label_name_off=exno, ex_label_name_len=exnl,
            ex_label_value_off=exvo, ex_label_value_len=exvl,
            meta_type=_last(n_md, mf, mf.of(1, 0), mf.val, np.uint64).view(np.int64),
            meta_name_off=_last(n_md, mf, name_f, mf.body, np.int64),
            meta_name_len=_last(n_md, mf, name_f, mf.val, np.int64),
            series_key_lo=key_lo, series_key_hi=key_hi,
        )
