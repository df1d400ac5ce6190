"""Columnar decoded form of a remote-write request.

A copy of the JAX package's `ingest/types.py`, trimmed to the lanes the
pure-Python decoder fills (the native parser's hash and key lanes wait
for the native parser), plus `series_raw_keys`, the byte range of each
series' labels, which the engine's id cache keys on.

Instead of the reference's pooled object tree (WriteRequest -> TimeSeries ->
Label/Sample, pooled_types.rs), the parse result is struct-of-arrays: flat
sample/label lanes plus per-series ranges — the layout the engine ships to
device HBM and feeds the metric-engine id hashing without another pivot.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ParsedWriteRequest:
    """All arrays are views/copies detached from the parser arena; `payload`
    is the original buffer that label offsets point into (zero-copy slices).
    """

    payload: bytes
    # per-series ranges into the label/sample lanes
    series_label_start: np.ndarray  # int64 [n_series]
    series_label_count: np.ndarray
    series_sample_start: np.ndarray
    series_sample_count: np.ndarray
    # flattened labels as (offset, length) into payload
    label_name_off: np.ndarray  # int64 [n_labels]
    label_name_len: np.ndarray
    label_value_off: np.ndarray
    label_value_len: np.ndarray
    # flattened samples
    sample_value: np.ndarray    # float64 [n_samples]
    sample_ts: np.ndarray       # int64 ms
    sample_series: np.ndarray   # int64 owning-series index
    # flattened exemplars
    exemplar_value: np.ndarray
    exemplar_ts: np.ndarray
    exemplar_series: np.ndarray
    # exemplar labels as (offset, length) into payload, per-exemplar ranges
    exemplar_label_start: np.ndarray
    exemplar_label_count: np.ndarray
    ex_label_name_off: np.ndarray
    ex_label_name_len: np.ndarray
    ex_label_value_off: np.ndarray
    ex_label_value_len: np.ndarray
    # metadata entries
    meta_type: np.ndarray
    meta_name_off: np.ndarray
    meta_name_len: np.ndarray
    # per series, the byte range of its label fields in `payload`, or -1
    # where it has none or they are interleaved with other fields
    series_key_lo: np.ndarray | None = None
    series_key_hi: np.ndarray | None = None

    @property
    def n_series(self) -> int:
        return len(self.series_label_start)

    @property
    def n_samples(self) -> int:
        return len(self.sample_value)

    def label_name(self, i: int) -> bytes:
        o, l = int(self.label_name_off[i]), int(self.label_name_len[i])
        return self.payload[o : o + l]

    def label_value(self, i: int) -> bytes:
        o, l = int(self.label_value_off[i]), int(self.label_value_len[i])
        return self.payload[o : o + l]

    def series_labels(self, series: int) -> list[tuple[bytes, bytes]]:
        s = int(self.series_label_start[series])
        c = int(self.series_label_count[series])
        return [(self.label_name(i), self.label_value(i)) for i in range(s, s + c)]

    def exemplar_labels(self, ex: int) -> list[tuple[bytes, bytes]]:
        s = int(self.exemplar_label_start[ex])
        c = int(self.exemplar_label_count[ex])
        out = []
        for i in range(s, s + c):
            no, nl = int(self.ex_label_name_off[i]), int(self.ex_label_name_len[i])
            vo, vl = int(self.ex_label_value_off[i]), int(self.ex_label_value_len[i])
            out.append((self.payload[no:no + nl], self.payload[vo:vo + vl]))
        return out

    def series_raw_keys(self) -> "list[bytes | None]":
        """Per series, the bytes of its encoded labels as they lie in
        `payload` (the label fields' byte range; the parser sets
        `series_key_lo`/`series_key_hi`), or None where the series has no
        labels or its label fields are not contiguous. The bytes decode to
        exactly the series' label list, so equal keys are equal series:
        the engine's id cache keys on them."""
        p = self.payload
        return [p[a:b] if a >= 0 else None
                for a, b in zip(self.series_key_lo.tolist(), self.series_key_hi.tolist())]

    def meta_name(self, i: int) -> bytes:
        o, l = int(self.meta_name_off[i]), int(self.meta_name_len[i])
        return self.payload[o : o + l]
