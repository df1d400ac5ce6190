"""Per-stage scan timing attribution and per-query notes.

A copy of the JAX package's `storage/scanstats.py`, trimmed to what the
port's engine and query batcher read: the contextvar collector
(`scan_stats`, `current`), counters (`note`, `note_max`) and
stage timings (`stage`, `record`). The batcher keys its concurrency signal
on collector identity and hands each member its notes (`batched_with`,
pad waste, the shape class) through it. Every stage also feeds the
process-wide `horaedb_scan_stage_seconds{stage=...}` histogram and the
active trace span. Left out: the memtrace ledger and the compile-time
deduction of nested stages (the port has no compile lane inside a stage).

Usage:
    with scan_stats() as st:
        ... run scans ...
    st.as_dict()  # {"device_agg_s": ..., "batched_with": ..., ...}
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field

from horaedb_tpu_torch.common import tracing
from horaedb_tpu_torch.server.metrics import GLOBAL_METRICS

# canonical lane of a stage on /metrics (others keep their own name)
_STAGE_LANE = {
    "h2d": "transfer",
    "d2h": "transfer",
    "device_merge": "kernel",
    "device_agg": "kernel",
}

STAGE_SECONDS = GLOBAL_METRICS.histogram(
    "horaedb_scan_stage_seconds",
    help="Per-stage scan time by lane (io_decode, host_prep, transfer, "
         "kernel, compile, ...): the request-attribution view of scanstats.",
    labelnames=("stage",),
    exemplars=True,
)
for _lane in ("io_decode", "host_prep", "transfer", "kernel", "compile", "decode"):
    STAGE_SECONDS.labels(_lane)
del _lane


@dataclass
class ScanStats:
    seconds: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    def add(self, stage: str, secs: float) -> None:
        self.seconds[stage] = self.seconds.get(stage, 0.0) + secs
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def count(self, stage: str, n: int = 1) -> None:
        self.counts[stage] = self.counts.get(stage, 0) + n

    def as_dict(self) -> dict:
        out = {f"{k}_s": round(v, 4) for k, v in self.seconds.items()}
        out.update({k: v for k, v in self.counts.items() if k not in self.seconds})
        return out


_ACTIVE: ContextVar[ScanStats | None] = ContextVar("horaedb_scan_stats", default=None)


@contextmanager
def scan_stats():
    """Collect stage timings and notes for every scan inside the block
    (tasks spawned inside it share the collector: they copy the context)."""
    st = ScanStats()
    token = _ACTIVE.set(st)
    try:
        yield st
    finally:
        _ACTIVE.reset(token)


def record(name: str, secs: float) -> None:
    """Fold an externally-timed duration in as if a stage() block measured
    it: collector + process histogram + active trace span."""
    st = _ACTIVE.get()
    if st is not None:
        st.add(name, secs)
    STAGE_SECONDS.labels(_STAGE_LANE.get(name, name)).observe(secs)
    tracing.add_stage(name, secs)


@contextmanager
def stage(name: str):
    """Time one stage into the active collector (when one is attached), the
    process-wide histogram and the active trace span."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def note(name: str, n: int = 1) -> None:
    """Bump a counter (e.g. rows decoded, path taken) on the active collector."""
    st = _ACTIVE.get()
    if st is not None:
        st.count(name, n)


def note_max(name: str, n: int) -> None:
    """Record the MAXIMUM of `n` across the collector's lifetime instead of
    a running sum, for width-style facts that repeat per sub-query."""
    st = _ACTIVE.get()
    if st is not None:
        st.counts[name] = max(st.counts.get(name, 0), n)


def current() -> "ScanStats | None":
    """The active collector object (or None). The query batcher keys its
    concurrency signal on collector IDENTITY."""
    return _ACTIVE.get()
