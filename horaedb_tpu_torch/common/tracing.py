"""Lightweight request tracing: contextvar-propagated span trees.

A copy of the JAX package's `common/tracing.py`, trimmed to the spans the
engine opens (`span`, `add_stage`), the attributes PromQL sets on them
(`add_attr`) and the context variable they read.
The root `trace()`, its sampling knobs, the recent-trace ring and the
slow-trace warning come with the server, which opens the traces and
serves them; until then no trace is active and both calls are one
contextvar get.

Spans opened in `asyncio` child tasks and in `asyncio.to_thread` workers
attach to the caller's trace (both copy the context at spawn). No deps
beyond the stdlib (storage/ and ingest/ import this).
"""

from __future__ import annotations

import itertools
import time
from contextlib import contextmanager
from contextvars import ContextVar


class Span:
    __slots__ = ("span_id", "parent_id", "name", "start_ms", "duration_s",
                 "attrs")

    def __init__(self, span_id: int, parent_id: int | None, name: str,
                 attrs: dict):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ms = time.time() * 1000.0
        self.duration_s: float | None = None  # None while open
        self.attrs = attrs


class Trace:
    """One request's span set. Spans append from any task/thread of the
    request (list.append is atomic under the GIL; span identity is never
    shared across appenders)."""

    __slots__ = ("trace_id", "spans", "_ids")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self._ids = itertools.count(1)

    def new_span(self, parent_id: int | None, name: str, attrs: dict) -> Span:
        sp = Span(next(self._ids), parent_id, name, attrs)
        self.spans.append(sp)
        return sp


# (trace, current span) of the running context; None outside any trace
_ACTIVE: ContextVar[tuple[Trace, Span] | None] = ContextVar(
    "horaedb_trace", default=None
)


@contextmanager
def span(name: str, **attrs):
    """Child span of the active trace; a no-op (one contextvar get) when
    no trace is active. Yields the Span or None."""
    cur = _ACTIVE.get()
    if cur is None:
        yield None
        return
    t, parent = cur
    sp = t.new_span(parent.span_id, name, attrs)
    token = _ACTIVE.set((t, sp))
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        sp.duration_s = time.perf_counter() - t0
        _ACTIVE.reset(token)


def add_attr(**kw) -> None:
    """Attach attributes to the current span (no-op outside a trace)."""
    cur = _ACTIVE.get()
    if cur is not None:
        cur[1].attrs.update(kw)


def add_stage(stage: str, seconds: float) -> None:
    """Fold one scanstats stage timing into the current span (accumulated
    under a 'stages' attr — per-chunk stages would flood the tree as
    individual spans)."""
    cur = _ACTIVE.get()
    if cur is None:
        return
    stages = cur[1].attrs.setdefault("stages", {})
    stages[stage] = round(stages.get(stage, 0.0) + seconds, 6)
