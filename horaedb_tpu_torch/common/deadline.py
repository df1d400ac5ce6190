"""A copy of the JAX package's `common/deadline.py`.

End-to-end request deadlines: a contextvar token + cooperative checks.

Every query gets a ``Deadline`` budget at the HTTP layer (config default
in ``[metric_engine.query]``, per-request override via Prometheus-style
``timeout=``), installed with :func:`deadline_scope` so it propagates —
like tracing's spans and scanstats' collector — into every coroutine,
``asyncio.gather`` fan-out, and ``to_thread`` hop the query spawns,
without threading a parameter through thirty call sites.

The scan path then calls :func:`check` at its natural yield points
(region fan-out, per-SST reads, between device-lane launches, per-segment
scans): an expired or abandoned query raises
:class:`~horaedb_tpu_torch.common.error.DeadlineExceeded` at the NEXT check
instead of finishing a scan nobody will read, releasing its admission
slot (server/admission.py) and its device/IO budget promptly. The check
is built to be free on the hot path: one contextvar get when no deadline
is installed (the write path, background work), one ``perf_counter``-
class clock read + compare when one is.

Background durability work spawned FROM a request context (flush-executor
workers kicked by a query's flush barrier) must not inherit the request's
budget — ``asyncio`` tasks copy the spawning context — so those tasks
call :func:`detach` first; killing a half-done SST upload because a
dashboard panel gave up would turn a slow query into parked memtables.

Object-store reads issued on behalf of a query respect the budget too:
``objstore/resilient.py`` caps each attempt's ``op_deadline`` at
:func:`remaining_s` and stops its retry ladder once the budget cannot
cover another attempt — a black-holed store under a 1 s query deadline
costs ~1 s, not the full ladder.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar

from horaedb_tpu_torch.common.error import DeadlineExceeded


class Deadline:
    """One request's time budget, measured on the monotonic clock.

    ``clock`` is injectable so tests drive expiry without sleeping."""

    __slots__ = ("budget_s", "_t0", "_clock")

    def __init__(self, budget_s: float, clock=time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self._t0 = clock()

    def elapsed_s(self) -> float:
        return self._clock() - self._t0

    def remaining_s(self) -> float:
        """Seconds left (negative once expired)."""
        return self.budget_s - self.elapsed_s()

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def check(self, at: str = "") -> None:
        """Raise :class:`DeadlineExceeded` if the budget is spent.
        ``at`` names the yield point for the 504 body / logs."""
        elapsed = self.elapsed_s()
        if elapsed >= self.budget_s:
            raise DeadlineExceeded(
                f"query deadline exceeded after {elapsed:.3f}s "
                f"(budget {self.budget_s:.3f}s)"
                + (f" at {at}" if at else ""),
                budget_s=self.budget_s, elapsed_s=elapsed, at=at,
            )

    def __repr__(self) -> str:  # debugging / trace attrs
        return f"Deadline(budget={self.budget_s:.3f}s, remaining={self.remaining_s():.3f}s)"


_ACTIVE: ContextVar[Deadline | None] = ContextVar(
    "horaedb_deadline", default=None
)


def current() -> Deadline | None:
    """The active deadline token, or None (no budget installed)."""
    return _ACTIVE.get()


def remaining_s() -> float | None:
    """Remaining budget of the active deadline; None without one."""
    d = _ACTIVE.get()
    return None if d is None else d.remaining_s()


def check(at: str = "") -> None:
    """Cooperative checkpoint: no-op without an active deadline, raises
    DeadlineExceeded past one. THE call scan-path yield points make."""
    d = _ACTIVE.get()
    if d is not None:
        d.check(at)


@contextmanager
def deadline_scope(deadline: Deadline | None):
    """Install ``deadline`` as the active token for the block (and every
    task/thread spawned inside it). ``None`` explicitly clears any
    inherited deadline for the block."""
    token = _ACTIVE.set(deadline)
    try:
        yield deadline
    finally:
        _ACTIVE.reset(token)


def detach() -> None:
    """Clear any inherited deadline in THIS task's context, permanently
    (background durability work — flush workers, compaction tasks —
    spawned from a request context must not be killed by the request's
    budget). Safe because each asyncio task owns a COPY of the spawning
    context: the set never leaks back to the spawner."""
    _ACTIVE.set(None)
