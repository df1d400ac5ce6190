"""Error types of the port: one exception class, the `ensure!` helper and
the `.context()` wrapper.

A copy of the JAX package's `common/error.py` core (the retry taxonomy is
left out until a slice with a remote object store needs it) and its
`DeadlineExceeded`, plus `NotPortedError` for the routes this port does
not have yet.
"""

from __future__ import annotations

from contextlib import contextmanager


class HoraeError(Exception):
    """Single internal error type; message carries the context chain."""

    def __init__(self, msg: str, cause: BaseException | None = None):
        super().__init__(msg)
        self.__cause__ = cause

    def __str__(self) -> str:  # render the full context chain like anyhow
        parts = [self.args[0] if self.args else self.__class__.__name__]
        cur = self.__cause__
        while cur is not None:
            parts.append(str(cur))
            cur = cur.__cause__
        return ": ".join(parts)


class NotPortedError(HoraeError):
    """A route or option of the JAX package that the port lacks so far. It
    raises instead of quietly running something else in its place."""


class DeadlineExceeded(HoraeError):
    """The end-to-end deadline of the request driving this work expired
    (common/deadline.py carries the token; the query path checks it
    cooperatively). Not retryable: under the same expired deadline an
    identical retry cannot succeed."""

    def __init__(self, msg: str, cause: BaseException | None = None,
                 budget_s: float | None = None,
                 elapsed_s: float | None = None, at: str = ""):
        super().__init__(msg, cause=cause)
        self.budget_s = budget_s
        self.elapsed_s = elapsed_s
        self.at = at


def ensure(cond: bool, msg: str) -> None:
    """`ensure!` analog: raise HoraeError(msg) unless `cond` holds."""
    if not cond:
        raise HoraeError(msg)


@contextmanager
def context(msg: str):
    """`.context(msg)` analog: wrap any raised exception in HoraeError(msg),
    keeping the class of a HoraeError subclass (NotFound stays NotFound)."""
    try:
        yield
    except HoraeError as e:
        try:
            wrapped = type(e)(msg, cause=e)
        except TypeError:
            wrapped = HoraeError(msg, cause=e)
        raise wrapped from e
    except Exception as e:  # noqa: BLE001 - deliberate funnel
        raise HoraeError(msg, cause=e) from e
