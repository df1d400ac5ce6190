"""Error type of the port: one exception class plus the `ensure!` helper.

A copy of the JAX package's `common/error.py` core (the retry taxonomy is
left out until a slice with an object store needs it).
"""

from __future__ import annotations


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


def ensure(cond: bool, msg: str) -> None:
    """`ensure!` analog: raise HoraeError(msg) unless `cond` holds."""
    if not cond:
        raise HoraeError(msg)
