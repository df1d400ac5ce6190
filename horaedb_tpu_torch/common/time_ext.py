"""Human-readable durations and the engine clock.

Contract (reference: src/common/src/time_ext.rs:39-217, TiKV-style):
- parse strings like "1d2h3m4s5ms" — any subset of units, in order d,h,m,s,ms,
  each count may be fractional; bare numbers are milliseconds.
- serialize back to the compact "2h5m" form.
- `now_ms()` is the engine wall clock in milliseconds (used for TTL expiry).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass

from horaedb_tpu_torch.common.error import HoraeError

_MS = 1
_SECOND = 1000 * _MS
_MINUTE = 60 * _SECOND
_HOUR = 60 * _MINUTE
_DAY = 24 * _HOUR

_UNITS = {"d": _DAY, "h": _HOUR, "m": _MINUTE, "s": _SECOND, "ms": _MS}
# Units must appear in strictly decreasing order; regex tokenizes value+unit.
_TOKEN = re.compile(r"(?P<value>\d+(?:\.\d*)?)(?P<unit>d|h|ms|m|s)")
_UNIT_ORDER = ["d", "h", "m", "s", "ms"]


@dataclass(frozen=True, order=True)
class ReadableDuration:
    """A duration stored as integer milliseconds, (de)serialized human-readably."""

    ms: int

    # -- constructors -----------------------------------------------------
    @classmethod
    def millis(cls, v: int | float) -> "ReadableDuration":
        return cls(int(v))

    @classmethod
    def secs(cls, v: int | float) -> "ReadableDuration":
        return cls(int(v * _SECOND))

    @classmethod
    def minutes(cls, v: int | float) -> "ReadableDuration":
        return cls(int(v * _MINUTE))

    @classmethod
    def hours(cls, v: int | float) -> "ReadableDuration":
        return cls(int(v * _HOUR))

    @classmethod
    def days(cls, v: int | float) -> "ReadableDuration":
        return cls(int(v * _DAY))

    # -- parse / serialize ------------------------------------------------
    @classmethod
    def parse(cls, s: str | int | float | "ReadableDuration") -> "ReadableDuration":
        if isinstance(s, ReadableDuration):
            return s
        if isinstance(s, (int, float)):
            return cls(int(s))
        text = s.strip()
        if not text:
            raise HoraeError("empty duration string")
        # bare number == milliseconds
        try:
            return cls(int(float(text)))
        except ValueError:
            pass
        total = 0.0
        pos = 0
        last_unit_idx = -1
        for m in _TOKEN.finditer(text):
            if m.start() != pos:
                raise HoraeError(f"invalid duration string: {s!r}")
            unit = m.group("unit")
            idx = _UNIT_ORDER.index(unit)
            if idx <= last_unit_idx:
                raise HoraeError(f"duration units out of order: {s!r}")
            last_unit_idx = idx
            total += float(m.group("value")) * _UNITS[unit]
            pos = m.end()
        if pos != len(text):
            raise HoraeError(f"invalid duration string: {s!r}")
        return cls(int(round(total)))

    def __str__(self) -> str:
        if self.ms == 0:
            return "0s"
        rest = self.ms
        out = []
        for unit in _UNIT_ORDER:
            size = _UNITS[unit]
            n, rest = divmod(rest, size)
            if n:
                out.append(f"{n}{unit}")
        return "".join(out)

    # -- conversions ------------------------------------------------------
    @property
    def seconds(self) -> float:
        return self.ms / _SECOND

    def as_millis(self) -> int:
        return self.ms

    def __bool__(self) -> bool:
        return self.ms != 0


def now_ms() -> int:
    """Current wall-clock in ms (reference: src/common/src/time_ext.rs:212-217)."""
    return time.time_ns() // 1_000_000
