"""Human-readable byte sizes.

Contract (reference: src/common/src/size_ext.rs:26-188, forked-from-TiKV idiom):
- parse "2GiB", "512MiB", "0.5e6 B", "4KB" (KB == KiB: binary multiples),
  optional whitespace before the unit, scientific notation allowed.
- serialize to the largest binary unit that divides evenly, else raw bytes
  with a decimal.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from horaedb_tpu_torch.common.error import HoraeError

_B = 1
_KIB = 1024
_MIB = _KIB * 1024
_GIB = _MIB * 1024
_TIB = _GIB * 1024
_PIB = _TIB * 1024

_UNITS = {
    "B": _B,
    "KB": _KIB, "KIB": _KIB,
    "MB": _MIB, "MIB": _MIB,
    "GB": _GIB, "GIB": _GIB,
    "TB": _TIB, "TIB": _TIB,
    "PB": _PIB, "PIB": _PIB,
}
_PATTERN = re.compile(
    r"^\s*(?P<value>[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*(?P<unit>[a-zA-Z]*)\s*$"
)


@dataclass(frozen=True, order=True)
class ReadableSize:
    """A byte count, (de)serialized human-readably."""

    bytes: int

    @classmethod
    def kb(cls, v: int | float) -> "ReadableSize":
        return cls(int(v * _KIB))

    @classmethod
    def mb(cls, v: int | float) -> "ReadableSize":
        return cls(int(v * _MIB))

    @classmethod
    def gb(cls, v: int | float) -> "ReadableSize":
        return cls(int(v * _GIB))

    @classmethod
    def parse(cls, s: str | int | float | "ReadableSize") -> "ReadableSize":
        if isinstance(s, ReadableSize):
            return s
        if isinstance(s, (int, float)):
            return cls(int(s))
        m = _PATTERN.match(s)
        if not m:
            raise HoraeError(f"invalid size string: {s!r}")
        value = float(m.group("value"))
        unit = m.group("unit").upper()
        if unit == "":
            unit = "B"
        if unit not in _UNITS:
            raise HoraeError(f"unknown size unit in: {s!r}")
        if value < 0:
            raise HoraeError(f"negative size: {s!r}")
        return cls(int(value * _UNITS[unit]))

    def __str__(self) -> str:
        for label, size in (("PiB", _PIB), ("TiB", _TIB), ("GiB", _GIB),
                            ("MiB", _MIB), ("KiB", _KIB)):
            if self.bytes >= size and self.bytes % size == 0:
                return f"{self.bytes // size}{label}"
        return f"{self.bytes}B"

    def as_bytes(self) -> int:
        return self.bytes

    def __bool__(self) -> bool:
        return self.bytes != 0
