"""Predicate tree and its host evaluation over numpy lanes.

Copied from the JAX package's `ops/filter.py`: the same AST (`Compare`,
`InSet`, `And`, `Or`, `Not`) and `eval_predicate_np`, which holds the
semantics of the arrow evaluator `eval_predicate_host` on numpy lanes:
a literal the column's dtype cannot represent raises instead of wrapping,
and set members that cannot occur in the column drop from the set. The
packed downsample pass evaluates its predicate here, on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

from horaedb_tpu_torch.common.error import HoraeError

_OPS = ("eq", "ne", "lt", "le", "gt", "ge")


@dataclass(frozen=True)
class Compare:
    column: str
    op: str  # one of _OPS
    literal: float | int

    def __post_init__(self):
        if self.op not in _OPS:
            raise HoraeError(f"unknown compare op: {self.op}")


@dataclass(frozen=True)
class InSet:
    """column IN (v1, v2, ...)."""

    column: str
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))


@dataclass(frozen=True)
class And:
    children: tuple

    def __init__(self, *children: "Predicate"):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True)
class Or:
    children: tuple

    def __init__(self, *children: "Predicate"):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True)
class Not:
    child: "Predicate"


Predicate = Union[Compare, InSet, And, Or, Not]


def time_range_pred(ts_column: str, start: int, end: int) -> Predicate:
    """[start, end) range scan predicate."""
    return And(Compare(ts_column, "ge", start), Compare(ts_column, "lt", end))


def _representable_values(vals, dt: np.dtype) -> list:
    """Set members representable in a column dtype: for integer columns,
    out-of-range or fractional values can never be equal, so they drop."""
    vals_list = list(vals)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        vals_list = [
            int(v) for v in vals_list
            if (not isinstance(v, float) or v.is_integer())
            and info.min <= v <= info.max
        ]
    return vals_list


def _checked_cast(v, dt: np.dtype, column: str):
    """Cast a literal to a column dtype, rejecting values the dtype cannot
    represent (wrapping or truncation would change lt/ge/eq semantics)."""
    if np.issubdtype(dt, np.integer):
        if isinstance(v, float):
            if not v.is_integer():
                raise HoraeError(
                    f"fractional literal {v} on integer column {column!r}; "
                    "rewrite the predicate with an integer bound"
                )
            v = int(v)
        info = np.iinfo(dt)
        if not (info.min <= v <= info.max):
            raise HoraeError(
                f"literal {v} out of range for column {column!r} ({dt})"
            )
    return np.asarray(v, dtype=dt)


def eval_predicate_np(pred: Predicate | None, cols: dict[str, np.ndarray]) -> np.ndarray:
    """Boolean row mask of `pred` over numpy lanes (numeric columns)."""
    n = len(next(iter(cols.values())))
    if pred is None:
        return np.ones(n, dtype=bool)

    def ev(p: Predicate) -> np.ndarray:
        if isinstance(p, Compare):
            c = cols[p.column]
            lit = _checked_cast(p.literal, c.dtype, p.column)
            if p.op == "eq":
                return c == lit
            if p.op == "ne":
                return c != lit
            if p.op == "lt":
                return c < lit
            if p.op == "le":
                return c <= lit
            if p.op == "gt":
                return c > lit
            return c >= lit
        if isinstance(p, InSet):
            c = cols[p.column]
            vals_list = _representable_values(p.values, c.dtype)
            if not vals_list:
                return np.zeros(len(c), dtype=bool)
            return np.isin(c, np.asarray(vals_list, dtype=c.dtype))
        if isinstance(p, And):
            out = ev(p.children[0])
            for ch in p.children[1:]:
                out = out & ev(ch)
            return out
        if isinstance(p, Or):
            out = ev(p.children[0])
            for ch in p.children[1:]:
                out = out | ev(ch)
            return out
        if isinstance(p, Not):
            return ~ev(p.child)
        raise HoraeError(f"unsupported predicate node on numpy path: {p!r}")

    return ev(pred)
