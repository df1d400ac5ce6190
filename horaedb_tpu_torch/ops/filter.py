"""Predicates: the tree, its literal templates, host evaluation, min/max
pruning, and kernel E (the device evaluation inside `index_merge_filter`
and `scan_kernel`).

Copied from the JAX package's `ops/filter.py`: the same AST (`Compare`,
`InSet`, `And`, `Or`, `Not`), the template form (`split_literals` turns
literals into `Slot`s and `InSet` into an `InSetProbe` over a padded value
array), `literal_arrays` (which raises on a literal its column cannot
represent and drops set members that cannot occur), the arrow and numpy
host evaluators and `prune_range`.

The JAX package evaluates a template on the device with traced XLA ops
(`eval_predicate` / `_eval`). Here `compile_program` flattens the template
into a postfix program of compare, set-probe and boolean instructions over
lanes and literal slots, and `eval_predicate` runs it: kernel E
(`csrc/predicate.cu`, one thread per row, one compiled interpreter for
every template) on CUDA lanes, or `eval_program_plain` on CPU lanes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from horaedb_tpu_torch.backend import device_lane
from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import _build

# -- predicate tree ----------------------------------------------------------

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
    """column IN (v1, v2, ...), e.g. TSID membership from the inverted index."""

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


@dataclass(frozen=True)
class InSetProbe:
    """Template form of InSet after `split_literals`: the membership values
    travel as a padded value array (values_slot) plus an active mask
    (mask_slot), padded to a power-of-two bucket: up to 128 members probe
    linearly, above that by binary search."""

    column: str
    values_slot: int
    mask_slot: int
    padded_size: int


@dataclass(frozen=True)
class Slot:
    """Placeholder for a literal extracted by `split_literals`. A predicate
    whose Compare literals are Slots is a hashable *template*; the literal
    values travel beside it. Carries the column name so the cast site needs
    no second type-dispatched tree walk."""

    idx: int
    column: str = ""


def iter_nodes(pred: Predicate):
    """Generic pre-order walk — the single structural traversal shared by
    every predicate pass (split/cast/eval helpers)."""
    yield pred
    if isinstance(pred, (And, Or)):
        for c in pred.children:
            yield from iter_nodes(c)
    elif isinstance(pred, Not):
        yield from iter_nodes(pred.child)


def pred_columns(pred: Predicate | None) -> set[str]:
    """Column names a predicate references (scan planners use this to decide
    which columns must reach the evaluation site)."""
    if pred is None:
        return set()
    out: set[str] = set()
    for node in iter_nodes(pred):
        c = getattr(node, "column", None)
        if c:
            out.add(c)
    return out


def _pad_bucket(n: int) -> int:
    """Next power of two (min 1): membership arrays pad to size buckets so
    compiled-kernel reuse is per bucket, not per exact set size."""
    return 1 << max(0, n - 1).bit_length() if n > 0 else 1


def is_template(pred: Predicate | None) -> bool:
    """True if `pred` already went through split_literals (contains Slot or
    InSetProbe markers)."""
    if pred is None:
        return False
    for node in iter_nodes(pred):
        if isinstance(node, InSetProbe):
            return True
        if isinstance(node, Compare) and isinstance(node.literal, Slot):
            return True
    return False


def split_literals(pred: Predicate | None) -> tuple[Predicate | None, tuple]:
    """Extract literals into a tuple, leaving dynamic markers behind:
    Compare literals become Slots; InSet value tuples become InSetProbe
    (padded values array + active mask, two slots).

    Idempotent: an already-split template passes through unchanged (with no
    literals — the original split's literals remain authoritative); without
    this, re-splitting would renumber Compare slots into collision with
    InSetProbe value/mask slots."""
    if is_template(pred):
        return pred, ()
    literals: list = []

    def walk(p: Predicate) -> Predicate:
        if isinstance(p, Compare):
            literals.append(p.literal)
            return Compare(p.column, p.op, Slot(len(literals) - 1, p.column))
        if isinstance(p, InSet):
            literals.append(tuple(p.values))
            literals.append(None)  # mask slot, filled by literal_arrays
            return InSetProbe(
                p.column,
                len(literals) - 2,
                len(literals) - 1,
                _pad_bucket(len(p.values)),
            )
        if isinstance(p, And):
            return And(*[walk(c) for c in p.children])
        if isinstance(p, Or):
            return Or(*[walk(c) for c in p.children])
        if isinstance(p, Not):
            return Not(walk(p.child))
        return p

    if pred is None:
        return None, ()
    return walk(pred), tuple(literals)


def _representable_values(vals, dt: np.dtype) -> list:
    """Membership-set values representable in a column dtype. For integer
    columns, equality can never hold for out-of-range or fractional values,
    so they drop from the set — the SINGLE definition shared by the device
    (_eval), numpy (eval_predicate_np), and template (literal_arrays)
    evaluators, keeping set semantics identical across all three."""
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
    represent (silent wrapping or float truncation would silently change
    lt/ge/eq semantics — and host-side pruning, which compares exactly,
    would then disagree with device evaluation)."""
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


def literal_arrays(
    template: Predicate | None, literals: tuple, dtypes: dict
) -> tuple:
    """Cast extracted literals to their columns' dtypes (a u64 id >= 2**63
    must not pass through a default int64 conversion)."""
    if template is None:
        return ()
    slot_col: dict[int, str] = {}
    inset_nodes: dict[int, InSetProbe] = {}
    for node in iter_nodes(template):
        if isinstance(node, Compare) and isinstance(node.literal, Slot):
            slot_col[node.literal.idx] = node.literal.column or node.column
        elif isinstance(node, InSetProbe):
            inset_nodes[node.values_slot] = node
    out: list = [None] * len(literals)
    for i, v in enumerate(literals):
        if i in inset_nodes:
            node = inset_nodes[i]
            dt = np.dtype(dtypes.get(node.column, np.int64))
            vals_list = _representable_values(v, dt)
            k = len(vals_list)
            pad_val = vals_list[0] if k else 0
            padded = vals_list + [pad_val] * (node.padded_size - k)
            out[node.values_slot] = np.asarray(padded, dtype=dt)
            mask = np.zeros(node.padded_size, dtype=bool)
            mask[:k] = True
            out[node.mask_slot] = mask
        elif out[i] is None and i in slot_col:
            col = slot_col[i]
            dt = dtypes.get(col)
            out[i] = (
                _checked_cast(v, np.dtype(dt), col) if dt is not None else np.asarray(v)
            )
        elif out[i] is None:
            out[i] = np.asarray(v) if v is not None else np.zeros(0, dtype=bool)
    return tuple(out)


def time_range_pred(ts_column: str, start: int, end: int) -> Predicate:
    """[start, end) range scan predicate."""
    return And(Compare(ts_column, "ge", start), Compare(ts_column, "lt", end))


# -- kernel E: device evaluation -------------------------------------------

# lane types of the predicate program (backend.device_lane makes the lanes)
LANE_I64, LANE_I32, LANE_U8, LANE_F64 = 0, 1, 2, 3
# instructions: (opcode, a, b, c)
#   CMP: a = compare op (index in _OPS), b = lane, c = literal slot
#   SET: a = lane, b = offset into the set values, c = set size
#   AND / OR: pop two, push one;  NOT: negate the top
OP_CMP, OP_SET, OP_AND, OP_OR, OP_NOT = 1, 2, 3, 4, 5
MAX_LANES = 16
MAX_DEPTH = 32
LINEAR_SET_MAX = 128  # sets up to this size probe linearly, larger by binary search


def lane_type(dtype) -> int:
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return LANE_F64
    if dt in (np.bool_, np.uint8):
        return LANE_U8
    if dt in (np.int8, np.int16, np.uint16, np.int32):
        return LANE_I32
    return LANE_I64


@dataclass(frozen=True)
class Program:
    """A predicate template flattened to postfix form. `lanes[i]` names the
    column lane i reads; integer literals and set members are in the
    lanes' device representation (u64 mapped through `u64_to_i64`)."""

    lanes: tuple[str, ...]
    lane_types: tuple[int, ...]
    code: np.ndarray      # int32 [m, 4]
    lit_i64: np.ndarray   # int64 literal slots
    lit_f64: np.ndarray   # float64 literal slots
    set_i64: np.ndarray   # sorted unique members of every integer set
    set_f64: np.ndarray   # sorted unique members of every float set (no NaN)


def _stack_depth(p) -> int:
    """Values the postfix program of `p` holds on its stack at most: a
    connective keeps its first child's value while each later one runs."""
    if isinstance(p, (And, Or)) and p.children:
        return max([_stack_depth(p.children[0])]
                   + [1 + _stack_depth(ch) for ch in p.children[1:]])
    if isinstance(p, Not):
        return _stack_depth(p.child)
    return 1


def program_fits(pred: Predicate | None) -> bool:
    """Whether kernel E can evaluate `pred`: it reads at most MAX_LANES
    columns and nests at most MAX_DEPTH deep. The scan planner evaluates
    any other predicate on the host."""
    return pred is None or (len(pred_columns(pred)) <= MAX_LANES
                            and _stack_depth(pred) <= MAX_DEPTH)


def compile_program(pred: Predicate | None, dtypes: dict) -> Program | None:
    """Flatten `pred` over columns of host `dtypes` into a Program (None for
    no predicate). Literals go through `literal_arrays`, so a literal its
    column cannot represent raises and unrepresentable set members drop,
    exactly as the JAX package's device evaluation does."""
    if pred is None:
        return None
    template, raw = split_literals(pred)
    lits = literal_arrays(template, raw, dtypes)
    lanes: list[str] = []
    code: list[tuple[int, int, int, int]] = []
    lit_i64: list[int] = []
    lit_f64: list[float] = []
    set_i64: list[np.ndarray] = []
    set_f64: list[np.ndarray] = []
    sizes = {"i": 0, "f": 0}

    def lane_of(column: str) -> int:
        ensure(column in dtypes, f"predicate column {column!r} not in the scan's lanes")
        if column not in lanes:
            lanes.append(column)
        return lanes.index(column)

    def emit(p) -> None:
        if isinstance(p, Compare):
            lane = lane_of(p.column)
            v = lits[p.literal.idx]
            if lane_type(dtypes[p.column]) == LANE_F64:
                lit_f64.append(float(v))
                slot = len(lit_f64) - 1
            else:
                lit_i64.append(int(device_lane(np.asarray([v], dtype=dtypes[p.column]))[0]))
                slot = len(lit_i64) - 1
            code.append((OP_CMP, _OPS.index(p.op), lane, slot))
        elif isinstance(p, InSetProbe):
            lane = lane_of(p.column)
            vals = np.asarray(lits[p.values_slot])[np.asarray(lits[p.mask_slot], dtype=bool)]
            vals = device_lane(vals.astype(dtypes[p.column], copy=False))
            if lane_type(dtypes[p.column]) == LANE_F64:
                vals = np.unique(vals[~np.isnan(vals)])
                set_f64.append(vals)
                key = "f"
            else:
                vals = np.unique(vals.astype(np.int64))
                set_i64.append(vals)
                key = "i"
            code.append((OP_SET, lane, sizes[key], len(vals)))
            sizes[key] += len(vals)
        elif isinstance(p, (And, Or)):
            ensure(len(p.children) > 0, f"empty {type(p).__name__}")
            emit(p.children[0])
            for ch in p.children[1:]:
                emit(ch)
                code.append((OP_AND if isinstance(p, And) else OP_OR, 0, 0, 0))
        elif isinstance(p, Not):
            emit(p.child)
            code.append((OP_NOT, 0, 0, 0))
        else:
            raise HoraeError(f"unknown predicate node: {p!r}")

    emit(template)
    ensure(len(lanes) <= MAX_LANES, f"predicate reads {len(lanes)} lanes (at most {MAX_LANES})")
    depth = _stack_depth(template)
    ensure(depth <= MAX_DEPTH, f"predicate nests {depth} deep (at most {MAX_DEPTH})")
    return Program(
        lanes=tuple(lanes),
        lane_types=tuple(lane_type(dtypes[c]) for c in lanes),
        code=np.asarray(code, dtype=np.int32).reshape(-1, 4),
        lit_i64=np.asarray(lit_i64, dtype=np.int64),
        lit_f64=np.asarray(lit_f64, dtype=np.float64),
        set_i64=np.concatenate(set_i64) if set_i64 else np.zeros(0, np.int64),
        set_f64=np.concatenate(set_f64) if set_f64 else np.zeros(0, np.float64),
    )


def _probe_plain(lane: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """Set membership: a linear compare up to LINEAR_SET_MAX members, a
    binary search over the sorted members above (an empty set is all
    false)."""
    if len(members) <= LINEAR_SET_MAX:
        hit = torch.zeros(lane.shape, dtype=torch.bool, device=lane.device)
        for v in members:
            hit |= lane == v
        return hit
    pos = torch.searchsorted(members, lane).clamp_(max=len(members) - 1)
    return members[pos] == lane


def eval_program_plain(prog: Program, lanes: dict[str, torch.Tensor], n: int) -> torch.Tensor:
    """Plain version of kernel E: the program over device lanes with torch
    ops, one instruction at a time. Returns a bool mask of length n."""
    dev = next(iter(lanes.values())).device if lanes else torch.device("cpu")
    cmp = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)
    lit_i64 = torch.from_numpy(prog.lit_i64).to(dev)
    lit_f64 = torch.from_numpy(prog.lit_f64).to(dev)
    set_i64 = torch.from_numpy(prog.set_i64).to(dev)
    set_f64 = torch.from_numpy(prog.set_f64).to(dev)
    stack: list[torch.Tensor] = []
    for op, a, b, c in prog.code.tolist():
        if op == OP_CMP:
            lane = lanes[prog.lanes[b]]
            if prog.lane_types[b] == LANE_F64:
                stack.append(cmp[a](lane, lit_f64[c]))
            else:
                stack.append(cmp[a](lane.to(torch.int64), lit_i64[c]))
        elif op == OP_SET:
            lane = lanes[prog.lanes[a]]
            if prog.lane_types[a] == LANE_F64:
                stack.append(_probe_plain(lane, set_f64[b:b + c]))
            else:
                stack.append(_probe_plain(lane.to(torch.int64), set_i64[b:b + c]))
        elif op == OP_NOT:
            stack.append(~stack.pop())
        else:
            y, x = stack.pop(), stack.pop()
            stack.append(x & y if op == OP_AND else x | y)
    return stack[0] if stack else torch.ones(n, dtype=torch.bool, device=dev)


_PREDICATE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p,
]


def launch_program(prog: Program, lanes: dict[str, torch.Tensor], n: int,
                   out: torch.Tensor, library: str = "index_merge_filter") -> None:
    """Kernel E: write the program's uint8 mask over n CUDA rows into `out`.
    Built into, and counted as part of, the kernel `library`
    (`index_merge_filter` or `scan_kernel`); raises on a failed launch (the
    caller counts)."""
    dev = out.device
    for name, lt in zip(prog.lanes, prog.lane_types):
        t = lanes[name]
        want = {LANE_I64: torch.int64, LANE_I32: torch.int32, LANE_U8: torch.uint8,
                LANE_F64: torch.float64}[lt]
        ensure(t.dtype == want and t.dim() == 1 and t.shape[0] == n and t.is_contiguous()
               and t.device == dev, f"predicate lane {name!r} must be contiguous {want}[{n}] "
               f"on {dev}, got {t.dtype}{tuple(t.shape)} on {t.device}")
    ensure(out.dtype == torch.uint8 and out.shape[0] == n and out.is_contiguous(),
           "predicate output must be contiguous uint8[n]")
    code = torch.from_numpy(np.ascontiguousarray(prog.code)).to(dev)
    lit_i64 = torch.from_numpy(prog.lit_i64).to(dev)
    lit_f64 = torch.from_numpy(prog.lit_f64).to(dev)
    set_i64 = torch.from_numpy(prog.set_i64).to(dev)
    set_f64 = torch.from_numpy(prog.set_f64).to(dev)
    k = len(prog.lanes)
    ptrs = (ctypes.c_void_p * max(k, 1))(*[lanes[c].data_ptr() for c in prog.lanes])
    types = (ctypes.c_int32 * max(k, 1))(*prog.lane_types)
    fn = _build.kernel(library, "predicate_launch", _PREDICATE_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptrs, types, k, code.data_ptr(), len(prog.code), lit_i64.data_ptr(),
                lit_f64.data_ptr(), set_i64.data_ptr(), set_f64.data_ptr(), n,
                out.data_ptr(), stream)
    if rc != 0:
        raise HoraeError(f"predicate (kernel E): CUDA launch failed with cudaError {rc}")


def eval_predicate(pred: Predicate | None, cols: dict[str, torch.Tensor],
                   dtypes: dict) -> torch.Tensor:
    """Bool keep-mask of `pred` over device lanes (`backend.device_lane`
    form; `dtypes` are the columns' host dtypes, which set the literal
    casts): kernel E on CUDA lanes, `eval_program_plain` on CPU lanes."""
    n = next(iter(cols.values())).shape[0]
    prog = compile_program(pred, dtypes)
    dev = next(iter(cols.values())).device
    if prog is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return eval_program_plain(prog, cols, n)
    if dev.type != "cuda":
        raise HoraeError(f"eval_predicate: unsupported device {dev}")
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    launch_program(prog, cols, n, out)
    return out.view(torch.bool)

# -- host-side evaluation (binary-capable) -----------------------------------

def eval_predicate_host(pred: Predicate | None, table) -> np.ndarray:
    """Vectorized predicate evaluation over a pyarrow Table on host —
    supports binary/string columns (bytes literals, ordering via arrow
    compute), used by the binary-primary-key scan path. Returns a boolean
    numpy mask."""
    import pyarrow as pa
    import pyarrow.compute as pc

    n = table.num_rows
    if pred is None:
        return np.ones(n, dtype=bool)

    def ev(p: Predicate) -> np.ndarray:
        if isinstance(p, Compare):
            col = table.column(p.column).combine_chunks()
            lit = p.literal
            try:
                fn = {"eq": pc.equal, "ne": pc.not_equal, "lt": pc.less,
                      "le": pc.less_equal, "gt": pc.greater, "ge": pc.greater_equal}[p.op]
                # pin the scalar to the column type: untyped inference maps
                # a large u64 id (>= 2^63) to int64 and overflows
                out = fn(col, pa.scalar(lit, type=col.type)
                         if not isinstance(lit, (bytes, str)) else pa.scalar(lit))
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError,
                    pa.ArrowTypeError, OverflowError) as e:
                raise HoraeError(
                    f"predicate literal {lit!r} incompatible with column "
                    f"{p.column!r} ({col.type})"
                ) from e
            return pc.fill_null(out, False).to_numpy(zero_copy_only=False)
        if isinstance(p, InSet):
            col = table.column(p.column).combine_chunks()
            try:
                out = pc.is_in(col, value_set=pa.array(list(p.values), type=col.type))
            except (pa.ArrowInvalid, pa.ArrowTypeError, OverflowError) as e:
                raise HoraeError(
                    f"InSet values incompatible with column {p.column!r} ({col.type})"
                ) from e
            return pc.fill_null(out, False).to_numpy(zero_copy_only=False)
        if isinstance(p, And):
            out = ev(p.children[0])
            for c in p.children[1:]:
                out = out & ev(c)
            return out
        if isinstance(p, Or):
            out = ev(p.children[0])
            for c in p.children[1:]:
                out = out | ev(c)
            return out
        if isinstance(p, Not):
            return ~ev(p.child)
        raise HoraeError(f"unsupported predicate node on host path: {p!r}")

    return ev(pred)


def _isin_run_compressed(c: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """np.isin that exploits sorted-scan locality: engine lanes arrive in
    (pk...) order, so tag/series columns are piecewise-constant. Detect the
    runs (one vector diff) and, when the column compresses well, probe only
    the run representatives and expand with repeat — the set probe is the
    scan's costliest host-filter leaf (~7 ns/row via np.isin), and on a
    10K-rows-per-series shape this turns it into ~2 ops/row. Columns that
    don't compress (n_runs > n/8) keep the plain probe."""
    n = len(c)
    if n < 4096:
        return np.isin(c, probe)
    neq = c[1:] != c[:-1]
    n_runs = int(np.count_nonzero(neq)) + 1
    if n_runs > n // 8:
        return np.isin(c, probe)
    starts = np.empty(n_runs, dtype=np.int64)
    starts[0] = 0
    starts[1:] = np.flatnonzero(neq) + 1
    reps = c[starts]
    hit = np.isin(reps, probe)
    lengths = np.empty(n_runs, dtype=np.int64)
    lengths[:-1] = starts[1:] - starts[:-1]
    lengths[-1] = n - starts[-1]
    return np.repeat(hit, lengths)


def eval_predicate_np(pred: Predicate | None, cols: dict[str, np.ndarray]) -> np.ndarray:
    """Vectorized predicate evaluation over numpy host lanes (numeric
    columns only; binary/string predicates go through eval_predicate_host).
    Raw predicates only — Slot/InSetProbe templates are device-side forms."""
    n = len(next(iter(cols.values())))
    if pred is None:
        return np.ones(n, dtype=bool)

    def ev(p: Predicate) -> np.ndarray:
        if isinstance(p, Compare):
            c = cols[p.column]
            if isinstance(p.literal, Slot):
                raise HoraeError("Slot template unsupported on the numpy path")
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
            probe = np.asarray(vals_list, dtype=c.dtype)
            return _isin_run_compressed(c, probe)
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


# -- host-side min/max pruning ----------------------------------------------

def prune_range(pred: Predicate | None, stats: dict[str, tuple]) -> bool:
    """Can any row in a chunk with column [min, max] `stats` match?

    Conservative: returns True (keep) unless the predicate provably rejects
    the whole chunk. Used for SST- and row-group-level pruning, the analog of
    row-group min/max statistics.
    """
    if pred is None:
        return True
    return _prune(pred, stats)


def _prune(pred: Predicate, stats: dict[str, tuple]) -> bool:
    if isinstance(pred, Compare):
        if pred.column not in stats:
            return True
        lo, hi = stats[pred.column]
        v = pred.literal
        try:
            if pred.op == "eq":
                return lo <= v <= hi
            if pred.op == "ne":
                return not (lo == hi == v)
            if pred.op == "lt":
                return lo < v
            if pred.op == "le":
                return lo <= v
            if pred.op == "gt":
                return hi > v
            return hi >= v
        except TypeError:
            return True  # mismatched stat/literal types (e.g. bytes stats): keep
    if isinstance(pred, InSet):
        if pred.column not in stats:
            return True
        lo, hi = stats[pred.column]
        try:
            return any(lo <= v <= hi for v in pred.values)
        except TypeError:
            return True
    if isinstance(pred, InSetProbe):
        return True  # membership values are dynamic; stay conservative
    if isinstance(pred, And):
        return all(_prune(c, stats) for c in pred.children)
    if isinstance(pred, Or):
        return any(_prune(c, stats) for c in pred.children)
    if isinstance(pred, Not):
        return True  # can't cheaply invert interval logic; stay conservative
    raise HoraeError(f"unknown predicate node: {pred!r}")
