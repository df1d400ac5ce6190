"""PromQL subset: tokenizer, AST, and parser.

A copy of the JAX package's `promql/__init__.py` (it imports only the
error module). The evaluator (promql/eval.py) runs the parsed expression
against the port's metric engine: the `*_over_time` family with
window == step rides the device downsample pushdown, counter functions
and instant selectors ride the raw scan.

Supported grammar (see promql/eval.py for semantics and divergences):

    expr      := and_expr ("or" and_expr)*
    and_expr  := cmp (("and"|"unless") cmp)*
    cmp       := arith ((">"|">="|"<"|"<="|"=="|"!=") arith)*
    arith     := term (("+"|"-") term)*
    term      := unary (("*"|"/") unary)*
    unary     := "-"? primary
    primary   := NUMBER
               | FUNC "(" expr ")"
               | AGG ("by"|"without") "(" labels ")" "(" expr ")"
               | AGG "(" expr ")" [("by"|"without") "(" labels ")"]
               | ("topk"|"bottomk") "(" INT "," expr ")"
               | "(" expr ")"
               | selector
    selector  := NAME ["{" matcher ("," matcher)* "}"] ["[" DURATION "]"]
                 ["offset" DURATION]
    matcher   := NAME ("=" | "!=" | "=~" | "!~") STRING

FUNC:   rate increase delta avg_over_time sum_over_time min_over_time
        max_over_time count_over_time last_over_time
MATHFN: abs ceil floor round sqrt ln log2 log10 exp   — MATHFN "(" expr ")"
        clamp_min clamp_max "(" expr "," ["-"] NUMBER ")"
        histogram_quantile "(" NUMBER "," expr ")"  — expr yields `le` buckets
        label_replace "(" expr "," STRING x4 ")"  — dst, replacement, src, regex
AGG:    sum avg min max count
A NAME from any function set followed by anything but "(" parses as a
metric selector (a metric named `rate` stays queryable).
DURATION: integer + unit in {ms, s, m, h, d, w}

Binary arithmetic: scalar-vector elementwise, or vector-vector with
EXACT label-set matching (ignoring __name__; one-to-one only — group_left
/group_right many-to-one matching is out of the subset and rejected
loudly). Comparisons are Prometheus filter semantics (failing steps drop;
the `bool` modifier is out of the subset), and the set operators
and/or/unless match per step on the __name__-stripped label set — the
shapes SLO burn-rate rules need (`err/total` ratios, `short > x and
long > x`). `and`/`or`/`unless` are reserved words in operator position
only; a metric so named stays queryable standalone.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from horaedb_tpu_torch.common.error import HoraeError


class PromQLError(HoraeError):
    """Parse or evaluation error (surfaces as Prometheus bad_data)."""


FUNCS = frozenset({
    "rate", "increase", "delta", "avg_over_time", "sum_over_time",
    "min_over_time", "max_over_time", "count_over_time", "last_over_time",
})
AGGS = frozenset({"sum", "avg", "min", "max", "count"})
TOPK_AGGS = frozenset({"topk", "bottomk"})
# elementwise math over a vector (or scalar); clamp_* take (expr, scalar)
MATH_FUNCS = frozenset({"abs", "ceil", "floor", "round", "sqrt", "ln", "log2",
                        "log10", "exp"})
CLAMP_FUNCS = frozenset({"clamp_min", "clamp_max"})

_DURATION_UNITS = {
    "ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
    "d": 86_400_000, "w": 7 * 86_400_000,
}

# matcher op -> QueryRequest matcher op (engine/engine.py:78-80); "=" maps
# to the cheaper equality filter lane instead
_MATCH_OPS = {"!=": "ne", "=~": "re", "!~": "nre"}


# -- AST --------------------------------------------------------------------


@dataclass(frozen=True)
class Selector:
    name: str
    # (key, op, value) with op in {"=", "!=", "=~", "!~"}
    matchers: tuple = ()
    range_ms: int | None = None  # [5m] -> 300000; None = instant vector
    offset_ms: int = 0           # `offset 5m` shifts the data window back


@dataclass(frozen=True)
class Func:
    fn: str
    arg: Selector  # subset: over-time/counter functions take a selector


@dataclass(frozen=True)
class Agg:
    op: str
    expr: object
    by: tuple | None = None       # by(...) projection
    without: tuple | None = None  # without(...) exclusion


@dataclass(frozen=True)
class TopK:
    op: str      # topk | bottomk
    k: int
    expr: object


@dataclass(frozen=True)
class MathFn:
    fn: str           # abs/ceil/floor/round/sqrt/ln/log2/log10/exp/clamp_*
    expr: object
    arg: float | None = None  # clamp bound


@dataclass(frozen=True)
class HistogramQuantile:
    q: float
    expr: object  # must evaluate to a vector of `le`-labelled buckets


@dataclass(frozen=True)
class LabelReplace:
    expr: object
    dst: str
    replacement: str  # RE2-style $1 / ${name} group references
    src: str
    regex: str


@dataclass(frozen=True)
class Scalar:
    value: float


@dataclass(frozen=True)
class BinOp:
    op: str  # + - * /
    left: object
    right: object


@dataclass(frozen=True)
class Cmp:
    """Filter comparison (Prometheus semantics: steps failing the
    predicate drop out; the value kept is the LEFT operand's)."""

    op: str  # > >= < <= == !=
    left: object
    right: object


@dataclass(frozen=True)
class SetOp:
    """Vector set operator matching per step on the __name__-stripped
    label set: and (intersect), or (union, left wins), unless (minus)."""

    op: str  # and | or | unless
    left: object
    right: object


CMP_OPS = frozenset({">", ">=", "<", "<=", "==", "!="})
SET_OPS = frozenset({"and", "or", "unless"})


# -- tokenizer --------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+)
  | (?P<NUMBER>\d+\.\d*|\.\d+|\d+)
  | (?P<NAME>[a-zA-Z_:][a-zA-Z0-9_:]*)
  | (?P<STRING>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<OP>=~|!~|!=|==|>=|<=|=|>|<|\+|-|\*|/|\(|\)|\{|\}|\[|\]|,)
    """,
    re.VERBOSE,
)


@dataclass
class _Tok:
    kind: str
    text: str
    pos: int


def _tokenize(src: str) -> list[_Tok]:
    out, i = [], 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if m is None:
            raise PromQLError(f"unexpected character {src[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind != "WS":
            out.append(_Tok(kind, m.group(), m.start()))
    out.append(_Tok("EOF", "", len(src)))
    return out


def _unquote(s: str) -> str:
    """Resolve PromQL string escapes. Hand-rolled: `unicode_escape` would
    round-trip through latin-1 and mangle non-ASCII label values."""
    body = s[1:-1]
    if "\\" not in body:
        return body
    out, i = [], 0
    simple = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"', "'": "'"}
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            n = body[i + 1]
            if n in simple:
                out.append(simple[n])
                i += 2
                continue
            if n == "u" and i + 6 <= len(body):
                try:
                    out.append(chr(int(body[i + 2 : i + 6], 16)))
                    i += 6
                    continue
                except ValueError:
                    pass
            if n == "x" and i + 4 <= len(body):
                try:
                    out.append(chr(int(body[i + 2 : i + 4], 16)))
                    i += 4
                    continue
                except ValueError:
                    pass
            out.append(n)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


# -- parser -----------------------------------------------------------------


@dataclass
class _Parser:
    toks: list[_Tok]
    i: int = field(default=0)

    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> _Tok:
        t = self.next()
        if t.text != text:
            raise PromQLError(f"expected {text!r} at {t.pos}, got {t.text!r}")
        return t

    # expr := and_expr ("or" and_expr)*  — Prometheus precedence: `or`
    # binds loosest, then and/unless, then comparisons, then +-, then */
    def expr(self):
        node = self.and_expr()
        while self.peek().kind == "NAME" and self.peek().text == "or":
            self.next()
            node = SetOp("or", node, self.and_expr())
        return node

    def and_expr(self):
        node = self.cmp()
        while (self.peek().kind == "NAME"
               and self.peek().text in ("and", "unless")):
            op = self.next().text
            node = SetOp(op, node, self.cmp())
        return node

    def cmp(self):
        node = self.arith()
        while self.peek().kind == "OP" and self.peek().text in CMP_OPS:
            op = self.next().text
            node = Cmp(op, node, self.arith())
        return node

    def arith(self):
        node = self.term()
        while self.peek().text in ("+", "-"):
            op = self.next().text
            node = BinOp(op, node, self.term())
        return node

    def term(self):
        node = self.unary()
        while self.peek().text in ("*", "/"):
            op = self.next().text
            node = BinOp(op, node, self.unary())
        return node

    def unary(self):
        if self.peek().text == "-":
            self.next()
            return BinOp("-", Scalar(0.0), self.primary())
        return self.primary()

    def _called(self) -> bool:
        """True when the NAME at the cursor is followed by '(' — the
        function-vs-metric disambiguation Prometheus itself uses (a metric
        literally named `rate` or `abs` stays queryable)."""
        return self.toks[self.i + 1].text == "("

    def primary(self):
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            return Scalar(float(t.text))
        if t.text == "(":
            self.next()
            node = self.expr()
            self.expect(")")
            return node
        if t.kind == "NAME":
            name = t.text
            if name in FUNCS and self._called():
                self.next()
                self.expect("(")
                arg = self.expr()
                self.expect(")")
                if not isinstance(arg, Selector):
                    raise PromQLError(f"{name}() takes a range-vector selector")
                if arg.range_ms is None:
                    raise PromQLError(
                        f"{name}() needs a range selector, e.g. m[5m]"
                    )
                return Func(name, arg)
            if name in AGGS and (
                self._called() or self.toks[self.i + 1].text in ("by", "without")
            ):
                return self._aggregate(name)
            if name in TOPK_AGGS and self._called():
                self.next()
                self.expect("(")
                k_tok = self.next()
                if k_tok.kind != "NUMBER" or float(k_tok.text) != int(float(k_tok.text)):
                    raise PromQLError(f"{name}() needs an integer k at {k_tok.pos}")
                self.expect(",")
                inner = self.expr()
                self.expect(")")
                return TopK(name, int(float(k_tok.text)), inner)
            if name == "histogram_quantile" and self._called():
                self.next()
                self.expect("(")
                neg = self.peek().text == "-"
                if neg:
                    self.next()
                q_tok = self.next()
                if q_tok.kind != "NUMBER":
                    raise PromQLError(
                        f"histogram_quantile needs a numeric q at {q_tok.pos}"
                    )
                self.expect(",")
                inner = self.expr()
                self.expect(")")
                return HistogramQuantile(
                    float(q_tok.text) * (-1.0 if neg else 1.0), inner
                )
            if name == "label_replace" and self._called():
                self.next()
                self.expect("(")
                inner = self.expr()
                strs = []
                for _ in range(4):
                    self.expect(",")
                    t2 = self.next()
                    if t2.kind != "STRING":
                        raise PromQLError(
                            f"label_replace needs string args at {t2.pos}"
                        )
                    strs.append(_unquote(t2.text))
                self.expect(")")
                return LabelReplace(inner, strs[0], strs[1], strs[2], strs[3])
            if name in MATH_FUNCS and self._called():
                self.next()
                self.expect("(")
                inner = self.expr()
                self.expect(")")
                return MathFn(name, inner)
            if name in CLAMP_FUNCS and self._called():
                self.next()
                self.expect("(")
                inner = self.expr()
                self.expect(",")
                bound = self.next()
                neg = False
                if bound.text == "-":
                    neg = True
                    bound = self.next()
                if bound.kind != "NUMBER":
                    raise PromQLError(f"{name}() needs a numeric bound at {bound.pos}")
                self.expect(")")
                b = float(bound.text) * (-1.0 if neg else 1.0)
                return MathFn(name, inner, b)
            return self._selector()
        raise PromQLError(f"unexpected token {t.text!r} at {t.pos}")

    def _aggregate(self, op: str):
        self.next()  # the AGG name
        by = without = None
        if self.peek().text in ("by", "without"):
            mode = self.next().text
            labels = self._label_list()
            if mode == "by":
                by = labels
            else:
                without = labels
        self.expect("(")
        inner = self.expr()
        self.expect(")")
        if by is None and without is None and self.peek().text in ("by", "without"):
            mode = self.next().text
            labels = self._label_list()
            if mode == "by":
                by = labels
            else:
                without = labels
        return Agg(op, inner, by=by, without=without)

    def _label_list(self) -> tuple:
        self.expect("(")
        out = []
        while self.peek().text != ")":
            t = self.next()
            if t.kind != "NAME":
                raise PromQLError(f"expected label name at {t.pos}")
            out.append(t.text)
            if self.peek().text == ",":
                self.next()
        self.expect(")")
        return tuple(out)

    def _selector(self):
        name = self.next().text
        matchers = []
        if self.peek().text == "{":
            self.next()
            while self.peek().text != "}":
                key = self.next()
                if key.kind != "NAME":
                    raise PromQLError(f"expected label name at {key.pos}")
                op = self.next().text
                if op not in ("=", "!=", "=~", "!~"):
                    raise PromQLError(f"bad matcher op {op!r}")
                val = self.next()
                if val.kind != "STRING":
                    raise PromQLError(f"expected quoted value at {val.pos}")
                matchers.append((key.text, op, _unquote(val.text)))
                if self.peek().text == ",":
                    self.next()
            self.expect("}")
        range_ms = None
        if self.peek().text == "[":
            self.next()
            range_ms = self._duration()
            self.expect("]")
        offset_ms = 0
        if self.peek().text == "offset":
            self.next()
            offset_ms = self._duration()
        return Selector(name, tuple(matchers), range_ms, offset_ms)

    def _duration(self) -> int:
        num = self.next()
        if num.kind != "NUMBER":
            raise PromQLError(f"expected duration at {num.pos}")
        unit = self.next()
        if unit.text not in _DURATION_UNITS:
            raise PromQLError(f"bad duration unit {unit.text!r}")
        return int(float(num.text) * _DURATION_UNITS[unit.text])


def parse(src: str):
    """Parse one PromQL expression; raises PromQLError on any syntax the
    subset does not cover."""
    p = _Parser(_tokenize(src))
    node = p.expr()
    if p.peek().kind != "EOF":
        t = p.peek()
        raise PromQLError(f"trailing input at {t.pos}: {t.text!r}")
    return node


def parse_duration_ms(s: str) -> int:
    """'5m' / '30s' / '250ms' -> milliseconds (for the `step` params)."""
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w)", s)
    if m is None:
        # Prometheus also accepts bare seconds
        try:
            return int(float(s) * 1000)
        except ValueError:
            raise PromQLError(f"bad duration {s!r}") from None
    return int(float(m.group(1)) * _DURATION_UNITS[m.group(2)])
