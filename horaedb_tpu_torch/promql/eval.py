"""PromQL subset evaluation over the metric engine.

A port of the JAX package's `promql/eval.py`. Execution strategy:

- `sum_over_time` / `count_over_time` / `avg_over_time` / `min_over_time`
  / `max_over_time` with window == step ride the engine's aggregate
  PUSHDOWN (engine/data.py::query_downsample): every per-(series, bucket)
  reduction runs on the device behind the calibrated aggregation
  dispatcher (ops/agg_registry.py) — raw rows never reach the host.
- Counter functions (`rate`, `increase`, `delta`), `last_over_time`,
  instant selectors, and windows != step need per-window first/last
  semantics the grid does not carry; they evaluate from the raw scan with
  vectorized per-series window reductions on host.
- Aggregations (`sum by (...)`) group the per-series step vectors; scalar
  arithmetic is elementwise.

Documented divergences from Prometheus (semantics kept simple and stated
rather than silently approximated):

1. Windows are right-aligned HALF-OPEN buckets [t-step, t) evaluated at
   each step timestamp, not Prometheus's (t-window, t] — boundary samples
   land one bucket later.
2. `rate`/`increase` use (last - first + counter-reset corrections) over
   the window WITHOUT Prometheus's edge extrapolation — values are exact
   over observed samples, slightly lower than Prometheus near window
   edges.
3. Instant vector lookback is 5 minutes (Prometheus default), applied at
   each step of a range query.
4. Vector-vector binary arithmetic (label matching) is not in the subset.
5. histogram_quantile: a step whose +Inf bucket is absent yields NO value
   (as in Prometheus), but an absent FINITE bucket is treated as empty at
   the previous cumulative count instead of being dropped from the vector
   — the winning bucket matches Prometheus, while the interpolation lower
   bound may be the absent bucket's le rather than the next-lower present
   one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from horaedb_tpu_torch.common import tracing
from horaedb_tpu_torch.engine.engine import QueryRequest
from horaedb_tpu_torch.ops import agg_registry
from horaedb_tpu_torch.storage import scanstats
from horaedb_tpu_torch.promql import (
    Agg,
    BinOp,
    Cmp,
    Func,
    HistogramQuantile,
    LabelReplace,
    MathFn,
    PromQLError,
    Scalar,
    Selector,
    SetOp,
    TopK,
    _MATCH_OPS,
)

_MATH = {
    "abs": np.abs, "ceil": np.ceil, "floor": np.floor,
    # Prometheus round() resolves .5 ties UP (floor(v+0.5)); np.round's
    # banker's rounding would diverge on every half-integer
    "round": lambda v: np.floor(v + 0.5),
    "sqrt": np.sqrt, "ln": np.log, "log2": np.log2,
    "log10": np.log10, "exp": np.exp,
}

LOOKBACK_MS = 300_000  # Prometheus default instant-vector staleness window

# grid stat backing each aligned *_over_time function
_GRID_STAT = {
    "sum_over_time": "sum",
    "count_over_time": "count",
    "avg_over_time": "mean",
    "min_over_time": "min",
    "max_over_time": "max",
}


@dataclass
class SeriesVector:
    """One output series: its labels and one value per step (NaN = absent)."""

    labels: dict[str, str]
    values: np.ndarray


def _to_query(sel: Selector, start_ms: int, end_ms: int,
              bucket_ms: int | None = None) -> QueryRequest:
    filters, matchers = [], []
    for key, op, val in sel.matchers:
        if op == "=":
            filters.append((key.encode(), val.encode()))
        else:
            matchers.append((key.encode(), _MATCH_OPS[op], val.encode()))
    return QueryRequest(
        metric=sel.name.encode(), start_ms=start_ms, end_ms=end_ms,
        filters=filters, matchers=matchers, bucket_ms=bucket_ms,
    )


class RangeEvaluator:
    """Evaluate one parsed expression over [start, end] at `step` spacing.

    Steps are `start + k*step` for k in 0..floor((end-start)/step)
    (Prometheus range-query grid)."""

    def __init__(self, engine, start_ms: int, end_ms: int, step_ms: int,
                 max_series: int = 10_000):
        if step_ms <= 0:
            raise PromQLError("step must be > 0")
        if end_ms < start_ms:
            raise PromQLError("end must be >= start")
        n_steps = (end_ms - start_ms) // step_ms + 1
        if n_steps > 11_000:
            raise PromQLError(
                f"{n_steps} steps exceeds the resolution limit (11000); "
                "increase step"
            )
        self._engine = engine
        self.start = start_ms
        self.step = step_ms
        self.steps = start_ms + step_ms * np.arange(n_steps, dtype=np.int64)
        self._max_series = max_series

    # -- public -------------------------------------------------------------

    async def eval(self, node) -> "list[SeriesVector] | float":
        if isinstance(node, Scalar):
            return node.value
        if isinstance(node, BinOp):
            return await self._binop(node)
        if isinstance(node, Cmp):
            return await self._cmp(node)
        if isinstance(node, SetOp):
            return await self._setop(node)
        if isinstance(node, Selector):
            if node.range_ms is not None:
                raise PromQLError(
                    "a range selector needs a function (rate, *_over_time)"
                )
            return await self._instant(node)
        if isinstance(node, Func):
            return await self._func(node)
        if isinstance(node, Agg):
            return await self._agg(node)
        if isinstance(node, TopK):
            return await self._topk(node)
        if isinstance(node, MathFn):
            return await self._math(node)
        if isinstance(node, HistogramQuantile):
            return await self._histogram_quantile(node)
        if isinstance(node, LabelReplace):
            return await self._label_replace(node)
        raise PromQLError(f"unsupported node {type(node).__name__}")

    async def _label_replace(self, node: LabelReplace):
        """Prometheus label_replace(v, dst, replacement, src, regex): when
        regex FULL-matches src's value, dst is set to replacement with
        RE2-style $N/${name} group references expanded; an empty result
        drops dst; non-matching series pass through unchanged. The engine's
        catastrophic-backtracking guard applies (the regex is user input
        evaluated on the event loop)."""
        import re as _re

        from horaedb_tpu_torch.engine.index import _reject_catastrophic

        inner = await self.eval(node.expr)
        if isinstance(inner, float):
            raise PromQLError("label_replace needs a vector operand")
        if not _re.fullmatch(r"[a-zA-Z_][a-zA-Z0-9_]*", node.dst):
            raise PromQLError(f"invalid destination label {node.dst!r}")
        try:
            _reject_catastrophic(node.regex)
        except Exception as e:  # noqa: BLE001 — HoraeError -> bad_data
            raise PromQLError(str(e)) from None
        try:
            pat = _re.compile(node.regex)
        except _re.error as e:
            raise PromQLError(f"bad regex {node.regex!r}: {e}") from None
        # RE2 replacement syntax -> Python expand template:
        # $$ -> $, ${name} -> \g<name>, $1 -> \g<1>
        def _tr(m):
            g = m.group(1)
            if g == "$":
                return "$"
            if g.startswith("{"):
                return rf"\g<{g[1:-1]}>"
            return rf"\g<{g}>"

        template = _re.sub(r"\$(\$|\{\w+\}|\d+)", _tr, node.replacement)
        out = []
        for sv in inner:
            m = pat.fullmatch(sv.labels.get(node.src, ""))
            if m is None:
                out.append(sv)
                continue
            try:
                val = m.expand(template)
            except (_re.error, IndexError) as e:
                raise PromQLError(
                    f"bad replacement {node.replacement!r}: {e}"
                ) from None
            labels = dict(sv.labels)
            if val == "":
                labels.pop(node.dst, None)
            else:
                labels[node.dst] = val
            out.append(SeriesVector(labels, sv.values))
        return out

    async def _histogram_quantile(self, node: HistogramQuantile):
        """Prometheus histogram_quantile over classic `le` buckets: group
        the inner vector by labels-minus-le, enforce monotone cumulative
        counts, and linearly interpolate within the winning bucket
        (promql/quantile.go semantics; the +Inf bucket carries the total).
        Vectorized over steps per group."""
        inner = await self.eval(node.expr)
        if isinstance(inner, float):
            raise PromQLError("histogram_quantile needs a vector of buckets")
        q = node.q
        groups: dict[tuple, list[tuple[float, np.ndarray]]] = {}
        glabels: dict[tuple, dict] = {}
        for sv in inner:
            le_s = sv.labels.get("le")
            if le_s is None:
                continue  # Prometheus ignores bucket-less series
            try:
                le = float("inf") if le_s in ("+Inf", "Inf", "inf") else float(le_s)
            except ValueError:
                continue
            rest = {k: v for k, v in sv.labels.items()
                    if k not in ("le", "__name__")}
            key = tuple(sorted(rest.items()))
            groups.setdefault(key, []).append((le, sv.values))
            glabels[key] = rest
        out = []
        for key, buckets in sorted(groups.items()):
            buckets.sort(key=lambda b: b[0])
            les = np.array([b[0] for b in buckets])
            if not np.isinf(les[-1]) or len(buckets) < 2:
                continue  # no +Inf bucket -> undefined (Prometheus: NaN/skip)
            raw = np.stack([b[1] for b in buckets])  # [buckets, steps]
            # a step where the +Inf series is absent has NO total — emitting
            # one from the finite buckets would fabricate a quantile
            inf_absent = np.isnan(raw[-1])
            # absent FINITE buckets impute to the previous bucket's
            # cumulative count via the max-accumulate repair: they can then
            # never win the bucket search, though the interpolation lower
            # bound remains the absent bucket's le (documented divergence —
            # Prometheus drops the bucket from the instant vector entirely)
            cum = np.where(np.isnan(raw), 0.0, raw)
            cum = np.maximum.accumulate(cum, axis=0)  # also repairs jitter
            total = cum[-1]
            n_steps = cum.shape[1]
            vals = np.full(n_steps, np.nan)
            ok = (total > 0) & ~inf_absent
            if q < 0:
                vals[ok] = -np.inf
            elif q > 1:
                vals[ok] = np.inf
            else:
                rank = q * total  # target cumulative count per step
                # first bucket with cum >= rank (argmax of a bool stack)
                ge = cum >= rank[None, :]
                b_idx = np.argmax(ge, axis=0)
                lo_bound = np.where(b_idx > 0, les[np.maximum(b_idx - 1, 0)], 0.0)
                hi_bound = les[b_idx]
                cum_lo = np.where(
                    b_idx > 0,
                    cum[np.maximum(b_idx - 1, 0), np.arange(n_steps)],
                    0.0,
                )
                cum_hi = cum[b_idx, np.arange(n_steps)]
                # +Inf winning bucket: Prometheus returns its lower bound
                inf_win = np.isinf(hi_bound)
                with np.errstate(all="ignore"):
                    frac = np.where(
                        cum_hi > cum_lo, (rank - cum_lo) / (cum_hi - cum_lo), 1.0
                    )
                    interp = lo_bound + (hi_bound - lo_bound) * frac
                res = np.where(inf_win, lo_bound, interp)
                # quantile.go: a winning FIRST bucket with upperBound <= 0
                # returns the upper bound itself (interpolating from the
                # hardcoded 0 lower bound would exceed the data's range)
                if les[0] <= 0:
                    res = np.where(b_idx == 0, les[0], res)
                vals[ok] = res[ok]
            if not np.isnan(vals).all():
                out.append(SeriesVector(glabels[key], vals))
        return out

    async def _math(self, node: MathFn):
        inner = await self.eval(node.expr)

        def apply(v):
            with np.errstate(all="ignore"):
                if node.fn == "clamp_min":
                    return np.maximum(v, node.arg)
                if node.fn == "clamp_max":
                    return np.minimum(v, node.arg)
                return _MATH[node.fn](v)

        if isinstance(inner, float):
            return float(apply(np.float64(inner)))
        # function application drops __name__ (Prometheus semantics)
        return [
            SeriesVector(
                {k: v for k, v in sv.labels.items() if k != "__name__"},
                apply(sv.values),
            )
            for sv in inner
        ]

    # -- series plumbing ----------------------------------------------------

    # raw-path materialization cap: the native JSON API caps at 1M rows;
    # PromQL's raw functions get more headroom (rate over long windows) but
    # never unbounded — a panel query must not OOM the server
    MAX_RAW_ROWS = 5_000_000

    def _labels_of(self, sel: Selector, tsids, keep_name: bool):
        """tsid -> result labels, decoded only for the tsids actually in
        the result (a selective query must not decode a 100k-series
        metric). Public engine surface — works on RegionedEngine too."""
        by_tsid = self._engine.series_labels_map(sel.name.encode(), list(tsids))
        out = {}
        for tsid, labs in by_tsid.items():
            d = {k.decode(errors="replace"): v.decode(errors="replace")
                 for k, v in labs.items()}
            if keep_name:
                d["__name__"] = sel.name
            out[tsid] = d
        return out

    async def _raw_series(self, sel: Selector, pre_ms: int):
        """Raw samples per tsid over [start - pre, end], each sorted by ts:
        {tsid: (ts_array, value_array)}. `offset` shifts the DATA window
        back and the returned timestamps forward by the same amount, so
        every downstream window computation stays offset-oblivious."""
        o = sel.offset_ms
        req = _to_query(sel, self.start - pre_ms - o,
                        int(self.steps[-1]) + 1 - o)
        req.limit = self.MAX_RAW_ROWS + 1
        scanstats.note("promql_raw_selects")
        table = await self._engine.query(req)
        if table is None:
            return {}
        if table.num_rows > self.MAX_RAW_ROWS:
            raise PromQLError(
                f"query materializes more than {self.MAX_RAW_ROWS} raw "
                "samples; narrow the range/selector, or use an *_over_time "
                "function with window == step (served by pushdown)"
            )
        tsid = table.column("tsid").to_numpy(zero_copy_only=False).astype(np.uint64)
        ts = table.column("ts").to_numpy(zero_copy_only=False).astype(np.int64) + o
        val = table.column("value").to_numpy(zero_copy_only=False)
        order = np.lexsort((ts, tsid))
        tsid, ts, val = tsid[order], ts[order], val[order]
        out = {}
        bounds = np.flatnonzero(tsid[1:] != tsid[:-1]) + 1
        starts = np.concatenate([[0], bounds, [len(tsid)]])
        for i in range(len(starts) - 1):
            lo, hi = starts[i], starts[i + 1]
            if lo < hi:
                out[int(tsid[lo])] = (ts[lo:hi], val[lo:hi])
        if len(out) > self._max_series:
            raise PromQLError(
                f"query selects {len(out)} series (limit {self._max_series})"
            )
        return out

    # -- selector / function evaluation --------------------------------------

    async def _instant(self, sel: Selector) -> list[SeriesVector]:
        """Instant vector at each step: last sample within the lookback."""
        series = await self._raw_series(sel, LOOKBACK_MS)
        labels = self._labels_of(sel, series.keys(), keep_name=True)
        out = []
        for tsid, (ts, val) in series.items():
            idx = np.searchsorted(ts, self.steps, side="right") - 1
            vals = np.full(len(self.steps), np.nan)
            ok = idx >= 0
            cand = np.where(ok, idx, 0)
            fresh = ok & (self.steps - ts[cand] <= LOOKBACK_MS)
            vals[fresh] = val[cand[fresh]]
            if np.isnan(vals).all():
                continue
            out.append(SeriesVector(labels.get(tsid, {}), vals))
        return out

    async def _func(self, node: Func) -> list[SeriesVector]:
        sel = node.arg
        window = sel.range_ms
        if node.fn in _GRID_STAT and window == self.step:
            return await self._grid_over_time(node.fn, sel)
        series = await self._raw_series(sel, window)
        labels = self._labels_of(sel, series.keys(), keep_name=False)
        out = []
        for tsid, (ts, val) in series.items():
            vals = self._window_reduce(node.fn, ts, val, window)
            if np.isnan(vals).all():
                continue
            out.append(SeriesVector(labels.get(tsid, {}), vals))
        return out

    async def _grid_over_time(self, fn: str, sel: Selector) -> list[SeriesVector]:
        """window == step: ONE device-pushdown downsample serves every step
        — the device fast path (raw rows never reach the host).

        Buckets anchor one window BEFORE the first step, so bucket k covers
        [steps[k] - step, steps[k]) and step 0 gets a real value from
        pre-range samples — identical alignment to the raw-path
        `_window_reduce` (a step nudge across the ==window boundary must
        not add or drop points)."""
        o = sel.offset_ms
        t0 = self.start - self.step - o
        req = _to_query(sel, t0, int(self.steps[-1]) - o, bucket_ms=self.step)
        scanstats.note("promql_pushdowns")
        res = await self._engine.query(req)
        # span attribution: which aggregation kernel the calibrated
        # registry dispatcher served this pushdown with
        tracing.add_attr(agg_impl=agg_registry.last_choice())
        if res is None:
            return []
        tsids, grids = res
        labels = self._labels_of(sel, [int(t) for t in tsids], keep_name=False)
        stat = _GRID_STAT[fn]
        grid = np.asarray(grids[stat], dtype=np.float64)
        count = np.asarray(grids["count"])
        out = []
        for i, tsid in enumerate(tsids):
            vals = np.full(len(self.steps), np.nan)
            n = min(grid.shape[1], len(self.steps))
            v = grid[i, :n].copy()
            v[count[i, :n] == 0] = np.nan
            vals[:n] = v
            if np.isnan(vals).all():
                continue
            out.append(SeriesVector(labels.get(int(tsid), {}), vals))
        return out

    def _window_reduce(self, fn: str, ts, val, window: int) -> np.ndarray:
        """Per-step reduction over [t-window, t) windows of one series."""
        lo = np.searchsorted(ts, self.steps - window, side="left")
        hi = np.searchsorted(ts, self.steps, side="left")
        n = len(self.steps)
        vals = np.full(n, np.nan)
        if fn in ("sum_over_time", "count_over_time", "avg_over_time"):
            csum = np.concatenate([[0.0], np.cumsum(val)])
            cnt = (hi - lo).astype(np.float64)
            s = csum[hi] - csum[lo]
            nz = cnt > 0
            if fn == "sum_over_time":
                vals[nz] = s[nz]
            elif fn == "count_over_time":
                vals[nz] = cnt[nz]
            else:
                vals[nz] = s[nz] / cnt[nz]
            return vals
        if fn == "last_over_time":
            nz = hi > lo
            vals[nz] = val[hi[nz] - 1]
            return vals
        if fn in ("min_over_time", "max_over_time"):
            # one vectorized reduceat over interleaved (lo, hi) bounds:
            # even slots hold each window's reduction (odd slots are the
            # inter-window gaps — discarded). A sentinel pad makes hi ==
            # len(val) a legal index; empty windows are masked by `nz`.
            red = np.minimum if fn == "min_over_time" else np.maximum
            pad = np.append(val, np.inf if fn == "min_over_time" else -np.inf)
            idx = np.empty(2 * n, dtype=np.int64)
            idx[0::2] = lo
            idx[1::2] = np.maximum(hi, lo)
            nz = hi > lo
            out = red.reduceat(pad, idx)[0::2]
            vals[nz] = out[nz]
            return vals
        if fn in ("rate", "increase", "delta"):
            # counter semantics: increase = last - first + resets. A reset
            # restarts the counter at ~0, so each one contributes the full
            # PRE-RESET value (Prometheus's correction), not the drop
            # amount. delta skips the correction (gauge). No edge
            # extrapolation (module docstring).
            drops = np.where(val[1:] < val[:-1], val[:-1], 0.0)
            cdrop = np.concatenate([[0.0], np.cumsum(drops)])
            nz = hi - lo >= 2
            first = val[np.where(nz, lo, 0)]
            last = val[np.where(nz, hi - 1, 0)]
            resets = cdrop[np.where(nz, hi - 1, 0)] - cdrop[np.where(nz, lo, 0)]
            if fn == "delta":
                vals[nz] = (last - first)[nz]
            else:
                inc = (last - first + resets)[nz]
                vals[nz] = inc if fn == "increase" else inc / (window / 1000.0)
            return vals
        raise PromQLError(f"unsupported function {fn}")

    async def _topk(self, node: TopK) -> list[SeriesVector]:
        """topk/bottomk with Prometheus RANGE semantics: the winning set is
        chosen independently at every step, so a series appears only at the
        steps where it ranks (masked NaN elsewhere)."""
        inner = await self.eval(node.expr)
        if isinstance(inner, float):
            raise PromQLError(f"{node.op}() needs a vector operand")
        if not inner or node.k <= 0:
            return []
        stack = np.stack([sv.values for sv in inner])  # [series, steps]
        fill = -np.inf if node.op == "topk" else np.inf
        arr = np.where(np.isnan(stack), fill, stack)
        # secondary validity key: the NaN fill ties with a REAL -Inf (topk)
        # / +Inf (bottomk) value, and a plain stable sort could rank the
        # absent series into the k-set (its mask would then silently drop a
        # real member). Valid entries must win every tie.
        isnan = np.isnan(stack)
        tie = isnan.astype(np.int8) if node.op == "bottomk" else (~isnan).astype(np.int8)
        order = np.lexsort((tie, arr), axis=0)
        k = min(node.k, stack.shape[0])
        keep_idx = order[-k:, :] if node.op == "topk" else order[:k, :]
        keep = np.zeros(stack.shape, dtype=bool)
        keep[keep_idx, np.arange(stack.shape[1])[None, :]] = True
        keep &= ~np.isnan(stack)
        out = []
        for i, sv in enumerate(inner):
            vals = np.where(keep[i], sv.values, np.nan)
            if not np.isnan(vals).all():
                out.append(SeriesVector(sv.labels, vals))
        return out

    # -- aggregation / arithmetic --------------------------------------------

    async def _agg(self, node: Agg) -> list[SeriesVector]:
        inner = await self.eval(node.expr)
        if isinstance(inner, float):
            raise PromQLError(f"{node.op}() needs a vector operand")
        groups: dict[tuple, list[SeriesVector]] = {}
        for sv in inner:
            if node.by is not None:
                key_labels = {k: sv.labels.get(k, "") for k in node.by}
            elif node.without is not None:
                key_labels = {
                    k: v for k, v in sv.labels.items()
                    if k not in node.without and k != "__name__"
                }
            else:
                key_labels = {}
            key = tuple(sorted(key_labels.items()))
            groups.setdefault(key, []).append(sv)
        out = []
        for key, members in sorted(groups.items()):
            stack = np.stack([m.values for m in members])
            with np.errstate(all="ignore"):
                if node.op == "sum":
                    vals = np.nansum(stack, axis=0)
                elif node.op == "avg":
                    vals = np.nanmean(stack, axis=0)
                elif node.op == "min":
                    vals = np.nanmin(stack, axis=0)
                elif node.op == "max":
                    vals = np.nanmax(stack, axis=0)
                else:  # count
                    vals = np.sum(~np.isnan(stack), axis=0).astype(np.float64)
            # all-NaN step stays NaN (nansum yields 0.0 there — mask it)
            allnan = np.isnan(stack).all(axis=0)
            if node.op in ("sum", "count"):
                vals = np.where(allnan, np.nan, vals)
            out.append(SeriesVector(dict(key), vals))
        return out

    async def _binop(self, node: BinOp):
        left = await self.eval(node.left)
        right = await self.eval(node.right)
        if isinstance(left, float) and isinstance(right, float):
            return float(_apply(node.op, np.float64(left), np.float64(right)))
        if isinstance(left, float):
            return [
                SeriesVector(sv.labels, _apply(node.op, left, sv.values))
                for sv in right
            ]
        if isinstance(right, float):
            return [
                SeriesVector(sv.labels, _apply(node.op, sv.values, right))
                for sv in left
            ]
        # vector-vector: exact one-to-one label-set matching (__name__
        # ignored, dropped from the result — Prometheus arithmetic strips
        # the metric name). Unmatched series drop; a duplicate label set
        # on either side would be many-to-one matching, which is outside
        # the subset and rejected loudly.
        rmap = _keyed(right, "right operand")
        out = []
        for key, lsv in _keyed(left, "left operand").items():
            rsv = rmap.get(key)
            if rsv is None:
                continue
            out.append(SeriesVector(
                dict(key), _apply(node.op, lsv.values, rsv.values)
            ))
        return out

    async def _cmp(self, node: "Cmp"):
        """Filter comparison: steps where the predicate fails become NaN
        (absent); the surviving value is the LEFT operand's, labels kept
        verbatim (Prometheus keeps __name__ through filter comparisons).
        Series with no surviving step drop entirely."""
        left = await self.eval(node.left)
        right = await self.eval(node.right)
        if isinstance(left, float) and isinstance(right, float):
            raise PromQLError(
                "scalar-scalar comparison needs the bool modifier, which "
                "is outside the subset; compare a vector against a scalar"
            )
        if isinstance(left, float):
            # scalar OP vector keeps the VECTOR's entries (Prometheus:
            # the vector side survives filtering); mirror the predicate
            out = []
            for sv in right:
                keep = _cmp_mask(node.op, np.full_like(sv.values, left),
                                 sv.values)
                vals = np.where(keep, sv.values, np.nan)
                if not np.isnan(vals).all():
                    out.append(SeriesVector(sv.labels, vals))
            return out
        if isinstance(right, float):
            pairs = [(sv, np.full_like(sv.values, right)) for sv in left]
        else:
            rmap = _keyed(right, "right operand")
            pairs = [
                (lsv, rmap[key].values)
                for key, lsv in _keyed(left, "left operand").items()
                if key in rmap
            ]
        out = []
        for lsv, rvals in pairs:
            keep = _cmp_mask(node.op, lsv.values, rvals)
            vals = np.where(keep, lsv.values, np.nan)
            if not np.isnan(vals).all():
                out.append(SeriesVector(lsv.labels, vals))
        return out

    async def _setop(self, node: "SetOp"):
        """and/or/unless per step on the __name__-stripped label set:
        `and` keeps left steps where the right series has a value,
        `unless` keeps left steps where it does NOT, `or` is the union
        with left winning matched steps. Left labels survive verbatim."""
        left = await self.eval(node.left)
        right = await self.eval(node.right)
        if isinstance(left, float) or isinstance(right, float):
            raise PromQLError(
                f"`{node.op}` needs vector operands on both sides"
            )
        rmap = _keyed(right, "right operand")
        lmap = _keyed(left, "left operand")
        out = []
        for key, lsv in lmap.items():
            rsv = rmap.get(key)
            if node.op == "and":
                if rsv is None:
                    continue
                vals = np.where(np.isnan(rsv.values), np.nan, lsv.values)
                if np.isnan(vals).all():
                    continue
            elif node.op == "unless":
                vals = (lsv.values if rsv is None
                        else np.where(np.isnan(rsv.values), lsv.values,
                                      np.nan))
                if np.isnan(vals).all():
                    continue
            else:  # or: left value wins; right fills left's gaps
                vals = (lsv.values if rsv is None
                        else np.where(np.isnan(lsv.values), rsv.values,
                                      lsv.values))
            out.append(SeriesVector(lsv.labels, vals))
        if node.op == "or":
            out.extend(rsv for key, rsv in rmap.items() if key not in lmap)
        return out


def _apply(op: str, a, b):
    with np.errstate(all="ignore"):
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        return a / b


def _keyed(vec, side: str) -> dict:
    """{__name__-stripped sorted label items: SeriesVector}. A duplicate
    key is many-to-one territory — rejected, not silently merged."""
    out = {}
    for sv in vec:
        key = tuple(sorted(
            (k, v) for k, v in sv.labels.items() if k != "__name__"
        ))
        if key in out:
            raise PromQLError(
                f"vector matching: duplicate label set {dict(key)} on the "
                f"{side} (many-to-one matching is outside the subset; "
                "aggregate one side first)"
            )
        out[key] = sv
    return out


def _cmp_mask(op: str, a, b):
    """Comparison predicate; NaN on either side compares False (the step
    is absent, so it cannot survive a filter)."""
    with np.errstate(all="ignore"):
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == "==":
            return a == b
        return ~np.isnan(a) & ~np.isnan(b) & (a != b)


def walk_expr(node):
    """Yield every node of a parsed PromQL expression tree (generic
    dataclass descent). THE walker: max_selector_window_ms,
    selector_metrics, the rule engine's relevance filter, and the
    server's provenance view all ride this one traversal, so a new node
    type (or a Selector field change) is handled in exactly one place."""
    from dataclasses import fields as dc_fields, is_dataclass

    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        if is_dataclass(n) and not isinstance(n, type):
            for f in dc_fields(n):
                v = getattr(n, f.name)
                if isinstance(v, (list, tuple)):
                    stack.extend(v)
                else:
                    stack.append(v)


def selector_metrics(node) -> tuple:
    """Sorted metric names the expression reads (every selector)."""
    return tuple(sorted({
        n.name for n in walk_expr(node) if isinstance(n, Selector)
    }))


def max_selector_window_ms(node) -> int:
    """Largest data lookback any part of `node` reads at one step: the
    max selector range (rate windows) floored at the instant-vector
    LOOKBACK. The rule evaluator uses this to smear a dirty data range
    onto the output steps it can influence — a sample at time x can only
    change steps in (x, x + window]."""
    worst = LOOKBACK_MS
    for n in walk_expr(node):
        if isinstance(n, Selector):
            # `offset` shifts the DATA window back: a sample at x feeds
            # steps in (x + offset, x + offset + window] — the lookback
            # is window PLUS offset, not max of the two
            window = (int(n.range_ms) if n.range_ms is not None
                      else LOOKBACK_MS)
            worst = max(worst, window + int(n.offset_ms or 0))
    return worst


async def evaluate_range(
    engine, expr, start_ms: int, end_ms: int, step_ms: int,
    max_series: int = 10_000,
) -> "tuple[np.ndarray, list[SeriesVector] | float]":
    """The reusable eval entry for standing queries (rule bodies): parse
    (if given a string) and evaluate over the [start, end] step grid,
    returning (steps, series). Exactly the engine the HTTP handlers run —
    a recording rule's incremental output is bit-exact vs a cold
    /api/v1/query_range of the same body by construction, because both
    ARE this function."""
    from horaedb_tpu_torch.promql import parse

    node = parse(expr) if isinstance(expr, str) else expr
    ev = RangeEvaluator(engine, start_ms, end_ms, step_ms,
                        max_series=max_series)
    return ev.steps, await ev.eval(node)


def to_prometheus_matrix(
    series: "list[SeriesVector] | float", steps: np.ndarray
) -> dict:
    """Prometheus /api/v1/query_range response `data` payload."""
    secs = steps / 1000.0
    if isinstance(series, float):
        return {
            "resultType": "matrix",
            "result": [{
                "metric": {},
                "values": [[float(s), _fmt(series)] for s in secs],
            }],
        }
    result = []
    for sv in series:
        pts = [
            [float(secs[i]), _fmt(sv.values[i])]
            for i in range(len(steps))
            if not np.isnan(sv.values[i])
        ]
        if pts:
            result.append({"metric": sv.labels, "values": pts})
    return {"resultType": "matrix", "result": result}


def to_prometheus_vector(
    series: "list[SeriesVector] | float", at_ms: int
) -> dict:
    """Prometheus instant-query `data` payload (last step only)."""
    sec = at_ms / 1000.0
    if isinstance(series, float):
        return {
            "resultType": "scalar",
            "result": [sec, _fmt(series)],
        }
    result = []
    for sv in series:
        v = sv.values[-1]
        if not np.isnan(v):
            result.append({"metric": sv.labels, "value": [sec, _fmt(v)]})
    return {"resultType": "vector", "result": result}


def _fmt(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)
