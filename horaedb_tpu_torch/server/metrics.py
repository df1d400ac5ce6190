"""Metrics registry: counters, gauges, and fixed-bucket histograms.

A copy of the JAX package's `server/metrics.py` (it imports nothing of
that package); the port's engine and query batcher register their
`horaedb_*` families here.

The reference has logging but NO metrics endpoint (SURVEY §5.5 —
DataFusion's metrics set is accepted but unused); the survey explicitly
tells the TPU build to do better. This module is the process-wide registry
every layer (ingest, flush, scan, compaction, HTTP) reports into, rendered
in the Prometheus text exposition format at /metrics.

Dependency-free by design: storage/, engine/, and parallel/ import it, so
it must never pull in aiohttp, jax, or anything above common/.

API:

    H = GLOBAL_METRICS.histogram("horaedb_scan_stage_seconds",
                                 help="per-stage scan time",
                                 labelnames=("stage",))
    H.labels("io_decode").observe(0.012)

    C = GLOBAL_METRICS.counter("horaedb_queries_total")
    C.inc()

Legacy string API (`METRICS.inc('name{label="v"}')`) keeps working: the
embedded label form parses into a labeled child so the seed's call sites
render with correct `# TYPE` metadata and escaped label values.
"""

from __future__ import annotations

import bisect
import re
import threading
import time

__all__ = [
    "Metrics", "CounterFamily", "GaugeFamily", "HistogramFamily",
    "GLOBAL_METRICS", "DEFAULT_BUCKETS", "set_exemplar_source",
    "OPENMETRICS_CONTENT_TYPE",
]

OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text"

# Exemplar source: a zero-arg callable returning the active trace id (or
# None outside a trace). Injected — NOT imported — so this module stays
# dependency-free (storage/ and parallel/ import it); the telemetry
# package wires it to common/tracing.current_trace_id at import.
_exemplar_source = None


def set_exemplar_source(fn) -> None:
    global _exemplar_source
    _exemplar_source = fn

# Prometheus' classic latency buckets (seconds); wide enough to cover a
# sub-ms device dispatch and a multi-second compaction in one family.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

# Size buckets (bytes): 4 KiB .. 4 GiB in 8x steps.
BYTES_BUCKETS = tuple(float(4096 * 8 ** i) for i in range(7))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LEGACY_RE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
                        r"(?:\{(?P<labels>.*)\})?$")
_LEGACY_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def escape_label_value(v: str) -> str:
    """Escape a label value per the Prometheus text format: backslash,
    double-quote, and newline (in that order — backslash first)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape_label_value(v: str) -> str:
    """Single-pass inverse of escape_label_value: sequential .replace()
    calls would let an escaped backslash donate its second character to a
    following escape (`a\\\\nb` — literal backslash + n — must not decode
    to a newline)."""
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v
    )


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Sample value formatting: integers render bare (1 not 1.0)."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(v)


def _label_str(items: tuple[tuple[str, str], ...]) -> str:
    if not items:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in items)
    return "{" + inner + "}"


class _Family:
    """One metric family: a name, a type, and children keyed by their
    label items tuple ``((name, value), ...)``."""

    TYPE = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(kw[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values!r}"
            )
        key = tuple(zip(self.labelnames, (str(v) for v in values)))
        return self._child(key)

    def _child(self, key: tuple):
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = self._make_child()
                self._children[key] = c
            return c

    def _make_child(self):
        raise NotImplementedError

    # -- label-less convenience: the family IS its only child ---------------
    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels {self.labelnames}")
        return self._child(())

    def samples(self) -> list[tuple[str, tuple, float]]:
        """(suffix, label items, value) triples for render()."""
        out = []
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            out.extend(child.rows(key))
        return out


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        return self._value

    def rows(self, key):
        return [("", key, self._value)]


class _GaugeChild(_CounterChild):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def dec(self, value: float = 1.0) -> None:
        self.inc(-value)


class CounterFamily(_Family):
    TYPE = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, value: float = 1.0) -> None:
        self._default().inc(value)

    @property
    def value(self) -> float:
        return self._default().value


class GaugeFamily(_Family):
    TYPE = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, value: float = 1.0) -> None:
        self._default().inc(value)

    def dec(self, value: float = 1.0) -> None:
        self._default().dec(value)

    @property
    def value(self) -> float:
        return self._default().value


class _HistogramChild:
    __slots__ = ("_bounds", "_counts", "_sum", "_lock", "_ex")

    def __init__(self, bounds: tuple[float, ...], exemplars: bool = False):
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._lock = threading.Lock()
        # per-bucket latest exemplar (labels, value, unix seconds) — only
        # allocated on exemplar-enabled families (route/scan/flush latency)
        self._ex: "list | None" = [None] * (len(bounds) + 1) if exemplars \
            else None

    def time(self) -> "_Timer":
        """Context manager observing the block's wall time."""
        return _Timer(self)

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
        if self._ex is not None and _exemplar_source is not None:
            tid = _exemplar_source()
            if tid:
                # one tuple store under the GIL; rendering snapshots the
                # tuple, never the mutating list slot
                self._ex[i] = ({"trace_id": str(tid)}, value, time.time())

    def exemplars(self) -> "list":
        """Per-bucket (labels, value, ts) snapshot, index-aligned with
        the bounds (+Inf last); empty when the family is not
        exemplar-enabled."""
        return list(self._ex) if self._ex is not None else []

    @property
    def count(self) -> int:
        return sum(self._counts)

    @property
    def sum(self) -> float:
        return self._sum

    def _snapshot(self) -> tuple[list[int], float]:
        """Counts + sum under ONE lock acquisition: a render racing an
        observe must never emit `_count` != the +Inf bucket (the validator
        — and Prometheus quantile math — treat that as corruption)."""
        with self._lock:
            return list(self._counts), self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """(upper bound, cumulative count) pairs, ending at +Inf."""
        counts, _ = self._snapshot()
        out, acc = [], 0
        for b, c in zip(self._bounds, counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out

    def rows(self, key):
        counts, total_sum = self._snapshot()
        out, acc = [], 0
        for b, c in zip(self._bounds, counts):
            acc += c
            out.append(("_bucket", key + (("le", _fmt(float(b))),), float(acc)))
        total = acc + counts[-1]
        out.append(("_bucket", key + (("le", "+Inf"),), float(total)))
        out.append(("_sum", key, total_sum))
        out.append(("_count", key, float(total)))
        return out


class HistogramFamily(_Family):
    TYPE = "histogram"

    def __init__(self, name, help, labelnames, buckets, exemplars=False):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        if bounds and bounds[-1] == float("inf"):
            bounds = bounds[:-1]  # +Inf is implicit
        self.buckets = bounds
        self.exemplars_enabled = bool(exemplars)

    def _make_child(self):
        return _HistogramChild(self.buckets, exemplars=self.exemplars_enabled)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def time(self) -> "_Timer":
        """Context manager observing the block's wall time (label-less)."""
        return self._default().time()


class _Timer:
    __slots__ = ("_child", "_t0")

    def __init__(self, child: _HistogramChild):
        self._child = child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.perf_counter() - self._t0)
        return False


class Metrics:
    """Process-wide registry. Families register once (idempotent: the same
    (name, type) returns the existing family; a type conflict raises)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._start = time.time()

    # -- registration --------------------------------------------------------
    def _register(self, cls, name, help, labelnames, eager_default=True,
                  **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.TYPE}"
                    )
                return fam
            fam = cls(name, help, tuple(labelnames), **kw)
            self._families[name] = fam
        if eager_default and not fam.labelnames:
            # a label-less family has exactly one child: create it now so
            # the family renders its zero state from boot (scrapers see the
            # series exist before the first event). Legacy LABELED names
            # suppress this — their family is declared label-less but every
            # real series carries labels, and an eager () child would be a
            # phantom unlabeled 0 series on /metrics.
            fam._child(())
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> CounterFamily:
        return self._register(CounterFamily, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> GaugeFamily:
        return self._register(GaugeFamily, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  exemplars: bool = False) -> HistogramFamily:
        """`exemplars=True` stores the latest (trace_id, value, ts) per
        bucket when an exemplar source is wired (set_exemplar_source) —
        rendered only in the OpenMetrics exposition."""
        return self._register(HistogramFamily, name, help, labelnames,
                              buckets=buckets, exemplars=exemplars)

    def get(self, name: str) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    # -- legacy string API ---------------------------------------------------
    def _legacy_child(self, cls, name: str):
        m = _LEGACY_RE.match(name)
        if m is None:
            raise ValueError(f"invalid metric name: {name!r}")
        fam_name = m.group("name")
        raw = m.group("labels")
        pairs: tuple[tuple[str, str], ...] = ()
        if raw:
            pairs = tuple(
                (k, _unescape_label_value(v))
                for k, v in _LEGACY_PAIR_RE.findall(raw)
            )
        fam = self._register(cls, fam_name, "", (),
                             eager_default=not pairs)
        # legacy children bypass labelnames: key directly by the pairs, so
        # one family may hold heterogeneous label sets (table gauges do)
        return fam._child(pairs)

    def inc(self, name: str, value: float = 1.0) -> None:
        """Legacy: counter increment; `name` may embed `{k="v"}` labels."""
        self._legacy_child(CounterFamily, name).inc(value)

    def set(self, name: str, value: float) -> None:
        """Legacy: gauge set; `name` may embed `{k="v"}` labels."""
        self._legacy_child(GaugeFamily, name).set(value)

    # -- snapshots (self-scrape collector) -----------------------------------
    def snapshot_samples(self) -> list[tuple[str, str, str, tuple, float]]:
        """(family, type, sample_name, label items, value) for every
        sample the text exposition would render (histograms exploded to
        _bucket/_sum/_count, cumulative counts, `le` formatted exactly as
        render() prints it). The self-scrape collector's source of truth:
        a PromQL query over a self-written series must return values
        bit-equal to this snapshot at the scrape timestamp."""
        with self._lock:
            fams = sorted(self._families.items())
        out = []
        for name, fam in fams:
            for suffix, key, value in fam.samples():
                out.append((name, fam.TYPE, name + suffix, key,
                            float(value)))
        return out

    def federation_snapshot(self) -> list:
        """The JSON-serializable wire shape of snapshot_samples for
        `GET /api/v1/telemetry/snapshot` — what a fleet-telemetry peer
        pulls: [[sample_name, [[label, value]...], value]...]. Family
        and type drop out (the puller relabels and writes through its
        own ingest path; the text exposition keeps the typed view)."""
        return [
            [sample, [[k, v] for k, v in key], value]
            for _family, _type, sample, key, value in
            self.snapshot_samples()
        ]

    # -- rendering -----------------------------------------------------------
    def render(self) -> str:
        lines = [
            "# HELP horaedb_uptime_seconds Seconds since process start.",
            "# TYPE horaedb_uptime_seconds gauge",
            f"horaedb_uptime_seconds {time.time() - self._start:.1f}",
        ]
        with self._lock:
            fams = sorted(self._families.items())
        for name, fam in fams:
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.TYPE}")
            for suffix, key, value in fam.samples():
                lines.append(f"{name}{suffix}{_label_str(key)} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """OpenMetrics 1.0 exposition (content-negotiated on /metrics):
        counter family names drop the `_total` suffix (the sample keeps
        it), exemplar-enabled histograms append `# {trace_id="..."} v ts`
        to their bucket lines, and the body terminates with `# EOF`. A
        counter whose registered name lacks `_total` cannot be spelled as
        an OpenMetrics counter — it renders as `unknown` (tools/
        promcheck.py --openmetrics enforces the grammar)."""
        lines = [
            "# TYPE horaedb_uptime_seconds gauge",
            f"horaedb_uptime_seconds {time.time() - self._start:.1f}",
        ]
        with self._lock:
            fams = sorted(self._families.items())
        for name, fam in fams:
            if fam.TYPE == "counter":
                conformant = name.endswith("_total")
                base = name[:-len("_total")] if conformant else name
                om_type = "counter" if conformant else "unknown"
            else:
                base, om_type = name, fam.TYPE
            if fam.help:
                lines.append(f"# HELP {base} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {base} {om_type}")
            if fam.TYPE != "histogram":
                for suffix, key, value in fam.samples():
                    lines.append(
                        f"{name}{suffix}{_label_str(key)} {_fmt(value)}"
                    )
                continue
            with fam._lock:
                items = sorted(fam._children.items())
            for key, child in items:
                counts, total_sum = child._snapshot()
                exs = child.exemplars()
                bounds = list(child._bounds) + [float("inf")]
                acc = 0
                for j, b in enumerate(bounds):
                    acc += counts[j]
                    line = (
                        f"{name}_bucket"
                        f"{_label_str(key + (('le', _fmt(float(b))),))} "
                        f"{_fmt(float(acc))}"
                    )
                    ex = exs[j] if j < len(exs) else None
                    if ex is not None:
                        line += _exemplar_str(ex)
                    lines.append(line)
                lines.append(f"{name}_sum{_label_str(key)} {_fmt(total_sum)}")
                lines.append(
                    f"{name}_count{_label_str(key)} {_fmt(float(acc))}"
                )
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _exemplar_str(ex: tuple) -> str:
    """` # {trace_id="..."} value timestamp` (OpenMetrics exemplar)."""
    labels, value, ts = ex
    items = tuple((str(k), str(v)) for k, v in labels.items())
    return f" # {_label_str(items)} {_fmt(float(value))} {ts:.3f}"


GLOBAL_METRICS = Metrics()
