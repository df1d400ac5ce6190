"""The port's PromQL (horaedb_tpu_torch/promql) against the JAX package's,
on the CPU.

The seeded remote-write payloads of tests/test_torch_engine.py (TSBS host
tags, three metrics, non-dyadic values, a few NaN) go into the JAX
`MetricEngine` (HORAEDB_SERVING=off, enable_compaction=False) and the
port's (`device="cpu"`), once for the module. Checked:
- `parse` against the JAX `parse` on the reference's parser cases and
  more, rejects included (the same AST, the same refusals);
- `evaluate_range` answers for the grid pushdown, the raw path,
  `by`/`without`, scalar arithmetic, comparisons and set operators,
  `topk`/`bottomk`, `offset` and `last_over_time` (window == step and a
  wider window, both the raw path's window walk): the same label
  sets in the same order, counts exact, every other value within rtol
  1e-12 (NaN where the reference has NaN);
- the `to_prometheus_matrix` / `to_prometheus_vector` bodies, numbers
  within the same rtol;
- the engine's `label_names`, `series`, `series_labels_map` and
  `match_series` equal to the reference's.
The port's calibration cache lives under a temp path.
"""

import asyncio
import os

import numpy as np
import pytest

from horaedb_tpu.objstore import MemStore as JaxMemStore
from horaedb_tpu.ops import agg_registry as JR
from horaedb_tpu.promql import PromQLError as JaxPromQLError
from horaedb_tpu.promql import parse as jax_parse
from horaedb_tpu.promql import parse_duration_ms as jax_parse_duration_ms
from horaedb_tpu.promql import eval as jax_eval
from horaedb_tpu_torch.objstore import MemStore
from horaedb_tpu_torch.ops import agg_registry as R
from horaedb_tpu_torch.promql import PromQLError, parse, parse_duration_ms
from horaedb_tpu_torch.promql import eval as port_eval
from tests.test_torch_engine import BASE, fill, jax_open, make_payloads, port_open

START, END, STEP = BASE + 60_000, BASE + 360_000, 60_000
RTOL = 1e-12
ENV = {"HORAEDB_SERVING": "off", "HORAEDB_BATCH": "off"}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    env = dict(ENV, HORAEDB_AGG_CACHE=str(tmp_path_factory.mktemp("agg") / "calib.json"))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    R.reset_cache(memory_only=True)
    JR.reset_cache(memory_only=True)
    loop = asyncio.new_event_loop()
    payloads = make_payloads()
    jax_eng = loop.run_until_complete(jax_open(JaxMemStore()))
    port_eng = loop.run_until_complete(port_open(MemStore()))
    loop.run_until_complete(fill(jax_eng, payloads))
    loop.run_until_complete(fill(port_eng, payloads))
    yield loop, jax_eng, port_eng
    loop.run_until_complete(jax_eng.close())
    loop.run_until_complete(port_eng.close())
    pending = asyncio.all_tasks(loop)  # the JAX engine's background tasks
    for task in pending:
        task.cancel()
    loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
    loop.close()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    R.reset_cache(memory_only=True)
    JR.reset_cache(memory_only=True)


# -- the parser -------------------------------------------------------------------

PARSE_CASES = [
    "http_requests",
    'cpu{host="web-1", region=~"us-.*", dc!="x"}[5m]',
    'sum by (host) (rate(reqs{a="b"}[1m]))',
    "avg(mem) by (dc)",
    "sum without (host) (mem)",
    "2 + 3 * m",
    "-m",
    "m[90s]",
    "m[2h] offset 5m",
    "topk(3, rate(reqs[1m]))",
    "bottomk(2, m)",
    "a > 2 and b < 3 or c unless d",
    'histogram_quantile(0.9, sum by (le) (rate(h_bucket[5m])))',
    'label_replace(m, "dst", "$1", "src", "(.*)-x")',
    "clamp_min(m, -1.5)",
    "round(abs(m))",
    'm{host="caf\\u00e9", q=\'a\\\'b\'}',
    "rate",
    "sum(1)",
]
PARSE_REJECTS = ["rate(m)", "m{host=web}", "m[5x]", "rate(sum(m[5m]))", "m)", '{a="b"}',
                 "topk(1.5, m)", "m{", "clamp_max(m, x)", "m # x"]


@pytest.mark.parametrize("src", PARSE_CASES)
def test_parse_matches_the_reference(src):
    assert repr(parse(src)) == repr(jax_parse(src))


@pytest.mark.parametrize("src", PARSE_REJECTS)
def test_parse_rejects_what_the_reference_rejects(src):
    with pytest.raises(JaxPromQLError):
        jax_parse(src)
    with pytest.raises(PromQLError):
        parse(src)


def test_expression_walkers_and_durations_match():
    node_src = 'rate(a[10m] offset 1h) / sum(b) + c{x="y"}'
    port, ref = parse(node_src), jax_parse(node_src)
    assert port_eval.selector_metrics(port) == jax_eval.selector_metrics(ref)
    assert port_eval.max_selector_window_ms(port) == jax_eval.max_selector_window_ms(ref)
    assert [type(n).__name__ for n in port_eval.walk_expr(port)] == \
        [type(n).__name__ for n in jax_eval.walk_expr(ref)]
    for d in ("250ms", "15s", "5m", "1.5h", "30"):
        assert parse_duration_ms(d) == jax_parse_duration_ms(d)


# -- range evaluation ----------------------------------------------------------------

EXACT = "exact"  # counts: equal, not within rtol
QUERIES = [
    ("avg_over_time(cpu_usage_user[1m])", None),
    ("sum_over_time(cpu_usage_user[1m])", None),
    ("count_over_time(cpu_usage_system[1m])", EXACT),
    ("min_over_time(cpu_usage_user[1m])", None),
    ("max by (region) (max_over_time(cpu_usage_system[1m]))", None),
    ("sum without (hostname, rack, service, team, service_version) "
     "(avg_over_time(cpu_usage_user[1m]))", None),
    ("avg by (rack) (cpu_usage_idle)", None),
    ("rate(cpu_usage_user[2m])", None),
    ("last_over_time(cpu_usage_user[1m])", None),
    ("last_over_time(cpu_usage_user[2m])", None),
    ("cpu_usage_user * 2 - 1", None),
    ("-avg_over_time(cpu_usage_user[1m]) / 4", None),
    ("cpu_usage_user > 90", None),
    ("avg_over_time(cpu_usage_user[1m]) <= 40 and avg_over_time(cpu_usage_system[1m]) > 10",
     None),
    ("topk(3, avg_over_time(cpu_usage_user[1m]))", None),
    ("bottomk(2, cpu_usage_system)", None),
    ("avg_over_time(cpu_usage_user[1m] offset 1m)", None),
    ("last_over_time(cpu_usage_user[1m] offset 30s)", None),
    ('max_over_time(cpu_usage_user{hostname=~"host_(1|2|3|4|5|6|7|8)"}[1m])', None),
    ('sum_over_time(cpu_usage_user{rack="3", team!="SF"}[1m])', None),
    ("count(cpu_usage_user)", EXACT),
    ("no_such_metric", None),
    ("2 * 3", None),
]


def evaluate(engines, src, start=START, end=END, step=STEP):
    loop, jax_eng, port_eng = engines
    want = loop.run_until_complete(jax_eval.evaluate_range(jax_eng, src, start, end, step))
    got = loop.run_until_complete(port_eval.evaluate_range(port_eng, src, start, end, step))
    return got, want


def same_answer(got, want, exact: bool, ctx: str) -> None:
    np.testing.assert_array_equal(got[0], want[0])
    g, w = got[1], want[1]
    if isinstance(w, float):
        assert isinstance(g, float) and g == w, ctx
        return
    assert [sv.labels for sv in g] == [sv.labels for sv in w], ctx
    for a, b in zip(g, w):
        if exact:
            np.testing.assert_array_equal(a.values, b.values, err_msg=ctx)
        else:
            np.testing.assert_allclose(a.values, b.values, rtol=RTOL, atol=0, equal_nan=True,
                                       err_msg=ctx)


@pytest.mark.parametrize("src,mode", QUERIES, ids=[q for q, _ in QUERIES])
def test_range_answers_match_the_reference(engines, src, mode):
    got, want = evaluate(engines, src)
    same_answer(got, want, mode == EXACT, src)
    if src.startswith(("avg_over_time", "count_over_time", "max by", "topk", "last_over")):
        assert not isinstance(want[1], float) and want[1], f"{src}: empty answer tests nothing"


def test_grid_pushdown_notes_the_dispatcher(engines):
    """The pushdown went through the calibrated dispatcher (a CPU
    calibration under the temp cache) and attributes its choice."""
    from horaedb_tpu_torch.storage import scanstats

    loop, _jax_eng, port_eng = engines
    with scanstats.scan_stats() as st:
        loop.run_until_complete(port_eval.evaluate_range(
            port_eng, "avg_over_time(cpu_usage_user[1m])", START, END, STEP))
    notes = [k for k in st.counts if k.startswith("agg_impl_")]
    assert st.counts.get("promql_pushdowns") == 1 and notes
    assert notes[0][len("agg_impl_"):] in R.SORTED_IMPLS
    assert os.path.exists(R.cache_path())


def _close_body(got, want, ctx):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), ctx
        for k in want:
            _close_body(got[k], want[k], ctx)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), ctx
        for a, b in zip(got, want):
            _close_body(a, b, ctx)
    elif isinstance(want, str) and want not in ("NaN", "+Inf", "-Inf", "matrix", "vector",
                                                "scalar"):
        try:
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=0, err_msg=ctx)
        except ValueError:
            assert got == want, ctx
    else:
        assert got == want, ctx


@pytest.mark.parametrize("src", ["avg_over_time(cpu_usage_user[1m])", "cpu_usage_user > 90",
                                 "sum(cpu_usage_idle) / 7", "5"])
def test_prometheus_bodies_match(engines, src):
    got, want = evaluate(engines, src)
    _close_body(port_eval.to_prometheus_matrix(got[1], got[0]),
                jax_eval.to_prometheus_matrix(want[1], want[0]), src)
    _close_body(port_eval.to_prometheus_vector(got[1], int(got[0][-1])),
                jax_eval.to_prometheus_vector(want[1], int(want[0][-1])), src)


@pytest.mark.parametrize("src", ["rate(cpu_usage_user[5m])", "cpu_usage_user[1m]",
                                 "sum(2)", "1 > 2", "cpu_usage_user and 3"])
def test_evaluation_errors_match(engines, src):
    with pytest.raises(JaxPromQLError):
        evaluate_one(engines, src, jax=True)
    with pytest.raises(PromQLError):
        evaluate_one(engines, src, jax=False)


def evaluate_one(engines, src, jax: bool):
    loop, jax_eng, port_eng = engines
    mod, eng = (jax_eval, jax_eng) if jax else (port_eval, port_eng)
    # 300 s at a 27 ms step is 11,112 steps, over the resolution limit
    step = 27 if src.startswith("rate") else STEP
    return loop.run_until_complete(mod.evaluate_range(eng, src, START, END, step))


# -- the engine's discovery surface ---------------------------------------------------

def test_discovery_surface_matches_the_reference(engines):
    loop, jax_eng, port_eng = engines
    assert port_eng.label_names() == jax_eng.label_names()
    for metric in (b"cpu_usage_user", b"cpu_usage_idle", b"nope"):
        assert port_eng.series(metric) == jax_eng.series(metric)
        full = port_eng.series_labels_map(metric)
        assert full == jax_eng.series_labels_map(metric)
        some = sorted(full)[::3] + [12345]
        assert port_eng.series_labels_map(metric, some) == \
            jax_eng.series_labels_map(metric, some)
    for filters, matchers in (([(b"rack", b"3")], []),
                              ([], [(b"hostname", "re", b"host_1[0-9]")]),
                              ([(b"team", b"SF")], [(b"region", "nre", b"us-.*")]),
                              ([(b"rack", b"nope")], [])):
        got = loop.run_until_complete(port_eng.match_series(b"cpu_usage_user", filters,
                                                            matchers))
        want = loop.run_until_complete(jax_eng.match_series(b"cpu_usage_user", filters,
                                                            matchers))
        assert got == want
