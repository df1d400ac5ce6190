"""Self-calibrating aggregation kernel registry: the calibrated dispatcher
in front of the sorted (and unsorted) segment reductions.

A port of the JAX package's `ops/agg_registry.py`. Every interchangeable
(sum, count) strategy registers here under the JAX package's name, with its
capability envelope; `choose_sorted`/`choose_unsorted` pick one by a
micro-A/B run once per (platform, density class), persisted in a JSON file,
and the choice is exported as `horaedb_agg_impl_total{impl=...}`. Pins:
`HORAEDB_AGG_IMPL` > `HORAEDB_SORTED_IMPL` > the cache for sorted input,
`HORAEDB_UNSORTED_IMPL` > the cache for unsorted input.

What each name runs in the port is `ops/blockagg.py`'s concern: kernel B
under every block variant and both scatters, kernel B with bf16 rounding
for `block_bf16`, kernel `lane_sum_count` for `lanes`; the host lanes
(`reduceat`, `bincount`) live here and run on the CPU only: calibration
never times them on the card, and a pin naming one is refused there
(`check_host_lane`), so no work leaves the card. Platforms are the torch
device types, `cuda` and `cpu`, as in `ops/decode.py`.

Two changes from the JAX package: `_time_impl` synchronises the card, so
calibration times the work and not its launches; and a device
implementation that raises during calibration is recorded under
`rejected` as before, which `chip_smoke.py` treats as a failure (a kernel
that does not build or launch is never hidden by a forfeit). The
calibration file is the port's own (`torch_agg_calib.json` under the
configured directory or the temp dir, or `HORAEDB_AGG_CACHE`), with its
own version stamp, so a file shared through the env var is never read as
the JAX package's.

The host lanes are the one place on the aggregate path that calls
`np.add.reduceat`/`np.minimum.reduceat`.
"""

from __future__ import annotations

import contextvars
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device, to_device
from horaedb_tpu_torch.common.calib_cache import CalibCache
from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.server.metrics import GLOBAL_METRICS

AGG_IMPL_TOTAL = GLOBAL_METRICS.counter(
    "horaedb_agg_impl_total",
    help="Aggregation kernel the calibrated dispatcher selected, per dispatch.",
    labelnames=("impl",),
)
# pre-register the universal fallback so the family renders from boot
AGG_IMPL_TOTAL.labels("scatter")

# bf16 value-lane error budget per grid cell, vs the f64 oracle:
# |err| <= BF16_L1_BUDGET * sum(|v|) + BF16_ATOL. Inputs round to bf16
# (rel ~2^-9 each), so the cell-sum error is bounded by the cell's L1 mass.
# The calibrator holds every lane to it before letting one win.
BF16_L1_BUDGET = 2.0 ** -7
BF16_ATOL = 1e-3

CALIB_VERSION = "torch-2"


@dataclass(frozen=True)
class AggImpl:
    """One registered (sum, count) strategy. `platforms`: the device types
    the impl is measured on (() = all)."""

    name: str
    kind: str  # "device" | "host"
    platforms: tuple[str, ...]
    description: str


SORTED_IMPLS: dict[str, AggImpl] = {
    impl.name: impl
    for impl in (
        AggImpl("scatter", "device", (), "kernel B (the JAX package's two scatters)"),
        AggImpl("scatter_fused", "device", (),
                "kernel B (the JAX package's stacked sorted scatter)"),
        AggImpl("block", "device", (), "kernel B, the segmented reduction"),
        AggImpl("block_wide", "device", (), "kernel B (TPU block=2048 ranks=256)"),
        AggImpl("block_r32", "device", (), "kernel B (TPU ranks=32)"),
        AggImpl("block_bf16", "device", (),
                "kernel B with values rounded to bf16 on load; gated by the f64-oracle "
                "error budget"),
        AggImpl("block_scan", "device", (), "kernel B (TPU scan prologue)"),
        AggImpl("lanes", "device", (),
                "kernel lane_sum_count: warp-grouped f32 atomics into the grids (the plain "
                "version: eight lane grids)"),
        AggImpl("reduceat", "host", ("cpu",),
                "host run-boundary lane: np.add.reduceat over searchsorted/diff "
                "boundaries"),
    )
}

UNSORTED_IMPLS: dict[str, AggImpl] = {
    impl.name: impl
    for impl in (
        AggImpl("scatter", "device", (), "kernel grouped_stats"),
        AggImpl("sort", "device", (), "kernel sort_perm, then kernel B"),
        AggImpl("bincount", "host", ("cpu",),
                "host np.bincount pair (hash-style grouping)"),
    )
}


def sorted_impl_names(platform: str | None = None) -> list[str]:
    """Registered sorted-lane names eligible on `platform` (None = all)."""
    return [i.name for i in SORTED_IMPLS.values()
            if not i.platforms or platform is None or platform in i.platforms]


def unsorted_impl_names(platform: str | None = None) -> list[str]:
    return [i.name for i in UNSORTED_IMPLS.values()
            if not i.platforms or platform is None or platform in i.platforms]


def is_host_impl(name: str) -> bool:
    impl = SORTED_IMPLS.get(name) or UNSORTED_IMPLS.get(name)
    return impl is not None and impl.kind == "host"


def check_host_lane(name: str, device) -> None:
    """Refuse host lane `name` for data on a device other than the CPU: a
    host lane would copy the rows off the card and the results back."""
    dev = torch.device(device)
    ensure(not is_host_impl(name) or dev.type == "cpu",
           f"agg impl {name!r} is a host lane and runs on CPU tensors only; the data is on "
           f"{dev} (pin a device impl)")


# ---------------------------------------------------------------------------
# host lanes (a copy of the JAX package's)
# ---------------------------------------------------------------------------


def _acc_dtype(v: np.ndarray) -> np.dtype:
    """Accumulation dtype: floats keep their width, integers widen to
    64-bit exact accumulation."""
    if np.issubdtype(v.dtype, np.floating):
        return v.dtype
    if np.issubdtype(v.dtype, np.unsignedinteger):
        return np.dtype(np.uint64)
    return np.dtype(np.int64)


def _run_starts(k: np.ndarray) -> np.ndarray:
    b = np.flatnonzero(k[1:] != k[:-1])
    starts = np.empty(len(b) + 1, np.int64)
    starts[0] = 0
    starts[1:] = b + 1
    return starts


def host_reduceat_sum_count(k_sorted, v, num_cells: int, weights=None):
    """(sum, count) per cell over SORTED host arrays via run-boundary
    `np.add.reduceat`. Invalid rows either carry sentinel ids >= num_cells
    (dropped by the cell filter) or ride `weights` with values pre-masked
    to 0."""
    k = np.asarray(k_sorted)
    v = np.asarray(v)
    acc = _acc_dtype(v)
    gs = np.zeros(num_cells, acc)
    gc = np.zeros(num_cells, acc)
    n = k.shape[0]
    if n == 0:
        return gs, gc
    starts = _run_starts(k)
    sums = np.add.reduceat(v.astype(acc, copy=False), starts)
    if weights is None:
        ends = np.empty(len(starts), np.int64)
        ends[:-1] = starts[1:]
        ends[-1] = n
        cnts = (ends - starts).astype(acc)
    else:
        cnts = np.add.reduceat(np.asarray(weights).astype(acc, copy=False), starts)
    cells = k[starts]
    ok = (cells >= 0) & (cells < num_cells)
    cok, sok, nok = cells[ok], sums[ok], cnts[ok]
    if len(cok) and not np.all(cok[1:] >= cok[:-1]):
        # non-monotone key stream: a cell can span several runs, so
        # accumulate (plain assignment would keep only the last run)
        np.add.at(gs, cok, sok)
        np.add.at(gc, cok, nok)
    else:
        gs[cok] = sok
        gc[cok] = nok
    return gs, gc


def host_reduceat_min_max(k_sorted, v, num_cells: int, valid=None):
    """(min, max) per cell over SORTED host arrays via
    np.minimum/np.maximum.reduceat; +/-inf fills mark empty cells."""
    k = np.asarray(k_sorted)
    v = np.asarray(v)
    vd = v.dtype if np.issubdtype(v.dtype, np.floating) else np.dtype(np.float64)
    gmn = np.full(num_cells, np.inf, vd)
    gmx = np.full(num_cells, -np.inf, vd)
    n = k.shape[0]
    if n == 0:
        return gmn, gmx
    if valid is not None:
        valid = np.asarray(valid)
        v_lo = np.where(valid, v, vd.type(np.inf))
        v_hi = np.where(valid, v, vd.type(-np.inf))
    else:
        v_lo = v_hi = v.astype(vd, copy=False)
    starts = _run_starts(k)
    mns = np.minimum.reduceat(v_lo, starts)
    mxs = np.maximum.reduceat(v_hi, starts)
    cells = k[starts]
    ok = (cells >= 0) & (cells < num_cells)
    cok = cells[ok]
    if len(cok) and not np.all(cok[1:] >= cok[:-1]):
        np.minimum.at(gmn, cok, mns[ok])
        np.maximum.at(gmx, cok, mxs[ok])
    else:
        gmn[cok] = mns[ok]
        gmx[cok] = mxs[ok]
    return gmn, gmx


def host_bincount_sum_count(k, v, num_cells: int, weights=None):
    """(sum, count) per cell for UNSORTED host arrays via np.bincount.
    Sentinel ids >= num_cells drop via the minlength+slice trick."""
    k = np.asarray(k)
    v = np.asarray(v)
    acc = _acc_dtype(v)
    if k.shape[0] == 0:
        return np.zeros(num_cells, acc), np.zeros(num_cells, acc)
    kc = np.clip(k, 0, num_cells).astype(np.int64, copy=False)
    gs = np.bincount(kc, weights=v, minlength=num_cells + 1)[:-1]
    if weights is None:
        gc = np.bincount(kc, minlength=num_cells + 1)[:-1].astype(acc)
    else:
        gc = np.bincount(kc, weights=np.asarray(weights), minlength=num_cells + 1)[:-1]
    # bincount with weights accumulates f64; fold back to the contract dtype
    return gs.astype(acc, copy=False), gc.astype(acc, copy=False)


# host sum/count lanes by registered name: a new host impl must register
# here too, or its callers fail with a KeyError
HOST_SORTED_FNS = {"reduceat": host_reduceat_sum_count}
HOST_UNSORTED_FNS = {"bincount": host_bincount_sum_count}


def _host_cells(ts, series_idx, values, t0, bucket_ms, num_series, num_buckets, valid):
    ts = np.asarray(ts)
    sid = np.asarray(series_idx)
    v = np.asarray(values)
    bucket = ((ts.astype(np.int64) - int(t0)) // int(bucket_ms)).astype(np.int64)
    ok = (bucket >= 0) & (bucket < num_buckets) & (sid >= 0) & (sid < num_series)
    if valid is not None:
        ok = ok & np.asarray(valid)
    safe = (np.clip(sid.astype(np.int64), 0, num_series - 1) * num_buckets
            + np.clip(bucket, 0, num_buckets - 1))
    return v, ok, safe


def host_downsample_sorted(ts, series_idx, values, t0, bucket_ms, num_series: int,
                           num_buckets: int, with_minmax: bool = True, valid=None,
                           impl: str = "reduceat") -> dict:
    """Full host-lane downsample over rows SORTED by (series, ts): the numpy
    mirror of aggregate.downsample_sorted when the dispatcher picks a host
    lane. Accumulates in the value dtype. `impl` names the registered host
    sum/count lane (KeyError on an unregistered name)."""
    v, ok, safe = _host_cells(ts, series_idx, values, t0, bucket_ms, num_series,
                              num_buckets, valid)
    num_cells = num_series * num_buckets
    all_ok = bool(ok.all())
    acc = _acc_dtype(v)
    vm = v.astype(acc, copy=False) if all_ok else \
        np.where(ok, v, v.dtype.type(0)).astype(acc, copy=False)
    s, c = HOST_SORTED_FNS[impl](safe, vm, num_cells,
                                 weights=None if all_ok else ok.astype(acc))
    shape = (num_series, num_buckets)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = {"sum": s.reshape(shape), "count": c.reshape(shape),
               "mean": (s / c).reshape(shape)}
    if with_minmax:
        mn, mx = host_reduceat_min_max(safe, v, num_cells, valid=None if all_ok else ok)
        out["min"] = mn.reshape(shape)
        out["max"] = mx.reshape(shape)
    return out


def host_downsample_unsorted(ts, series_idx, values, t0, bucket_ms, num_series: int,
                             num_buckets: int, with_minmax: bool = True, valid=None,
                             impl: str = "bincount") -> dict:
    """Host-lane downsample for UNSORTED rows; `impl` names the registered
    host unsorted sum/count lane. min/max use np.minimum.at /
    np.maximum.at."""
    v, ok, safe = _host_cells(ts, series_idx, values, t0, bucket_ms, num_series,
                              num_buckets, valid)
    num_cells = num_series * num_buckets
    acc = _acc_dtype(v)
    all_ok = bool(ok.all())
    vm = v.astype(acc, copy=False) if all_ok else \
        np.where(ok, v, v.dtype.type(0)).astype(acc, copy=False)
    s, c = HOST_UNSORTED_FNS[impl](safe, vm, num_cells,
                                   weights=None if all_ok else ok.astype(acc))
    shape = (num_series, num_buckets)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = {"sum": s.reshape(shape), "count": c.reshape(shape),
               "mean": (s / c).reshape(shape)}
    if with_minmax:
        vd = v.dtype if np.issubdtype(v.dtype, np.floating) else np.dtype(np.float64)
        mn = np.full(num_cells, np.inf, vd)
        mx = np.full(num_cells, -np.inf, vd)
        kk = safe[ok]
        np.minimum.at(mn, kk, v[ok])
        np.maximum.at(mx, kk, v[ok])
        out["min"] = mn.reshape(shape)
        out["max"] = mx.reshape(shape)
    return out


# ---------------------------------------------------------------------------
# execution shims (the calibrator's and the sweep's entry points; production
# callers go through blockagg's dispatch)
# ---------------------------------------------------------------------------


def run_sorted(name: str, k, v, num_cells: int, weights=None):
    """Execute one registered sorted impl on tensors `k` (int32, sorted)
    and `v` (f32 or f64)."""
    ensure(name in SORTED_IMPLS, f"unknown sorted agg impl {name!r}")
    from horaedb_tpu_torch.ops.blockagg import sorted_segment_sum_count

    return sorted_segment_sum_count(k, v, num_cells, impl=name, weights=weights)


def run_unsorted(name: str, k, v, num_cells: int, weights=None):
    ensure(name in UNSORTED_IMPLS, f"unknown unsorted agg impl {name!r}")
    from horaedb_tpu_torch.ops.blockagg import segment_sum_count

    return segment_sum_count(k, v, num_cells, impl=name, weights=weights)


# ---------------------------------------------------------------------------
# calibration cache
# ---------------------------------------------------------------------------

# density regimes calibrate separately: one winner does not serve both
DENSE_ROWS_PER_CELL = 8

# last dispatcher decision, context-local first (exact for code that
# dispatches and attributes in the same coroutine/thread: read.py's scanstats
# note), process-global for observers in other contexts (promql's span attr)
_last_choice_ctx: "contextvars.ContextVar[str | None]" = \
    contextvars.ContextVar("horaedb_agg_last_choice", default=None)
_last_choice_global: str = "scatter"

_calib_cache = CalibCache(
    env_var="HORAEDB_AGG_CACHE",
    filename="torch_agg_calib.json",
    version=CALIB_VERSION,
    tmp_prefix=".torch_agg_calib.",
    inventory=lambda: {
        "sorted_impls": sorted(SORTED_IMPLS),
        "unsorted_impls": sorted(UNSORTED_IMPLS),
    },
)


def configure_cache_dir(path: str) -> None:
    """Point the calibration cache under a data root; HORAEDB_AGG_CACHE
    overrides with a full file path."""
    _calib_cache.configure_dir(path)


def cache_path() -> str:
    return _calib_cache.path()


def reset_cache(memory_only: bool = False) -> None:
    """Drop the in-memory view (tests); optionally leave the file."""
    _calib_cache.reset(memory_only)


def density_class(n: int, num_cells: int) -> str:
    return "dense" if n >= DENSE_ROWS_PER_CELL * max(1, num_cells) else "sparse"


def _calib_shape(klass: str) -> tuple[int, int]:
    """Micro-A/B problem size (HORAEDB_AGG_CALIB_N rows, 2^18 by default):
    large enough that per-launch overhead does not decide the winner."""
    try:
        n = int(os.environ.get("HORAEDB_AGG_CALIB_N", str(1 << 18)))
    except ValueError:
        n = 1 << 18
    cells = max(1, n // 16) if klass == "dense" else 2 * n
    return n, cells


def calib_inputs(klass: str, kind: str = "sorted"):
    """The synthetic stream calibration measures on: (k int32, v f32,
    num_cells) as numpy, sorted ids for `sorted`, shuffled for `unsorted`."""
    n, cells = _calib_shape(klass)
    rng = np.random.default_rng(0xA66)
    k = np.sort(rng.integers(0, cells, n)).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    if kind == "unsorted":
        k = rng.permutation(k).astype(np.int32)
    return k, v, cells


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_impl(fn, device: torch.device, iters: int = 2) -> float:
    """Seconds per pass; the card is synchronised before and after the
    timed passes, so the time covers the work and not only its launches."""
    fn()  # warm: the first call builds and loads the kernel
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def _bf16_within_budget(s, oracle_sum, l1) -> bool:
    err = np.abs(s.cpu().numpy().astype(np.float64) - oracle_sum)
    return bool(np.all(err <= BF16_L1_BUDGET * l1 + BF16_ATOL))


def _calibrate(kind: str, device: torch.device, klass: str) -> dict:
    """Measure every eligible impl on a synthetic stream of the density
    class on `device` and return {impl, device_impl, ab, rejected, ...}."""
    k, v, cells = calib_inputs(klass, kind)
    n = len(k)
    if kind == "unsorted":
        names = unsorted_impl_names(device.type)
        runner, impls = run_unsorted, UNSORTED_IMPLS
    else:
        names = sorted_impl_names(device.type)
        runner, impls = run_sorted, SORTED_IMPLS
    kt, vt = to_device(k, device), to_device(v, device)
    oracle_sum = np.bincount(k, weights=v.astype(np.float64), minlength=cells)
    l1 = np.bincount(k, weights=np.abs(v.astype(np.float64)), minlength=cells)
    ab: dict[str, float] = {}
    rejected: dict[str, str] = {}
    for name in names:
        try:
            s, _c = runner(name, kt, vt, cells)
            if not _bf16_within_budget(s, oracle_sum, l1):
                rejected[name] = "exceeds f64-oracle error budget"
                continue
            secs = _time_impl(lambda name=name: runner(name, kt, vt, cells), device)
            ab[name] = round(n / max(secs, 1e-9))
        except Exception as e:  # noqa: BLE001 - recorded; chip_smoke fails on a device one
            rejected[name] = f"{type(e).__name__}: {e}"[:200]
    if not ab:
        ab = {"scatter": 0.0}
    best = max(ab, key=ab.get)
    device_ab = {x: r for x, r in ab.items() if impls[x].kind == "device"}
    return {
        "impl": best,
        "device_impl": max(device_ab, key=device_ab.get) if device_ab else "scatter",
        "ab": ab,
        "rejected": rejected,
        "n": n,
        "num_cells": cells,
        "calibrated_unix": int(time.time()),
    }


def calibration_entry(kind: str, n: int, num_cells: int,
                      device=DEFAULT_DEVICE) -> tuple[dict, str]:
    """(entry, source) for the (platform, kind, density) regime of `device`
    (cuda or cpu); source is 'cache' (warm) or 'calibrated' (cold
    micro-A/B just ran)."""
    dev = resolve_device(device)
    klass = density_class(n, num_cells)
    key = f"{dev.type}/{kind}/{klass}"
    entry = (_calib_cache.load().get("entries") or {}).get(key)
    if entry is not None:
        return entry, "cache"
    entry = _calibrate(kind, dev, klass)
    _calib_cache.store_entry(key, entry)
    return entry, "calibrated"


def _record(name: str) -> str:
    global _last_choice_global
    _last_choice_ctx.set(name)
    _last_choice_global = name
    AGG_IMPL_TOTAL.labels(name).inc()
    return name


def choose_sorted(n: int, num_cells: int, *, device=DEFAULT_DEVICE) -> str:
    """Resolve the sorted-lane impl: HORAEDB_AGG_IMPL pin > HORAEDB_SORTED_IMPL
    pin > calibration cache (micro-A/B on first use)."""
    pinned = os.environ.get("HORAEDB_AGG_IMPL")
    if pinned:
        ensure(pinned in SORTED_IMPLS,
               f"HORAEDB_AGG_IMPL={pinned!r} is not one of {sorted(SORTED_IMPLS)}")
        check_host_lane(pinned, device)
        return _record(pinned)
    legacy = os.environ.get("HORAEDB_SORTED_IMPL", "auto")
    if legacy != "auto" and legacy in SORTED_IMPLS:
        check_host_lane(legacy, device)
        return _record(legacy)
    entry, _source = calibration_entry("sorted", n, num_cells, device=device)
    return _record(entry["impl"])


def choose_unsorted(n: int, num_cells: int, *, device=DEFAULT_DEVICE) -> str:
    pinned = os.environ.get("HORAEDB_UNSORTED_IMPL", "auto")
    if pinned != "auto" and pinned in UNSORTED_IMPLS:
        check_host_lane(pinned, device)
        return _record(pinned)
    entry, _source = calibration_entry("unsorted", n, num_cells, device=device)
    return _record(entry["impl"])


def last_choice() -> str:
    """Most recent dispatcher decision: exact when the dispatch happened in
    the current context, else the process-global last decision."""
    ctx = _last_choice_ctx.get()
    return ctx if ctx is not None else _last_choice_global


# ---------------------------------------------------------------------------
# CLI sweep
# ---------------------------------------------------------------------------


def _sweep(n: int, device=DEFAULT_DEVICE) -> dict:
    """Measure every registered impl eligible on `device` at a dense sorted
    shape of n rows (and its shuffle) and return a JSON-able report."""
    dev = resolve_device(device)
    cells = max(1, n // 22)  # about TSBS's density
    rng = np.random.default_rng(7)
    k = np.sort(rng.integers(0, cells, n)).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    report: dict = {"metric": "agg_registry_sweep", "platform": dev.type, "n_rows": n,
                    "num_cells": cells, "sorted_ab": {}, "unsorted_ab": {}}
    kt, vt = to_device(k, dev), to_device(v, dev)
    for name in sorted_impl_names(dev.type):
        try:
            secs = _time_impl(lambda name=name: run_sorted(name, kt, vt, cells), dev)
            report["sorted_ab"][name] = round(n / max(secs, 1e-9))
        except Exception as e:  # noqa: BLE001 - report, keep sweeping
            report["sorted_ab"][name] = f"error: {e}"[:120]
    ku = to_device(rng.permutation(k).astype(np.int32), dev)
    for name in unsorted_impl_names(dev.type):
        try:
            secs = _time_impl(lambda name=name: run_unsorted(name, ku, vt, cells), dev)
            report["unsorted_ab"][name] = round(n / max(secs, 1e-9))
        except Exception as e:  # noqa: BLE001
            report["unsorted_ab"][name] = f"error: {e}"[:120]
    return report


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", type=int, nargs="?", const=1 << 22, metavar="N_ROWS",
                    help="measure every registered impl at N_ROWS and print one JSON line")
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.sweep:
        print(json.dumps(_sweep(args.sweep, args.device)))
        return
    ap.print_help()


if __name__ == "__main__":
    main()
