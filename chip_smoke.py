#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (horaedb_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
1. print the card's name and power limit, build the kernels from
   horaedb_tpu_torch/ops/csrc (one nvcc per source, in parallel);
2. hold each kernel (sort_perm, block_sum_count, block_min_max) against its
   plain PyTorch version on the card, on edge cases and at the main path's
   shapes, and time kernel, plain version and one PyTorch library call;
3. the main path at TSBS cpu-only scale (10,000 series, one field, 10 s
   interval, 4 h = two 2 h segments = 14.4M samples): shuffled writes plus a
   5 % re-send through ObjectBasedStorage.write, then the 5-minute
   downsample query over all series and over a 1,000-series subset, held
   against a numpy oracle (last write wins, then bincount) and run twice
   for bitwise-identical grids; every kernel must have launched; one more
   query runs under torch.profiler and cProfile for where its time goes.
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12     # H100 SXM FP64 outside the tensor cores (data sheet)

NUM_SERIES = 10_000
INTERVAL_MS = 10_000
SEGMENT_MS = 2 * 3600 * 1000
WINDOW_MS = 2 * SEGMENT_MS
BUCKET_MS = 5 * 60 * 1000
BATCHES_PER_SEGMENT = 24
RESEND_FRACTION = 0.05
SUBSET = 1_000
METRIC_ID = 1
T0 = 1_700_000_000_000 - 1_700_000_000_000 % SEGMENT_MS
SCHEMA = [("metric_id", np.uint64), ("tsid", np.uint64), ("field_id", np.uint64),
          ("ts", np.int64), ("value", np.float64)]


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def same_values(torch, a, b) -> bool:
    """Equal by value, NaN == NaN."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def abs_err(torch, a, b) -> float:
    """Largest |a - b| over cells that differ by value (inf == inf, NaN == NaN)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = torch.where(same, 0.0, (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def close_sums(torch, a, b, rtol: float = 1e-12) -> bool:
    """f64 sums within rtol (the additions run in another order); inf and
    NaN must sit in the same cells."""
    try:
        torch.testing.assert_close(a, b, rtol=rtol, atol=0.0, equal_nan=True)
    except AssertionError:
        return False
    return True


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels against their plain versions ---------------------------

def sort_cases(rng):
    """(name, list of host key lanes, most significant first)."""
    u64max = np.iinfo(np.uint64).max
    big = rng.integers(2**63, 2**64 - 1, 5000, dtype=np.uint64, endpoint=True)
    edges = np.array([u64max, 0, u64max], dtype=np.uint64)
    yield "u64 >= 2^63 with sentinel", [np.concatenate([big, edges])]
    yield "negative i64", [rng.integers(-(2**62), 2**40, 7001).astype(np.int64)]
    i64 = np.iinfo(np.int64)
    yield "full i64 span", [np.array([i64.min, 5, -5, i64.max, 0] * 900, dtype=np.int64)]
    yield "duplicates (stability)", [rng.integers(0, 3, 9000).astype(np.uint64),
                                     rng.integers(0, 2, 9000).astype(np.int64)]
    yield "constant keys", [np.full(4100, 7, np.uint64), np.full(4100, -3, np.int64)]
    yield "one row", [np.array([2**64 - 1], np.uint64)]
    yield "no rows", [np.zeros(0, np.uint64)]
    n = 2048 * 3 + 17
    yield "4 keys, tail tile", [np.full(n, 1, np.uint64),
                                rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
                                np.zeros(n, np.uint64),
                                rng.integers(-(2**40), 2**40, n).astype(np.int64)]


def segment_cases(rng):
    """(name, k int32 sorted, v f64, w f64, valid bool, num_cells)."""
    # runs of random length, some spanning several 2048-row tiles
    lens = np.concatenate([rng.integers(1, 40, 300), [2048, 5000, 1, 2047, 4097],
                           rng.integers(1, 3000, 20)])
    k = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    n = len(k)
    v = rng.integers(-1000, 1000, n).astype(np.float64)  # exact sums in any order
    valid = rng.random(n) > 0.1
    specials = rng.choice(n, 40, replace=False)
    v[specials] = rng.choice([np.nan, np.inf, -np.inf, 0.0, -0.0], 40)
    yield "runs across tiles, NaN/inf/-0, masked rows", k, v, valid
    yield "ids >= num_cells dropped", k, v, valid  # num_cells cut below
    k1 = np.zeros(10_000, np.int32)
    yield "one cell", k1, rng.integers(0, 50, 10_000).astype(np.float64), np.ones(10_000, bool)
    yield "no rows", np.zeros(0, np.int32), np.zeros(0), np.zeros(0, bool)
    kn = np.concatenate([np.full(5, -1), np.arange(2100), np.full(3000, 4000)]).astype(np.int32)
    yield "negative and out-of-range ids", kn, np.ones(len(kn)), np.ones(len(kn), bool)


def main_path_segment_inputs(rng):
    """Kernel B/C inputs with the main path's shapes: one 2 h segment of the
    TSBS grid, rows sorted by (series, ts), 48-bucket grid of 10,000 series."""
    per_series = SEGMENT_MS // INTERVAL_MS
    num_buckets = WINDOW_MS // BUCKET_MS
    sid = np.repeat(np.arange(NUM_SERIES, dtype=np.int64), per_series)
    bucket = np.tile(np.arange(per_series) * INTERVAL_MS // BUCKET_MS, NUM_SERIES)
    k = (sid * num_buckets + bucket).astype(np.int32)
    v = rng.uniform(0, 100, len(k))
    return k, v, NUM_SERIES * num_buckets


def check_kernels(torch, rng, dev) -> list[dict]:
    from horaedb_tpu_torch.backend import order_key
    from horaedb_tpu_torch.ops import blockagg
    from horaedb_tpu_torch.ops import sort as sort_ops

    records = []

    # kernel A
    for name, keys in sort_cases(rng):
        mapped = [torch.from_numpy(order_key(k)).to(dev) for k in keys]
        bounds = [(int(m.min()), int(m.max())) if len(m) else (0, 0) for m in mapped]
        got = sort_ops.sort_perm(mapped, bounds)
        want = sort_ops.sort_perm_plain(mapped)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"sort_perm != plain on case {name!r}")
    n = round(NUM_SERIES * WINDOW_MS / INTERVAL_MS * (1 + RESEND_FRACTION) / 50)
    series = rng.integers(0, 2**64 - 1, NUM_SERIES, dtype=np.uint64, endpoint=True)
    keys_np = [np.full(n, METRIC_ID, np.uint64),
               series[rng.integers(0, NUM_SERIES, n)],
               np.zeros(n, np.uint64),
               T0 + rng.integers(0, SEGMENT_MS // INTERVAL_MS, n) * INTERVAL_MS]
    mapped = [torch.from_numpy(order_key(k)).to(dev) for k in keys_np]
    bounds = [(int(m.min()), int(m.max())) for m in mapped]
    got = sort_ops.sort_perm(mapped, bounds)
    require(torch.equal(got, sort_ops.sort_perm_plain(mapped)),
            "sort_perm != plain at the write batch shape, all four keys")
    # the write path uploads only the keys that need a radix pass (tsid, ts):
    # metric_id and field_id are constant over the batch
    varying = [i for i, (lo, hi) in enumerate(bounds) if sort_ops.num_digits(lo, hi) > 0]
    require(varying == [1, 3], f"expected tsid and ts to vary, got keys {varying}")
    keys_v = [mapped[i] for i in varying]
    bounds_v = [bounds[i] for i in varying]
    got = sort_ops.sort_perm(keys_v, bounds_v)
    want = sort_ops.sort_perm_plain(keys_v)
    require(torch.equal(got, want), "sort_perm != plain at the write batch shape")
    sort_err = float((got.long() - want.long()).abs().max())
    # each sorted key read once (8 B/row), the int32 permutation written once
    nb, kind = bound(n * (8 * len(keys_v) + 4), 0)
    records.append({
        "name": "sort_perm", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/sort_perm.cu",
        "replaces": "horaedb_tpu/ops/sort.py:22",
        "shape": f"{n} rows x {len(keys_v)} keys (tsid, ts)",
        "max_abs_err": sort_err,
        "ms": cuda_ms(torch, lambda: sort_ops.sort_perm(keys_v, bounds_v)),
        "plain_ms": cuda_ms(torch, lambda: sort_ops.sort_perm_plain(keys_v)),
        "bound_ms": nb, "bound_by": kind,
        # no single PyTorch call computes a stable permutation over two
        # 64-bit keys; one stable sort of the tsid lane alone is kept apart
        # as a yardstick for one pass
        "library_ms": None,
        "one_key_sort_ms": cuda_ms(torch, lambda: torch.sort(keys_v[0], stable=True)),
    })

    # kernels B and C: edge cases
    for name, k, v, valid in segment_cases(rng):
        cells = int(k.max()) + 1 if len(k) else 100
        if name.startswith("ids >="):
            cells = max(1, cells - 7)
        if name.startswith("negative"):
            cells = 3000
        kt = torch.from_numpy(k).to(dev)
        vt = torch.from_numpy(v).to(dev)
        okt = torch.from_numpy(valid).to(dev)
        wt = okt.to(torch.float64)
        vm = torch.where(okt, vt, 0.0)
        s, c = blockagg.sorted_segment_sum_count(kt, vm, cells, weights=wt)
        ps, pc = blockagg.sum_count_plain(kt, vm, wt, cells)
        mn, mx = blockagg.sorted_segment_min_max(kt, vt, cells, valid=okt)
        pmn, pmx = blockagg.min_max_plain(kt, vt, okt, cells)
        torch.cuda.synchronize()
        require(torch.equal(c, pc), f"block_sum_count counts != plain on {name!r}")
        require(close_sums(torch, s, ps), f"block_sum_count sums != plain on {name!r}")
        require(same_values(torch, mn, pmn) and same_values(torch, mx, pmx),
                f"block_min_max != plain on {name!r}")

    # kernels B and C at the main path's shape
    k, v, cells = main_path_segment_inputs(rng)
    kt = torch.from_numpy(k).to(dev)
    vt = torch.from_numpy(v).to(dev)
    wt = torch.ones_like(vt)
    okt = torch.ones(len(k), dtype=torch.bool, device=dev)
    s, c = blockagg.sorted_segment_sum_count(kt, vt, cells, weights=wt)
    ps, pc = blockagg.sum_count_plain(kt, vt, wt, cells)
    require(torch.equal(c, pc) and close_sums(torch, s, ps),
            "block_sum_count != plain at the main path shape")
    mn, mx = blockagg.sorted_segment_min_max(kt, vt, cells, valid=okt)
    pmn, pmx = blockagg.min_max_plain(kt, vt, okt, cells)
    require(same_values(torch, mn, pmn) and same_values(torch, mx, pmx),
            "block_min_max != plain at the main path shape")
    n = len(k)
    shape = f"{n} rows, {cells} cells"
    idx = kt.long()
    vw = torch.stack([vt, wt], dim=1)
    idx2 = idx[:, None].expand(n, 2).contiguous()
    vneg = torch.stack([vt, -vt], dim=1)
    nb, kind = bound(n * (4 + 8 + 8) + cells * 16, 2 * n)
    records.append({
        "name": "block_sum_count", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/block_sum_count.cu",
        "replaces": "horaedb_tpu/ops/blockagg.py:76", "shape": shape,
        "max_abs_err": abs_err(torch, s, ps),
        "ms": cuda_ms(torch, lambda: blockagg.sorted_segment_sum_count(kt, vt, cells, weights=wt)),
        "plain_ms": cuda_ms(torch, lambda: blockagg.sum_count_plain(kt, vt, wt, cells)),
        "bound_ms": nb, "bound_by": kind,
        "library_ms": cuda_ms(torch, lambda: torch.zeros(
            cells, 2, dtype=torch.float64, device=dev).index_add_(0, idx, vw)),
        "library_call": "index_add_ of stacked (value, weight)",
    })
    nb, kind = bound(n * (4 + 8 + 1) + cells * 16, 2 * n)
    records.append({
        "name": "block_min_max", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/block_min_max.cu",
        "replaces": "horaedb_tpu/ops/blockagg.py:201", "shape": shape,
        "max_abs_err": max(abs_err(torch, mn, pmn), abs_err(torch, mx, pmx)),
        "ms": cuda_ms(torch, lambda: blockagg.sorted_segment_min_max(kt, vt, cells, valid=okt)),
        "plain_ms": cuda_ms(torch, lambda: blockagg.min_max_plain(kt, vt, okt, cells)),
        "bound_ms": nb, "bound_by": kind,
        "library_ms": cuda_ms(torch, lambda: torch.full(
            (cells, 2), torch.inf, dtype=torch.float64, device=dev).scatter_reduce_(
                0, idx2, vneg, "amin", include_self=True)),
        "library_call": "scatter_reduce amin of stacked (value, -value)",
    })
    return records


# -- phase 3: the main path ---------------------------------------------------

def make_data(rng):
    """The TSBS grid in (series, ts) order, the re-sent rows and the final
    value of every (series, ts) after the re-send (last write wins)."""
    tsids = np.unique(rng.integers(1, 2**64 - 1, NUM_SERIES * 2, dtype=np.uint64))
    tsids = rng.choice(tsids, NUM_SERIES, replace=False)
    tsids.sort()
    require(len(tsids) == NUM_SERIES, "tsid draw collided")
    per_series = WINDOW_MS // INTERVAL_MS
    ts = T0 + np.arange(per_series, dtype=np.int64) * INTERVAL_MS
    values = rng.uniform(0, 100, NUM_SERIES * per_series)
    resend = np.sort(rng.choice(len(values), int(len(values) * RESEND_FRACTION), replace=False))
    new_values = rng.uniform(0, 100, len(resend))
    final = values.copy()
    final[resend] = new_values
    return tsids, ts, values, resend, new_values, final


def write_all(storage, rng, tsids, ts, values, resend, new_values):
    from horaedb_tpu_torch.storage import TimeRange, WriteRequest

    per_series = len(ts)
    n_total = len(values)

    def batch(rows, vals):
        s, t = rows // per_series, rows % per_series
        return {"metric_id": np.full(len(rows), METRIC_ID, np.uint64), "tsid": tsids[s],
                "field_id": np.zeros(len(rows), np.uint64), "ts": ts[t], "value": vals}

    seg_of = (ts - T0) // SEGMENT_MS
    rows_written = 0
    t_start = time.perf_counter()
    for seg in range(WINDOW_MS // SEGMENT_MS):
        rng_seg = TimeRange(T0 + seg * SEGMENT_MS, T0 + (seg + 1) * SEGMENT_MS)
        rows = np.flatnonzero(seg_of[np.arange(n_total) % per_series] == seg)
        rows = rng.permutation(rows)
        for part in np.array_split(rows, BATCHES_PER_SEGMENT):
            storage.write(WriteRequest(batch(part, values[part]), rng_seg))
            rows_written += len(part)
        rs = np.flatnonzero(seg_of[resend % per_series] == seg)
        rs = rng.permutation(rs)
        storage.write(WriteRequest(batch(resend[rs], new_values[rs]), rng_seg))
        rows_written += len(rs)
    return rows_written, time.perf_counter() - t_start


def oracle(tsids, ts, final):
    """Independent numpy downsample of the final values: bincount for sum
    and count, reduceat over the (series, ts)-ordered cells for min/max."""
    per_series = len(ts)
    num_buckets = WINDOW_MS // BUCKET_MS
    cells = NUM_SERIES * num_buckets
    flat = (np.repeat(np.arange(NUM_SERIES), per_series) * num_buckets
            + np.tile((ts - T0) // BUCKET_MS, NUM_SERIES))
    s = np.bincount(flat, weights=final, minlength=cells)
    c = np.bincount(flat, minlength=cells).astype(np.float64)
    starts = np.flatnonzero(np.r_[True, flat[1:] != flat[:-1]])
    mn = np.full(cells, np.inf)
    mx = np.full(cells, -np.inf)
    mn[flat[starts]] = np.minimum.reduceat(final, starts)
    mx[flat[starts]] = np.maximum.reduceat(final, starts)
    shape = (NUM_SERIES, num_buckets)
    return {"sum": s.reshape(shape), "count": c.reshape(shape),
            "min": mn.reshape(shape), "max": mx.reshape(shape)}


def check_grids(got, want, what: str) -> None:
    require(np.array_equal(got["count"], want["count"]), f"{what}: counts differ from oracle")
    require(np.array_equal(got["min"], want["min"]), f"{what}: min differs from oracle")
    require(np.array_equal(got["max"], want["max"]), f"{what}: max differs from oracle")
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-12, atol=0,
                               err_msg=f"{what}: sums differ from oracle")
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = want["sum"] / want["count"]
    np.testing.assert_allclose(got["mean"], mean, rtol=1e-12, atol=0, equal_nan=True,
                               err_msg=f"{what}: means differ from oracle")


def bitwise_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k].view(np.uint64), b[k].view(np.uint64)) for k in a)


def main_path(torch, rng, dev) -> dict:
    import horaedb_tpu_torch as port
    from horaedb_tpu_torch.engine_query import query_downsample
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.storage import ObjectBasedStorage, TimeRange

    tsids, ts, values, resend, new_values, final = make_data(rng)
    want = oracle(tsids, ts, final)
    subset = np.sort(rng.choice(NUM_SERIES, SUBSET, replace=False))
    window = TimeRange(T0, T0 + WINDOW_MS)
    pred = F.And(F.Compare("metric_id", "eq", METRIC_ID),
                 F.time_range_pred("ts", window.start, window.end))

    port.reset_launch_counts()
    storage = ObjectBasedStorage.try_new(SCHEMA, 4, SEGMENT_MS, device=dev)
    rows, write_s = write_all(storage, rng, tsids, ts, values, resend, new_values)
    torch.cuda.synchronize()
    query_s = []
    grids = []
    for ids in (tsids, tsids, tsids[subset]):
        t = time.perf_counter()
        grids.append(query_downsample(storage, ids, window, BUCKET_MS, pred, device=dev))
        query_s.append(time.perf_counter() - t)
    launches = port.launch_counts()
    profiled = profile_query(torch, storage, tsids, window, pred, dev)

    check_grids(grids[0], want, "all series")
    require(bitwise_equal(grids[0], grids[1]), "repeat query is not bitwise identical")
    check_grids(grids[2], {k: v[subset] for k, v in want.items()}, "1000-series subset")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")
    return {"rows_written": rows, "write_rows_per_s": rows / write_s,
            "query_s_all_series": query_s[0], "query_s_repeat": query_s[1],
            "query_s_subset": query_s[2], "launches": launches, "profile": profiled}


def profile_query(torch, storage, ids, window, pred, dev) -> dict:
    """One more query under torch.profiler (device kernels and copies) and
    cProfile (host): wall time, device busy time and share, and the host
    functions with the most own time."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from horaedb_tpu_torch.engine_query import query_downsample

    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        host.enable()
        query_downsample(storage, ids, window, BUCKET_MS, pred, device=dev)
        host.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    by_kernel = sorted(((e.key[:60], e.self_device_time_total / 1e6)
                        for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                       key=lambda kv: -kv[1])[:6]
    stats = pstats.Stats(host)
    top = sorted(((f"{fn[0].rsplit('/', 1)[-1]}:{fn[2]}", st[2])
                  for fn, st in stats.stats.items()), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall, "device_busy_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall, "device_top": by_kernel,
            "host_top_self_s": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from horaedb_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    t = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t:.1f} s wall, per kernel "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()), flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    records = check_kernels(torch, rng, dev)
    for r in records:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{r['name']}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} [{card}]",
              flush=True)
    result = main_path(torch, rng, dev)
    for r in records:
        r["launches"] = result["launches"][r["name"]]
    profiled = result.pop("profile")
    print(json.dumps({"main_path": {k: v for k, v in result.items() if k != "launches"},
                      "card": card}), flush=True)
    print(json.dumps({"query_profile": profiled, "card": card}), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
