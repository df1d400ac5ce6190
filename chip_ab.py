#!/usr/bin/env python3
"""A/B timings on one GPU, at the shapes of chip_smoke.py.

    python3 chip_ab.py reduce [--root DIR] [--seed N]
    python3 chip_ab.py reduce-split [--root DIR] [--seed N]
    python3 chip_ab.py id-cache [--seed N]
    python3 chip_ab.py solo-fold [--root DIR] [--seed N]
    python3 chip_ab.py launch [--root DIR] [--seed N]

`reduce` builds and times, with chip_smoke's CUDA-event timer, the kernels
that share `horaedb_tpu_torch/ops/csrc/segreduce.cuh`:
- block_sum_count (kernel B) and block_min_max (kernel C) at phase 4's
  shape (chip_smoke.main_path_segment_inputs) and at phase 2's few cells
  of many rows (chip_smoke.long_run_inputs);
- grouped_stats at that long-run shape, and grouped_stats and downsample
  at the fused query's shape of phase 3e (FUSED_SERIES series x
  FUSED_WINDOW_MS / FUSED_BUCKET_MS buckets, the rows of the window and
  its re-send in (series, ts) order, then shuffled by a torch.Generator
  seeded from --seed).
`reduce-split` gives the device time of each kernel (torch.profiler)
inside one grouped_stats and one downsample call at that fused shape,
sorted and shuffled.
`--root DIR` imports `horaedb_tpu_torch` from DIR (another checkout, such
as a `git archive` of a parent commit unpacked where .gitignore lists it)
and builds its kernels there; the shapes and the timer always come from
the chip_smoke.py beside this script. Run the trees in one call, in the
order parent, change, change, parent.

`id-cache` writes TSBS cpu-only payloads (phase 3i's hosts and payloads,
10,000 hosts x 10 fields x 3 scrapes) through `MetricEngine.write_payload`
on the card: the first payload registers the series, then blocks of three
payloads with the engine's id cache on, off, off and on (off: a mapping
that never hits, so every payload runs the registration probes of the
JAX engine's slow path). Each payload carries new timestamps.

`solo-fold` times `ops/aggregate.py::downsample_sorted` end to end on the
card (the host prologue, the upload, kernels B and C, the grids back to
the host), host clock after a synchronise, on one 2 h segment of the
TSBS grid (10,000 series x 720 rows, 48 buckets), the packed pass's fold:
once with every row in the grid and once with the window starting an hour
into the segment (half the rows outside the grid, on the host with
`HORAEDB_AGG_IMPL=block` pinned, where the package has the dispatcher).
Seven runs each after a warm-up; `--root` as for `reduce`.

`launch` splits the time of kernels `lane_sum_count` and `grid_fold` and
of their one-call PyTorch yardsticks at phase 4's shapes (the calibration
stream, 2^18 rows into 16,384 and into 524,288 cells, sorted and
shuffled; one slot of 3l's scatter-gather fold, [4, 2,500, 30]) into:
`events_ms`, chip_smoke's CUDA-event loop (20 calls); `device_ms`, the
device time per call of every kernel and memset the call runs
(torch.profiler, 20 calls); `host_us`, perf_counter per call over 1,000
calls until the last is enqueued, and `wall_us`, until the synchronise
after it. Where `host_us` exceeds `device_ms`, the events loop measures
the host. `host_parts_us` times the pieces a launch path is made of
(an allocation, a view, the stream handle, a device switch, a ctypes
call that does no work). It splits the other rows under 0.1 ms the same
way (the four decode kernels on 2^17-row synthetic lanes, the mesh key
kernel on 3.6M rows). `--root` as for `reduce`, for a tree that has
`_build.launch`.

Each mode prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_smoke():
    """chip_smoke.py beside this script, whatever --root puts first."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reduce_times(torch, cs, rng, dev) -> dict:
    from horaedb_tpu_torch.ops import _build, aggregate, blockagg

    _build.build_all(("block_sum_count", "block_min_max", "grouped_stats", "downsample"))
    out = {}
    for name, (k, v, cells) in (("main", cs.main_path_segment_inputs(rng)),
                                ("long_runs", cs.long_run_inputs(rng))):
        kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
        ok = torch.ones_like(vt, dtype=torch.bool)
        out[f"{name}_shape"] = f"{len(k)} rows, {cells} cells"
        out[f"{name}_block_sum_count_ms"] = cs.cuda_ms(
            torch, lambda: blockagg.sorted_segment_sum_count(kt, vt, cells))
        out[f"{name}_block_min_max_ms"] = cs.cuda_ms(
            torch, lambda: blockagg.sorted_segment_min_max(kt, vt, cells, valid=ok))
        if name == "long_runs":
            out[f"{name}_grouped_stats_ms"] = cs.cuda_ms(
                torch, lambda: aggregate.grouped_stats(vt, kt, None, cells))
        del kt, vt, ok

    series, buckets = cs.FUSED_SERIES, cs.FUSED_WINDOW_MS // cs.FUSED_BUCKET_MS
    for order, (ts, sid, vals, flat) in fused_lanes(torch, cs, rng, dev):
        out["fused_shape"] = f"{len(ts)} rows, {series} series x {buckets} buckets"
        key = "fused" if order == "sorted" else "fused_shuffled"
        out[f"{key}_grouped_stats_ms"] = cs.cuda_ms(
            torch, lambda: aggregate.grouped_stats(vals, flat, None, series * buckets), iters=5)
        out[f"{key}_downsample_ms"] = cs.cuda_ms(
            torch, lambda: aggregate.downsample(ts, sid, vals, None, 0, cs.FUSED_BUCKET_MS,
                                                series, buckets), iters=5)
    return out


def fused_lanes(torch, cs, rng, dev):
    """The fused query's shape of phase 3e (FUSED_SERIES series x
    FUSED_WINDOW_MS / FUSED_BUCKET_MS buckets, the window's rows and its
    re-send) as card lanes (ts, sid, values, flat cell ids): yields
    ("sorted", lanes in (series, ts) order), then ("shuffled", the same rows
    shuffled by a torch.Generator seeded from `rng`)."""
    series = cs.FUSED_SERIES
    buckets = cs.FUSED_WINDOW_MS // cs.FUSED_BUCKET_MS
    per = round(cs.FUSED_WINDOW_MS // cs.INTERVAL_MS * (1 + cs.RESEND_FRACTION))
    n = series * per
    sid = torch.arange(series, dtype=torch.int32, device=dev).repeat_interleave(per)
    ts = torch.arange(per, dtype=torch.int64, device=dev).repeat(series) * (cs.FUSED_WINDOW_MS // per)
    vals = torch.from_numpy(rng.uniform(0, 100, n)).to(dev)
    flat = sid * buckets + (ts // cs.FUSED_BUCKET_MS).to(torch.int32)
    yield "sorted", (ts, sid, vals, flat)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2**31)))
    perm = torch.randperm(n, device=dev, generator=gen)
    yield "shuffled", (ts[perm], sid[perm], vals[perm], flat[perm])


def reduce_split(torch, cs, rng, dev) -> dict:
    """Device ms by kernel (torch.profiler, the mean of 5 calls) of one
    grouped_stats and one downsample call at the fused shape, sorted and
    shuffled."""
    from horaedb_tpu_torch.ops import aggregate

    series, buckets = cs.FUSED_SERIES, cs.FUSED_WINDOW_MS // cs.FUSED_BUCKET_MS
    out = {}
    for order, (ts, sid, vals, flat) in fused_lanes(torch, cs, rng, dev):
        for name, fn in (
                ("grouped_stats",
                 lambda: aggregate.grouped_stats(vals, flat, None, series * buckets)),
                ("downsample",
                 lambda: aggregate.downsample(ts, sid, vals, None, 0, cs.FUSED_BUCKET_MS, series,
                                              buckets))):
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            split = {}
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                if t > 0:
                    split[e.key[:80]] = t / 5 / 1000
            out[f"{name}_{order}_ms_by_kernel"] = dict(sorted(split.items(), key=lambda x: -x[1]))
    return out


def solo_fold_times(torch, cs, rng, dev) -> dict:
    from horaedb_tpu_torch.ops import aggregate

    per = cs.SEGMENT_MS // cs.INTERVAL_MS
    sid = np.repeat(np.arange(cs.NUM_SERIES, dtype=np.int32), per)
    ts = cs.T0 + np.tile(np.arange(per, dtype=np.int64) * cs.INTERVAL_MS, cs.NUM_SERIES)
    vals = rng.uniform(0, 100, len(ts))
    buckets = cs.WINDOW_MS // cs.BUCKET_MS
    out = {"shape": f"{len(ts)} rows, {cs.NUM_SERIES} series x {buckets} buckets"}
    os.environ["HORAEDB_AGG_IMPL"] = "block"
    for name, t0 in (("in_grid", cs.T0), ("half_outside", cs.T0 + cs.SEGMENT_MS // 2)):
        def fold():
            g = aggregate.downsample_sorted(ts, sid, vals, t0, cs.BUCKET_MS, cs.NUM_SERIES,
                                            buckets, device=dev)
            return {k: v.cpu().numpy() for k, v in g.items()}

        fold()
        secs = []
        for _ in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fold()
            secs.append(time.perf_counter() - t)
        out[f"{name}_s"] = secs
        out[f"{name}_median_s"] = float(np.median(secs))
    return out


def fold_partials(torch, cs, rng, dev) -> dict:
    """One slot of phase 3l's scatter-gather fold: [NUM_REGIONS, NUM_SERIES
    / MESH_SLOTS, 30] f64 partial grids, each series in one region's
    partial (six 10 s scrapes a 1-minute bucket), identity rows in the
    others."""
    k = cs.NUM_REGIONS
    s = -(-cs.NUM_SERIES // cs.MESH_SLOTS)
    b = cs.ENGINE_WINDOW_MS // cs.ENGINE_BUCKET_MS
    per = cs.ENGINE_BUCKET_MS // cs.INTERVAL_MS
    owner = rng.integers(0, k, s)
    mine = np.broadcast_to((owner[None, :] == np.arange(k)[:, None])[:, :, None], (k, s, b))
    vals = rng.uniform(0, 100, (s, b, per))
    grids = {"sum": np.where(mine, vals.sum(-1), 0.0),
             "count": np.where(mine, float(per), 0.0),
             "min": np.where(mine, vals.min(-1), np.inf),
             "max": np.where(mine, vals.max(-1), -np.inf)}
    return {key: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for key, a in grids.items()}


def launch_split(torch, cs, fn, iters: int = 1000) -> dict:
    """Events-loop ms, device ms per call (torch.profiler) and host us per
    call of fn() (module docstring)."""
    out = {"events_ms": cs.cuda_ms(torch, fn)}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            split[e.name[:60]] = split.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 20e3
    out["device_ms"] = sum(split.values())
    out["device_ms_by_kernel"] = split
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t_host = time.perf_counter()
    torch.cuda.synchronize()
    t_wall = time.perf_counter()
    out["host_us"] = (t_host - t) / iters * 1e6
    out["wall_us"] = (t_wall - t) / iters * 1e6
    return out


def host_parts(torch, dev, iters: int = 10_000) -> dict:
    """Host us a call of the pieces a launch path is made of, on this
    machine: perf_counter around `iters` calls."""
    from horaedb_tpu_torch.ops import _build
    from horaedb_tpu_torch.ops.aggregate import _LANES_ARGTYPES

    x = torch.empty(16, dtype=torch.float32, device=dev)
    fn = _build.kernel("lane_sum_count", "lane_sum_count_launch", _LANES_ARGTYPES)
    nothing = [None] * 3 + [0, 0] + [None] * (len(fn.argtypes) - 5)  # 0 cells: returns at once

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "torch_empty": lambda: torch.empty((2, 16_384), dtype=torch.float32, device=dev),
        "new_empty": lambda: x.new_empty((2, 16_384)),
        "unbind_4": lambda: x.view(4, 4).unbind(0),
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "device_context": device_context,
        "to_same_dtype": lambda: x.to(torch.float32),
        "unbind_2": lambda: x.view(2, 8).unbind(0),
        "ctypes_call_no_work": lambda: fn(*nothing),
        "build_launch_no_work": lambda: _build.launch("lane_sum_count", fn, dev, *nothing[:-1]),
    }
    out = {}
    for name, part in parts.items():
        part()
        t = time.perf_counter()
        for _ in range(iters):
            part()
        out[name] = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return out


def launch_times(torch, cs, rng, dev) -> dict:
    from horaedb_tpu_torch.ops import agg_registry
    from horaedb_tpu_torch.ops import aggregate as agg
    from horaedb_tpu_torch.ops import mesh as mesh_ops

    out = {}
    for klass in ("dense", "sparse"):
        for kind in ("sorted", "unsorted"):
            k, v, cells = agg_registry.calib_inputs(klass, kind)
            kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
            kc = kt.long().clamp(0, cells)
            ones = torch.ones_like(vt)

            def library(kc=kc, vt=vt, ones=ones, cells=cells):
                torch.zeros(cells + 1, dtype=torch.float32, device=dev).index_add_(0, kc, vt)
                torch.zeros(cells + 1, dtype=torch.float32, device=dev).index_add_(0, kc, ones)

            key = f"lane_sum_count_{klass}_{kind}"
            out[f"{key}_shape"] = f"{len(k)} rows into {cells} cells"
            out[key] = launch_split(torch, cs, lambda kt=kt, vt=vt, cells=cells:
                                    agg.lane_segment_sum_count(kt, vt, cells))
            out[f"{key}_library"] = launch_split(torch, cs, library)
    part = fold_partials(torch, cs, rng, dev)
    out["grid_fold_shape"] = list(part["sum"].shape)
    out["grid_fold"] = launch_split(torch, cs, lambda: mesh_ops.grid_fold(part))
    out["grid_fold_library"] = launch_split(
        torch, cs, lambda: (part["sum"].sum(0), part["count"].sum(0), part["min"].amin(0),
                            part["max"].amax(0)))
    out.update(small_rows(torch, cs, rng, dev))
    out["host_parts_us"] = host_parts(torch, dev)
    return out


def small_rows(torch, cs, rng, dev) -> dict:
    """The split of the other rows under 0.1 ms: the four decode kernels
    on the calibration's synthetic lanes (2^17 rows; xor a constant lane,
    as 3g's value lane is) and the mesh key kernel on one slot of 3l's
    mesh downsample (3.6M sorted rows, 5,000 series x 48 buckets)."""
    from horaedb_tpu_torch.ops import decode
    from horaedb_tpu_torch.ops import mesh as mesh_ops
    from horaedb_tpu_torch.storage import encoding as enc_mod

    out = {}
    for codec, name in cs.DECODE_NAMES.items():
        if codec == "xor":  # the synthetic lane's normal floats leave the envelope
            lane = enc_mod._encode_xor(np.full(1 << 17, 42.5), enc_mod.DEFAULT_PAGE_ROWS)
        else:
            lane, _ = decode._synth_lane(codec, 1 << 17)
        dt = np.dtype(lane.dtype)
        pages = [p for p in lane.pages if decode.in_envelope(codec, dt, p, lane.dict_values)]
        if not pages:
            continue
        s = decode.stage_pages(codec, dt, lane.payload, pages, lane.dict_values, dev)
        args = {"dict": (s.words, s.table, s.dict_bits, s.rows),
                "rle": (s.words, s.table, s.cum, s.rows, dt.itemsize)}.get(
                    codec, (s.words, s.table, s.rows, dt.itemsize))
        kern = getattr(decode, name)
        out[f"{name}_shape"] = f"{s.rows} rows, {len(pages)} pages"
        out[name] = launch_split(torch, cs, lambda kern=kern, args=args: kern(*args))
    series, buckets = cs.NUM_SERIES // 2, cs.WINDOW_MS // cs.BUCKET_MS
    per = 720
    n = series * per
    sid = torch.arange(series, dtype=torch.int32, device=dev).repeat_interleave(per)
    ts = cs.T0 + torch.arange(per, dtype=torch.int64, device=dev).repeat(series) * \
        (cs.WINDOW_MS // per)
    vals = torch.from_numpy(rng.uniform(0, 100, n)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    out["sharded_downsample_keys_shape"] = f"{n} rows, {series} series x {buckets} buckets"
    out["sharded_downsample_keys"] = launch_split(
        torch, cs, lambda: mesh_ops.sharded_keys(ts, sid, vals, valid, None, cs.T0,
                                                 cs.BUCKET_MS, 0, series, buckets))
    return out


class NeverHit(dict):
    """An id cache that never hits and keeps nothing."""

    def get(self, key, default=None):
        return default

    def __setitem__(self, key, value):
        pass


async def id_cache_times(torch, cs, rng, dev) -> dict:
    from horaedb_tpu_torch.engine import MetricEngine
    from horaedb_tpu_torch.objstore import LocalStore
    from horaedb_tpu_torch.serving import ServingTierConfig

    tags, _rack = cs.engine_hosts(rng)
    writer = cs.PayloadWriter(tags, cs.CPU_FIELDS)
    values = rng.uniform(0, 100, (len(tags) * len(cs.CPU_FIELDS), cs.ENGINE_PER_PAYLOAD))
    out = {"series_per_payload": int(values.shape[0]),
           "samples_per_payload": int(values.size), "on_s": [], "off_s": []}
    with tempfile.TemporaryDirectory(prefix="chip_ab_") as workdir:
        eng = await MetricEngine.open("ab", LocalStore(workdir), enable_compaction=False,
                                      serving=ServingTierConfig(enabled=False), device=dev)
        cache = eng._ids_by_key
        p = 0

        async def write(n: int) -> list:
            nonlocal p
            secs = []
            for _ in range(n):
                ts = cs.T0 + (np.arange(cs.ENGINE_PER_PAYLOAD) + cs.ENGINE_PER_PAYLOAD * p) \
                    * cs.INTERVAL_MS
                payload = writer.payload(values, ts)
                t = time.perf_counter()
                written = await eng.write_payload(payload)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                cs.require(written == values.size, f"payload {p}: {written} samples")
                p += 1
            return secs

        out["first_s"] = (await write(1))[0]
        for on in (True, False, False, True):
            eng._ids_by_key = cache if on else NeverHit()
            out["on_s" if on else "off_s"] += await write(3)
        await eng.close()
    for k in ("on", "off"):
        out[f"{k}_mean_s"] = float(np.mean(out[f"{k}_s"]))
        out[f"{k}_samples_per_s"] = values.size / out[f"{k}_mean_s"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("mode", choices=("reduce", "reduce-split", "id-cache", "solo-fold", "launch"))
    ap.add_argument("--root", default=None, help="import horaedb_tpu_torch from this checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cs = load_smoke()
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    import horaedb_tpu_torch

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    if args.mode == "reduce":
        out = reduce_times(torch, cs, rng, dev)
    elif args.mode == "reduce-split":
        out = reduce_split(torch, cs, rng, dev)
    elif args.mode == "solo-fold":
        out = solo_fold_times(torch, cs, rng, dev)
    elif args.mode == "launch":
        out = launch_times(torch, cs, rng, dev)
    else:
        out = asyncio.run(id_cache_times(torch, cs, rng, dev))
    out.update(mode=args.mode, package=os.path.dirname(horaedb_tpu_torch.__file__), card=card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
