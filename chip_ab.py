#!/usr/bin/env python3
"""A/B timings on one GPU, at the shapes of chip_smoke.py.

    python3 chip_ab.py reduce [--root DIR] [--seed N]
    python3 chip_ab.py reduce-split [--root DIR] [--seed N]
    python3 chip_ab.py id-cache [--seed N]
    python3 chip_ab.py solo-fold [--root DIR] [--seed N]
    python3 chip_ab.py launch [--root DIR] [--seed N]
    python3 chip_ab.py merge [--root DIR] [--seed N]
    python3 chip_ab.py sort-split [--root DIR] [--seed N]
    python3 chip_ab.py default-device [--root DIR] [--seed N]
    python3 chip_ab.py burst [--root DIR] [--seed N] [--rounds N]
    python3 chip_ab.py burst-pair --root DIR [--seed N] [--rounds N]
    python3 chip_ab.py scan-pair --root DIR [--seed N] [--rounds N] [--no-warm-turn]
    python3 chip_ab.py mesh-step --root DIR [--seed N]
    python3 chip_ab.py decode-pair --root DIR [--seed N]
    python3 chip_ab.py agg-pair --root DIR [--seed N] [--stacked-call FILE]

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
It also times kernels B and C at phase 4's shape as
`ops/aggregate.py::downsample_sorted` calls them (no weights, no valid
mask: `main_call`), B and C on a sparse grid (SPARSE_ROWS sorted rows
spread over phase 4's cells), and stacked_downsample (row 7) at burst A's
launch shape ([16, 32,768] padded lanes, 16 x 128 series x 30 buckets,
STACKED_REAL rows a lane sorted by (series, ts)).
`reduce-split` gives the device time of each kernel (torch.profiler)
inside one grouped_stats and one downsample call at that fused shape,
sorted and shuffled, inside one call of kernels B, C and grouped_stats at
the long-run shape and of stacked_downsample at burst A's launch shape,
and inside one call of kernels B and C at phase 4's shape in two forms:
with the smoke's explicit lanes (weights of ones, an all-true valid mask)
and as downsample_sorted calls them (`main_call`): by part (the lane of
ones the wrapper fills, seg::fill_kernel, seg::run_kernel, others by
name), the kernels a call launches, and the device bytes a call allocates
(the peak over the call less what was allocated before it). Where the
tree exports them, it also reports run_kernel's registers, shared bytes
and blocks an SM for each lane set (`run_occupancy`).
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
way: the four decode kernels on the lanes phase 4 times them on (3g's
re-send SST, 1.8M rows in 440 pages: `ts` dod, `tsid` rle, `field_id`
dict; 3h's `up` values, 30,000 rows, xor; and, a kernel shape rather than
a main-path one, the re-send's values as an f32 xor lane at widths <= 32),
each with its library yardstick where one exists and the host ms of its
`stage_pages` (`stage_pages_ms`), and `decode_dod_host_parts_us` (the decode
wrapper's checks, its output's allocation, the kernel lookup, the device
context and Stream object the decoders entered before `_build.launch`,
the raw stream handle); the mesh key kernel (a tree that has it) or the
slot pass (a tree that has that) on 3.6M sorted rows; and the three launch
paths of `ops/aggregate.py` (grouped_stats, stacked_downsample,
segment_last_value) at small shapes, where the host path is the call.
`--root` as for `reduce`, for a tree that has `_build.launch`.

`merge` splits the four merges that sort through a digit sort at the
smoke's main shapes: `packed_merge` (row 18: one 2 h segment of
chip_smoke.make_data, about 7.56M rows, its dense (series_id, ts, seq)
key, 42 bits; with its plain version's and its library yardstick's
events ms), `index_merge_mask` and `index_merge_filter` (rows 19 and 20:
that segment's sort-key lanes; the filter an InSet of 1,000 tsids and a
ts range) and `sample_sort_merge` (row 14: the dense key over 8 slots of
the card). For each: `events_ms` and `device_ms` as for `launch`,
`device_ms_by_part` (torch.profiler, by kernel name: the predicate, the
partition, the key passes, the look-back digit sweeps, radix.cuh's digit
passes and, apart, their one-block scans of the (digit, tile) counts, the
compactions' one-block tile scans, the compaction, the bucket scatter,
copies and memsets), `device_ms_by_kernel`, and `host_us` / `wall_us`
over 50 calls; then, end to end, seven raw scans
of that segment (written as phase 3a writes it) on each route that
launches kernel F (`scans`: host seconds after a synchronise, and the
kernels launched). `--root` as for `reduce`.

`sort-split` splits the two kernels that sort through the packed-key
chain since the look-back rework (keychain.cuh), at chip_smoke's shapes:
`scan_kernel` (row 21) on the fused query's pass of phase 3e, built on the
card (FUSED_SERIES series x 60 samples and the 5 % re-send = 63M rows, in
the order the scan reads them: 20 writes of shuffled rows, each sorted as
its SST is, then the re-send; tsid, ts and the seq rank as key lanes, the
pass's eight gathered lanes, the metric_id and ts-range predicate on the
device) and `sort_perm` (row 4) on phase 2's write batch (302,400 rows of
tsid and ts). For each: `events_ms`, `device_ms`, `device_ms_by_part`
(SORT_PARTS: the predicate, the partition, the one-block tile scans, the
key passes, the digit sweeps or radix passes, the lane gather, the flags,
copies, memsets), `device_ms_by_kernel`, `host_us` and `wall_us`, as for
`merge`; the plain version's and one stable torch.sort's events ms; and a
check that the kernel's output equals the plain version's. `--root` as for
`reduce`.

`default-device` opens storage and the metric engine with the default
device (`device=` left out: a bare "cuda") and runs, on a small table of
2^17 series, an InSet raw scan under HORAEDB_SCAN_PATH=device (kernels E
and F), the fused downsample over all 2^17 series (scan_kernel), and an
engine write and raw query of one host under HORAEDB_SCAN_PATH=device
(kernels E and F in the data table's scan); each read again on storage
and an engine opened on cuda:0. It reports, per read, the kernels it
launched and the exception the default device raised (type and text), or
whether its answer equals cuda:0's bit for bit. `--root` as for `reduce`:
a tree whose `resolve_device` leaves a bare "cuda" without an index
raises on the first two reads and the engine's.

`burst` times phase 3i's burst A end to end: chip_smoke's TSBS cpu-only
write (NUM_SERIES hosts x 10 fields x 180 scrapes, 60 payloads through
`MetricEngine.write_payload`), then `--rounds` rounds after one warm-up
round, each the 16 rack panels one by one with HORAEDB_BATCH=off
(`solo_sum_s`, the sum of their host seconds) and then together through
the 2 ms batcher (`burst_s`, host wall). Every burst must launch
stacked_downsample once and answer as the solo run did. `--root` as for
`reduce`; run the trees in alternating pairs in one call.
`burst-pair` runs burst A on both trees in one process: the package of
this checkout ("change") and that of `--root` ("parent"), each imported
apart and swapped into sys.modules while its engine runs, each engine
written with the same payloads; the two take turns every round (change
first in even rounds), so both see the same host.
`scan-pair` does the same for the raw scans of segment 0 that launch
rows 19, 20 and 14 (each tree writes it as phase 3a does, and into 3d's
dense table): `auto_metric_eq` (index_merge_mask), `device_inset_1000`
(HORAEDB_SCAN_PATH=device, index_merge_filter) and `sharded` (3l's scan
of the dense table on an 8-slot mesh, sample_sort_merge); host seconds
after a synchronise, the device allocations each scan made and, for the
first two, the index merge's device ms inside the scan (CUDA events). An
untimed `auto_metric_eq` scan opens each tree's turn (`--no-warm-turn`
drops it), so that no timed scan follows the other tree's.

`mesh-step` times the two mesh steps whole, from the raw lanes to the
folded grids, on two packages in one process: that of `--root` ("parent")
and that of this checkout ("change"), each imported apart, in the order
parent, change, change, parent. Row 16 (`sharded_downsample`): one 2 h
segment of 3l's packed downsample, NUM_SERIES series x 720 scrapes in
(series, ts) order over the window's 48 buckets, on 4 slots of the card
(rows 2 x series 2); row 17 (`multisegment_downsample`): 3l's 3-axis step
over two such segments on 8 slots (seg 2 x rows 2 x series 2). For each
step and turn: `events_ms` (chip_smoke's timer, 5 steps), `device_ms` by
part (MESH_PARTS) and by kernel (torch.profiler, the mean of 5 steps),
the device ops a step, the package's launch counts of one step, and host
us a step until the last launch is enqueued (`host_us`) and until the
synchronise (`wall_us`), over 20 steps, and the functions with the most
host time a step (`host_top_us`, cProfile). Each turn also times, with
chip_smoke's timer, the rows that share the steps' headers and wrappers
(`other_rows_ms`: B and C at phase 4's shape and the long-run shape,
grouped_stats and downsample at the fused shape sorted and shuffled,
stacked_downsample at burst A's launch, grid_fold on a slot of 3l's fold),
and every grid of every turn must equal the first turn's bit for bit (a
digest on the card). The steps' library yardsticks (2 index_add_ + 2
scatter_reduce over the same rows) are timed once.

`decode-pair` runs `launch`'s decode split (the five decode rows, with
`stage_pages_ms`) on two packages in one process: that of `--root`
("parent") and that of this checkout ("change"), each imported apart, in
the order parent, change, change, parent, with the card's empty launch
(`torch.cuda._sleep(0)`: events ms, device ms and host us) in every
turn; the library yardsticks are timed in the first turn only, and every
turn's rows must equal the first turn's bit for bit.

`agg-pair` runs the rows that share grouped_stats.cu, onesweep.cuh and
segreduce.cuh on two packages in one process: that of `--root` ("parent")
and that of this checkout ("change"), each imported apart, in the order
parent, change, change, parent: stacked_downsample (row 7) at burst A's
launch shape (STACKED_SHAPE) and, with `--stacked-call FILE` (written by
`chip_smoke.py --save-stacked-call FILE`), at 3i's captured call, and at
EMPTY_LANE_SHAPE with its last lane empty; grouped_stats with 90 % of its
rows masked (MASKED_SHAPE);
segment_last_value (row 9) at 3k's shape (its row pass's u32 route), and
at that shape with one seq of 2^33 (the u64 route) and of INT64_MAX (the
16-byte CAS route); grouped_stats and
downsample (rows 5, 8) at the fused shape, sorted and shuffled; kernels B
and C (rows 1, 2) as downsample_sorted calls them at phase 4's shape; the
sorts that share onesweep.cuh's key pass and partition: sort_perm (row 4,
phase 2's write batch), packed_merge (row 18, one 2 h segment) and
scan_kernel (row 21, the fused pass); and the two mesh steps whole (rows
16, 17, as `mesh-step`). For each row: `launch_split` (events ms, device
ms by kernel and device operations a call by torch.profiler, host us and
wall us a call); every turn's outputs must equal the first turn's bit for
bit (a digest on the card; the sorts: equal to their plain versions).

Each mode prints the card's name and power limit, then one JSON line.
Device ms come from torch.profiler windows in which every kernel, copy
and memset ran a whole number of times a call (chip_smoke.profiled_events:
a window that lost records is taken again); the JSON's
`profiler_windows_retaken` counts those taken again.
"""

from __future__ import annotations

import argparse
import asyncio
import ctypes
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


# the sparse grid: this many sorted rows spread over phase 4's cells
SPARSE_ROWS = 1_000
# burst A's stacked launch: lanes, padded rows a lane, series and buckets a
# lane's grid, real rows a lane (100 hosts x 180 scrapes of 10 s)
STACKED_SHAPE = (16, 32_768, 128, 30)
STACKED_REAL = 18_000


def sparse_inputs(cs, rng):
    """SPARSE_ROWS sorted ids drawn over phase 4's grid, uniform values."""
    cells = cs.NUM_SERIES * (cs.WINDOW_MS // cs.BUCKET_MS)
    k = np.sort(rng.integers(0, cells, SPARSE_ROWS)).astype(np.int32)
    return k, rng.uniform(0, 100, SPARSE_ROWS), cells


def stacked_inputs(torch, rng, dev):
    """Burst A's stacked launch (STACKED_SHAPE): each lane's first
    STACKED_REAL rows valid, sorted by (series, ts), 1-minute buckets."""
    b, r, series, buckets = STACKED_SHAPE
    per = STACKED_REAL // 100
    sid = np.zeros((b, r), np.int32)
    ts = np.zeros((b, r), np.int64)
    valid = np.zeros((b, r), bool)
    sid[:, :STACKED_REAL] = np.repeat(np.sort(rng.choice(series, 100, replace=False)), per)
    ts[:, :STACKED_REAL] = np.tile(np.arange(per) * 10_000, 100)
    valid[:, :STACKED_REAL] = True
    vals = rng.uniform(0, 100, (b, r))
    lanes = [torch.from_numpy(a).to(dev) for a in (ts, sid, vals, valid, np.zeros(b, np.int64))]
    return lanes, 60_000, series, buckets


# the widest stacked grid of agg-pair: lanes, padded rows a lane, series
# and buckets a lane's grid (10,000 hosts of TSBS' devops set, 30 minutes of
# 1-minute buckets); every lane but the last holds EMPTY_LANE_REAL rows, the
# last none
EMPTY_LANE_SHAPE = (16, 327_680, 10_000, 30)
EMPTY_LANE_REAL = 300_000
# agg-pair's masked grouped_stats: rows and segments; a row is valid when
# its segment is below a tenth of them (the kept rows bunch there)
MASKED_SHAPE = (4_000_000, 2_000_000)


def empty_lane_inputs(torch, rng, dev):
    """A stacked launch (EMPTY_LANE_SHAPE) with its last lane empty: each
    other lane's first EMPTY_LANE_REAL rows valid, in (series, ts) order."""
    b, r, series, buckets = EMPTY_LANE_SHAPE
    sid = np.zeros((b, r), np.int32)
    ts = np.zeros((b, r), np.int64)
    valid = np.zeros((b, r), bool)
    for lane in range(b - 1):
        s = rng.integers(0, series, EMPTY_LANE_REAL).astype(np.int32)
        t = rng.integers(0, buckets * 60_000, EMPTY_LANE_REAL)
        order = np.lexsort((t, s))
        sid[lane, :EMPTY_LANE_REAL], ts[lane, :EMPTY_LANE_REAL] = s[order], t[order]
        valid[lane, :EMPTY_LANE_REAL] = True
    vals = rng.uniform(0, 100, (b, r))
    lanes = [torch.from_numpy(a).to(dev) for a in (ts, sid, vals, valid, np.zeros(b, np.int64))]
    return lanes, 60_000, series, buckets


def masked_inputs(torch, rng, dev):
    """grouped_stats lanes (values, ids, valid, segments) of MASKED_SHAPE:
    shuffled ids over every segment, about 90 % of the rows masked."""
    n, segs = MASKED_SHAPE
    ids = rng.integers(0, segs, n).astype(np.int32)
    host = (rng.uniform(0, 100, n), ids, ids < segs // 10)
    return (*(torch.from_numpy(a).to(dev) for a in host), segs)


def reduce_times(torch, cs, rng, dev) -> dict:
    from horaedb_tpu_torch.ops import _build, aggregate, blockagg

    _build.build_all(("block_sum_count", "block_min_max", "grouped_stats", "downsample",
                      "stacked_downsample"))
    out = {}
    for name, (k, v, cells) in (("main", cs.main_path_segment_inputs(rng)),
                                ("long_runs", cs.long_run_inputs(rng)),
                                ("sparse", sparse_inputs(cs, rng))):
        kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
        ok = torch.ones_like(vt, dtype=torch.bool)
        w = torch.ones_like(vt)
        out[f"{name}_shape"] = f"{len(k)} rows, {cells} cells"
        out[f"{name}_block_sum_count_ms"] = cs.cuda_ms(
            torch, lambda: blockagg.block_sum_count(kt, vt, cells, weights=w))
        out[f"{name}_block_min_max_ms"] = cs.cuda_ms(
            torch, lambda: blockagg.block_min_max(kt, vt, cells, valid=ok))
        out[f"{name}_main_call_block_sum_count_ms"] = cs.cuda_ms(
            torch, lambda: blockagg.sorted_segment_sum_count(kt, vt, cells, impl="block"))
        out[f"{name}_main_call_block_min_max_ms"] = cs.cuda_ms(
            torch, lambda: blockagg.sorted_segment_min_max(kt, vt, cells, impl="block"))
        if name == "long_runs":
            out[f"{name}_grouped_stats_ms"] = cs.cuda_ms(
                torch, lambda: aggregate.grouped_stats(vt, kt, None, cells))
        del kt, vt, ok, w

    lanes, bucket_ms, series, buckets = stacked_inputs(torch, rng, dev)
    out["stacked_shape"] = f"{list(lanes[0].shape)} padded rows, {series} x {buckets} a lane"
    out["stacked_downsample_ms"] = cs.cuda_ms(
        torch, lambda: aggregate.stacked_downsample(*lanes, bucket_ms, series, buckets))
    del lanes

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


def last_write_lanes(torch, cs, rng, dev, route: str = "u32"):
    """Phase 3k's call of segment_last_value as card lanes (values, seq,
    index, valid, segments). 3k's seq (1..49) packs into u32 keys; route
    "u64" sets one row's seq to 2^33, "wide" to INT64_MAX (no u64 key
    holds it: the 16-byte CAS), so the row pass takes that route at the
    same shape."""
    vals, seq, index, segs, _resend, _want = cs.last_write_inputs(rng)
    if route != "u32":
        seq = seq.copy()
        seq[0] = 2**63 - 1 if route == "wide" else 2**33
    lanes = [torch.from_numpy(a).to(dev) for a in (vals, seq, index)]
    return (*lanes, torch.ones(len(vals), dtype=torch.bool, device=dev), segs)


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


def segment_part(name: str) -> str:
    """The part of a kernel B or C call a profiled kernel is."""
    if "FillFunctor" in name:
        return "ones fill"
    for part in ("fill_kernel", "run_kernel"):
        if f"seg::{part}" in name:
            return part
    return name[:80]


def profile_call(torch, cs, fn, calls: int = 5) -> tuple[dict, int, int]:
    """Device ms a call by segment_part (torch.profiler, the mean of
    `calls` calls: chip_smoke.profiled_events), the device operations a
    call runs, and the device bytes one call allocates (the peak over it
    less what was allocated before)."""
    events = cs.profiled_events(torch, fn, calls)
    parts = {}
    for e in events:
        part = segment_part(e.name)
        parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us() / calls / 1e3
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return parts, len(events) // calls, torch.cuda.max_memory_allocated() - before


def reduce_split(torch, cs, rng, dev) -> dict:
    """Device ms by kernel (torch.profiler, the mean of 5 calls) of one
    grouped_stats and one downsample call at the fused shape, sorted and
    shuffled; and of kernels B and C at phase 4's shape, with explicit
    lanes and as downsample_sorted calls them."""
    from horaedb_tpu_torch.ops import aggregate, blockagg

    out = {}
    k, v, cells = cs.main_path_segment_inputs(rng)
    kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    w = torch.ones_like(vt)
    ok = torch.ones_like(vt, dtype=torch.bool)
    out["main_shape"] = f"{len(k)} rows, {cells} cells"
    for form, b_call, c_call in (
            ("explicit", lambda: blockagg.block_sum_count(kt, vt, cells, weights=w),
             lambda: blockagg.block_min_max(kt, vt, cells, valid=ok)),
            ("main_call", lambda: blockagg.sorted_segment_sum_count(kt, vt, cells, impl="block"),
             lambda: blockagg.sorted_segment_min_max(kt, vt, cells, impl="block"))):
        for name, fn in (("block_sum_count", b_call), ("block_min_max", c_call)):
            parts, kernels, alloc = profile_call(torch, cs, fn)
            out[f"{name}_{form}_ms_by_part"] = parts
            out[f"{name}_{form}_kernels_a_call"] = kernels
            out[f"{name}_{form}_alloc_bytes"] = alloc
    del kt, vt, w, ok
    k, v, cells = cs.long_run_inputs(rng)
    kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    w = torch.ones_like(vt)
    ok = torch.ones_like(vt, dtype=torch.bool)
    for name, fn in (
            ("block_sum_count", lambda: blockagg.block_sum_count(kt, vt, cells, weights=w)),
            ("block_min_max", lambda: blockagg.block_min_max(kt, vt, cells, valid=ok)),
            ("grouped_stats", lambda: aggregate.grouped_stats(vt, kt, None, cells))):
        out[f"long_runs_{name}_ms_by_part"] = profile_call(torch, cs, fn)[0]
    del kt, vt, w, ok
    lanes, bucket_ms, series, buckets = stacked_inputs(torch, rng, dev)
    out["stacked_downsample_ms_by_part"] = profile_call(
        torch, cs, lambda: aggregate.stacked_downsample(*lanes, bucket_ms, series, buckets))[0]
    del lanes
    slv = last_write_lanes(torch, cs, rng, dev)
    out["segment_last_value_shape"] = f"{len(slv[0])} shuffled rows, {slv[4]} segments"
    out["segment_last_value_ms_by_part"] = profile_call(
        torch, cs, lambda: aggregate.segment_last_value(*slv))[0]
    del slv
    try:
        out["run_occupancy"] = cs.segreduce_occupancy()
    except AttributeError:  # a tree whose libraries do not export it
        out["run_occupancy"] = {}

    series, buckets = cs.FUSED_SERIES, cs.FUSED_WINDOW_MS // cs.FUSED_BUCKET_MS
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
    """Events-loop ms, device ms per call (torch.profiler, a window with
    every record: chip_smoke.profiled_events) and host us per call of fn()
    (module docstring)."""
    out = {"events_ms": cs.cuda_ms(torch, fn)}
    torch.cuda.synchronize()
    events = cs.profiled_events(torch, fn, 20)
    split = {}
    for e in events:
        split[e.name[:60]] = split.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 20e3
    out["device_ms"] = sum(split.values())
    out["device_ms_by_kernel"] = split
    out["device_ops"] = len(events) / 20
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


def timed_parts(parts: dict, iters: int = 10_000) -> dict:
    """Host us a call of each part, perf_counter around `iters` calls
    after one."""
    out = {}
    for name, part in parts.items():
        part()
        t = time.perf_counter()
        for _ in range(iters):
            part()
        out[name] = (time.perf_counter() - t) / iters * 1e6
    return out


def _stream_in_context(torch, dev):
    """The launch path the decoders took before `_build.launch`: the
    device context and a Stream object on every launch."""
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


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
    out = timed_parts(parts, iters)
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


def encoded_lanes(cs, rng) -> dict:
    """The lanes phase 4 times the decode kernels on, as the smoke's
    encoded writes make them: the largest SST of phase 3g is its 5 %
    re-send (1.8M rows of TSBS cpu-only's ten fields, sorted by the primary
    key as a write sorts them), whose ts lane encodes as dod, tsid as rle
    and field_id as dict; phase 3h's SSTs hold three scrapes of Prometheus
    `up` (30,000 rows), whose value lane encodes as xor at width 0. Each
    lane through `encode_lane`, as `encode_table` picks its codec. Under
    "xor_f32", a kernel shape and not a main-path one: the re-send's value
    lane (the smoke's TSBS cpu field values, uniform in [0, 100)) cast to
    f32 and encoded with `_encode_xor` directly, at widths <= 32
    (`encode_lane` keeps such a lane raw: it saves less than 1/_MIN_WIN)."""
    from horaedb_tpu_torch.storage import encoding as enc_mod

    tsids, values, resend, new, _final = cs.make_enc_data(rng)
    hosts, fields, scrapes = values.shape
    del values, _final
    order = np.argsort(resend)
    flat = resend[order]  # tsids ascend with the host: flat order is (tsid, field, ts)
    h, rem = np.divmod(flat, fields * scrapes)
    f, sc = np.divmod(rem, scrapes)
    page_rows = enc_mod.DEFAULT_PAGE_ROWS
    lanes = {"tsid": enc_mod.encode_lane("tsid", tsids[h], page_rows),
             "field_id": enc_mod.encode_lane("field_id", f.astype(np.uint64), page_rows),
             "ts": enc_mod.encode_lane("ts", cs.T0 + sc.astype(np.int64) * cs.INTERVAL_MS,
                                       page_rows, prefer_ts=True),
             "up": enc_mod.encode_lane("value", np.ones(3 * hosts), page_rows)}
    out = {lane.codec: (name, lane) for name, lane in lanes.items()}
    f32 = enc_mod._encode_xor(new[order].astype(np.float32), page_rows)
    f32.name = "value"
    out["xor_f32"] = ("value (f32)", f32)
    return out


# the rows `decode_rows` times: (lane key of `encoded_lanes`, codec, kernel, row)
DECODE_ROWS = (("dict", "dict", "decode_unpack", "decode_unpack"),
               ("dod", "dod", "decode_dod", "decode_dod"),
               ("xor", "xor", "decode_xor", "decode_xor"),
               ("rle", "rle", "decode_rle", "decode_rle"),
               ("xor_f32", "xor", "decode_xor", "decode_xor_f32"))


def decode_args(s) -> tuple:
    """The arguments of a decode wrapper for staged pages `s`; a tree whose
    rle pages carry a host-built cumulative lane (`s.cum`) passes it."""
    itemsize = s.dtype.itemsize
    if s.codec == "dict":
        return s.words, s.table, s.dict_bits, s.rows
    if getattr(s, "cum", None) is not None:
        return s.words, s.table, s.cum, s.rows, itemsize
    return s.words, s.table, s.rows, itemsize


def stage_ms(torch, decode, codec, lane, pages, dev, calls: int = 20) -> float:
    """Host ms of one `stage_pages` call (the page checks, the word lane,
    the uploads; after a synchronise), the mean over `calls`."""
    dt = np.dtype(lane.dtype)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        decode.stage_pages(codec, dt, lane.payload, pages, lane.dict_values, dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e3


def decode_rows(torch, cs, dev, lanes: dict, library: bool = True, iters: int = 1000):
    """Each row of DECODE_ROWS on its lane (`encoded_lanes`) through the
    current tree's decode module: its shape, `launch_split`, the host ms of
    its `stage_pages`, its library yardstick where one computes the
    function; and the rows' outputs, each checked equal to its plain
    version's."""
    from horaedb_tpu_torch.ops import decode

    out, rows, staged = {}, {}, {}
    for key, codec, name, row in DECODE_ROWS:
        cs.require(key in lanes, f"no lane encoded as {key}: {sorted(lanes)}")
        lane_name, lane = lanes[key]
        dt = np.dtype(lane.dtype)
        pages = [p for p in lane.pages if decode.in_envelope(codec, dt, p, lane.dict_values)]
        cs.require(len(pages) == len(lane.pages), f"{lane_name}: pages outside the envelope")
        s = decode.stage_pages(codec, dt, lane.payload, pages, lane.dict_values, dev)
        args = decode_args(s)
        kern = getattr(decode, name)
        got = decode.run_pages(s)
        cs.require(torch.equal(got, decode.run_pages_plain(s)), f"{name} != plain on {key}")
        widths = sorted({p.width for p in pages})
        out[f"{row}_shape"] = f"{s.rows} rows, {len(pages)} pages, {lane_name}, widths {widths}"
        out[row] = launch_split(torch, cs, lambda kern=kern, args=args: kern(*args), iters)
        out[row]["stage_pages_ms"] = stage_ms(torch, decode, codec, lane, pages, dev)
        if library:
            lib = cs.decode_library(torch, decode, s, got)
            if lib is not None:
                out[f"{row}_library"] = launch_split(torch, cs, lib[0], iters=100)
        rows[row], staged[key] = got, s
    return out, rows, staged


DECODE_KERNELS = ("decode_unpack", "decode_dod", "decode_xor", "decode_rle")
DECODE_MODULES = (".ops._build", ".ops.decode", ".storage.encoding")


def decode_pair_times(torch, cs, rng, dev, roots: list[tuple[str, str]]) -> dict:
    """The `decode-pair` mode (module docstring): `decode_rows` on the
    trees of `roots` (tag, checkout) in the order parent, change, change,
    parent, with the empty launch beside them in every turn; every turn's
    rows must equal the first turn's bit for bit."""
    trees = {tag: Tree(root, DECODE_MODULES) for tag, root in roots}
    for tree in trees.values():
        use_tree(tree.mods)
        tree.mod("ops._build").build_all(DECODE_KERNELS)
    lanes = encoded_lanes(cs, rng)
    tags = [t for t, _ in roots]
    order = tags + tags[::-1]
    out = {tag: {"package": trees[tag].package, "turns": []} for tag in tags}
    ref = None
    for turn, tag in enumerate(order):
        use_tree(trees[tag].mods)
        split, rows, _staged = decode_rows(torch, cs, dev, lanes, library=turn == 0)
        split["empty_launch"] = launch_split(torch, cs, lambda: torch.cuda._sleep(0))
        out[tag]["turns"].append(split)
        ref = rows if ref is None else ref
        diff = sorted(k for k in ref if not torch.equal(ref[k], rows[k]))
        cs.require(not diff, f"{tag}: decoded rows differ from {order[0]}'s: {diff}")
    out["order"] = order
    out["bitwise_equal"] = True
    return out


def small_rows(torch, cs, rng, dev) -> dict:
    """The split of the other rows under 0.1 ms: the four decode kernels
    on the lanes phase 4 times them on, and decode_xor on an f32 lane of
    the same SST (`encoded_lanes`, `decode_rows`: each with the host ms of
    its `stage_pages`), and the mesh key kernel or slot pass on one slot of
    3l's mesh downsample (3.6M sorted rows, 5,000 series x 48 buckets).
    Each decode also gets its library yardstick where one computes its
    function (chip_smoke.decode_library), and `host_parts_us` the pieces of
    a decode wrapper's host path."""
    from horaedb_tpu_torch.ops import _build
    from horaedb_tpu_torch.ops import decode
    from horaedb_tpu_torch.ops import mesh as mesh_ops

    out, _rows, staged = decode_rows(torch, cs, dev, encoded_lanes(cs, rng))
    dod = staged["dod"]
    p = ctypes.c_void_p
    fn = _build.kernel("decode_dod", "decode_dod_launch", [p, p, ctypes.c_int64, ctypes.c_int,
                                                           p, p])
    out["decode_dod_host_parts_us"] = timed_parts({
        "check": lambda: decode._check("decode_dod", dod.words, dod.table, 8),
        "out_alloc": lambda: decode._out(dod.rows, 8, dev),
        "kernel_lookup": lambda: _build.kernel("decode_dod", "decode_dod_launch",
                                               fn.argtypes[:-1]),
        "device_context_and_stream": lambda: _stream_in_context(torch, dev),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
    })
    series, buckets = cs.NUM_SERIES // 2, cs.WINDOW_MS // cs.BUCKET_MS
    per = 720
    n = series * per
    sid = torch.arange(series, dtype=torch.int32, device=dev).repeat_interleave(per)
    ts = cs.T0 + torch.arange(per, dtype=torch.int64, device=dev).repeat(series) * \
        (cs.WINDOW_MS // per)
    vals = torch.from_numpy(rng.uniform(0, 100, n)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if hasattr(mesh_ops, "sharded_keys"):  # a tree with the key kernel
        out["sharded_downsample_keys_shape"] = f"{n} rows, {series} series x {buckets} buckets"
        out["sharded_downsample_keys"] = launch_split(
            torch, cs, lambda: mesh_ops.sharded_keys(ts, sid, vals, valid, None, cs.T0,
                                                     cs.BUCKET_MS, 0, series, buckets))
    if hasattr(mesh_ops, "slot_grids"):  # a tree with the slot pass
        out["sharded_downsample_slot_shape"] = f"{n} rows, {series} series x {buckets} buckets"
        out["sharded_downsample_slot"] = launch_split(
            torch, cs, lambda: mesh_ops.slot_grids(ts, sid, vals, valid, None, cs.T0,
                                                   cs.BUCKET_MS, 0, series, buckets, True))
    out.update(aggregate_launches(torch, cs, rng, dev))
    return out


def aggregate_launches(torch, cs, rng, dev) -> dict:
    """launch_split of the three launch paths of ops/aggregate.py at small
    shapes, where the host path is the call's time: grouped_stats (rows 5
    and 8 launch through it) over 4,096 shuffled rows into 1,024 segments,
    stacked_downsample (row 7) over [2, 2,048] lanes of 16 series x 8
    buckets, segment_last_value (row 9) over 4,096 rows into 1,024
    segments."""
    from horaedb_tpu_torch.ops import aggregate

    n, segs = 4_096, 1_024
    idx = torch.from_numpy(rng.integers(0, segs, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.normal(size=n)).to(dev)
    seq = torch.from_numpy(rng.integers(0, 2**40, n)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    b, r = 2, 2_048
    lanes = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 8 * 1_000, (b, r)).astype(np.int64),
        rng.integers(0, 16, (b, r)).astype(np.int32), rng.normal(size=(b, r)),
        np.ones((b, r), bool), np.zeros(b, np.int64))]
    return {
        "grouped_stats_small": launch_split(
            torch, cs, lambda: aggregate.grouped_stats(vals, idx, None, segs)),
        "stacked_downsample_small": launch_split(
            torch, cs, lambda: aggregate.stacked_downsample(*lanes, 1_000, 16, 8)),
        "segment_last_value_small": launch_split(
            torch, cs, lambda: aggregate.segment_last_value(vals, seq, idx, valid, segs))}


# (part, pattern of the profiler's kernel name), the first match wins;
# radix::scan_kernel right after a radix::hist_kernel is a digit pass's
# scan of its (digit, tile) counts, elsewhere a compaction's tile scan
DIGIT_SCAN = "digit passes' scan (radix::scan_kernel, one block)"
MERGE_PARTS = (
    ("predicate", ("predicate", "program")),
    ("partition", ("MaskFlag", "NotSentinel", "RowFlag")),
    ("compaction", ("KeepLast", "AllFlag", "AllRowIds", "AllRows")),
    ("tile scan (one block)", ("radix::scan_kernel", "compact::tile_scan_kernel")),
    ("key passes", ("onesweep::key_kernel", "onesweep::decide_kernel", "onesweep::zero_kernel",
                    "onesweep::compact_kernel", "radix::gather_kernel", "iota_kernel")),
    ("digit sweeps", ("onesweep::sweep_kernel",)),
    ("digit passes (radix::hist_kernel, radix::scatter_kernel)",
     ("radix::hist_kernel", "radix::scatter_kernel")),
    ("bucket scatter", ("starts_kernel", "fill_kernel", "scatter_kernel")),
    ("copies and the exchange's torch ops", ("Memcpy", "at::native")),
    ("memsets", ("Memset",)),
)


def merge_part(name: str, parts=MERGE_PARTS, prev: str = "") -> str:
    if "radix::scan_kernel" in name and "radix::hist_kernel" in prev:
        return DIGIT_SCAN
    for part, patterns in parts:
        if any(p in name for p in patterns):
            return part
    return "other"


def merge_split(torch, cs, fn, iters: int = 50, parts=MERGE_PARTS) -> dict:
    """launch_split's events, device and host times of fn(), with the
    device time also split into `parts` (MERGE_PARTS by default)."""
    out = {"events_ms": cs.cuda_ms(torch, fn, iters=10, warmup=2)}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    by_kernel, by_part = {}, {}
    prev = ""
    for e in sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        ms = e.time_range.elapsed_us() / 5e3
        name = cs.kernel_name(e.name)
        by_kernel[name] = by_kernel.get(name, 0.0) + ms
        part = merge_part(name, parts, prev)
        by_part[part] = by_part.get(part, 0.0) + ms
        if not name.startswith(("Memcpy", "Memset")):
            prev = name
    out["device_ms"] = sum(by_kernel.values())
    out["device_ms_by_part"] = dict(sorted(by_part.items(), key=lambda kv: -kv[1]))
    out["device_ms_by_kernel"] = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t_host = time.perf_counter()
    torch.cuda.synchronize()
    out["host_us"] = (t_host - t) / iters * 1e6
    out["wall_us"] = (time.perf_counter() - t) / iters * 1e6
    return out


def merge_times(torch, cs, rng, dev) -> dict:
    from horaedb_tpu_torch.backend import order_key
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.ops import merge
    from horaedb_tpu_torch.parallel import merge as pmerge
    from horaedb_tpu_torch.storage.read import _pack_sort_keys, predicate_lanes, sort_key_lanes

    data = cs.make_data(rng)
    seg = cs.segment_runs(rng, data, 0)
    n = len(seg["ts"])
    keys, bounds, num_pk, key_names = sort_key_lanes(seg.__getitem__, cs.SORT_KEYS, dev)
    mask = torch.from_numpy((seg["metric_id"] == cs.METRIC_ID).astype(np.uint8)).to(dev)
    out = {"index_merge_mask_shape": f"{n} rows x {len(keys)} key lanes ({', '.join(key_names)})"}
    out["index_merge_mask"] = merge_split(
        torch, cs, lambda: merge.index_merge_mask(keys, bounds, num_pk, mask, True, False))
    subset = np.sort(rng.choice(data[0], cs.SUBSET, replace=False))
    pred = F.And(F.InSet("tsid", tuple(int(t) for t in subset)),
                 F.time_range_pred("ts", cs.T0 + 600_000, cs.T0 + cs.SEGMENT_MS - 600_000))
    pcols = {c: seg[c] for c in ("tsid", "ts")}
    prog = F.compile_program(pred, {c: a.dtype for c, a in pcols.items()})
    plane = predicate_lanes(pcols, dict(zip(key_names, keys)), dev)
    _idx, kept = merge.index_merge_filter(keys, bounds, num_pk, prog, plane, n, True, False, dev)
    out["index_merge_filter_shape"] = (f"as index_merge_mask, InSet of {cs.SUBSET} + ts range, "
                                       f"{int(kept.item())} survivors")
    out["index_merge_filter"] = merge_split(
        torch, cs, lambda: merge.index_merge_filter(keys, bounds, num_pk, prog, plane, n, True,
                                                    False, dev))
    packed, width, bits = _pack_sort_keys(seg.__getitem__, ("series_id", "ts", "__seq__"), n)
    key = torch.from_numpy(order_key(packed)).to(dev)
    got, want = merge.packed_merge(key, bits, width, True), merge.packed_merge_plain(key, width,
                                                                                     True)
    cs.require(cs.same_survivors(torch, got, want), "packed_merge differs from its plain version")
    out["packed_merge_shape"] = (f"{n} rows, {bits}-bit key (series_id, ts, seq rank), "
                                 f"{int(got[1].item())} survivors")
    del got, want
    out["packed_merge"] = merge_split(torch, cs, lambda: merge.packed_merge(key, bits, width,
                                                                            True))
    out["packed_merge"]["plain_ms"] = cs.cuda_ms(
        torch, lambda: merge.packed_merge_plain(key, width, True), iters=5)
    out["packed_merge"]["library_ms"] = cs.cuda_ms(
        torch, lambda: cs.packed_merge_library(torch, key, width), iters=5)
    mesh = cs.card_mesh(torch, dev, cs.MERGE_SLOTS)
    plan = pmerge.SamplePlan(packed, width, True, mesh, bits)
    out["sample_sort_merge_shape"] = (f"{n} rows over {plan.d_slots} slots of one card, "
                                      f"{bits}-bit key")
    out["sample_sort_merge"] = merge_split(torch, cs, plan.run, iters=10)
    out["one_key_sort_ms"] = cs.cuda_ms(torch, lambda: torch.sort(key, stable=True), iters=5)
    out["scans"] = asyncio.run(scan_times(torch, cs, rng, dev, data))
    return out


# (part, patterns of the profiler's kernel name), the first match wins
SORT_PARTS = (
    ("predicate", ("predicate", "program")),
    ("partition", ("RowFlag", "MaskFlag")),
    ("tile scan (one block)", ("radix::scan_kernel", "compact::tile_scan_kernel")),
    ("key passes", ("onesweep::key_kernel", "onesweep::decide_kernel", "onesweep::zero_kernel",
                    "onesweep::compact_kernel", "radix::gather_kernel", "iota_kernel")),
    ("digit sweeps", ("onesweep::sweep_kernel", "radix::hist_kernel", "radix::scatter_kernel")),
    ("lane gather", ("gather_kernel",)),
    ("flags", ("flags_kernel",)),
    ("copies", ("Memcpy",)),
    ("memsets", ("Memset",)),
)


def fused_scan_inputs(torch, cs, rng, dev):
    """scan_kernel's arguments at the fused query's main shape (phase 3e),
    built on the card: rows of FUSED_SERIES series x 60 samples in (tsid,
    ts) order, read back as 20 writes of shuffled rows each sorted as its
    SST is, then the 5 % re-send (seq rank 20)."""
    from horaedb_tpu_torch.backend import u64_to_i64
    from horaedb_tpu_torch.ops import filter as F

    per = cs.FUSED_WINDOW_MS // cs.INTERVAL_MS
    n0 = cs.FUSED_SERIES * per
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2**31)))
    parts = torch.randperm(n0, device=dev, generator=gen).chunk(cs.FUSED_WRITES)
    resend = torch.randperm(n0, device=dev, generator=gen)[: int(n0 * cs.RESEND_FRACTION)]
    src = torch.cat([torch.sort(p).values for p in parts] + [torch.sort(resend).values])
    seq = torch.cat([torch.full((len(p),), i, dtype=torch.int64, device=dev)
                     for i, p in enumerate(list(parts) + [resend])])
    del parts, resend
    tsids = np.sort(rng.choice(np.unique(rng.integers(1, 2**64 - 1, cs.FUSED_SERIES * 2,
                                                      dtype=np.uint64)),
                               cs.FUSED_SERIES, replace=False))
    tsid = torch.from_numpy(u64_to_i64(tsids)).to(dev)[src // per]
    ts = cs.T0 + (src % per) * cs.INTERVAL_MS
    n = len(src)
    metric = torch.full((n,), int(u64_to_i64(np.array([cs.METRIC_ID], np.uint64))[0]),
                        dtype=torch.int64, device=dev)
    lanes = {"metric_id": metric, "tsid": tsid, "field_id": torch.full_like(metric, -(2**63)),
             "ts": ts, "value": torch.rand(n, dtype=torch.float64, device=dev, generator=gen),
             "__seq__": seq + 10**18, "__reserved__": torch.zeros_like(metric),
             "__sid__": (src // per).to(torch.int32)}
    keys = [tsid, ts, seq]
    bounds = [(int(k.min()), int(k.max())) for k in keys]
    pred = F.And(F.Compare("metric_id", "eq", cs.METRIC_ID),
                 F.time_range_pred("ts", cs.T0, cs.T0 + cs.FUSED_WINDOW_MS))
    prog = F.compile_program(pred, {"metric_id": np.dtype(np.uint64), "ts": np.dtype(np.int64)})
    return lanes, keys, bounds, prog, n


def sort_split(torch, cs, rng, dev) -> dict:
    """Rows 21 and 4 split by part (module docstring)."""
    from horaedb_tpu_torch.backend import order_key
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.ops import scan as scan_ops
    from horaedb_tpu_torch.ops import sort as sort_ops

    out = {}
    lanes, keys, bounds, prog, n = fused_scan_inputs(torch, cs, rng, dev)

    def kern():
        return scan_ops.scan_kernel(lanes, keys, bounds, 2, prog, n, True, False, dev)

    def plain():
        return scan_ops.scan_kernel_plain(lanes, keys, 2, F.eval_program_plain(prog, lanes, n),
                                          True, False)

    got, want = kern(), plain()
    k = int(got[4].item())
    cs.require(k == int(want[4].item()) == n and torch.equal(got[1][:k], want[1][:k])
               and torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
               "scan_kernel differs from its plain version")
    del got, want
    out["scan_kernel_shape"] = (f"{n} rows, key lanes tsid, ts, seq rank {bounds}, "
                                f"{len(lanes)} gathered lanes, the predicate on the device")
    out["scan_kernel"] = merge_split(torch, cs, kern, iters=10, parts=SORT_PARTS)
    out["scan_kernel"]["plain_ms"] = cs.cuda_ms(torch, plain, iters=3, warmup=1)
    out["scan_kernel"]["one_key_sort_ms"] = cs.cuda_ms(
        torch, lambda: torch.sort(keys[0], stable=True), iters=5, warmup=1)
    del lanes, keys

    m = round(cs.NUM_SERIES * cs.WINDOW_MS / cs.INTERVAL_MS * (1 + cs.RESEND_FRACTION) / 50)
    series = rng.integers(0, 2**64 - 1, cs.NUM_SERIES, dtype=np.uint64, endpoint=True)
    host = [series[rng.integers(0, cs.NUM_SERIES, m)],
            cs.T0 + rng.integers(0, cs.SEGMENT_MS // cs.INTERVAL_MS, m) * cs.INTERVAL_MS]
    skeys = [torch.from_numpy(order_key(a)).to(dev) for a in host]
    sbounds = [(int(k.min()), int(k.max())) for k in skeys]
    cs.require(torch.equal(sort_ops.sort_perm(skeys, sbounds), sort_ops.sort_perm_plain(skeys)),
               "sort_perm differs from its plain version")
    out["sort_perm_shape"] = f"{m} rows x 2 keys (tsid, ts) {sbounds}"
    out["sort_perm"] = merge_split(torch, cs, lambda: sort_ops.sort_perm(skeys, sbounds),
                                   parts=SORT_PARTS)
    out["sort_perm"]["plain_ms"] = cs.cuda_ms(torch, lambda: sort_ops.sort_perm_plain(skeys))
    out["sort_perm"]["one_key_sort_ms"] = cs.cuda_ms(
        torch, lambda: torch.sort(skeys[0], stable=True))
    return out


async def default_device_reads(torch, cs, rng, dev) -> dict:
    """The `default-device` mode (module docstring)."""
    import pyarrow as pa

    from horaedb_tpu_torch import launch_counts, reset_launch_counts
    from horaedb_tpu_torch.engine import MetricEngine, QueryRequest
    from horaedb_tpu_torch.engine_query import query_downsample
    from horaedb_tpu_torch.objstore import MemStore
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.serving import ServingTierConfig
    from horaedb_tpu_torch.storage import ObjectBasedStorage, ScanRequest, TimeRange, WriteRequest

    series = 1 << 17  # the packed pass declines at 2^17 series: the fused route
    tsids = np.sort(rng.choice(np.unique(rng.integers(1, 2**64 - 1, 2 * series, dtype=np.uint64)),
                               series, replace=False))
    used = np.sort(rng.choice(series, 300, replace=False))
    n = 3000
    sid = used[rng.integers(0, len(used), n)]
    ts = cs.T0 + rng.integers(0, cs.SEGMENT_MS // 60_000, n) * 60_000
    seg = TimeRange(cs.T0, cs.T0 + cs.SEGMENT_MS)
    batch = pa.RecordBatch.from_pydict(
        {"metric_id": np.full(n, cs.METRIC_ID, np.uint64), "tsid": tsids[sid],
         "field_id": np.zeros(n, np.uint64), "ts": ts, "value": rng.normal(size=n)},
        schema=cs.arrow_schema(False))
    inset = F.And(F.InSet("tsid", tuple(int(t) for t in tsids[used[::3]])),
                  F.time_range_pred("ts", seg.start + 600_000, seg.end - 600_000))
    fpred = F.And(F.Compare("metric_id", "eq", cs.METRIC_ID),
                  F.time_range_pred("ts", seg.start, seg.end))
    tags = cs.engine_hosts(rng)[0][:100]
    writer = cs.PayloadWriter(tags, cs.CPU_FIELDS[:1])
    payload = writer.payload(rng.uniform(0, 100, (len(tags), cs.ENGINE_PER_PAYLOAD)),
                             cs.T0 + np.arange(cs.ENGINE_PER_PAYLOAD) * cs.INTERVAL_MS)
    query = QueryRequest(metric=b"cpu_usage_user", start_ms=cs.T0,
                         end_ms=cs.T0 + cs.ENGINE_PER_PAYLOAD * cs.INTERVAL_MS,
                         filters=[tags[0][0]])  # raw rows: the storage scan's device merge

    async def reads(kw) -> dict:
        got = {"launches": {}}
        st = await ObjectBasedStorage.try_new("db", MemStore(), cs.arrow_schema(False), 4,
                                              cs.SEGMENT_MS, enable_compaction_scheduler=False,
                                              start_background_merger=False, **kw)
        got["device"] = str(st._device)
        await st.write(WriteRequest(batch, seg))
        for name, read in (
                ("inset_scan", lambda: cs.timed_scan(st, ScanRequest(seg, predicate=inset))),
                ("fused_query", lambda: query_downsample(st, tsids, seg, 30 * 60_000, fpred))):
            reset_launch_counts()
            try:
                with cs.EnvPin(**({"HORAEDB_SCAN_PATH": "device"} if name == "inset_scan"
                                  else {})):
                    r = await read()
                got[name] = cs.table_lanes(r[0]) if name == "inset_scan" else r
            except Exception as e:  # the fault under study: report it, never hide it
                got[name] = f"{type(e).__name__}: {e}"
            got["launches"][name] = {k: v for k, v in launch_counts().items() if v}
        await st.close()
        try:
            eng = await MetricEngine.open("eng", MemStore(), enable_compaction=False,
                                          serving=ServingTierConfig(enabled=False), **kw)
            try:
                await eng.write_payload(payload)
                reset_launch_counts()
                with cs.EnvPin(HORAEDB_SCAN_PATH="device"):
                    got["engine_query"] = cs.table_lanes(await eng.query(query))
                got["launches"]["engine_query"] = {k: v for k, v in launch_counts().items() if v}
            finally:
                await eng.close()
        except Exception as e:
            got["engine_query"] = f"{type(e).__name__}: {e}"
        return got

    default = await reads({})
    card0 = await reads({"device": dev})
    out = {"default_device": default.pop("device"), "cuda0_device": card0.pop("device"),
           "default_launches": default.pop("launches"), "cuda0_launches": card0.pop("launches")}
    for name, want in card0.items():
        got = default[name]
        if isinstance(got, str) or isinstance(want, str):
            out[name] = {"default": got if isinstance(got, str) else "ok",
                         "cuda0": want if isinstance(want, str) else "ok"}
        else:
            out[name] = {"default": "ok", "cuda0": "ok", "bitwise_equal": cs.lanes_equal(got, want)}
    return out


async def scan_times(torch, cs, rng, dev, data, runs: int = 7) -> dict:
    """End to end: segment 0 of the data written as chip_smoke's phase 3a
    writes it, then `runs` raw scans of it, host clock after a synchronise,
    after one warm-up, on the two routes that launch kernel F: the
    planner's own (a metric_id predicate) and HORAEDB_SCAN_PATH=device with
    an InSet of 1,000 tsids and a ts range (index_merge_filter)."""
    from horaedb_tpu_torch import launch_counts, reset_launch_counts
    from horaedb_tpu_torch.objstore import LocalStore
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.storage import ObjectBasedStorage, ScanRequest, TimeRange

    seg0 = TimeRange(cs.T0, cs.T0 + cs.SEGMENT_MS)
    subset = np.sort(rng.choice(cs.NUM_SERIES, cs.SUBSET, replace=False))
    inset = F.And(F.InSet("tsid", tuple(int(v) for v in data[0][subset])),
                  F.time_range_pred("ts", cs.T0 + 600_000, cs.T0 + cs.SEGMENT_MS - 600_000))
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_ab_") as workdir:
        st = await ObjectBasedStorage.try_new(
            "tsbs", LocalStore(workdir), cs.arrow_schema(False), 4, cs.SEGMENT_MS,
            enable_compaction_scheduler=False, start_background_merger=False, device=dev)
        await cs.write_all(st, rng, data, segments=(0,))
        for name, pred, env in (
                ("auto_metric_eq", F.Compare("metric_id", "eq", cs.METRIC_ID), {}),
                ("device_inset_1000", inset, {"HORAEDB_SCAN_PATH": "device"})):
            secs = []
            with cs.EnvPin(**env):
                for i in range(runs + 1):
                    reset_launch_counts()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    rows = 0
                    async for b in st.scan(ScanRequest(seg0, predicate=pred)):
                        rows += b.num_rows
                    torch.cuda.synchronize()
                    if i:
                        secs.append(time.perf_counter() - t)
            out[name] = {"rows": rows, "s": secs, "median_s": float(np.median(secs)),
                         "route": sorted(k for k, v in launch_counts().items() if v)}
        await st.close()
    return out


PKG = "horaedb_tpu_torch"


def _pkg_modules() -> dict:
    return {k: m for k, m in sys.modules.items() if k == PKG or k.startswith(PKG + ".")}


def use_tree(mods: dict) -> None:
    """Put one checkout's package modules in sys.modules, so that the
    imports its code makes inside functions resolve to that checkout."""
    for k in _pkg_modules():
        del sys.modules[k]
    sys.modules.update(mods)


# the modules a mesh step and the rows beside it import, lazily ones included
MESH_MODULES = tuple(f".ops.{m}" for m in (
    "_build", "agg_registry", "aggregate", "blockagg", "blocks", "decode", "dedup", "filter",
    "keychain", "merge", "mesh", "scan", "sort")) + (".parallel.merge", ".parallel.scan")


def load_tree(root: str, extra: tuple = ()) -> dict:
    """Import the package of checkout `root`, and the modules burst A and
    the scans drive (and `extra`), apart from any copy already imported;
    its sys.modules entries, for use_tree."""
    use_tree({})
    path = os.path.abspath(root)
    sys.path.insert(0, path)
    try:
        for name in ("", ".common.time_ext", ".engine", ".objstore", ".ops.filter",
                     ".parallel.mesh", ".server.batching", ".serving", ".storage",
                     ".storage.scanstats") + extra:
            importlib.import_module(PKG + name)
    finally:
        sys.path.remove(path)
    return _pkg_modules()


class Tree:
    """One checkout's package, loaded beside another in one process."""

    def __init__(self, root: str, extra: tuple = ()):
        self.mods = load_tree(root, extra)
        self.package = os.path.dirname(self.mods[PKG].__file__)

    def mod(self, name: str):
        return self.mods[f"{PKG}.{name}" if name else PKG]


class BurstTree(Tree):
    """Phase 3i's engine and burst A on one checkout's package."""

    eng = None

    async def close(self) -> None:
        if self.eng is not None:
            use_tree(self.mods)
            await self.eng.close()

    async def open(self, torch, cs, dev, workdir: str, writer, flat, ts0) -> float:
        """The engine, written with chip_smoke's 60 payloads; the seconds
        the writes took, payload encoding included."""
        use_tree(self.mods)
        os.makedirs(workdir)
        self.eng = await self.mod("engine").MetricEngine.open(
            "tsbs_engine", self.mod("objstore").LocalStore(workdir), enable_compaction=False,
            serving=self.mod("serving").ServingTierConfig(enabled=False), device=dev)
        t = time.perf_counter()
        for p in range(cs.ENGINE_SCRAPES // cs.ENGINE_PER_PAYLOAD):
            sl = slice(p * cs.ENGINE_PER_PAYLOAD, (p + 1) * cs.ENGINE_PER_PAYLOAD)
            await self.eng.write_payload(writer.payload(flat[:, sl], ts0[sl]))
        torch.cuda.synchronize()
        batching = self.mod("server.batching")
        self.batcher = batching.GLOBAL_BATCHER
        self.batcher.configure(batching.BatchingConfig(
            max_delay=self.mod("common.time_ext").ReadableDuration.millis(cs.ENGINE_MAX_DELAY_MS)))
        return time.perf_counter() - t

    async def round(self, cs, racks: list) -> tuple[float, float, dict]:
        """The panels one by one with HORAEDB_BATCH=off, then together: the
        solo queries' summed seconds, the burst's wall and its launches."""
        use_tree(self.mods)
        port, scanstats = self.mod(""), self.mod("storage.scanstats")
        reqs = [self.mod("engine").QueryRequest(
            metric=b"cpu_usage_user", start_ms=cs.T0, end_ms=cs.T0 + cs.ENGINE_WINDOW_MS,
            bucket_ms=cs.ENGINE_BUCKET_MS, filters=[(b"rack", b"%d" % r)]) for r in racks]

        async def one(req):
            with scanstats.scan_stats():  # as chip_smoke's burst: a collector a panel
                return await self.eng.query(req)

        solo, secs = [], 0.0
        with cs.EnvPin(HORAEDB_BATCH="off"):
            for req in reqs:
                t = time.perf_counter()
                solo.append(await self.eng.query(req))
                secs += time.perf_counter() - t
        port.reset_launch_counts()
        tok = self.batcher.begin()  # the dashboard's token: the first panel waits too
        try:
            t = time.perf_counter()
            got = await asyncio.gather(*(one(req) for req in reqs))
            wall = time.perf_counter() - t
        finally:
            self.batcher.end(tok)
        counts = port.launch_counts()
        cs.require(counts["stacked_downsample"] == 1,
                   f"burst A launched stacked_downsample {counts['stacked_downsample']} times")
        cs.require(all(cs.same_answer(g, w) for g, w in zip(got, solo)),
                   "burst A differs from its HORAEDB_BATCH=off run")
        return secs, wall, {k: v for k, v in counts.items() if v}


async def burst_times(torch, cs, rng, dev, rounds: int, roots: list[tuple[str, str]]) -> dict:
    """Burst A on each (tag, checkout) of `roots`, each with its own engine
    written with the same payloads; the trees take turns a round, the first
    going first in even rounds, after a warm-up round."""
    tags, rack = cs.engine_hosts(rng)
    values = rng.uniform(0, 100, (cs.NUM_SERIES, len(cs.CPU_FIELDS), cs.ENGINE_SCRAPES))
    flat = values.reshape(cs.NUM_SERIES * len(cs.CPU_FIELDS), cs.ENGINE_SCRAPES)
    ts0 = cs.T0 + np.arange(cs.ENGINE_SCRAPES, dtype=np.int64) * cs.INTERVAL_MS
    writer = cs.PayloadWriter(tags, cs.CPU_FIELDS)
    per_rack = np.bincount(rack, minlength=100)
    racks = [r for r in range(100) if 65 <= per_rack[r] <= 128][:cs.BURST_A_PANELS]
    cs.require(len(racks) == cs.BURST_A_PANELS, f"only {len(racks)} racks hold 65-128 hosts")
    trees = {tag: BurstTree(root) for tag, root in roots}
    out = {tag: {"package": tree.package, "solo_sum_s": [], "burst_s": []}
           for tag, tree in trees.items()}
    with tempfile.TemporaryDirectory(prefix="chip_ab_") as workdir:
        try:
            for tag, tree in trees.items():
                out[tag]["write_s"] = await tree.open(torch, cs, dev, f"{workdir}/{tag}", writer,
                                                      flat, ts0)
            for r in range(rounds + 1):
                for tag in list(trees) if r % 2 == 0 else list(trees)[::-1]:
                    secs, wall, out[tag]["launches"] = await trees[tag].round(cs, racks)
                    if r:
                        out[tag]["solo_sum_s"].append(secs)
                        out[tag]["burst_s"].append(wall)
        finally:
            for tree in trees.values():
                await tree.close()
    for o in out.values():
        for k in ("solo_sum_s", "burst_s"):
            o[f"{k[:-2]}_median_s"] = float(np.median(o[k]))
    return {"panels": len(racks), "hosts": int(per_rack[racks].sum()), "trees": out}


class ScanTree(Tree):
    """Segment 0 of chip_smoke's data on one checkout's package, written as
    phase 3a writes it twice: the 4-key table and 3d's dense table. The
    package's `index_merge_mask` and `index_merge_filter` are wrapped in a
    pair of CUDA events each, which time their device work inside a scan."""

    def __init__(self, root: str):
        super().__init__(root)
        self.tables, self.events = {}, []
        merge = self.mod("ops.merge")
        for name in ("index_merge_mask", "index_merge_filter"):
            setattr(merge, name, self._timed(getattr(merge, name)))

    def _timed(self, fn):
        import torch

        def call(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return res
        return call

    async def open(self, torch, cs, dev, workdir: str, data, seed: int) -> None:
        use_tree(self.mods)
        rng = np.random.default_rng(seed)  # the same writes for every tree
        store = self.mod("objstore").LocalStore(workdir)
        storage = self.mod("storage")
        for name, dense in (("tsbs", False), ("dense", True)):
            st = await storage.ObjectBasedStorage.try_new(
                name, store, cs.arrow_schema(dense), 2 if dense else 4, cs.SEGMENT_MS,
                enable_compaction_scheduler=False, start_background_merger=False, device=dev)
            await cs.write_all(st, rng, data, dense=dense, segments=(0,))
            self.tables[name] = st
        self.mesh8 = cs.card_mesh(torch, dev, cs.MERGE_SLOTS)

    async def scan(self, torch, cs, route: str, inset_ids) -> tuple:
        """One raw scan of segment 0 on `route`: its table, host seconds
        after a synchronise, the kernels it launched and the caching
        allocator's device allocations (cudaMalloc calls) during it; the
        index merges' device ms in it are left in `merge_ms`."""
        use_tree(self.mods)
        F, storage = self.mod("ops.filter"), self.mod("storage")
        set_active_mesh = self.mod("parallel.mesh").set_active_mesh
        seg0 = storage.TimeRange(cs.T0, cs.T0 + cs.SEGMENT_MS)
        pred, table, env = None, "tsbs", {}
        if route == "auto_metric_eq":
            pred = F.Compare("metric_id", "eq", cs.METRIC_ID)
        elif route == "device_inset_1000":
            pred = F.And(F.InSet("tsid", tuple(int(v) for v in inset_ids)),
                         F.time_range_pred("ts", cs.T0 + 600_000, cs.T0 + cs.SEGMENT_MS - 600_000))
            env = {"HORAEDB_SCAN_PATH": "device"}
        else:  # 3l's sharded scan of the dense table on 8 slots
            table, env = "dense", {"HORAEDB_SCAN_PATH": "sharded"}
        self.mod("").reset_launch_counts()
        set_active_mesh(self.mesh8 if route == "sharded" else None)
        self.events.clear()
        allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
        try:
            with cs.EnvPin(**env):
                torch.cuda.synchronize()
                got, secs = await cs.timed_scan(self.tables[table],
                                                storage.ScanRequest(seg0, predicate=pred))
        finally:
            set_active_mesh(None)
        allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs
        torch.cuda.synchronize()
        self.merge_ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events.clear()
        return got, secs, sorted(k for k, v in self.mod("").launch_counts().items() if v), allocs

    async def close(self) -> None:
        use_tree(self.mods)
        for st in self.tables.values():
            await st.close()


SCAN_ROUTES = {"auto_metric_eq": "index_merge_mask", "device_inset_1000": "index_merge_filter",
               "sharded": "sample_sort_merge"}


async def scan_pair_times(torch, cs, rng, dev, rounds: int, roots: list[tuple[str, str]],
                          seed: int, warm_turn: bool) -> dict:
    """The raw scans that launch rows 19, 20 and 14 on each (tag, checkout)
    of `roots`, in one process: the trees take turns every round (the first
    going first in even rounds), after a warm-up round in which every route
    must launch its kernel and give the first tree's table lane for lane.
    With `warm_turn`, an untimed scan opens each turn, so that no timed scan
    follows the other tree's."""
    data = cs.make_data(rng)
    inset_ids = data[0][np.sort(rng.choice(cs.NUM_SERIES, cs.SUBSET, replace=False))]
    trees = {tag: ScanTree(root) for tag, root in roots}
    out = {tag: {"package": tree.package, **{r: [] for r in SCAN_ROUTES},
                 **{f"{r}_device_allocs": [] for r in ("opening", *SCAN_ROUTES)},
                 **{f"{r}_merge_ms": [] for r in SCAN_ROUTES if r != "sharded"}}
           for tag, tree in trees.items()}
    rows = {}
    with tempfile.TemporaryDirectory(prefix="chip_ab_") as workdir:
        try:
            for tag, tree in trees.items():
                await tree.open(torch, cs, dev, f"{workdir}/{tag}", data, seed)
            for r in range(rounds + 1):
                first = {}
                for tag in list(trees) if r % 2 == 0 else list(trees)[::-1]:
                    if warm_turn:
                        *_, allocs = await trees[tag].scan(torch, cs, "auto_metric_eq", inset_ids)
                        if r:
                            out[tag]["opening_device_allocs"].append(allocs)
                    for route, kernel in SCAN_ROUTES.items():
                        got, secs, launched, allocs = await trees[tag].scan(torch, cs, route,
                                                                            inset_ids)
                        cs.require(kernel in launched, f"{tag} {route}: launched {launched}")
                        if r == 0:
                            lanes = cs.table_lanes(got)
                            cs.require(route not in first or cs.lanes_equal(lanes, first[route]),
                                       f"{tag} {route}: differs from the other tree's scan")
                            first[route] = lanes
                            rows[route] = int(got.num_rows)
                        else:
                            out[tag][route].append(secs)
                            out[tag][f"{route}_device_allocs"].append(allocs)
                            if route != "sharded":
                                out[tag][f"{route}_merge_ms"].append(trees[tag].merge_ms)
        finally:
            for tree in trees.values():
                await tree.close()
    for o in out.values():
        for route in SCAN_ROUTES:
            o[f"{route}_median_s"] = float(np.median(o[route]))
    return {"rows": rows, "trees": out}


# the mesh steps' device work by part (the first match wins)
MESH_PARTS = (
    ("key kernel (keys_kernel)", ("keys_kernel",)),
    ("slot pass (sorted rows)", ("slot_run_kernel", "SlotKeys")),
    ("sort: key pass, decide, partition", ("onesweep::key_kernel", "onesweep::decide_kernel",
                                           "onesweep::zero_kernel",
                                           "onesweep::compact_kernel")),
    ("sort: digit sweeps", ("onesweep::sweep_kernel",)),
    ("fold: seg::fill_kernel", ("seg::fill_kernel",)),
    ("fold: seg::run_kernel", ("seg::run_kernel",)),
    ("grouped_stats' mean_kernel", ("mean_kernel",)),
    ("grid_fold", ("grid_fold",)),
    ("copies (stack, cat)", ("Memcpy", "CatArrayBatchedCopy", "copy")),
    ("memsets", ("Memset",)),
    ("torch elementwise (clamp, the mean)", ("at::native",)),
)


def mesh_step_inputs(cs, rng) -> dict:
    """Host lanes of 3l's two mesh steps. Row 16: one 2 h segment of the
    packed downsample, NUM_SERIES series x 720 scrapes in (series, ts)
    order, over the 48 buckets of the window (the first call of 3l's mesh
    downsample). Row 17: the 3-axis step over two such segments, [2, 7.2M]
    lanes in the same order, each segment's own t0 and 24 buckets."""
    per = cs.SEGMENT_MS // cs.INTERVAL_MS
    sid = np.repeat(np.arange(cs.NUM_SERIES, dtype=np.int32), per)
    ts = [cs.T0 + g * cs.SEGMENT_MS + np.tile(np.arange(per, dtype=np.int64) * cs.INTERVAL_MS,
                                               cs.NUM_SERIES) for g in (0, 1)]
    vals = rng.uniform(0, 100, (2, len(sid)))
    return {"sorted": (ts[0], sid, vals[0], np.ones(len(sid), bool)),
            "seg": (np.stack(ts), np.stack([sid, sid]), vals, np.ones((2, len(sid)), bool)),
            "t0_seg": np.array([cs.T0, cs.T0 + cs.SEGMENT_MS], np.int64)}


def digest(torch, grids) -> str:
    """A digest of the grids' bits, computed on the device: per f64 grid (a
    dict's sum, count, min, max, those it holds, in that order, or a
    tuple's in theirs) the wrapping int64 sum of its words times 1, 3, 5,
    ..., by position."""
    if isinstance(grids, dict):
        grids = [grids[k] for k in ("sum", "count", "min", "max") if k in grids]
    out = []
    for t in grids:
        v = t.contiguous().reshape(-1).view(torch.int64)
        w = torch.arange(v.numel(), dtype=torch.int64, device=v.device) * 2 + 1
        out.append(f"{int((v * w).sum()) & (2**64 - 1):016x}")
    return "-".join(out)


def step_split(torch, cs, port, fn, steps: int = 5, host_steps: int = 20) -> dict:
    """One mesh step, fn(): events ms (chip_smoke's timer), device ms by
    part and by kernel (torch.profiler, the mean of `steps` steps), the
    kernels and memsets a step runs, the package's launch counts of one
    step, and host us a step until the last launch is enqueued (`host_us`)
    and until the synchronise after it (`wall_us`), over `host_steps`."""
    out = {"events_ms": cs.cuda_ms(torch, fn, iters=steps, warmup=1)}
    torch.cuda.synchronize()
    by_kernel, by_part, events = {}, {}, 0
    for e in cs.profiled_events(torch, fn, steps):
        ms = e.time_range.elapsed_us() / steps / 1e3
        name = cs.kernel_name(e.name)
        by_kernel[name] = by_kernel.get(name, 0.0) + ms
        part = merge_part(name, MESH_PARTS)
        by_part[part] = by_part.get(part, 0.0) + ms
        events += 1
    out["device_ms"] = sum(by_kernel.values())
    out["device_ms_by_part"] = dict(sorted(by_part.items(), key=lambda kv: -kv[1]))
    out["device_ms_by_kernel"] = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))
    out["device_ops_a_step"] = events / steps
    port.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    out["launches_a_step"] = {k: v for k, v in port.launch_counts().items() if v}
    t = time.perf_counter()
    for _ in range(host_steps):
        fn()
    t_host = time.perf_counter()
    torch.cuda.synchronize()
    out["host_us"] = (t_host - t) / host_steps * 1e6
    out["wall_us"] = (time.perf_counter() - t) / host_steps * 1e6
    out["host_top_us"] = host_profile(torch, fn, host_steps)
    return out


def host_profile(torch, fn, steps: int, top: int = 12) -> dict:
    """cProfile over `steps` calls of fn(): the functions with the most
    own time, in µs a call of fn() (the profiler's own cost included)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(steps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((f"{f[0].rsplit('/', 1)[-1]}:{f[2]}", st[2] / steps * 1e6)
                   for f, st in stats.items()), key=lambda kv: -kv[1])
    return dict(rows[:top])


def mesh_steps(torch, cs, tree, dev, inputs: dict) -> tuple[dict, dict]:
    """Rows 16 and 17 as whole steps on `tree`'s package (step_split each)
    and the digests of their grids."""
    use_tree(tree.mods)
    pscan = tree.mod("parallel.scan")
    port = tree.mod("")
    mesh4 = cs.card_mesh(torch, dev, cs.MESH_SLOTS)
    series = cs.NUM_SERIES + (-cs.NUM_SERIES % 2)
    lanes, _ = pscan.shard_rows(mesh4, inputs["sorted"], pad_value=(0, series, 0, False))
    buckets = cs.WINDOW_MS // cs.BUCKET_MS

    def step16():
        return pscan.sharded_downsample(mesh4, *lanes, cs.T0, cs.BUCKET_MS, series, buckets,
                                        sorted_input=True)

    fn3 = pscan.build_multisegment_downsample(cs.card_mesh(torch, dev, 8, ("seg", "rows", "series")),
                                              cs.NUM_SERIES, cs.SEG_BUCKETS)
    seg = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in inputs["seg"]]

    def step17():
        return fn3(*seg, inputs["t0_seg"], cs.BUCKET_MS)

    out, digests = {}, {}
    for name, fn in (("sharded_downsample", step16), ("multisegment_downsample", step17)):
        got = fn()
        digests[name] = digest(torch, got)
        out[name] = step_split(torch, cs, port, fn)
    return out, digests


def other_rows(torch, cs, tree, dev, seed: int) -> tuple[dict, dict]:
    """Events ms and grid digests of the rows that share the mesh steps'
    headers or wrappers, at chip_smoke's shapes: B and C (rows 1, 2) at
    phase 4's shape, explicit and as downsample_sorted calls them, and at
    the long-run shape; grouped_stats and downsample (rows 5, 8) at the
    fused shape, sorted and shuffled; stacked_downsample (row 7) at burst
    A's launch; grid_fold (row 15) on one slot of 3l's fold."""
    use_tree(tree.mods)
    aggregate, blockagg = tree.mod("ops.aggregate"), tree.mod("ops.blockagg")
    mesh_ops = tree.mod("ops.mesh")
    rng = np.random.default_rng(seed)
    times, digests = {}, {}

    def row(name, fn, iters=20):
        digests[name] = digest(torch, fn())
        times[name] = cs.cuda_ms(torch, fn, iters=iters, warmup=2)

    for shape, (k, v, cells) in (("main", cs.main_path_segment_inputs(rng)),
                                 ("long_runs", cs.long_run_inputs(rng))):
        kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
        w, ok = torch.ones_like(vt), torch.ones_like(vt, dtype=torch.bool)
        row(f"{shape}_block_sum_count", lambda: blockagg.block_sum_count(kt, vt, cells, weights=w))
        row(f"{shape}_block_min_max", lambda: blockagg.block_min_max(kt, vt, cells, valid=ok))
        row(f"{shape}_main_call_block_sum_count",
            lambda: blockagg.sorted_segment_sum_count(kt, vt, cells, impl="block"))
        row(f"{shape}_main_call_block_min_max",
            lambda: blockagg.sorted_segment_min_max(kt, vt, cells, impl="block"))
        if shape == "long_runs":
            row("long_runs_grouped_stats", lambda: aggregate.grouped_stats(vt, kt, None, cells))
        del kt, vt, w, ok
    lanes, bucket_ms, series, buckets = stacked_inputs(torch, rng, dev)
    row("stacked_downsample",
        lambda: aggregate.stacked_downsample(*lanes, bucket_ms, series, buckets))
    del lanes
    part = fold_partials(torch, cs, rng, dev)
    row("grid_fold", lambda: mesh_ops.grid_fold(part))
    series, buckets = cs.FUSED_SERIES, cs.FUSED_WINDOW_MS // cs.FUSED_BUCKET_MS
    for order, (ts, sid, vals, flat) in fused_lanes(torch, cs, rng, dev):
        row(f"grouped_stats_{order}",
            lambda: aggregate.grouped_stats(vals, flat, None, series * buckets), iters=5)
        row(f"downsample_{order}",
            lambda: aggregate.downsample(ts, sid, vals, None, 0, cs.FUSED_BUCKET_MS, series,
                                         buckets), iters=5)
    return times, digests


def mesh_step_times(torch, cs, rng, dev, roots: list[tuple[str, str]], seed: int) -> dict:
    """The `mesh-step` mode (module docstring): the trees of `roots` (tag,
    checkout) in the order parent, change, change, parent."""
    inputs = mesh_step_inputs(cs, rng)
    trees = {tag: Tree(root, MESH_MODULES) for tag, root in roots}
    for tree in trees.values():
        use_tree(tree.mods)
        tree.mod("ops._build").build_all()
    tags = [t for t, _ in roots]
    order = tags + tags[::-1]
    out = {tag: {"package": trees[tag].package, "turns": []} for tag in tags}
    ref = None
    for tag in order:
        steps, step_digests = mesh_steps(torch, cs, trees[tag], dev, inputs)
        times, row_digests = other_rows(torch, cs, trees[tag], dev, seed)
        out[tag]["turns"].append({"steps": steps, "other_rows_ms": times})
        got = {**step_digests, **row_digests}
        if ref is None:
            ref = got
        diff = sorted(k for k in ref if ref[k] != got[k])
        cs.require(not diff, f"{tag}: grids differ from {order[0]}'s: {diff}")
    seg = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in inputs["seg"]]
    srt = [torch.from_numpy(a).to(dev) for a in inputs["sorted"]]
    buckets = cs.WINDOW_MS // cs.BUCKET_MS
    lib16 = cs.mesh_step_library(torch, dev, *[[x] for x in srt], [cs.T0], cs.NUM_SERIES, buckets)
    seg[1] = seg[1].clone()
    seg[1][1] += cs.NUM_SERIES  # segment 1's series past segment 0's: one flat grid of both
    lib17 = cs.mesh_step_library(torch, dev, *[[x[g] for g in (0, 1)] for x in seg],
                                 [int(t) for t in inputs["t0_seg"]], 2 * cs.NUM_SERIES,
                                 cs.SEG_BUCKETS)
    out["library_ms"] = {"sharded_downsample": cs.cuda_ms(torch, lib16, iters=5),
                         "multisegment_downsample": cs.cuda_ms(torch, lib17, iters=5)}
    out["library_call"] = "index_add_ x2 + scatter_reduce amin/amax over the flat cell ids"
    out["shapes"] = {"sharded_downsample": f"{len(inputs['sorted'][0])} sorted rows, "
                                           f"{cs.NUM_SERIES} x {buckets}, rows 2 x series 2",
                     "multisegment_downsample": f"[2, {inputs['seg'][0].shape[1]}] rows, "
                                                f"{cs.NUM_SERIES} x {cs.SEG_BUCKETS} a "
                                                f"segment, seg 2 x rows 2 x series 2"}
    out["order"] = order
    out["bitwise_equal"] = True
    return out


def agg_pair_inputs(torch, cs, rng, dev, stacked_call: str | None) -> dict:
    """The `agg-pair` mode's card lanes, made once for both trees."""
    from horaedb_tpu_torch.backend import order_key
    from horaedb_tpu_torch.storage.read import _pack_sort_keys

    out = {"stacked_synthetic": stacked_inputs(torch, rng, dev),
           "stacked_empty_lane": empty_lane_inputs(torch, rng, dev),
           "masked": masked_inputs(torch, rng, dev)}
    if stacked_call is not None:
        call = torch.load(stacked_call)
        out["stacked_3i"] = ([a.to(dev) for a in call["lanes"]], call["bucket_ms"],
                             call["num_series"], call["num_buckets"])
    slv_seed = int(rng.integers(2**31))
    for route in ("u32", "u64", "wide"):
        out[f"slv_{route}"] = last_write_lanes(torch, cs, np.random.default_rng(slv_seed), dev,
                                               route)
    k, v, cells = cs.main_path_segment_inputs(rng)
    out["main_segment"] = (torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev), cells)
    out["fused"] = dict(fused_lanes(torch, cs, rng, dev))
    m = round(cs.NUM_SERIES * cs.WINDOW_MS / cs.INTERVAL_MS * (1 + cs.RESEND_FRACTION) / 50)
    series = rng.integers(0, 2**64 - 1, cs.NUM_SERIES, dtype=np.uint64, endpoint=True)
    host = [series[rng.integers(0, cs.NUM_SERIES, m)],
            cs.T0 + rng.integers(0, cs.SEGMENT_MS // cs.INTERVAL_MS, m) * cs.INTERVAL_MS]
    skeys = [torch.from_numpy(order_key(a)).to(dev) for a in host]
    out["sort_perm"] = (skeys, [(int(x.min()), int(x.max())) for x in skeys])
    seg = cs.segment_runs(rng, cs.make_data(rng), 0)
    packed, width, bits = _pack_sort_keys(seg.__getitem__, ("series_id", "ts", "__seq__"),
                                          len(seg["ts"]))
    out["packed_merge"] = (torch.from_numpy(order_key(packed)).to(dev), bits, width)
    out["scan_kernel"] = fused_scan_inputs(torch, cs, rng, dev)
    return out


def agg_rows(torch, cs, tree, dev, inputs: dict) -> tuple[dict, dict]:
    """The `agg-pair` rows on `tree`'s package: launch_split of each (with
    the device operations a call) and the digests of their outputs (the
    sorts: checked equal to their plain versions instead)."""
    use_tree(tree.mods)
    aggregate, blockagg = tree.mod("ops.aggregate"), tree.mod("ops.blockagg")
    sort_ops, merge, scan_ops = tree.mod("ops.sort"), tree.mod("ops.merge"), tree.mod("ops.scan")
    F = tree.mod("ops.filter")
    times, digests = {}, {}

    def row(name, fn, iters, check=None):
        got = fn()
        torch.cuda.synchronize()
        if check is None:
            digests[name] = digest(torch, list(got.values()) if isinstance(got, dict) else got)
        else:
            cs.require(check(got), f"{name} differs from its plain version")
        times[name] = launch_split(torch, cs, fn, iters)

    for key, iters in (("stacked_synthetic", 1000), ("stacked_3i", 1000),
                       ("stacked_empty_lane", 50)):
        if key in inputs:
            lanes, bucket_ms, ns, nb = inputs[key]
            row(f"stacked_downsample_{key[8:]}",
                lambda: aggregate.stacked_downsample(*lanes, bucket_ms, ns, nb), iters)
    vals, ids, ok, segs = inputs["masked"]
    row("grouped_stats_masked", lambda: aggregate.grouped_stats(vals, ids, ok, segs), 50)
    for key in ("slv_u32", "slv_u64", "slv_wide"):
        lanes = inputs[key]
        row(f"segment_last_value_{key[4:]}", lambda: [aggregate.segment_last_value(*lanes)], 50)
    kt, vt, cells = inputs["main_segment"]
    row("block_sum_count_main_call",
        lambda: blockagg.sorted_segment_sum_count(kt, vt, cells, impl="block"), 1000)
    row("block_min_max_main_call",
        lambda: blockagg.sorted_segment_min_max(kt, vt, cells, impl="block"), 1000)
    series, buckets = cs.FUSED_SERIES, cs.FUSED_WINDOW_MS // cs.FUSED_BUCKET_MS
    for order, (ts, sid, vals, flat) in inputs["fused"].items():
        row(f"grouped_stats_{order}",
            lambda: aggregate.grouped_stats(vals, flat, None, series * buckets), 20)
        row(f"downsample_{order}",
            lambda: aggregate.downsample(ts, sid, vals, None, 0, cs.FUSED_BUCKET_MS, series,
                                         buckets), 20)
    skeys, sbounds = inputs["sort_perm"]
    row("sort_perm", lambda: sort_ops.sort_perm(skeys, sbounds), 200,
        lambda got: torch.equal(got, sort_ops.sort_perm_plain(skeys)))
    key, bits, width = inputs["packed_merge"]
    row("packed_merge", lambda: merge.packed_merge(key, bits, width, True), 20,
        lambda got: cs.same_survivors(torch, got, merge.packed_merge_plain(key, width, True)))
    lanes, keys, bounds, prog, n = inputs["scan_kernel"]

    def scan_same(got):
        want = scan_ops.scan_kernel_plain(lanes, keys, 2, F.eval_program_plain(prog, lanes, n),
                                          True, False)
        k = int(got[4].item())
        return (k == int(want[4].item()) and torch.equal(got[1][:k], want[1][:k])
                and torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]))

    row("scan_kernel", lambda: scan_ops.scan_kernel(lanes, keys, bounds, 2, prog, n, True, False,
                                                    dev), 5, scan_same)
    return times, digests


def agg_pair_times(torch, cs, rng, dev, roots: list[tuple[str, str]], seed: int,
                   stacked_call: str | None) -> dict:
    """The `agg-pair` mode (module docstring): the trees of `roots` (tag,
    checkout) in the order parent, change, change, parent."""
    trees = {tag: Tree(root, MESH_MODULES) for tag, root in roots}
    for tree in trees.values():
        use_tree(tree.mods)
        tree.mod("ops._build").build_all()
    inputs = agg_pair_inputs(torch, cs, rng, dev, stacked_call)
    mesh_inputs = mesh_step_inputs(cs, np.random.default_rng(seed))
    tags = [t for t, _ in roots]
    order = tags + tags[::-1]
    out = {tag: {"package": trees[tag].package, "turns": []} for tag in tags}
    ref = None
    for tag in order:
        times, got = agg_rows(torch, cs, trees[tag], dev, inputs)
        steps, step_digests = mesh_steps(torch, cs, trees[tag], dev, mesh_inputs)
        out[tag]["turns"].append({"rows": times, "mesh_steps": steps})
        got.update(step_digests)
        if ref is None:
            ref = got
        diff = sorted(k for k in ref if ref[k] != got[k])
        cs.require(not diff, f"{tag}: outputs differ from {order[0]}'s: {diff}")
    out["shapes"] = {
        "stacked_downsample_synthetic": f"{STACKED_SHAPE[:2]} padded lanes, "
                                        f"{STACKED_SHAPE[2]} x {STACKED_SHAPE[3]} a lane",
        "stacked_downsample_3i": "burst A's captured launch" if stacked_call else "not given",
        "stacked_downsample_empty_lane": f"{EMPTY_LANE_SHAPE[:2]} padded lanes, "
                                         f"{EMPTY_LANE_SHAPE[2]} x {EMPTY_LANE_SHAPE[3]} a lane, "
                                         f"{EMPTY_LANE_REAL} rows in each lane but the last",
        "grouped_stats_masked": f"{MASKED_SHAPE[0]} shuffled rows, {MASKED_SHAPE[1]} segments, "
                                f"the rows of the first tenth valid",
        "segment_last_value": f"{len(inputs['slv_u32'][0])} shuffled rows, "
                              f"{inputs['slv_u32'][4]} segments (3k: u32 keys); u64: one seq "
                              f"2^33; wide: one seq INT64_MAX",
        "fused": f"{len(inputs['fused']['sorted'][0])} rows, {cs.FUSED_SERIES} x "
                 f"{cs.FUSED_WINDOW_MS // cs.FUSED_BUCKET_MS}",
        "sort_perm": f"{len(inputs['sort_perm'][0][0])} rows x 2 keys",
        "packed_merge": (f"{len(inputs['packed_merge'][0])} rows, "
                         f"{inputs['packed_merge'][1]}-bit key"),
        "scan_kernel": f"{inputs['scan_kernel'][4]} rows"}
    out["order"] = order
    out["bitwise_equal"] = True
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
    ap.add_argument("mode", choices=("reduce", "reduce-split", "id-cache", "solo-fold", "launch",
                                     "merge", "sort-split", "default-device", "burst",
                                     "burst-pair", "scan-pair", "mesh-step", "decode-pair",
                                     "agg-pair"))
    ap.add_argument("--root", default=None, help="import horaedb_tpu_torch from this checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warm-turn", action="store_true",
                    help="scan-pair: no untimed scan opening each tree's turn")
    ap.add_argument("--stacked-call", default=None, metavar="FILE",
                    help="agg-pair: burst A's stacked_downsample inputs, as chip_smoke.py "
                         "--save-stacked-call writes them")
    ap.add_argument("--rounds", type=int, default=5,
                    help="burst, burst-pair, scan-pair: timed rounds after a warm-up")
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
    elif args.mode == "merge":
        out = merge_times(torch, cs, rng, dev)
    elif args.mode == "sort-split":
        out = sort_split(torch, cs, rng, dev)
    elif args.mode == "default-device":
        out = asyncio.run(default_device_reads(torch, cs, rng, dev))
    elif args.mode == "burst":
        res = asyncio.run(burst_times(torch, cs, rng, dev, args.rounds,
                                      [("tree", args.root or HERE)]))
        out = {"panels": res["panels"], "hosts": res["hosts"], **res["trees"]["tree"]}
    elif args.mode == "scan-pair":
        cs.require(args.root is not None, "scan-pair: --root names the other checkout")
        out = asyncio.run(scan_pair_times(torch, cs, rng, dev, args.rounds,
                                          [("change", HERE), ("parent", args.root)], args.seed,
                                          not args.no_warm_turn))
    elif args.mode == "burst-pair":
        cs.require(args.root is not None, "burst-pair: --root names the other checkout")
        out = asyncio.run(burst_times(torch, cs, rng, dev, args.rounds,
                                      [("change", HERE), ("parent", args.root)]))
    elif args.mode == "mesh-step":
        cs.require(args.root is not None, "mesh-step: --root names the parent checkout")
        out = mesh_step_times(torch, cs, rng, dev, [("parent", args.root), ("change", HERE)],
                              args.seed)
    elif args.mode == "agg-pair":
        cs.require(args.root is not None, "agg-pair: --root names the parent checkout")
        out = agg_pair_times(torch, cs, rng, dev, [("parent", args.root), ("change", HERE)],
                             args.seed, args.stacked_call)
    elif args.mode == "decode-pair":
        cs.require(args.root is not None, "decode-pair: --root names the parent checkout")
        out = decode_pair_times(torch, cs, rng, dev, [("parent", args.root), ("change", HERE)])
    else:
        out = asyncio.run(id_cache_times(torch, cs, rng, dev))
    out.setdefault("package", os.path.dirname(horaedb_tpu_torch.__file__))
    out.update(mode=args.mode, card=card, profiler_windows_retaken=cs.RETAKEN_WINDOWS[0])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
