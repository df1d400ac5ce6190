#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (horaedb_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
1. print the card's name and power limit, build the kernels from
   horaedb_tpu_torch/ops/csrc (one nvcc per library, in parallel), and
   print the occupancy of onesweep.cuh's sweep kernel for both of its
   instantiations (blocks an SM with its dynamic shared memory, and the
   registers a thread of the compiled kernel), and of segreduce.cuh's
   run_kernel for each set of lanes it stages (kernels B and C with and
   without their side lane, grouped_stats' reduction);
2. hold each kernel against its plain PyTorch version on the card, on edge
   cases and at the main path's shapes, and time kernel, plain version and
   a PyTorch library call where one computes the same function:
   sort_perm (A: row counts around the look-back sort's 4,096-row tile,
   keys over all 64 bits, three packed keys), block_sum_count (B),
   block_min_max (C) (at the main path's shape also as downsample_sorted
   calls them, with no weights and no valid mask), and the merges
   of a segment scan: packed_merge (D), the predicate kernel (E) and
   index_merge_mask / index_merge_filter (F) - edge cases n = 0 and 1,
   all rejected, one group, keys >= 2^63, NaN and -0.0 lanes, InSet of 0,
   1, 128, 129 and 65,536 members, presorted and shuffled rows, 4,095,
   4,096 and 4,097 kept rows (the look-back sort's tile), a tsid lane over
   all 64 bits, and one segment of about 7.56M rows, whose records name
   the packed sort keys, their digits and the sort path; and the fused
   route's scan_kernel (rows 0, 1, a tile +-1 and 70,001), downsample and
   grouped_stats on edge cases (f64, int64 and uint64
   values, NaN and -0.0, ids out of range, masked rows, empty cells, rows
   before t0, presorted and shuffled rows, dedup on and off, no predicate,
   a Compare, an InSet of 200 members, a host mask, u64 keys >= 2^63);
   and the decode kernels decode_unpack, decode_dod, decode_xor and
   decode_rle, bitwise on u64 views, on lanes at widths 0, 1, 17, 31 and
   32, a middle page of width 33 (the host fills it), pages of 1, 2, 3,
   4,095, 4,096 and 10,000 rows, i64 extremes and wraps mod 2^64, NaN payloads,
   +-0.0 and +-inf in f64 and f32, values >= 2^63, i4/u4 lanes, runs of 1
   and a run across pages, and past the rle and xor kernels' batch and
   chunk (page_rows 10,000: one run a page, 10,000 runs of 1, f32 and f64
   at width 31) and rle pages of 1 row; and stacked_downsample, bitwise on
   every grid (sums as u64 views) against its plain version on CPU copies, with
   B = 1, B = 16 with empty lanes, an all-masked lane, rows before t0 and
   past the grid, sid out of range, NaN and +-inf, a t0 per lane and runs
   straddling 8- and 2048-row boundaries, and one query stacked in lane 5
   of 16 against its solo reduction (downsample_sorted, kernels B and C);
   and kernels B, C and grouped_stats on 12 cells of 86,400 rows each
   (runs that segreduce.cuh folds block-wide), checked and timed;
   and both paths of grouped_stats' sort (csrc/onesweep.cuh: the
   presorted partition and the look-back digit passes) through
   grouped_stats and downsample, bitwise against their plain versions on
   CPU copies and bitwise repeatable: segment counts at the 8-bit digit
   edges (255, 256, 257, 2^16, 2^24, 2^24 + 1), rows 0, 1, a tile +-1 and
   2^20 + 3, every row dropped, one cell of 10^6 rows, NaN payloads,
   +-0.0, +-inf, int64 and uint64 sums that wrap, int64 ids past 2^32,
   each over presorted, presorted-with-dropped and shuffled rows, every
   launch's path held to its rows' order;
   and lane_sum_count (n mod 8 != 0, ids < 0 and >= the cell count,
   weights given and not, an empty input; counts exact, sums within
   2^-20 x the cell's L1 mass), segment_last_value (ties, empty segments,
   invalid rows, a seq span of 2^33, a u64 seq >= 2^63: each route of its
   row pass; bitwise)
   and kernel B's bf16 flag
   (bitwise), against their plain versions;
3. the main paths at TSBS cpu-only scale (10,000 series, one field, 10 s
   interval, 4 h = two 2 h segments = 14.4M samples), stored as parquet
   SSTs and a manifest in a LocalStore under a temporary directory; the
   launch counts are set to 0 before each path and read after it:
   a. write: 48 shuffled batches plus a 5 % re-send through
      `await ObjectBasedStorage.write` (kernel A);
   b. the 5-minute downsample query over all series (twice, bitwise
      identical) and over 1,000 series, held against a numpy oracle (last
      write wins, then bincount) on the packed route (kernels B, C);
   c. the same query with `scan_block_rows` below a segment's rows, so the
      chunked route runs: grids equal to the packed route's;
   d. raw scans through `ObjectBasedStorage.scan`, each held bitwise on
      every lane against a numpy last-write-wins oracle and against the
      same scan with HORAEDB_SCAN_PATH=host: one 2 h segment with a
      metric_id predicate on the planner's own route (index_merge_mask on a
      fast link); HORAEDB_SCAN_PATH=device with an InSet of 1,000 tsids and
      a ts range (index_merge_filter); a table with a dense int64 series id
      under HORAEDB_SCAN_PATH=device and HORAEDB_LINK_PROFILE=skip, no
      predicate (packed_merge);
   e. the fused route at TSBS cpu-only scale --scale=1000000 (1,000,000
      series, one field, 10 s interval, a 10-minute window of one 2 h
      segment = 60M samples): 20 shuffled writes of 3M rows plus a 5 %
      re-send, into a table whose scan_block_rows holds the segment in
      one pass; the 1-minute downsample over all series (twice, bitwise
      identical; the repeat under the profilers) and over 200,000 series
      must launch scan_kernel, downsample and grouped_stats (the packed
      pass declines at 2^17 series) and equal a numpy last-write-wins
      oracle;
   f. an append-mode table with a binary value column (about 1M rows in 8
      writes, repeated (tsid, ts) groups) scanned through
      `ObjectBasedStorage.scan` (scan_kernel), held bitwise against a numpy
      oracle that concatenates each group's bytes in (pk, write) order;
   g. encoded (format-v2) SSTs: TSBS cpu-only at --scale=10000 with its
      ten cpu fields (field_id 0-9), 10 s scrapes over a 1-hour window of
      one 2 h segment = 36M rows, written in time order as a remote-write
      client sends them (120 writes of three scrapes of every host and
      field, then a 5 % re-send), with EncodingConfig(enabled=True) and
      time_column="ts"; the codecs of each lane are printed and held to
      the prediction (tsid rle, field_id dict at width 4, ts dod, value
      raw); the 5-minute downsample of usage_user over all hosts (twice,
      bitwise) and over 1,000 hosts under HORAEDB_DECODE_IMPL=device
      (decode_unpack, decode_dod, decode_rle), host and raw, all equal and
      equal to a numpy oracle, and once under auto (the calibration's
      verdict and rows/s per codec); a raw scan with an InSet of 1,000
      tsids, field_id == 0 and a ts range against the oracle and the raw
      pin; every SST read must take the encoded branch (none under raw);
   h. Prometheus `up` over the same 10,000 targets, value 1.0, the same
      window and 120 writes (3.6M rows, the value lane xor at width 0):
      avg_over_time(up[5m]) over all targets under device (decode_xor),
      host and raw, against the oracle;
   i. the metric engine and the query batcher: TSBS cpu-only --scale=10000
      with its ten host tags, the ten cpu fields as ten Prometheus metrics
      (cpu_usage_user ... cpu_usage_guest_nice), 10 s scrapes over 30
      minutes of one 2 h segment = 18M samples through
      `MetricEngine.write_payload` in 60 remote-write payloads; burst A, a
      16-panel dashboard (one rack a panel, racks of 65-128 hosts, 1-minute
      buckets, one union scan), and burst B, TSBS single-groupby-5-8-1 from
      three clients (15 queries, hostname=~ matchers), each issued
      together (asyncio.gather) and answering bitwise equal to the same
      queries under HORAEDB_BATCH=off and equal to a numpy oracle; at the
      documented 2 ms batching window (docs/example.toml) burst A must make
      one stacked_downsample launch that every panel rode, and burst B's
      launches and solo members are reported; burst B then runs again with
      a window of twice its matchers' measured resolution time, which
      must make one launch that every query rode (the matchers resolve in
      worker threads, so their arrivals spread past 2 ms); a lone query
      must take the solo route; burst A runs again under torch.profiler,
      its device time split by kernel (`device_by_kernel`: the look-back
      sort's key passes and sweeps inside index_merge_filter apart);
   j. PromQL on 3i's engine before it closes, from a fresh calibration
      file of the aggregation dispatcher (so the first pushdown calibrates
      on the card, lane_sum_count included): `evaluate_range` of
      Q1 avg_over_time(cpu_usage_user[5m]) at a 5 m step (TSBS
      double-groupby-1's grid over all 10,000 hosts), Q2 max by (region)
      (max_over_time(cpu_usage_system[1m])) at 1 m, Q3 max_over_time of 8
      hosts by hostname=~ at 1 m (single-groupby-1-8-1), Q4 cpu_usage_user
      > 90 at 5 m (high-cpu-all, raw path), Q5
      last_over_time(cpu_usage_user[10m]) at 10 m (lastpoint-like, raw path)
      and Q6 topk(5, Q1), each equal to a numpy oracle (max and selections
      exact, means rtol 1e-12, the same series); the calibration entries
      (rows/s of every device implementation, none rejected) and the
      agg_impl_* notes printed; Q1 again under HORAEDB_AGG_IMPL = each
      device name, bitwise equal to `block`'s grid, with no lane_sum_count
      launch (f64 values);
   k. the last write of each of 7.2M segments (a dedup shape like 3a's
      segment, 5 % re-sent rows with a higher seq) through
      segment_last_value's own entry point, held against the written
      values; no engine or PromQL path calls it, as in the JAX package;
   l. the mesh on slots of the one card: 3d's dense segment scanned with
      HORAEDB_SCAN_PATH=sharded over 8 slots (lane for lane the default
      scan, its sample_sort_merge indices equal to packed_merge's, the
      path_device_merge_sharded note and no fallback note); 3b's packed
      downsample with a 4-slot (rows 2 x series 2) mesh installed
      (sharded_downsample, grid_fold), equal to 3b's grids and the
      oracle; a 4-region RegionedEngine (TSBS cpu-only's 10,000 hosts,
      cpu_usage_user, 1.8M samples in 6 payloads) whose query_partial_grids,
      split over two nodes and wire round-tripped, fold with merge_partials
      on the mesh (grid_fold; device_fold_safe must be True) bitwise equal
      to query(); entry.dryrun_multichip(4), then 3a's two segments in one
      3-axis (seg 2 x rows 2 x series 2) multisegment_downsample step
      (one slot pass a slot: 8 launches, no grouped_stats sort), equal to
      3b's grids segment by segment;
   m. storage opened with the default device (a bare "cuda", which
      resolves to the current card with its index): 3d's InSet scan under
      HORAEDB_SCAN_PATH=device (index_merge_filter) and 3e's fused
      downsample over 200,000 series (scan_kernel), each bitwise equal to
      the same read on the tables opened on cuda:0;
   every kernel must have launched on one of these paths; queries and a
   scan run under torch.profiler (and cProfile) for where the time goes;
4. scan_kernel, downsample and grouped_stats against their plain versions
   at the main path's shapes, on the inputs the first fused query of 3e
   gave them (kept from that run; downsample and grouped_stats also on a
   torch.Generator-seeded shuffle of those rows, each with its library
   call and the path its sort took), the four decode kernels on the
   largest lane each decoded on the device in 3g/3h, stacked_downsample
   on burst A's launch inputs (by CUDA events and by device ms, with its
   device operations a call; `--save-stacked-call FILE` keeps those inputs
   for `chip_ab.py agg-pair`), lane_sum_count at the calibration's shapes
   (2^18 rows into 16,384 and 524,288 cells; sorted ids, and shuffled
   under `unsorted`) and segment_last_value on
   3k's inputs (both timers, and the route of its row pass), and the four
   mesh kernels at 3l's shapes (one slot of the
   regioned fold; the mesh downsample's step and the 3-axis step whole,
   each held bitwise against the same step through the plain route and
   through the parent's route (the keys, then kernels B and C or
   grouped_stats) on the same card tensors, with its library yardstick;
   the sharded scan's merge), timed.
   Phase 2 also holds the mesh kernels against their plain versions (the
   steps on CPU slots), bitwise: grid_fold on NaN
   payloads, +-0.0, subnormals and infinities, k = 1, 5 and 9, odd and
   even cell counts;
   sample_sort_merge on random, all-sentinel, one-group and skewed keys
   and on 42- and 63-bit keys (and against packed_merge); sharded_downsample on prime series counts,
   sorted and unsorted, with a predicate; multisegment_downsample.
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import os
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
# phase 3e: TSBS cpu-only --scale=1000000, a 10-minute window, 1-minute buckets
FUSED_SERIES = 1_000_000
FUSED_WINDOW_MS = 10 * 60 * 1000
FUSED_BUCKET_MS = 60 * 1000
FUSED_WRITES = 20
FUSED_SUBSET = 200_000
FUSED_BLOCK_ROWS = 1 << 27  # scan_block_rows: the 63M-row segment in one pass
# phase 3f: the append-mode table with a binary value column
APPEND_SERIES = 50_000
APPEND_TS = 10
APPEND_WRITES = 8
APPEND_ROWS = 125_000
# phases 3g and 3h: encoded (format-v2) SSTs; TSBS cpu-only's ten cpu fields
# (field_id 0-9) and Prometheus `up`, 10 s scrapes over a 1-hour window
CPU_FIELDS = ("usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
              "usage_irq", "usage_softirq", "usage_steal", "usage_guest", "usage_guest_nice")
ENC_WINDOW_MS = 3600 * 1000
ENC_SCRAPES = ENC_WINDOW_MS // INTERVAL_MS
ENC_WRITES = 120
UP_METRIC_ID = 2
# the codecs each lane of a 3g write should pick (worked out from the data:
# runs of 30 rows per tsid, of 3 per field, 3 scrapes per (tsid, field))
ENC_CODECS = {"metric_id": ("dict", 0), "tsid": ("rle", 0), "field_id": ("dict", 4),
              "ts": ("dod", 16), "value": ("raw", 0), "__seq__": ("dict", 0),
              "__reserved__": ("null", 0)}


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


def sweep_occupancy() -> dict:
    """Phase 1: onesweep.cuh's sweep kernel in each instantiation, as the
    runtime reports the compiled kernel: blocks an SM with its dynamic
    shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), its
    registers a thread and its shared bytes a block."""
    import ctypes

    from horaedb_tpu_torch.ops import _build

    out = {}
    for library, inst in (("grouped_stats", "u32 keys, u64 values (grouped_stats.cu)"),
                          ("sort_perm", "u64 keys, int32 rows (keychain.cuh, sort_perm.cu)")):
        buf = (ctypes.c_int32 * 4)()
        rc = _build.kernel(library, f"{library}_sweep_occupancy", [ctypes.c_void_p])(buf)
        require(rc == 0, f"{library}: the sweep's occupancy query failed with cudaError {rc}")
        out[inst] = {"blocks_per_sm": buf[0], "registers_per_thread": buf[1],
                     "static_smem_bytes": buf[2], "dynamic_smem_bytes": buf[3]}
    return out


def segreduce_occupancy() -> dict:
    """Phase 1: segreduce.cuh's run_kernel (kernels B, C, grouped_stats'
    reduction and the mesh slot pass, unsorted and sorted) for each set of
    lanes it stages, as sweep_occupancy reports the sweep."""
    import ctypes

    from horaedb_tpu_torch.ops import _build

    out = {}
    for library, entry, sets in (
            ("block_sum_count", "block_sum_count_occupancy", ("v", "v, w")),
            ("block_min_max", "block_min_max_occupancy", ("v", "v, valid")),
            ("grouped_stats", "grouped_stats_run_occupancy", ("v",)),
            ("sharded_downsample", "sharded_slot_occupancy",
             ("the sort's ids, v", "ids from ts, sid, valid, mask; v"))):
        for i, lanes in enumerate(sets):
            buf = (ctypes.c_int32 * 4)()
            two = len(sets) > 1
            fn = _build.kernel(library, entry, [ctypes.c_void_p] + [ctypes.c_int32] * two)
            rc = fn(buf, i) if two else fn(buf)
            require(rc == 0, f"{library}: run_kernel's occupancy query failed with cudaError {rc}")
            out[f"{library} ({lanes})"] = {
                "blocks_per_sm": buf[0], "registers_per_thread": buf[1],
                "static_smem_bytes": buf[2], "dynamic_smem_bytes": buf[3]}
    return out


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
    # row counts around the look-back sort's 4,096-row tile (tsid and ts, two
    # packed keys), and three keys of 60-bit spans (three packed keys); their
    # own draws, so the later phases' data stays as it was
    own = np.random.default_rng(7)
    for n in (4095, 4096, 4097):
        yield f"{n} rows", [own.choice(own.integers(0, 2**64 - 1, 600, dtype=np.uint64,
                                                    endpoint=True), n),
                            own.integers(0, 7_200_000, n).astype(np.int64)]
    yield "three packed keys", [own.choice(own.integers(0, 2**60, 40), 50_001).astype(np.int64)
                                for _ in range(3)]


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


# few cells of many rows: 1-day buckets over 1 s scrapes hold 86,400 rows a
# cell; segreduce.cuh folds such runs block-wide in chunks from their heads
LONG_RUN_CELLS = 12
LONG_RUN_ROWS = 86_400


def long_run_inputs(rng):
    """Kernel B/C inputs with few cells of many rows: LONG_RUN_CELLS runs of
    LONG_RUN_ROWS rows sorted by cell id, uniform values."""
    k = np.repeat(np.arange(LONG_RUN_CELLS, dtype=np.int32), LONG_RUN_ROWS)
    return k, rng.uniform(0, 100, len(k)), LONG_RUN_CELLS


def check_long_runs(torch, rng, dev) -> dict:
    """Kernels B, C and grouped_stats on long_run_inputs against their plain
    versions (counts, min, max exact; sums rtol 1e-12), and their times."""
    from horaedb_tpu_torch.ops import blockagg
    from horaedb_tpu_torch.ops.aggregate import grouped_stats, grouped_stats_plain

    k, v, cells = long_run_inputs(rng)
    kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    okt = torch.ones(len(k), dtype=torch.bool, device=dev)
    s, c = blockagg.sorted_segment_sum_count(kt, vt, cells)
    ps, pc = blockagg.sum_count_plain(kt, vt, torch.ones_like(vt), cells)
    mn, mx = blockagg.sorted_segment_min_max(kt, vt, cells, valid=okt)
    pmn, pmx = blockagg.min_max_plain(kt, vt, okt, cells)
    g = grouped_stats(vt, kt, None, cells)
    want = grouped_stats_plain(vt, kt, okt, cells)
    require(torch.equal(c, pc) and close_sums(torch, s, ps), "long runs: kernel B != plain")
    require(torch.equal(mn, pmn) and torch.equal(mx, pmx), "long runs: kernel C != plain")
    require(close_sums(torch, g["sum"], want["sum"])
            and all(torch.equal(g[x], want[x]) for x in ("count", "min", "max")),
            "long runs: grouped_stats != plain")
    out = {"shape": f"{len(k)} rows, {cells} cells of {LONG_RUN_ROWS} rows",
           "block_sum_count_ms": cuda_ms(
               torch, lambda: blockagg.block_sum_count(kt, vt, cells)),
           "block_min_max_ms": cuda_ms(
               torch, lambda: blockagg.block_min_max(kt, vt, cells, valid=okt)),
           "grouped_stats_ms": cuda_ms(torch, lambda: grouped_stats(vt, kt, None, cells))}
    print(f"long runs ({out['shape']}): B {out['block_sum_count_ms']:.4f} ms, "
          f"C {out['block_min_max_ms']:.4f} ms, grouped_stats {out['grouped_stats_ms']:.4f} ms",
          flush=True)
    return out


def check_kernels(torch, rng, dev) -> list[dict]:
    from horaedb_tpu_torch.backend import order_key
    from horaedb_tpu_torch.ops import blockagg, keychain
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
    packed = keychain.pack_lanes(bounds_v)
    # each sorted key read once (8 B/row), the int32 permutation written once
    nb, kind = bound(n * (8 * len(keys_v) + 4), 0)
    records.append({
        "name": "sort_perm", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/sort_perm.cu + keychain.cuh, onesweep.cuh",
        "replaces": "horaedb_tpu/ops/sort.py:22",
        "shape": f"{n} rows x {len(keys_v)} keys (tsid, ts)",
        "sort_path": (f"{len(packed)} packed keys, {sum(d for _, _, d in packed)} look-back "
                      f"sweeps over {-(-n // 4096)} tiles"),
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
    # the calls as downsample_sorted makes them: no weights, no valid mask
    def main_sum():
        return blockagg.sorted_segment_sum_count(kt, vt, cells, impl="block")

    def main_min_max():
        return blockagg.sorted_segment_min_max(kt, vt, cells, impl="block")

    s1, c1 = main_sum()
    require(torch.equal(c1, pc) and close_sums(torch, s1, ps),
            "block_sum_count != plain at the main path's call (no weights)")
    mn1, mx1 = main_min_max()
    require(same_values(torch, mn1, pmn) and same_values(torch, mx1, pmx),
            "block_min_max != plain at the main path's call (no valid mask)")
    n = len(k)
    # the main path's call reads the id and the value (12 B/row)
    main_bound, _ = bound(n * (4 + 8) + cells * 16, 2 * n)
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
        "ms": cuda_ms(torch, lambda: blockagg.block_sum_count(kt, vt, cells, weights=wt)),
        "plain_ms": cuda_ms(torch, lambda: blockagg.sum_count_plain(kt, vt, wt, cells)),
        "bound_ms": nb, "bound_by": kind,
        "library_ms": cuda_ms(torch, lambda: torch.zeros(
            cells, 2, dtype=torch.float64, device=dev).index_add_(0, idx, vw)),
        "library_call": "index_add_ of stacked (value, weight)",
        "main_call_ms": cuda_ms(torch, main_sum), "main_call_bound_ms": main_bound,
    })
    nb, kind = bound(n * (4 + 8 + 1) + cells * 16, 2 * n)
    records.append({
        "name": "block_min_max", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/block_min_max.cu",
        "replaces": "horaedb_tpu/ops/blockagg.py:201", "shape": shape,
        "max_abs_err": max(abs_err(torch, mn, pmn), abs_err(torch, mx, pmx)),
        "ms": cuda_ms(torch, lambda: blockagg.block_min_max(kt, vt, cells, valid=okt)),
        "plain_ms": cuda_ms(torch, lambda: blockagg.min_max_plain(kt, vt, okt, cells)),
        "bound_ms": nb, "bound_by": kind,
        "library_ms": cuda_ms(torch, lambda: torch.full(
            (cells, 2), torch.inf, dtype=torch.float64, device=dev).scatter_reduce_(
                0, idx2, vneg, "amin", include_self=True)),
        "library_call": "scatter_reduce amin of stacked (value, -value)",
        "main_call_ms": cuda_ms(torch, main_min_max), "main_call_bound_ms": main_bound,
    })
    return records


# -- phase 2, continued: the merges of a segment scan (D, E, F) ---------------

SORT_KEYS = ("metric_id", "tsid", "field_id", "ts", "__seq__")
U64_MAX = np.uint64(2**64 - 1)
I64_MAX = 2**63 - 1  # the mapped packed sentinel


def same_survivors(torch, got, want) -> bool:
    (out, k), (pout, pk) = got, want
    k, pk = int(k.item()), int(pk.item())
    return k == pk and torch.equal(out[:k], pout[:pk])


def packed_merge_library(torch, key, seq_width: int):
    """packed_merge's function in the fewest PyTorch calls: one stable sort
    of the mapped keys, the keep-last flags (the next sorted key's group
    differs, the sentinel drops) and one boolean-index compaction. The
    mapped key's arithmetic shift groups as the raw key's does, and no valid
    key's group meets the sentinel's."""
    sk, perm = torch.sort(key, stable=True)
    grp = sk >> seq_width
    keep = sk != I64_MAX
    keep[:-1] &= grp[1:] != grp[:-1]
    return perm[keep]


def merge_edge_cases(rng):
    """(name, sort-key lanes, mask, presorted) for kernels D and F."""
    def lanes(n, pk_lo=0, pk_hi=50, g=rng):
        return {"metric_id": np.ones(n, np.uint64),
                "tsid": g.integers(2**63, 2**63 + pk_hi - pk_lo, n, dtype=np.uint64),
                "field_id": np.zeros(n, np.uint64),
                "ts": T0 + g.integers(0, 40, n).astype(np.int64),
                "__seq__": g.integers(10**18, 10**18 + 5, n).astype(np.uint64)}

    def sort(c):
        order = np.lexsort(tuple(c[k] for k in reversed(SORT_KEYS)))
        return {k: v[order] for k, v in c.items()}

    yield "no rows", lanes(0), np.zeros(0, bool), False
    yield "one row", lanes(1), np.ones(1, bool), False
    c = lanes(5000)
    yield "all rejected", c, np.zeros(5000, bool), False
    c = lanes(9000)
    c["tsid"][:] = U64_MAX
    c["ts"][:] = T0
    yield "all one group, key 2^64-1", c, rng.random(9000) < 0.9, False
    c = lanes(70_001, 0, 4000)
    yield "shuffled, keys >= 2^63", c, rng.random(70_001) < 0.7, False
    yield "presorted", sort(c), rng.random(70_001) < 0.7, True
    # kept counts around the look-back sort's 4,096-row tile, and a tsid
    # lane over all 64 bits (a key of 8 digits); their own draws, so the
    # later phases' data stays as it was
    g = np.random.default_rng(10)
    for kept in (4095, 4096, 4097):
        c = lanes(20_011, 0, 4000, g)
        mask = np.zeros(20_011, bool)
        mask[g.choice(20_011, kept, replace=False)] = True
        yield f"kept {kept} of 20,011", c, mask, False
    c = lanes(70_001, 0, 4000, g)
    c["tsid"] = g.choice(g.integers(0, 2**64 - 1, 3000, dtype=np.uint64, endpoint=True), 70_001)
    c["tsid"][:2] = [0, 2**64 - 1]
    yield "tsid over all 64 bits", c, g.random(70_001) < 0.7, False


def predicate_edge_cases(F):
    members = tuple(int(v) for v in np.arange(2**63, 2**63 + 70_000, dtype=np.uint64))
    return {
        "NaN and -0.0": F.Or(F.Compare("value", "eq", 0.0), F.Compare("value", "ne",
                                                                      float("nan"))),
        "NaN literal": F.Compare("value", "lt", float("nan")),
        "u64 >= 2^63": F.And(F.Compare("tsid", "ge", 2**63 + 7), F.Compare("ts", "lt", T0 + 30)),
        "InSet 0": F.InSet("tsid", (-1, 2**64)),
        "InSet 1": F.InSet("tsid", members[:1]),
        "InSet 128": F.InSet("tsid", members[:128]),
        "InSet 129": F.InSet("tsid", members[:129]),
        "InSet 65536": F.InSet("tsid", members[:65_536]),
        "float InSet": F.Not(F.InSet("value", (float("nan"), -0.0, 0.5))),
    }


def segment_runs(rng, data, seg: int):
    """One segment as the merge sees it: the rows of the segment's 24
    shuffled writes and its re-send, each write pk-sorted with its own
    sequence, concatenated in first-key order."""
    tsids, ts, _values, resend, _new, _final = data
    per_series = len(ts)
    seg_of = (ts - T0) // SEGMENT_MS
    rows = np.flatnonzero(seg_of[np.arange(NUM_SERIES * per_series) % per_series] == seg)
    parts = np.array_split(rng.permutation(rows), BATCHES_PER_SEGMENT)
    parts.append(resend[seg_of[resend % per_series] == seg])
    runs = []
    for w, part in enumerate(parts):
        part = np.sort(part)  # (series, ts) order is pk order
        runs.append({"metric_id": np.full(len(part), METRIC_ID, np.uint64),
                     "tsid": tsids[part // per_series],
                     "field_id": np.zeros(len(part), np.uint64),
                     "ts": ts[part % per_series],
                     "__seq__": np.full(len(part), 1_700_000_000_000_000_000 + w, np.uint64),
                     "series_id": (part // per_series).astype(np.int64)})
    runs.sort(key=lambda r: (int(r["tsid"][0]), int(r["ts"][0])))
    return {k: np.concatenate([r[k] for r in runs]) for k in runs[0]}


def check_merge_kernels(torch, rng, dev, data) -> list[dict]:
    from horaedb_tpu_torch.backend import device_lane, order_key
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.ops import keychain, merge
    from horaedb_tpu_torch.storage.read import _pack_sort_keys, predicate_lanes, sort_key_lanes

    # edge cases: D and F against their plain versions
    for name, cols, mask, presorted in merge_edge_cases(rng):
        n = len(mask)
        keys, bounds, num_pk, _ = sort_key_lanes(cols.__getitem__, SORT_KEYS, dev)
        mask_t = torch.from_numpy(mask.astype(np.uint8)).to(dev)
        for dedup in (True, False):
            require(same_survivors(torch, merge.index_merge_mask(keys, bounds, num_pk, mask_t,
                                                                 dedup, presorted),
                                   merge.index_merge_plain(keys, num_pk, mask_t, dedup,
                                                           presorted)),
                    f"index_merge_mask != plain on {name!r} (dedup={dedup})")
        packres = _pack_sort_keys(cols.__getitem__, ("tsid", "ts", "__seq__"), n)
        packed, width, bits = packres if packres else (np.zeros(n, np.uint64), 1, 8)
        key = torch.from_numpy(order_key(np.where(mask, packed, U64_MAX))).to(dev)
        for dedup in (True, False):
            require(same_survivors(torch, merge.packed_merge(key, bits, width, dedup),
                                   merge.packed_merge_plain(key, width, dedup)),
                    f"packed_merge != plain on {name!r} (dedup={dedup})")
    # E and E + F: NaN / -0.0 float lanes, u64 literals, InSet sizes
    cols = dict(next(c for nm, c, _m, _p in merge_edge_cases(rng) if nm.startswith("shuffled")))
    n = len(cols["ts"])
    cols["value"] = rng.choice(np.array([np.nan, -0.0, 0.0, 0.5, np.inf, -1.0]), n)
    dtypes = {k: a.dtype for k, a in cols.items()}
    lanes = {k: torch.from_numpy(device_lane(a)).to(dev) for k, a in cols.items()}
    keys, bounds, num_pk, _ = sort_key_lanes(cols.__getitem__, SORT_KEYS, dev)
    for name, pred in predicate_edge_cases(F).items():
        prog = F.compile_program(pred, dtypes)
        plain = F.eval_program_plain(prog, lanes, n)
        require(torch.equal(F.eval_predicate(pred, lanes, dtypes), plain),
                f"predicate kernel != plain on {name!r}")
        require(same_survivors(torch, merge.index_merge_filter(keys, bounds, num_pk, prog, lanes,
                                                               n, True, False, dev),
                               merge.index_merge_plain(keys, num_pk, plain, True, False)),
                f"index_merge_filter != plain on {name!r}")

    # the main path's shape: one segment of the TSBS data
    seg = segment_runs(rng, data, 0)
    n = len(seg["ts"])
    records = []
    # D: the dense-series table (series_id, ts, seq) packed into one key
    dense_keys = ("series_id", "ts", "__seq__")
    packed, width, bits = _pack_sort_keys(seg.__getitem__, dense_keys, n)
    key = torch.from_numpy(order_key(packed)).to(dev)
    got = merge.packed_merge(key, bits, width, True)
    want = merge.packed_merge_plain(key, width, True)
    require(same_survivors(torch, got, want), "packed_merge != plain at the main path shape")
    k = int(got[1].item())
    require(torch.equal(packed_merge_library(torch, key, width), got[0][:k].long()),
            "packed_merge's library yardstick differs from the kernel")
    nb, kind = bound(n * 8 + k * 4, 0)
    records.append({
        "name": "packed_merge", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/packed_merge.cu + packedsort.cuh, onesweep.cuh",
        "replaces": "horaedb_tpu/storage/read.py:405",
        "shape": f"{n} rows, {bits}-bit packed key (series_id, ts, seq rank), {k} survivors",
        "sort_path": f"valid-row partition, then onesweep.cuh's look-back sort of the raw "
                     f"key: one key pass, {(bits + 7) // 8} sweeps",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: merge.packed_merge(key, bits, width, True)),
        "plain_ms": cuda_ms(torch, lambda: merge.packed_merge_plain(key, width, True)),
        "bound_ms": nb, "bound_by": kind,
        "library_ms": cuda_ms(torch, lambda: packed_merge_library(torch, key, width)),
        "library_call": "one stable torch.sort, the keep-last flags, one boolean-index "
                        "compaction",
        "one_key_sort_ms": cuda_ms(torch, lambda: torch.sort(key, stable=True)),
    })
    # F with a host mask: metric_id eq keeps every row of this data
    keys, bounds, num_pk, key_names = sort_key_lanes(seg.__getitem__, SORT_KEYS, dev)
    packed_keys = [{"lanes": [key_names[i] for i in lanes], "shifts": list(shifts),
                    "digits": digits} for lanes, shifts, digits in keychain.pack_lanes(bounds)]
    sort_path = (f"mask partition, then keychain.cuh's look-back sorts (u64 keys, int32 rows) "
                 f"over {len(packed_keys)} packed keys: "
                 f"{sum(k['digits'] for k in packed_keys)} sweeps, {len(packed_keys)} key passes")
    mask_t = torch.from_numpy((seg["metric_id"] == METRIC_ID).astype(np.uint8)).to(dev)
    got = merge.index_merge_mask(keys, bounds, num_pk, mask_t, True, False)
    want = merge.index_merge_plain(keys, num_pk, mask_t, True, False)
    require(same_survivors(torch, got, want), "index_merge_mask != plain at the main path shape")
    k = int(got[1].item())
    # the mask read for every row, the key lanes only for the rows it keeps
    # (here every row), 4 B per survivor written
    kept = int(mask_t.sum().item())
    nb, kind = bound(n + kept * sum(t.element_size() for t in keys) + k * 4, 0)
    records.append({
        "name": "index_merge_mask", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/index_merge.cu + keychain.cuh, onesweep.cuh",
        "replaces": "horaedb_tpu/storage/read.py:580",
        "shape": f"{n} rows x {len(keys)} key lanes (tsid, ts, seq rank) + mask, {k} survivors",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: merge.index_merge_mask(keys, bounds, num_pk, mask_t, True,
                                                            False)),
        "plain_ms": cuda_ms(torch, lambda: merge.index_merge_plain(keys, num_pk, mask_t, True,
                                                                   False), iters=5),
        "bound_ms": nb, "bound_by": kind, "library_ms": None,
        "one_key_sort_ms": cuda_ms(torch, lambda: torch.sort(keys[0], stable=True)),
        "packed_keys": packed_keys, "sort_path": sort_path,
    })
    # E + F: InSet of 1,000 tsids and a ts range, evaluated on the device
    subset = np.sort(rng.choice(data[0], SUBSET, replace=False))
    pred = F.And(F.InSet("tsid", tuple(int(t) for t in subset)),
                 F.time_range_pred("ts", T0 + 600_000, T0 + SEGMENT_MS - 600_000))
    pcols = {c: seg[c] for c in ("tsid", "ts")}
    prog = F.compile_program(pred, {c: a.dtype for c, a in pcols.items()})
    # as the scan's planner does: tsid and ts are read from their key lanes
    plane = predicate_lanes(pcols, dict(zip(key_names, keys)), dev)
    got = merge.index_merge_filter(keys, bounds, num_pk, prog, plane, n, True, False, dev)
    plain_mask = F.eval_program_plain(prog, plane, n)
    want = merge.index_merge_plain(keys, num_pk, plain_mask, True, False)
    require(same_survivors(torch, got, want), "index_merge_filter != plain at the main shape")
    require(torch.equal(F.eval_predicate(pred, plane, {c: a.dtype for c, a in pcols.items()}),
                        plain_mask), "predicate kernel != plain at the main path shape")
    k = int(got[1].item())
    # the predicate's lanes read once for every row (tsid and ts are key
    # lanes), the other key lanes (the seq rank) only for the rows the mask
    # keeps, the program and its literals, 4 B per survivor written
    pred_keys = [key for key in keys if any(t is key for t in plane.values())]
    sort_only = [key for key in keys if not any(key is t for t in pred_keys)]
    own_lanes = [t for t in plane.values() if not any(t is key for key in keys)]
    literal_bytes = sum(a.nbytes for a in (prog.code, prog.lit_i64, prog.lit_f64, prog.set_i64,
                                           prog.set_f64))
    kept = int(plain_mask.sum().item())
    nb, kind = bound(n * sum(t.element_size() for t in pred_keys + own_lanes)
                     + kept * sum(t.element_size() for t in sort_only)
                     + literal_bytes + k * 4, 0)
    records.append({
        "name": "index_merge_filter", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/index_merge.cu + predicate.cu, keychain.cuh",
        "replaces": "horaedb_tpu/storage/read.py:586",
        "shape": f"{n} rows x {len(keys)} key lanes, the predicate reading tsid and ts from "
                 f"them, InSet of {SUBSET} + ts range, {kept} rows kept, {k} survivors",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: merge.index_merge_filter(keys, bounds, num_pk, prog, plane,
                                                              n, True, False, dev)),
        "plain_ms": cuda_ms(torch, lambda: merge.index_merge_plain(
            keys, num_pk, F.eval_program_plain(prog, plane, n), True, False), iters=5),
        "bound_ms": nb, "bound_by": kind, "library_ms": None,
        "predicate_ms": cuda_ms(torch, lambda: F.launch_program(
            prog, plane, n, torch.empty(n, dtype=torch.uint8, device=dev))),
        "predicate_plain_ms": cuda_ms(torch, lambda: F.eval_program_plain(prog, plane, n),
                                      iters=5),
        "one_key_sort_ms": cuda_ms(torch, lambda: torch.sort(keys[0], stable=True)),
        "packed_keys": packed_keys, "sort_path": sort_path,
    })
    return records


# -- phase 2, continued: the fused route (scan_kernel, downsample, grouped_stats)

def fused_values(rng, kind: str, n: int):
    """A value lane of `kind` (f64 with NaN / -0.0 / inf, int64, or uint64
    bits with bit 63 set on some rows, carried as int64) and its flag."""
    if kind == "f64":
        v = rng.integers(-1000, 1000, n).astype(np.float64)  # exact sums in any order
        m = min(n, 40)
        v[rng.choice(n, m, replace=False)] = np.resize([np.nan, -0.0, np.inf, -np.inf, 0.0], m)
        return v, False
    if kind == "i64":
        return rng.integers(-(2**56), 2**56, n).astype(np.int64), False
    u = rng.integers(0, 2**58, n, dtype=np.uint64)
    u[: n // 5] = np.uint64(2**63 + 77)
    return u.view(np.int64), True


def same_stats(torch, got: dict, want: dict, what: str) -> float:
    """Counts, min and max exact (NaN == NaN); float sums and means within
    rtol 1e-12, integer sums exact. Returns the largest |difference|."""
    for k in ("count", "min", "max"):
        require(got[k].dtype == want[k].dtype and same_values(torch, got[k], want[k]),
                f"{what}: {k} differs from the plain version")
    for k in ("sum", "mean"):
        if got[k].dtype == torch.float64:
            require(close_sums(torch, got[k], want[k]), f"{what}: {k} differs from plain")
        else:
            require(torch.equal(got[k], want[k]), f"{what}: {k} differs from the plain version")
    return max(abs_err(torch, got[k].double(), want[k].double()) for k in got)


def same_scan(torch, got, want, what: str) -> None:
    """kept, perm[:kept], every gathered lane's first kept rows (as raw
    bits), keep and starts all equal."""
    k = int(got[4].item())
    require(k == int(want[4].item()), f"{what}: kept differs from the plain version")
    require(torch.equal(got[1][:k], want[1][:k]), f"{what}: perm differs from the plain version")
    for name, lane in got[0].items():
        a, b = lane[:k], want[0][name][:k]
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        require(torch.equal(a, b), f"{what}: gathered lane {name!r} differs from plain")
    require(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
            f"{what}: keep / starts differ from the plain version")


def scan_plain_mask(torch, F, program, lanes, n, mask, dev):
    if program is not None:
        return F.eval_program_plain(program, lanes, n)
    return mask if mask is not None else torch.ones(n, dtype=torch.bool, device=dev)


def check_fused_kernels(torch, rng, dev) -> None:
    """Edge cases of the fused route's three kernels against their plain
    versions (the main-path shapes come in phase 4)."""
    from horaedb_tpu_torch.backend import device_lane
    from horaedb_tpu_torch.ops import aggregate as agg
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.ops import scan as scan_ops
    from horaedb_tpu_torch.storage.read import predicate_lanes, sort_key_lanes

    for kind in ("f64", "i64", "u64"):
        for n, cells in ((0, 9), (1, 1), (5000, 0), (70_001, 300), (300_000, 200_000)):
            v, unsigned = fused_values(rng, kind, n)
            idx = rng.integers(-4, cells + 4, n).astype(np.int32)
            idx[idx == cells // 2] = cells // 2 + 1  # an empty cell
            ok = rng.random(n) > 0.1
            vt, it, okt = (torch.from_numpy(a).to(dev) for a in (v, idx, ok))
            what = f"grouped_stats {kind} n={n} cells={cells}"
            same_stats(torch, agg.grouped_stats(vt, it, okt, cells, unsigned=unsigned),
                       agg.grouped_stats_plain(vt, it, okt, cells, unsigned=unsigned), what)
        t0, bucket_ms, ns, nb = T0, 60_000, 1_000, 10
        n = 100_003
        ts = t0 + rng.integers(-2 * bucket_ms, (nb + 2) * bucket_ms, n).astype(np.int64)
        ts[:3] = [t0 - 1, t0, t0 + nb * bucket_ms]  # bucket -1, bucket 0, past the grid
        sid = rng.integers(-2, ns + 2, n).astype(np.int32)
        v, unsigned = fused_values(rng, kind, n)
        args = [torch.from_numpy(a).to(dev) for a in (ts, sid, v, rng.random(n) > 0.2)]
        got = agg.downsample(*args, t0, bucket_ms, ns, nb, unsigned=unsigned)
        want = agg.downsample_plain(*args, t0, bucket_ms, ns, nb, unsigned=unsigned)
        same_stats(torch, {k: t.reshape(-1) for k, t in got.items()}, want,
                   f"downsample {kind}")

    members = tuple(range(2**63 - 3, 2**63 + 400, 2))
    preds = {"none": None,
             "compare": F.And(F.Compare("metric_id", "eq", METRIC_ID), F.Compare("ts", "lt", T0 + 90)),
             "inset 200": F.Or(F.InSet("tsid", members), F.Compare("value", "ne", 0.0))}
    for n in (0, 1, 4095, 4096, 4097, 70_001):
        for presorted in (False, True):
            cols = {"metric_id": rng.integers(1, 3, n).astype(np.uint64),
                    "tsid": rng.integers(2**63 - 3, 2**63 + 40, n, dtype=np.uint64),
                    "field_id": np.zeros(n, np.uint64),
                    "ts": T0 + rng.integers(0, 12, n).astype(np.int64) * 10,
                    "__seq__": rng.integers(10**18, 10**18 + 4, n).astype(np.uint64),
                    "value": rng.choice(np.array([np.nan, -0.0, 0.0, 1.5, -np.inf]), n),
                    "__sid__": rng.integers(0, 1000, n).astype(np.int32)}
            if presorted:
                order = np.lexsort(tuple(cols[k] for k in reversed(SORT_KEYS)))
                cols = {k: a[order] for k, a in cols.items()}
            keys, bounds, num_pk, names = sort_key_lanes(cols.__getitem__, SORT_KEYS, dev)
            lanes = predicate_lanes(cols, dict(zip(names, keys)), dev)
            for pname, pred in preds.items():
                for host in (False, True) if pred is not None else (False,):
                    prog = mask = None
                    if host:
                        mask = torch.from_numpy(F.eval_predicate_np(pred, cols)).to(dev)
                    elif pred is not None:
                        prog = F.compile_program(pred, {k: a.dtype for k, a in cols.items()})
                    for dedup in (True, False):
                        what = (f"scan_kernel n={n} presorted={presorted} {pname} "
                                f"host_mask={host} dedup={dedup}")
                        got = scan_ops.scan_kernel(lanes, keys, bounds, num_pk, prog, n, dedup,
                                                   presorted, dev, mask=mask)
                        want = scan_ops.scan_kernel_plain(
                            lanes, keys, num_pk, scan_plain_mask(torch, F, prog, lanes, n, mask,
                                                                 dev), dedup, presorted)
                        torch.cuda.synchronize()
                        same_scan(torch, got, want, what)
    require(device_lane(np.zeros(1, np.uint64)).dtype == np.int64, "u64 lanes map to int64")


# -- phase 2, continued: both paths of grouped_stats' sort (csrc/onesweep.cuh)

def same_bits(torch, got: dict, want: dict, what: str) -> None:
    """Counts, min and max exact (NaN == NaN); sums and means bitwise as
    u64 views, but NaN cells compared as NaN (the card's additions return
    another NaN payload than the CPU's) and zero cells by value (the plain
    fold starts from +0.0, the kernel's from the cell's first row)."""
    for k in ("count", "min", "max"):
        a, b = got[k].cpu(), want[k].cpu()
        require(a.dtype == b.dtype and same_values(torch, a, b), f"{what}: {k} != plain")
    for k in ("sum", "mean"):
        a, b = got[k].cpu(), want[k].cpu()
        require(a.dtype == b.dtype, f"{what}: {k} dtype != plain")
        if a.dtype != torch.float64:
            require(torch.equal(a, b), f"{what}: {k} != plain")
            continue
        nan = b.isnan()
        require(torch.equal(a.isnan(), nan), f"{what}: {k} NaN cells != plain")
        a, b = a[~nan], b[~nan]
        nz = b != 0
        require(torch.equal(a == 0, b == 0) and torch.equal(a[nz].view(torch.int64),
                                                            b[nz].view(torch.int64)),
                f"{what}: {k} not bitwise equal to plain")


def sort_path_ids(rng, n: int, segments: int, order: str):
    """Ids, mask and whether the kept ids are in order: `presorted` (no
    dropped row), `presorted_dropped` (dropped rows with stray ids among
    sorted kept rows, as the fused scan hands them over) or `shuffled`."""
    idx = rng.integers(0, segments, n)
    ok = np.ones(n, bool)
    if order != "shuffled":
        idx = np.sort(idx)
    if order != "presorted":
        drop = rng.random(n) < 0.15
        ok[drop & (rng.random(n) < 0.5)] = False
        idx[drop & ok] = rng.choice([-1, segments, segments + 7], int((drop & ok).sum()))
    if order == "shuffled" and n > 1:
        idx[:2], ok[:2] = [1, 0], True  # kept and out of order
    return idx, ok, order != "shuffled" or n < 2


def special_values(rng, kind: str, n: int):
    """f64 with NaN payloads, +-0.0 and +-inf among non-dyadic values, or
    int64 / uint64 values whose sums wrap past 2^64; and the unsigned flag."""
    if kind == "f64":
        v = rng.uniform(-1e3, 1e3, n)
        nans = np.array([0x7FF8000000000123, 0xFFF8000000000456, 0x7FF0000000000001],
                        np.uint64).view(np.float64)
        pick = rng.choice(n, n // 50, replace=False)
        v[pick] = np.resize(np.concatenate([nans, [0.0, -0.0, np.inf, -np.inf, -0.0]]),
                            len(pick))
        return v, False
    if kind == "i64":
        return rng.integers(2**62, 2**63 - 1, n).astype(np.int64) * rng.choice([-1, 1], n), False
    return rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64, endpoint=True).view(np.int64), True


def check_sort_paths(torch, rng, dev) -> dict:
    """grouped_stats and downsample on the edge cases of their sort against
    their plain versions on CPU copies, bitwise (`same_bits`), and again on
    the card (bitwise repeatable): segment counts at the 8-bit digit edges
    (255, 256, 257, 2^16, 2^24, 2^24 + 1), row counts 0, 1, a tile (4,096)
    +-1 and 2^20 + 3, every row dropped, one cell of 10^6 rows (alone and
    among other cells), NaN payloads, +-0.0, +-inf, int64 and uint64 sums
    that wrap, int64 ids past 2^32; over presorted rows (the partition),
    presorted rows with dropped rows interleaved, and shuffled rows (the
    look-back digit passes). Each launch's path must match its rows' order.
    Returns the count of cases per path."""
    from horaedb_tpu_torch.ops import aggregate as agg

    paths = {"presorted": 0, "radix": 0}

    def run(what, v, idx, ok, segments, unsigned, presorted):
        cv, ci, cok = (torch.from_numpy(a).to(dev) for a in (v, idx, ok))
        got, scratch = agg.grouped_stats_cuda(cv, ci, cok, segments, unsigned)
        want = agg.grouped_stats_plain(*(torch.from_numpy(a) for a in (v, idx, ok)), segments,
                                       unsigned)
        same_bits(torch, got, want, what)
        again = agg.grouped_stats(cv, ci, cok, segments, unsigned=unsigned)
        require(all(torch.equal(got[k].view(torch.int64), again[k].view(torch.int64))
                    for k in got), f"{what}: not bitwise repeatable")
        if len(idx):
            took = agg.took_presorted_path(scratch, len(idx))
            require(took == presorted, f"{what}: took the {'presorted' if took else 'radix'} path")
            paths["presorted" if took else "radix"] += 1

    orders = ("presorted", "presorted_dropped", "shuffled")
    for segments in (255, 256, 257, 2**16, 2**24, 2**24 + 1):
        for order in orders:
            idx, ok, pre = sort_path_ids(rng, 300_001, segments, order)
            run(f"grouped_stats {segments} segments {order}", rng.uniform(-1e3, 1e3, len(idx)),
                idx.astype(np.int32), ok, segments, False, pre)
    for n in (0, 1, 4095, 4096, 4097, 2**20 + 3):
        for order in orders[1:]:
            idx, ok, pre = sort_path_ids(rng, n, 1000, order)
            run(f"grouped_stats n={n} {order}", rng.uniform(-1e3, 1e3, n), idx.astype(np.int32),
                ok, 1000, False, pre)
    n = 50_000
    run("grouped_stats every row masked", rng.uniform(-1e3, 1e3, n),
        rng.integers(0, 100, n).astype(np.int32), np.zeros(n, bool), 100, False, True)
    run("grouped_stats every id out of range", rng.uniform(-1e3, 1e3, n),
        rng.integers(100, 10**6, n).astype(np.int32), np.ones(n, bool), 100, False, True)
    big = 10**6
    run("grouped_stats one cell of 10^6 rows", rng.uniform(-1e3, 1e3, big),
        np.ones(big, np.int32), np.ones(big, bool), 5000, False, True)
    idx = rng.integers(0, 5000, big + 300_000).astype(np.int32)
    idx[rng.choice(len(idx), big, replace=False)] = 1
    run("grouped_stats one cell of 10^6 rows among others", rng.uniform(-1e3, 1e3, len(idx)),
        idx, np.ones(len(idx), bool), 5000, False, False)
    idx = rng.integers(0, 1000, 100_000).astype(np.int64)
    far = rng.random(len(idx)) < 0.3
    idx[far] += rng.choice([2**32, 2**33, 2**40, -(2**32)], int(far.sum()))
    run("grouped_stats int64 ids past 2^32", rng.uniform(-1e3, 1e3, len(idx)), idx,
        rng.random(len(idx)) > 0.1, 1000, False, False)
    for kind in ("f64", "i64", "u64"):
        for order in orders[1:]:
            idx, ok, pre = sort_path_ids(rng, 200_003, 3000, order)
            v, unsigned = special_values(rng, kind, len(idx))
            run(f"grouped_stats {kind} special values {order}", v, idx.astype(np.int32), ok,
                3000, unsigned, pre)

    t0, bucket_ms, n = T0, 60_000, 250_000
    for ns, nb in ((255, 1), (4096, 16), (65281, 257)):  # 255, 2^16 and 2^24 + 1 cells
        for kind in ("f64", "i64", "u64"):
            for order in orders[1:]:
                sid = np.sort(rng.integers(0, ns, n)).astype(np.int32)
                ts = t0 + rng.integers(0, nb * bucket_ms, n).astype(np.int64)
                o = np.lexsort((ts, sid))
                sid, ts = sid[o], ts[o]
                stray = rng.integers(0, 30, n)
                ts[stray == 0] = t0 - 1  # bucket -1
                ts[stray == 1] = t0 + nb * bucket_ms  # past the grid
                ts[stray == 2] = t0 - 10**12
                sid[stray == 3] = ns  # a series past the grid
                ok = rng.random(n) > 0.05
                if order == "shuffled":
                    perm = rng.permutation(n)
                    sid, ts, ok = sid[perm], ts[perm], ok[perm]
                    sid[:2], ts[:2], ok[:2] = [1, 0], t0, True
                v, unsigned = (special_values(rng, kind, n) if kind != "f64"
                               else (rng.uniform(-1e3, 1e3, n), False))
                what = f"downsample {ns} x {nb} {kind} {order}"
                host = [torch.from_numpy(a) for a in (ts, sid, v, ok)]
                card = [a.to(dev) for a in host]
                got, scratch = agg.downsample_cuda(*card, t0, bucket_ms, ns, nb, unsigned)
                same_bits(torch, got, agg.downsample_plain(*host, t0, bucket_ms, ns, nb,
                                                           unsigned), what)
                again = agg.downsample(*card, t0, bucket_ms, ns, nb, unsigned=unsigned)
                require(all(torch.equal(got[k].view(torch.int64),
                                        again[k].reshape(-1).view(torch.int64)) for k in got),
                        f"{what}: not bitwise repeatable")
                took = agg.took_presorted_path(scratch, n)
                require(took == (order != "shuffled"),
                        f"{what}: took the {'presorted' if took else 'radix'} path")
                paths["presorted" if took else "radix"] += 1
    print(f"sort paths: {paths['presorted']} presorted and {paths['radix']} radix launches "
          "bitwise equal to plain", flush=True)
    return paths


class CaptureFused:
    """Keeps the arguments of the first scan_kernel and downsample calls
    made inside the block: the main path's own inputs, for phase 4."""

    def __init__(self):
        self.scan = None
        self.down = None

    def __enter__(self):
        from horaedb_tpu_torch.ops import aggregate as agg
        from horaedb_tpu_torch.ops import scan as scan_ops

        self.orig = (scan_ops.scan_kernel, agg.downsample)

        def scan(*a, **k):
            if self.scan is None:
                self.scan = (a, k)
            return self.orig[0](*a, **k)

        def down(*a, **k):
            if self.down is None:
                self.down = (a, k)
            return self.orig[1](*a, **k)

        scan_ops.scan_kernel, agg.downsample = scan, down
        return self

    def __exit__(self, *exc):
        from horaedb_tpu_torch.ops import aggregate as agg
        from horaedb_tpu_torch.ops import scan as scan_ops

        scan_ops.scan_kernel, agg.downsample = self.orig


def fused_records(torch, cap: CaptureFused, dev, seed: int) -> list[dict]:
    """Phase 4: scan_kernel, downsample and grouped_stats against their
    plain versions on the inputs the first fused query gave them, timed;
    downsample and grouped_stats also on a seeded shuffle of those rows,
    each with the path its sort took and the library yardstick."""
    from horaedb_tpu_torch.ops import aggregate as agg
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.ops import keychain
    from horaedb_tpu_torch.ops import scan as scan_ops

    require(cap.scan is not None and cap.down is not None, "the fused query ran no scan pass")
    records = []
    (lanes, keys, bounds, num_pk, prog, n, dedup, presorted, _d), kw = cap.scan
    mask = kw.get("mask")
    got = scan_ops.scan_kernel(lanes, keys, bounds, num_pk, prog, n, dedup, presorted, dev,
                               mask=mask)

    def plain_scan():
        return scan_ops.scan_kernel_plain(
            lanes, keys, num_pk, scan_plain_mask(torch, F, prog, lanes, n, mask, dev), dedup,
            presorted)

    same_scan(torch, got, plain_scan(), "scan_kernel at the main path shape")
    kept = int(got[4].item())
    packed = keychain.pack_lanes(bounds)
    # each distinct input lane read once (the tsid and ts key lanes are also
    # gathered lanes), every gathered lane written once, 4 B of perm and 2 B
    # of flags per row
    inputs = {t.data_ptr(): t.numel() * t.element_size()
              for t in [*keys, *lanes.values()] + ([mask] if mask is not None else [])}
    lit = 0 if prog is None else sum(a.nbytes for a in (prog.code, prog.lit_i64, prog.lit_f64,
                                                        prog.set_i64, prog.set_f64))
    out_bytes = sum(t.numel() * t.element_size() for t in lanes.values()) + n * (4 + 2)
    nb, kind = bound(sum(inputs.values()) + lit + out_bytes, 0)
    del got
    records.append({
        "name": "scan_kernel", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/scan.cu + predicate.cu, keychain.cuh, onesweep.cuh",
        "replaces": "horaedb_tpu/storage/read.py:926",
        "shape": f"{n} rows, {len(keys)} key lanes ({', '.join(str(b) for b in bounds)}), "
                 f"{len(lanes)} gathered lanes ({', '.join(lanes)}), presorted={presorted}, "
                 f"predicate on the device={prog is not None}, {kept} kept",
        "sort_path": (f"partition, then {len(packed)} packed keys, "
                      f"{sum(d for _, _, d in packed)} look-back sweeps over the kept rows"),
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: scan_ops.scan_kernel(lanes, keys, bounds, num_pk, prog, n,
                                                          dedup, presorted, dev, mask=mask),
                      iters=5, warmup=1),
        "plain_ms": cuda_ms(torch, plain_scan, iters=3, warmup=1),
        "bound_ms": nb, "bound_by": kind, "library_ms": None,
        "one_key_sort_ms": cuda_ms(torch, lambda: torch.sort(keys[0], stable=True), iters=5,
                                   warmup=1),
    })

    (ts, sid, values, valid, t0, bucket_ms, ns, nbk), kw = cap.down
    unsigned = kw.get("unsigned", False)
    cells = ns * nbk
    rows = ts.shape[0]
    shape = f"{rows} rows, {ns} series x {nbk} buckets = {cells} cells"
    # the same rows shuffled (a torch.Generator seeded from the run's seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    perm = torch.randperm(rows, device=dev, generator=gen)
    shuffled = [None if a is None else a[perm] for a in (ts, sid, values, valid)]
    del perm
    lib_note = "index_add_ x2 + scatter_reduce amin/amax over the unsorted cell ids"
    for name in ("downsample", "grouped_stats"):
        rec = {"name": name, "route": "cuda", "shape": shape, "library_call": lib_note,
               "source": ("horaedb_tpu_torch/ops/csrc/grouped_stats.cu + onesweep.cuh, "
                          "segreduce.cuh" + (" (grouped_stats_downsample_launch)"
                                             if name == "downsample" else "")),
               "replaces": ("horaedb_tpu/ops/aggregate.py:332" if name == "downsample"
                            else "horaedb_tpu/ops/aggregate.py:96")}
        # rows 8 and 5 read ts, sid (or the cell id), the value and the mask
        nb, kind = bound(rows * ((8 + 4 + 8 + 1) if name == "downsample" else (4 + 8 + 1))
                         + cells * 40, 0)
        rec.update(bound_ms=nb, bound_by=kind)
        for order, (ts_o, sid_o, val_o, ok_o) in (("", (ts, sid, values, valid)),
                                                   ("shuffled_", shuffled)):
            bucket = agg.bucket_of(ts_o, t0, bucket_ms)
            in_grid = ok_o.bool() & (bucket >= 0) & (bucket < nbk) & (sid_o >= 0) & (sid_o < ns)
            flat = sid_o * nbk + bucket
            if name == "downsample":
                def kern():
                    return agg.downsample_cuda(ts_o, sid_o, val_o, ok_o, t0, bucket_ms, ns, nbk,
                                               unsigned)

                def plain():
                    return agg.downsample_plain(ts_o, sid_o, val_o, ok_o, t0, bucket_ms, ns, nbk,
                                                unsigned)
            else:
                def kern():
                    return agg.grouped_stats_cuda(val_o, flat, in_grid, cells, unsigned)

                def plain():
                    return agg.grouped_stats_plain(val_o, flat, in_grid, cells, unsigned)
            got, scratch = kern()
            err = same_stats(torch, got, plain(), f"{name} at the main path shape "
                             f"{order.rstrip('_') or 'in scan order'}")
            rec[f"{order}path"] = ("presorted" if agg.took_presorted_path(scratch, rows)
                                   else "radix")
            rec[f"{order}max_abs_err"] = err
            del got, scratch
            rec[f"{order}ms"] = cuda_ms(torch, kern, iters=5, warmup=1)
            rec[f"{order}plain_ms"] = cuda_ms(torch, plain, iters=3, warmup=1)
            rec[f"{order}library_ms"] = cuda_ms(
                torch, stats_library(torch, val_o, torch.where(in_grid, flat.long(), cells), cells),
                iters=5, warmup=1)
        print(f"{name} [{shape}]: {rec['path']} path {rec['ms']:.4f} ms (library "
              f"{rec['library_ms']:.4f}); shuffled: {rec['shuffled_path']} path "
              f"{rec['shuffled_ms']:.4f} ms (library {rec['shuffled_library_ms']:.4f})", flush=True)
        records.append(rec)
    return records


def stats_library(torch, values, idx, cells: int):
    """The library yardstick of rows 5 and 8: two index_add_ and two
    scatter_reduce over the same unsorted ids (dropped rows at the
    sentinel cell `cells`)."""
    ones = torch.ones_like(values)

    def library():
        dev = values.device
        torch.zeros(cells + 1, dtype=values.dtype, device=dev).index_add_(0, idx, values)
        torch.zeros(cells + 1, dtype=values.dtype, device=dev).index_add_(0, idx, ones)
        torch.full((cells + 1,), torch.inf, dtype=values.dtype, device=dev).scatter_reduce_(
            0, idx, values, "amin", include_self=True)
        torch.full((cells + 1,), -torch.inf, dtype=values.dtype, device=dev).scatter_reduce_(
            0, idx, values, "amax", include_self=True)

    return library


# -- phase 2, continued: the decode kernels ------------------------------------

DECODE_NAMES = {"dict": "decode_unpack", "dod": "decode_dod", "xor": "decode_xor",
                "rle": "decode_rle"}
DECODE_REPLACES = {"dict": "horaedb_tpu/ops/decode.py:94", "dod": "horaedb_tpu/ops/decode.py:125",
                   "xor": "horaedb_tpu/ops/decode.py:152", "rle": "horaedb_tpu/ops/decode.py:171"}


def decode_cases(rng):
    """(name, codec, array, page_rows, extra encoder args) of phase 2's
    decode checks: widths 0, 1, 17, 31 and 32 on every bit-packed codec, a
    middle page of width 33, pages of 1, 2, 3, 4,095, 4,096 and 10,000 rows, wraps
    mod 2^64, NaN payloads and +-0.0 and +-inf, values >= 2^63, i4/u4 lanes;
    rle and xor past one batch (1,024 runs) and one chunk (4,096 rows)."""
    i64 = np.iinfo(np.int64)

    def dod_at(width: int, n: int = 9000, g=rng) -> np.ndarray:
        """Timestamps whose zigzag second differences need `width` bits."""
        half = 1 << max(width - 1, 0)
        dd = g.integers(-half, half, n - 2) if width else np.zeros(n - 2, np.int64)
        if width:
            dd[n // 2] = -half  # zigzag(-2^(w-1)) = 2^w - 1
        d = 15_000 + np.concatenate([[0], np.cumsum(dd)])
        return T0 + np.concatenate([[0], np.cumsum(d)]).astype(np.int64)

    def xor_at(width: int, n: int = 9000) -> np.ndarray:
        low = rng.integers(0, 1 << width, n, dtype=np.uint64) if width else np.zeros(n, np.uint64)
        if width:
            low[::2] |= np.uint64(1 << (width - 1))
            low[1::2] &= np.uint64((1 << (width - 1)) - 1)
        return (np.uint64(0x4059_0000_0000_0000) ^ low).view(np.float64)

    def dict_at(width: int, n: int = 9000) -> np.ndarray:
        k = 1 << width
        return (rng.permutation(np.arange(n) % k) * 7919).astype(np.int64)

    w33 = np.zeros(3000, np.int64)
    w33[1500] = 2**31  # zigzag 2^32: the middle page needs 33 bits
    f32 = rng.normal(size=9000).astype(np.float32)
    f32[:5] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
    f32[5] = np.array(0x7FC0_1234, np.uint32).view(np.float32)
    nan_payloads = (np.uint64(0x7FF8_0000_0000_0000)
                    | rng.integers(0, 1 << 20, 9000, dtype=np.uint64)).view(np.float64)
    cases = [(f"dod width {w}", "dod", dod_at(w), 4096, ()) for w in (0, 1, 17, 31, 32)]
    cases += [(f"xor f64 width {w}", "xor", xor_at(w), 4096, ()) for w in (0, 1, 17, 31, 32)]
    cases += [(f"dict width {w}", "dict", dict_at(w, 9000 if w < 17 else 1 << 17), 4096,
               (1 << max(w, 12),)) for w in (0, 1, 17)]
    cases += [
        ("dod middle page width 33", "dod", w33, 1000, ()),
        ("dod pages of 4096 + 1 rows", "dod", dod_at(7, 4097), 4096, ()),
        ("dod pages of 4096 + 2 rows", "dod", dod_at(7, 4098), 4096, ()),
        ("dod pages of 4096 + 3 rows", "dod", dod_at(7, 4099), 4096, ()),
        ("dod page_rows 10000", "dod", dod_at(9, 25_000), 10_000, ()),
        ("dod i64 extremes", "dod", np.asarray([i64.min, 0, i64.max, -1, 1, i64.min + 1],
                                               np.int64), 4096, ()),
        ("dod wrap of test_encoding.py:329", "dod",
         np.asarray([2**62, -(2**62), 2**62 - 7, 5], np.int64), 4096, ()),
        ("dod wraps mod 2^64 inside the envelope", "dod", np.asarray(
            [i64.max - 2, i64.max - 1, i64.max, i64.min, i64.min + 1], np.int64), 4096, ()),
        ("xor f64 NaN payloads", "xor", nan_payloads, 4096, ()),
        ("xor f64 +-0.0, +-inf, NaN", "xor", np.tile([0.0, -0.0, np.inf, -np.inf, np.nan], 900),
         4096, ()),
        ("xor f32 NaN payload, +-0.0, +-inf", "xor", f32, 4096, ()),
        ("dict u64 >= 2^63", "dict", np.uint64(2**63) + rng.integers(0, 9, 9000).astype(
            np.uint64) * np.uint64(2**59), 4096, (4096,)),
        ("dict i4", "dict", rng.integers(-3, 3, 9000).astype(np.int32), 4096, (4096,)),
        ("dict u4", "dict", rng.integers(2**31, 2**31 + 9, 9000).astype(np.uint32), 4096,
         (4096,)),
        ("rle u64 >= 2^63", "rle", np.repeat(np.uint64(2**64 - 1) - np.arange(
            900, dtype=np.uint64) * np.uint64(2**50), 10), 4096, ()),
        ("rle runs of length 1", "rle", rng.integers(-9, 9, 9000).astype(np.int64), 4096, ()),
        ("rle one run across a page", "rle", np.concatenate(
            [np.zeros(7, np.int64), np.full(9000, 5, np.int64), np.ones(3, np.int64)]), 4096, ()),
        ("rle u4", "rle", np.repeat(np.arange(300, dtype=np.uint32) + np.uint32(2**31), 30),
         4096, ()),
    ]
    # its own draws, so the later phases' data stays as it was
    cases.append(("dod pages of 4095 rows", "dod", dod_at(17, 8191, np.random.default_rng(12)),
                  4095, ()))
    big = np.random.default_rng(15)
    low = big.integers(0, 1 << 31, 20_000, dtype=np.uint64)
    low[::2] |= np.uint64(1 << 30)  # each XOR delta sets bit 30: width 31
    low[1::2] &= np.uint64((1 << 30) - 1)
    cases += [
        ("rle page_rows 10000, one run a page", "rle", np.repeat(
            np.array([2**64 - 1, 2**63], np.uint64), 10_000), 10_000, ()),
        ("rle page_rows 10000, runs of 1", "rle", np.uint64(2**63) + np.arange(
            20_000, dtype=np.uint64) * np.uint64(7), 10_000, ()),
        ("rle u4 page_rows 10000, runs of 1", "rle", np.arange(20_000, dtype=np.uint32)
         + np.uint32(2**31), 10_000, ()),
        ("rle pages of 1 row", "rle", big.integers(-9, 9, 5).astype(np.int64), 1, ()),
        ("xor f32 page_rows 10000", "xor", np.abs(big.normal(3, 2, 20_000)).astype(np.float32),
         10_000, ()),
        ("xor f64 width 31, page_rows 10000", "xor",
         (np.uint64(0x4059_0000_0000_0000) ^ low).view(np.float64), 10_000, ()),
    ]
    return cases


def check_decode_kernels(torch, rng, dev) -> None:
    """Each decode kernel against its plain version on the same staged
    pages, bitwise on u64 views, and each lane's device decode against the
    array it encodes (pages outside the envelope come from the host)."""
    from horaedb_tpu_torch.ops import decode
    from horaedb_tpu_torch.storage import encoding as enc

    widths = {}
    for name, codec, arr, page_rows, extra in decode_cases(rng):
        lane = getattr(enc, f"_encode_{codec}")(arr, page_rows, *extra)
        lane.name = name
        dt = np.dtype(lane.dtype)
        on_dev = [p for p in lane.pages if decode.in_envelope(codec, dt, p, lane.dict_values)]
        widths[name] = sorted({p.width for p in lane.pages})
        if on_dev:
            staged = decode.stage_pages(codec, dt, lane.payload, on_dev, lane.dict_values, dev)
            got, want = decode.run_pages(staged), decode.run_pages_plain(staged)
            torch.cuda.synchronize()
            require(torch.equal(got.cpu(), want.cpu()), f"{DECODE_NAMES[codec]} != plain on "
                                                        f"{name!r}")
        out = enc.decode_lane(lane, impl="device", device=dev)
        require(out.dtype == arr.dtype and np.array_equal(out.view(np.uint8), arr.view(np.uint8)),
                f"device decode of {name!r} differs from its input")
        require(len(on_dev) == sum(p.width <= 32 for p in lane.pages),
                f"{name!r}: the envelope is width <= 32")
    for name, want in (("dod width 17", [17]), ("xor f64 width 31", [31]),
                       ("xor f64 width 31, page_rows 10000", [31]),
                       ("dict width 17", [17]), ("dod middle page width 33", [0, 33]),
                       ("xor f64 width 32", [32])):
        require(widths[name] == want, f"{name!r} encoded at widths {widths[name]}")
    for codec in DECODE_NAMES:  # a lane of no pages, and a page of no rows
        require(decode.decode_pages(codec, "<i8" if codec != "xor" else "<f8", b"", [], [1],
                                    dev).shape == (0,), f"{codec}: no pages")


class CaptureDecode:
    """Keeps, per codec, the staged pages of the largest decode launched
    inside the block while `on` is set: the main path's own inputs, for
    phase 4 (the calibration's synthetic lanes are left out)."""

    def __init__(self):
        self.staged = {}
        self.on = False

    def __enter__(self):
        from horaedb_tpu_torch.ops import decode

        self.orig = decode.run_pages

        def run(s):
            old = self.staged.get(s.codec)
            if self.on and (old is None or s.rows > old.rows):
                self.staged[s.codec] = s
            return self.orig(s)

        decode.run_pages = run
        return self

    def __exit__(self, *exc):
        from horaedb_tpu_torch.ops import decode

        decode.run_pages = self.orig


def decode_library(torch, decode, s, got):
    """The library yardstick of a decode kernel on staged pages `s`, whose
    kernel output is `got`: (call, what it computes), or None where no
    PyTorch call computes the function (xor). rle: repeat_interleave of the
    run values by their lengths (both read from the pages' payload words),
    checked equal to `got`; dict: the plain
    unpack of the ids and one dictionary gather, checked equal; dod: the
    plain unpack and two cumsums (no segments, no zigzag: fewer calls than
    the function needs)."""
    table = s.table.cpu().numpy()
    itemsize = s.dtype.itemsize
    dev = s.words.device
    if s.codec == "rle":
        words = s.words.cpu().numpy()
        vals, lens = [], []
        for _out_off, _rows, wo, _w, runs, _p1 in table:
            w = words[wo:wo + runs * itemsize // 4]
            vals.append(w.view(np.int64) if itemsize == 8 else w)
            at = wo + runs * itemsize // 4
            lens.append(words[at:at + runs].view(np.uint32).astype(np.int64))
        vals_t = torch.from_numpy(np.concatenate(vals)).to(dev)
        lens_t = torch.from_numpy(np.concatenate(lens)).to(dev)

        def library():
            return torch.repeat_interleave(vals_t, lens_t, output_size=s.rows)
        require(torch.equal(library().cpu(), got.cpu()),
                "repeat_interleave differs from decode_rle")
        return library, "repeat_interleave of the run values by their lengths"
    if s.codec == "xor":
        return None
    _page, i, t = decode._row_pages(s.table, s.rows)
    wd, wo = t[:, 3], t[:, 2]
    if s.codec == "dict":
        def library():
            return s.dict_bits[decode._unpack_plain(s.words, wo, i * wd, wd)]
        require(torch.equal(library().cpu(), got.cpu()),
                "unpack + gather differs from decode_unpack")
        return library, "the plain unpack of the ids + one dictionary gather"
    bit = (i - 2).clamp(min=0) * wd

    def library():
        z = decode._unpack_plain(s.words, wo, bit, wd)
        return torch.cumsum(torch.cumsum(z, 0), 0)
    return library, "the plain unpack + two cumsum (no segments, no zigzag)"


def decode_records(torch, cap: CaptureDecode, dev) -> list[dict]:
    """Phase 4, continued: the four decode kernels against their plain
    versions on the largest lane each decoded on the 3g/3h paths, timed,
    with their library yardsticks (decode_library)."""
    from horaedb_tpu_torch.ops import decode

    records = []
    for codec, name in DECODE_NAMES.items():
        require(codec in cap.staged, f"no {name} launch was captured on the encoded paths")
        s = cap.staged[codec]
        itemsize = s.dtype.itemsize
        got, want = decode.run_pages(s), decode.run_pages_plain(s)
        require(torch.equal(got.cpu(), want.cpu()), f"{name} != plain at the main path shape")
        table = s.table.cpu().numpy()
        rows, width = table[:, 1], table[:, 3]
        args = ((s.words, s.table, s.dict_bits, s.rows) if codec == "dict"
                else (s.words, s.table, s.rows, itemsize))
        kern, plain = getattr(decode, name), getattr(decode, f"{name}_plain")
        library, call = decode_library(torch, decode, s, got) or (None, None)
        if codec == "rle":
            in_bytes = int(table[:, 4].sum()) * (itemsize + 4)
        else:
            stream = {"dict": rows, "dod": np.maximum(rows - 2, 0),
                      "xor": np.maximum(rows - 1, 0)}[codec]
            in_bytes = float((stream * width).sum()) / 8
            if codec == "dict":
                in_bytes += s.dict_bits.numel() * itemsize
        nb, kind = bound(in_bytes + s.rows * itemsize, 0)
        records.append({
            "name": name, "route": "cuda",
            "source": f"horaedb_tpu_torch/ops/csrc/{name}.cu + bitunpack.cuh",
            "replaces": DECODE_REPLACES[codec],
            "shape": f"{s.rows} rows, {len(table)} pages, {s.dtype.str}, widths "
                     f"{sorted(set(width.tolist()))}"
                     + (f", {int(table[:, 4].sum())} runs" if codec == "rle" else ""),
            "max_abs_err": 0.0,
            "ms": cuda_ms(torch, lambda: kern(*args)),
            "plain_ms": cuda_ms(torch, lambda: plain(*args)),
            "bound_ms": nb, "bound_by": kind,
            "library_ms": cuda_ms(torch, library) if library is not None else None,
            "library_call": call,
        })
    return records


# -- phase 2, continued: lane_sum_count, segment_last_value, kernel B's bf16 flag

def lane_within_budget(torch, s, ps, k: np.ndarray, v: np.ndarray, cells: int) -> float:
    """Largest |kernel - plain| of lane_sum_count sums, required within
    2^-20 x the cell's L1 mass (f32 atomics add in no fixed order)."""
    l1 = np.bincount(np.clip(k, 0, cells), weights=np.abs(v.astype(np.float64)),
                     minlength=cells + 1)[:cells]
    err = np.abs(s.cpu().numpy().astype(np.float64) - ps.cpu().numpy().astype(np.float64))
    require(bool(np.all(err <= 2.0 ** -20 * l1)), "lane_sum_count sums beyond 2^-20 x L1")
    return float(err.max()) if err.size else 0.0


I64_MIN = -(2**63)


def check_agg_kernels(torch, rng, dev) -> None:
    """Phase 2: lane_sum_count (counts exact, sums within 2^-20 x L1) and
    segment_last_value (bitwise, u64 views) against their plain versions on
    CPU copies, on edge cases; kernel B's bf16 flag bitwise against its
    plain version."""
    from horaedb_tpu_torch.ops import aggregate as agg
    from horaedb_tpu_torch.ops import blockagg

    lane_cases = [("n % 8 = 3, ids < 0 and >= C", 1003, 50, False),
                  ("weights, n % 8 = 5, ids < 0 and >= C", 10_005, 700, True),
                  ("empty input", 0, 16, False), ("tail rows only", 6, 16, True),
                  ("2^18 rows into 2^19 cells", 1 << 18, 1 << 19, True)]
    for name, n, cells, weighted in lane_cases:
        k = rng.integers(-3, cells + 3, n).astype(np.int32)
        v = (rng.normal(size=n) * 100).astype(np.float32)
        w = (rng.random(n) > 0.3).astype(np.float32) if weighted else None
        host = [torch.from_numpy(a) for a in (k, v)]
        hw = None if w is None else torch.from_numpy(w)
        s, c = agg.lane_segment_sum_count(*(a.to(dev) for a in host), cells,
                                          w=None if hw is None else hw.to(dev))
        ps, pc = agg.lane_segment_sum_count(*host, cells, w=hw)
        torch.cuda.synchronize()
        require(s.dtype == torch.float32 and torch.equal(c.cpu(), pc),
                f"lane_sum_count counts != plain on {name!r}")
        lane_within_budget(torch, s, ps, k, v, cells)

    n, segs = 1_000_003, 300_000
    for name in ("ties", "empty segments", "invalid rows", "seq spans 2^33", "seq >= 2^63 (u64)",
                 "no rows"):
        vals = rng.normal(size=n)
        vals[rng.choice(n, 60, replace=False)] = np.resize([np.nan, -0.0, np.inf, -np.inf], 60)
        index = rng.integers(-2, segs + 2, n).astype(np.int32)
        valid = rng.random(n) > (0.5 if name == "invalid rows" else 0.0)
        seq = rng.integers(0, 4, n).astype(np.uint64)  # ties
        m = segs
        if name == "empty segments":
            m = 8 * segs
        elif name == "seq spans 2^33":  # the u64 keys' route
            seq = seq + np.where(rng.random(n) > 0.5, np.uint64(2**33), np.uint64(0))
        elif name.startswith("seq"):  # the 16-byte CAS route
            seq = seq + np.uint64(2**63) - np.where(rng.random(n) > 0.5, np.uint64(2),
                                                    np.uint64(0))
        elif name == "no rows":
            vals, seq, index, valid = vals[:0], seq[:0], index[:0], valid[:0]
        host = [torch.from_numpy(a) for a in (vals, agg.seq_as_int64(seq), index, valid)]
        got = agg.segment_last_value(*(a.to(dev) for a in host), m)
        want = agg.segment_last_value(*host, m)
        torch.cuda.synchronize()
        require(np.array_equal(got.cpu().numpy().view(np.uint64), want.numpy().view(np.uint64)),
                f"segment_last_value != plain on {name!r}")

    k = np.sort(rng.integers(0, 3000, 200_000)).astype(np.int32)
    v = rng.normal(size=len(k)).astype(np.float32).astype(np.float64) * 1e3
    host = [torch.from_numpy(a) for a in (k, v)]
    got = blockagg.block_sum_count(*(a.to(dev) for a in host), 3000, bf16=True)
    want = blockagg.block_sum_count(*host, 3000, bf16=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        require(np.array_equal(a.cpu().numpy().view(np.uint64), b.numpy().view(np.uint64)),
                "block_sum_count with round_bf16 != plain")


def last_write_inputs(rng):
    """Phase 3k's host lanes: one row per segment of 3a's segment (7.2M)
    with a seq from its write batch, and a 5 % re-send of them with a
    higher seq, shuffled. (values, seq, index, segments, re-sent rows, the
    value each segment holds last)."""
    segs = NUM_SERIES * (SEGMENT_MS // INTERVAL_MS)
    resend = int(rng.binomial(segs, RESEND_FRACTION))
    again = rng.choice(segs, resend, replace=False)
    index = np.concatenate([np.arange(segs), again]).astype(np.int32)
    seq = np.concatenate([rng.integers(1, 2 * BATCHES_PER_SEGMENT + 1, segs),
                          np.full(resend, 2 * BATCHES_PER_SEGMENT + 1)]).astype(np.int64)
    vals = rng.uniform(0, 100, len(index))
    perm = rng.permutation(len(index))
    want = vals[:segs].copy()
    want[again] = vals[segs:]
    return vals[perm], seq[perm], index[perm], segs, resend, want


def last_write_path(torch, rng, dev, counted) -> tuple[dict, tuple]:
    """Phase 3k: the last write of each segment at a dedup shape like phase
    3a's segment (7.2M segments, 5 % re-sent rows with a higher seq, rows
    shuffled) through segment_last_value, held against the values written
    last. Returns the record and the inputs phase 4 times."""
    import horaedb_tpu_torch as port
    from horaedb_tpu_torch.ops import aggregate as agg

    vals, seq, index, segs, resend, want = last_write_inputs(rng)
    vt, st, it = (torch.from_numpy(a).to(dev) for a in (vals, seq, index))
    okt = torch.ones(len(index), dtype=torch.bool, device=dev)
    port.reset_launch_counts()
    t = time.perf_counter()
    got = agg.segment_last_value(vt, st, it, okt, segs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counted("last_write", port.launch_counts())
    require(np.array_equal(got.cpu().numpy(), want), "3k: not the last write of every segment")
    print(f"3k last write of {segs} segments from {len(index)} rows in {secs:.4f} s", flush=True)
    return ({"rows": len(index), "segments": segs, "resent": resend, "s": secs},
            (vt, st, it, okt, segs, resend))


def agg_records(torch, dev, last_write: tuple) -> list[dict]:
    """Phase 4: lane_sum_count at the calibration's two shapes (2^18 rows
    into 16,384 and 524,288 cells; its sorted stream, and shuffled under
    `unsorted`) and segment_last_value on phase 3k's inputs, against their
    plain versions on the card, timed."""
    from horaedb_tpu_torch.ops import agg_registry
    from horaedb_tpu_torch.ops import aggregate as agg

    def lane_record(klass: str, kind: str) -> dict:
        k, v, cells = agg_registry.calib_inputs(klass, kind)
        n = len(k)
        kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
        s, c = agg.lane_segment_sum_count(kt, vt, cells)
        ps, pc = agg.lane_sum_count_plain(kt, vt, cells)
        torch.cuda.synchronize()
        require(torch.equal(c, pc), f"lane_sum_count counts != plain at {klass} {kind} shape")
        err = lane_within_budget(torch, s, ps, k, v, cells)
        kc = kt.long().clamp(0, cells)
        ones = torch.ones_like(vt)

        def library():
            torch.zeros(cells + 1, dtype=torch.float32, device=dev).index_add_(0, kc, vt)
            torch.zeros(cells + 1, dtype=torch.float32, device=dev).index_add_(0, kc, ones)

        # each id and value read once (8 B/row: the timed calls pass no
        # weights, which would add 4 B/row), sum and count written once
        # (8 B/cell)
        nb, bound_by = bound(n * (kt.element_size() + vt.element_size()) + cells * 8, 0)
        return {"shape": f"{n} rows into {cells} cells (calibration, {klass}, {kind} ids)",
                "max_abs_err": err,
                "ms": cuda_ms(torch, lambda: agg.lane_segment_sum_count(kt, vt, cells)),
                "plain_ms": cuda_ms(torch, lambda: agg.lane_sum_count_plain(kt, vt, cells)),
                "bound_ms": nb, "bound_by": bound_by, "library_ms": cuda_ms(torch, library)}

    shapes = {klass: {**lane_record(klass, "sorted"), "unsorted": lane_record(klass, "unsorted")}
              for klass in ("dense", "sparse")}
    records = [{"name": "lane_sum_count", "route": "cuda",
                "source": "horaedb_tpu_torch/ops/csrc/lane_sum_count.cu",
                "replaces": "horaedb_tpu/ops/aggregate.py:246", **shapes["dense"],
                "library_call": "index_add_ x2 (f32 value, weight) over the clipped ids",
                "sparse": shapes["sparse"]}]

    vt, st, it, okt, segs, resend = last_write
    n = len(vt)
    got = agg.segment_last_value(vt, st, it, okt, segs)
    want = agg.segment_last_value_plain(vt, st, it, okt, segs)
    torch.cuda.synchronize()
    require(np.array_equal(got.cpu().numpy().view(np.uint64), want.cpu().numpy().view(np.uint64)),
            "segment_last_value != plain at the dedup shape")
    idx = it.long()
    pos = torch.arange(n, device=dev)

    def library():
        mx = torch.full((segs,), I64_MIN, dtype=torch.int64, device=dev).scatter_reduce_(
            0, idx, st, "amax")
        best = torch.full((segs,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, idx, torch.where(st == mx[idx], pos, -1), "amax")
        return vt[best.clamp_(min=0)]

    # each value, seq, index and mask read once (21 B/row), the value of
    # each segment written once (8 B/segment)
    nb, kind = bound(n * 21 + segs * 8, 0)
    def kern():
        return agg.segment_last_value(vt, st, it, okt, segs)

    dms, ops = device_ms(torch, kern, calls=10, with_ops=True)
    records.append({
        "name": "segment_last_value", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/segment_last_value.cu",
        "replaces": "horaedb_tpu/ops/aggregate.py:354",
        "shape": f"{n} rows ({resend} re-sent with a higher seq), {segs} segments",
        "max_abs_err": abs_err(torch, got, want),
        "ms": cuda_ms(torch, kern), "device_ms": dms, "device_ops": ops,
        "plain_ms": cuda_ms(torch, lambda: agg.segment_last_value_plain(vt, st, it, okt, segs)),
        "bound_ms": nb, "bound_by": kind, "library_ms": cuda_ms(torch, library),
        "library_call": "scatter_reduce amax x2 (seq, then position) + a gather"})
    return records


# -- phase 3: the main paths ----------------------------------------------------

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


def arrow_schema(dense: bool):
    import pyarrow as pa

    if dense:
        return pa.schema([("series_id", pa.int64()), ("ts", pa.int64()),
                          ("value", pa.float64())])
    return pa.schema([(n, pa.from_numpy_dtype(dt)) for n, dt in SCHEMA])


def tsbs_batch(tsids, ts, rows, vals, dense: bool = False):
    """Grid rows (series * samples + sample) as one TSBS record batch."""
    import pyarrow as pa

    s, t = rows // len(ts), rows % len(ts)
    if dense:
        arrays = [s.astype(np.int64), ts[t], vals]
    else:
        arrays = [np.full(len(rows), METRIC_ID, np.uint64), tsids[s],
                  np.zeros(len(rows), np.uint64), ts[t], vals]
    return pa.RecordBatch.from_arrays([pa.array(a) for a in arrays], schema=arrow_schema(dense))


async def write_all(storage, rng, data, dense: bool = False, segments=(0, 1)):
    """The shuffled writes plus the re-send, segment by segment."""
    from horaedb_tpu_torch.storage import TimeRange, WriteRequest

    tsids, ts, values, resend, new_values, _final = data
    per_series = len(ts)

    def batch(rows, vals):
        return tsbs_batch(tsids, ts, rows, vals, dense)

    seg_of = (ts - T0) // SEGMENT_MS
    rows_written = 0
    t_start = time.perf_counter()
    for seg in segments:
        rng_seg = TimeRange(T0 + seg * SEGMENT_MS, T0 + (seg + 1) * SEGMENT_MS)
        rows = np.flatnonzero(seg_of[np.arange(len(values)) % per_series] == seg)
        rows = rng.permutation(rows)
        for part in np.array_split(rows, BATCHES_PER_SEGMENT):
            await storage.write(WriteRequest(batch(part, values[part]), rng_seg))
            rows_written += len(part)
        rs = rng.permutation(np.flatnonzero(seg_of[resend % per_series] == seg))
        await storage.write(WriteRequest(batch(resend[rs], new_values[rs]), rng_seg))
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
    require(np.array_equal(got["count"], want["count"]), f"{what}: counts differ")
    require(np.array_equal(got["min"], want["min"]), f"{what}: min differs")
    require(np.array_equal(got["max"], want["max"]), f"{what}: max differs")
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-12, atol=0,
                               err_msg=f"{what}: sums differ")
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = want["sum"] / want["count"]
    np.testing.assert_allclose(got["mean"], mean, rtol=1e-12, atol=0, equal_nan=True,
                               err_msg=f"{what}: means differ")


def bitwise_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k].view(np.uint64), b[k].view(np.uint64)) for k in a)


def scan_oracle(data, series: np.ndarray, t_lo: int, t_hi: int, dense: bool) -> dict:
    """Last-write-wins rows of `series` (sorted indices) with ts in
    [t_lo, t_hi), in primary-key order, as the scan must return them."""
    tsids, ts, _v, _r, _n, final = data
    t_idx = np.flatnonzero((ts >= t_lo) & (ts < t_hi))
    s = np.repeat(series, len(t_idx))
    t = np.tile(t_idx, len(series))
    value = final[s * len(ts) + t]
    if dense:
        return {"series_id": s.astype(np.int64), "ts": ts[t], "value": value}
    return {"metric_id": np.full(len(s), METRIC_ID, np.uint64), "tsid": tsids[s],
            "field_id": np.zeros(len(s), np.uint64), "ts": ts[t], "value": value}


def table_lanes(table) -> dict:
    return {name: table.column(name).to_numpy() for name in table.schema.names}


def lanes_equal(a: dict, b: dict) -> bool:
    def bits(x):
        return x.view(np.uint64) if x.dtype == np.float64 else x
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(bits(a[k]), bits(b[k])) for k in a)


class EnvPin:
    """Set environment variables for one block, restoring them after."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


async def timed_scan(storage, req):
    import pyarrow as pa

    t = time.perf_counter()
    batches = [b async for b in storage.scan(req)]
    secs = time.perf_counter() - t
    return (pa.Table.from_batches(batches) if batches else None), secs


def make_fused_data(rng):
    """Phase 3e's grid in (series, ts) order: 1M series, 60 samples each
    over the 10-minute window, the 5 % re-sent rows and the final value of
    every sample (last write wins)."""
    tsids = np.unique(rng.integers(1, 2**64 - 1, FUSED_SERIES * 2, dtype=np.uint64))
    tsids = np.sort(rng.choice(tsids, FUSED_SERIES, replace=False))
    require(len(tsids) == FUSED_SERIES, "tsid draw collided")
    ts = T0 + np.arange(FUSED_WINDOW_MS // INTERVAL_MS, dtype=np.int64) * INTERVAL_MS
    n = FUSED_SERIES * len(ts)
    values = rng.uniform(0, 100, n)
    resend = rng.choice(n, int(n * RESEND_FRACTION), replace=False)
    new_values = rng.uniform(0, 100, len(resend))
    final = values.copy()
    final[resend] = new_values
    return tsids, ts, values, resend, new_values, final


async def write_fused(storage, rng, data):
    """20 shuffled writes of 3M rows, then the re-send as one write."""
    from horaedb_tpu_torch.storage import TimeRange, WriteRequest

    tsids, ts, values, resend, new_values, _final = data
    seg = TimeRange(T0, T0 + SEGMENT_MS)
    written = 0
    t = time.perf_counter()
    for part in np.array_split(rng.permutation(len(values)), FUSED_WRITES):
        await storage.write(WriteRequest(tsbs_batch(tsids, ts, part, values[part]), seg))
        written += len(part)
    await storage.write(WriteRequest(tsbs_batch(tsids, ts, resend, new_values), seg))
    written += len(resend)
    return written, time.perf_counter() - t


def fused_oracle(final, series=None) -> dict:
    """The 1-minute grids of the final values: every cell holds the 6
    consecutive samples of one series (the grid is in (series, ts) order)."""
    per_cell = FUSED_BUCKET_MS // INTERVAL_MS
    cells = final.reshape(FUSED_SERIES, FUSED_WINDOW_MS // FUSED_BUCKET_MS, per_cell)
    if series is not None:
        cells = cells[series]
    return {"sum": cells.sum(axis=2), "count": np.full(cells.shape[:2], float(per_cell)),
            "min": cells.min(axis=2), "max": cells.max(axis=2)}


def append_schema():
    import pyarrow as pa

    return pa.schema([("tsid", pa.uint64()), ("ts", pa.int64()), ("payload", pa.binary())])


def make_append_data(rng):
    """Phase 3f's writes, (tsid, ts, payload) per row, 16-64 byte payloads,
    and the oracle: one row per (tsid, ts) group, in key order, whose
    payload concatenates the group's bytes in (write, row) order."""
    import pyarrow as pa

    tsids = np.unique(rng.integers(0, 2**64 - 1, APPEND_SERIES * 2, dtype=np.uint64,
                                   endpoint=True))
    tsids = np.sort(rng.choice(tsids, APPEND_SERIES, replace=False))
    n = APPEND_WRITES * APPEND_ROWS
    sid = rng.integers(0, APPEND_SERIES, n)
    ts = T0 + rng.integers(0, APPEND_TS, n).astype(np.int64) * 1000
    lens = rng.integers(16, 65, n)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    blob = rng.integers(0, 256, int(offsets[-1]), dtype=np.uint8)
    payload = pa.BinaryArray.from_buffers(pa.binary(), n, [None, pa.py_buffer(
        offsets.astype(np.int32).tobytes()), pa.py_buffer(blob.tobytes())])
    writes = [pa.RecordBatch.from_arrays(
        [pa.array(tsids[sid[w:w + APPEND_ROWS]]), pa.array(ts[w:w + APPEND_ROWS]),
         payload.slice(w, APPEND_ROWS)], schema=append_schema())
        for w in range(0, n, APPEND_ROWS)]
    order = np.lexsort((np.arange(n), ts, sid))  # stable: (write, row) order within a group
    s_sid, s_ts, s_len = sid[order], ts[order], lens[order]
    head = np.r_[True, (s_sid[1:] != s_sid[:-1]) | (s_ts[1:] != s_ts[:-1])]
    # the payload bytes in sorted row order are the groups' payloads back to back
    out_off = np.concatenate([[0], np.cumsum(s_len)])
    byte_src = np.repeat(offsets[order] - out_off[:-1], s_len) + np.arange(out_off[-1])
    joined = blob[byte_src].tobytes()
    starts = out_off[:-1][head]
    ends = np.r_[starts[1:], out_off[-1]]
    want = {"tsid": tsids[s_sid[head]], "ts": s_ts[head],
            "payload": [joined[a:b] for a, b in zip(starts, ends)]}
    return writes, want


async def main_paths(torch, rng, dev, data, workdir) -> dict:
    import horaedb_tpu_torch as port
    from horaedb_tpu_torch.engine_query import query_downsample
    from horaedb_tpu_torch.objstore import LocalStore
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.storage import (
        ObjectBasedStorage,
        ScanRequest,
        StorageConfig,
        TimeRange,
        UpdateMode,
        WriteRequest,
    )

    tsids, ts, values, resend, new_values, final = data
    want = oracle(tsids, ts, final)
    subset = np.sort(rng.choice(NUM_SERIES, SUBSET, replace=False))
    window = TimeRange(T0, T0 + WINDOW_MS)
    query_pred = F.And(F.Compare("metric_id", "eq", METRIC_ID),
                       F.time_range_pred("ts", window.start, window.end))
    store = LocalStore(f"{workdir}/store")
    out: dict = {"launches": {}}
    launches = {name: 0 for name in port.KERNELS}

    def counted(path: str, counts: dict) -> None:
        out["launches"][path] = {k: v for k, v in counts.items() if v}
        for k, v in counts.items():
            launches[k] += v

    async def open_table(root, dense=False, config=None):
        return await ObjectBasedStorage.try_new(
            root, store, arrow_schema(dense), 2 if dense else 4, SEGMENT_MS, config=config,
            enable_compaction_scheduler=False, start_background_merger=False, device=dev)

    # a. write
    storage = await open_table("tsbs")
    port.reset_launch_counts()
    rows, write_s = await write_all(storage, rng, data)
    torch.cuda.synchronize()
    counted("write", port.launch_counts())
    out["rows_written"] = rows
    out["write_rows_per_s"] = rows / write_s
    out["write_s_incl_parquet_encode"] = write_s
    out["sst_bytes"] = sum(s.meta.size for s in storage.manifest.all_ssts())

    # b. the downsample query, packed route
    port.reset_launch_counts()
    grids, query_s = [], []
    for ids in (tsids, tsids, tsids[subset]):
        t = time.perf_counter()
        grids.append(await query_downsample(storage, ids, window, BUCKET_MS, query_pred))
        query_s.append(time.perf_counter() - t)
    counted("downsample_packed", port.launch_counts())
    check_grids(grids[0], want, "all series")
    require(bitwise_equal(grids[0], grids[1]), "repeat query is not bitwise identical")
    check_grids(grids[2], {k: v[subset] for k, v in want.items()}, "1000-series subset")
    out.update(query_s_all_series=query_s[0], query_s_repeat=query_s[1],
               query_s_subset=query_s[2])

    # c. the chunked route: scan_block_rows at a quarter of a segment's rows
    seg_rows = rows // (WINDOW_MS // SEGMENT_MS)
    chunked = await open_table("tsbs", config=StorageConfig(scan_block_rows=seg_rows // 4))
    port.reset_launch_counts()
    t = time.perf_counter()
    got = await query_downsample(chunked, tsids, window, BUCKET_MS, query_pred)
    out["query_s_chunked"] = time.perf_counter() - t
    counted("downsample_chunked", port.launch_counts())
    for key in ("count", "min", "max"):
        require(np.array_equal(got[key], grids[0][key]), f"chunked route: {key} differs")
    np.testing.assert_allclose(got["sum"], grids[0]["sum"], rtol=1e-12, atol=0,
                               err_msg="chunked route: sums differ")
    await chunked.close()

    # d. raw scans
    seg0 = TimeRange(T0, T0 + SEGMENT_MS)
    scans = {}

    async def raw_scan(name, st, req, expect, env):
        port.reset_launch_counts()
        with EnvPin(**env):
            table, secs = await timed_scan(st, req)
        counts = port.launch_counts()
        counted(f"scan_{name}", counts)
        require(table is not None, f"scan {name}: no rows")
        got = table_lanes(table)
        require(lanes_equal(got, expect), f"scan {name}: differs from the oracle")
        with EnvPin(HORAEDB_SCAN_PATH="host"):
            host, host_secs = await timed_scan(st, req)
        require(lanes_equal(table_lanes(host), got), f"scan {name}: differs from the host route")
        scans[name] = {"rows": table.num_rows, "s": secs, "rows_per_s": table.num_rows / secs,
                       "host_route_s": host_secs,
                       "route": sorted(k for k in counts if counts[k])}

    await raw_scan("auto_metric_eq", storage,
                   ScanRequest(seg0, predicate=F.Compare("metric_id", "eq", METRIC_ID)),
                   scan_oracle(data, np.arange(NUM_SERIES), seg0.start, seg0.end, False), {})
    lo, hi = T0 + 600_000, T0 + SEGMENT_MS - 600_000
    inset = F.And(F.InSet("tsid", tuple(int(v) for v in tsids[subset])),
                  F.time_range_pred("ts", lo, hi))
    await raw_scan("device_inset_1000", storage, ScanRequest(seg0, predicate=inset),
                   scan_oracle(data, subset, lo, hi, False), {"HORAEDB_SCAN_PATH": "device"})
    dense = await open_table("dense", dense=True)
    await write_all(dense, rng, data, dense=True, segments=(0,))
    await raw_scan("device_packed_dense", dense, ScanRequest(seg0),
                   scan_oracle(data, np.arange(NUM_SERIES), seg0.start, seg0.end, True),
                   {"HORAEDB_SCAN_PATH": "device", "HORAEDB_LINK_PROFILE": "skip"})
    out["scans"] = scans
    # m. the default device (a bare "cuda"): 3d's InSet scan, bitwise
    default_dev = await ObjectBasedStorage.try_new(
        "tsbs", store, arrow_schema(False), 4, SEGMENT_MS, enable_compaction_scheduler=False,
        start_background_merger=False)
    require(default_dev._device == dev, f"default device {default_dev._device}, not {dev}")
    inset_req = ScanRequest(seg0, predicate=inset)
    with EnvPin(HORAEDB_SCAN_PATH="device"):
        port.reset_launch_counts()
        got, secs = await timed_scan(default_dev, inset_req)
        counts = port.launch_counts()
        counted("default_device_inset", counts)
        want_scan, _ = await timed_scan(storage, inset_req)
    require(counts["index_merge_filter"] > 0, "default device: the InSet scan ran no kernel F")
    require(got is not None and lanes_equal(table_lanes(got), table_lanes(want_scan)),
            "default device: the InSet scan differs from cuda:0's")
    out["default_device"] = {"device": str(default_dev._device), "inset_rows": got.num_rows,
                             "inset_s": secs}
    await default_dev.close()
    out["profile"] = await profile_paths(torch, storage, tsids, window, query_pred, seg0)
    # l. the mesh on 3a's tables: the sharded scan, the mesh downsample, multisegment
    out["mesh"], out["mesh_capture"] = await mesh_scan_paths(
        torch, dev, data, storage, dense, query_pred, grids[0], want, counted)
    await dense.close()
    await storage.close()

    # e. the fused route: TSBS cpu-only at --scale=1000000
    t = time.perf_counter()
    fdata = make_fused_data(rng)
    out["fused_data_s"] = time.perf_counter() - t
    ftsids, fwindow = fdata[0], TimeRange(T0, T0 + FUSED_WINDOW_MS)
    fpred = F.And(F.Compare("metric_id", "eq", METRIC_ID),
                  F.time_range_pred("ts", fwindow.start, fwindow.end))
    fused = await open_table("tsbs1m", config=StorageConfig(scan_block_rows=FUSED_BLOCK_ROWS))
    port.reset_launch_counts()
    rows, write_s = await write_fused(fused, rng, fdata)
    torch.cuda.synchronize()
    counted("write_1m", port.launch_counts())
    out.update(fused_rows_written=rows, fused_write_rows_per_s=rows / write_s,
               fused_write_s=write_s,
               fused_sst_bytes=sum(s.meta.size for s in fused.manifest.all_ssts()))
    fused_kernels = ("scan_kernel", "downsample", "grouped_stats")

    async def fused_query(name, ids, profiled=False):
        port.reset_launch_counts()
        if profiled:
            grids, summary = await profiled_query(torch, fused, ids, fwindow, FUSED_BUCKET_MS,
                                                  fpred)
            out["profile"]["fused_query"] = summary
            secs = summary["wall_s"]
        else:
            t = time.perf_counter()
            grids = await query_downsample(fused, ids, fwindow, FUSED_BUCKET_MS, fpred)
            secs = time.perf_counter() - t
        counts = port.launch_counts()
        counted(name, counts)
        for k in fused_kernels:
            require(counts[k] > 0, f"{name}: the query did not launch {k}")
        out[f"query_s_{name}"] = secs
        return grids

    t = time.perf_counter()
    fwant = fused_oracle(fdata[5])
    out["fused_oracle_s"] = time.perf_counter() - t
    with CaptureFused() as cap:
        g_all = await fused_query("fused_all", ftsids)
    check_grids(g_all, fwant, "1M series, fused route")
    g_rep = await fused_query("fused_repeat", ftsids, profiled=True)
    require(bitwise_equal(g_all, g_rep), "repeat fused query is not bitwise identical")
    reader = fused.parquet_reader
    t = time.perf_counter()
    await reader._read_tables(fused.select_ssts(fwindow), reader._resolve_read_names(None, False),
                              fpred)
    out["profile"]["fused_query"]["host_read_decode_s"] = time.perf_counter() - t
    del g_rep, fwant
    fsub = np.sort(rng.choice(FUSED_SERIES, FUSED_SUBSET, replace=False))
    g_sub = await fused_query("fused_subset", ftsids[fsub])
    check_grids(g_sub, fused_oracle(fdata[5], fsub), "200,000-series subset, fused route")
    # m. the default device: the same fused query, bitwise
    default_dev = await ObjectBasedStorage.try_new(
        "tsbs1m", store, arrow_schema(False), 4, SEGMENT_MS,
        config=StorageConfig(scan_block_rows=FUSED_BLOCK_ROWS), enable_compaction_scheduler=False,
        start_background_merger=False)
    port.reset_launch_counts()
    t = time.perf_counter()
    g_dd = await query_downsample(default_dev, ftsids[fsub], fwindow, FUSED_BUCKET_MS, fpred)
    out["default_device"]["fused_subset_s"] = time.perf_counter() - t
    counts = port.launch_counts()
    counted("default_device_fused", counts)
    require(counts["scan_kernel"] > 0, "default device: the fused query ran no scan_kernel")
    require(bitwise_equal(g_dd, g_sub), "default device: the fused query differs from cuda:0's")
    await default_dev.close()
    del g_sub, g_dd, g_all, fdata
    await fused.close()

    # f. append mode over binary values
    import pyarrow as pa

    writes, awant = make_append_data(rng)
    app = await ObjectBasedStorage.try_new(
        "append", store, append_schema(), 2, SEGMENT_MS,
        config=StorageConfig(update_mode=UpdateMode.APPEND), enable_compaction_scheduler=False,
        start_background_merger=False, device=dev)
    for b in writes:
        await app.write(WriteRequest(b, TimeRange(T0, T0 + SEGMENT_MS)))
    port.reset_launch_counts()
    table, secs = await timed_scan(app, ScanRequest(TimeRange(T0, T0 + SEGMENT_MS)))
    counts = port.launch_counts()
    counted("scan_append_binary", counts)
    require(counts["scan_kernel"] > 0, "the append-mode scan did not launch scan_kernel")
    require(table is not None and table.num_rows == len(awant["ts"]),
            "append-mode scan: wrong number of groups")
    require(np.array_equal(table.column("tsid").to_numpy(), awant["tsid"])
            and np.array_equal(table.column("ts").to_numpy(), awant["ts"]),
            "append-mode scan: keys differ from the oracle")
    require(table.column("payload").type == pa.binary()
            and table.column("payload").to_pylist() == awant["payload"],
            "append-mode scan: payloads differ from the oracle")
    out["scans"]["append_binary"] = {"rows_in": APPEND_WRITES * APPEND_ROWS,
                                     "groups": table.num_rows, "s": secs}
    await app.close()

    # g, h. encoded (format-v2) tables
    with CaptureDecode() as dcap:
        out["encoded"] = await encoded_paths(torch, rng, dev, store, workdir, counted, dcap)

    # i. the metric engine and the query batcher
    out["engine"] = await engine_paths(torch, rng, dev, workdir, counted)

    # k. the last write of each segment (segment_last_value)
    out["last_write"], out["last_write_capture"] = last_write_path(torch, rng, dev, counted)

    # l. the regioned scatter-gather read
    out["regions"], out["fold_capture"] = await region_paths(torch, rng, dev, counted)
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on a main path")
    out["kernel_launches"] = launches
    out["fused_capture"] = cap
    out["decode_capture"] = dcap
    out["stacked_capture"] = out["engine"].pop("capture")
    from horaedb_tpu_torch.storage.read import _LinkProfile

    out["link_profile"] = _LinkProfile.get(dev)
    return out


def make_enc_data(rng):
    """Phase 3g's grid as [host, field, scrape]: 10,000 hosts, the ten cpu
    fields, 360 scrapes; the 5 % re-sent cells (flat indices) with their new
    values, and the final values (last write wins)."""
    tsids = np.unique(rng.integers(1, 2**64 - 1, NUM_SERIES * 2, dtype=np.uint64))
    tsids = np.sort(rng.choice(tsids, NUM_SERIES, replace=False))
    require(len(tsids) == NUM_SERIES, "tsid draw collided")
    values = rng.uniform(0, 100, (NUM_SERIES, len(CPU_FIELDS), ENC_SCRAPES))
    resend = rng.choice(values.size, int(values.size * RESEND_FRACTION), replace=False)
    new_values = rng.uniform(0, 100, len(resend))
    final = values.copy()
    final.reshape(-1)[resend] = new_values
    return tsids, values, resend, new_values, final


def enc_batch(tsids, flat, vals, metric_id: int, fields: int):
    """Cells of a [host, field, scrape] grid (flat indices) as one batch."""
    import pyarrow as pa

    h, rem = np.divmod(flat, fields * ENC_SCRAPES)
    f, sc = np.divmod(rem, ENC_SCRAPES)
    arrays = [np.full(len(flat), metric_id, np.uint64), tsids[h], f.astype(np.uint64),
              T0 + sc.astype(np.int64) * INTERVAL_MS, vals]
    return pa.RecordBatch.from_arrays([pa.array(a) for a in arrays], schema=arrow_schema(False))


async def write_enc(storage, rng, tsids, values, metric_id, resend=None, new_values=None):
    """120 writes in time order, each holding three scrapes of every host
    and field in the order a remote-write client sends them (scrape, host,
    field), then the re-send as one shuffled write."""
    from horaedb_tpu_torch.storage import TimeRange, WriteRequest

    hosts, fields, scrapes = values.shape
    per = scrapes // ENC_WRITES
    sl, h, f = (a.ravel() for a in np.meshgrid(np.arange(per), np.arange(hosts),
                                               np.arange(fields), indexing="ij"))
    base = (h * fields + f) * scrapes + sl
    flat_values = values.reshape(-1)
    seg = TimeRange(T0, T0 + SEGMENT_MS)
    t = time.perf_counter()
    written = 0
    for w in range(ENC_WRITES):
        cells = base + w * per
        await storage.write(WriteRequest(enc_batch(tsids, cells, flat_values[cells], metric_id,
                                                   fields), seg))
        written += len(cells)
    if resend is not None:
        order = rng.permutation(len(resend))
        await storage.write(WriteRequest(enc_batch(tsids, resend[order], new_values[order],
                                                   metric_id, fields), seg))
        written += len(resend)
    return written, time.perf_counter() - t


def enc_oracle(final, field: int, series=None) -> dict:
    """5-minute grids of one field: every cell holds 30 consecutive scrapes."""
    per_cell = BUCKET_MS // INTERVAL_MS
    cells = final[:, field, :].reshape(final.shape[0], ENC_SCRAPES // per_cell, per_cell)
    if series is not None:
        cells = cells[series]
    return {"sum": cells.sum(axis=2), "count": np.full(cells.shape[:2], float(per_cell)),
            "min": cells.min(axis=2), "max": cells.max(axis=2)}


def enc_scan_oracle(tsids, final, series, field: int, t_lo: int, t_hi: int) -> dict:
    """Rows of `series` (sorted host indices) and one field with ts in
    [t_lo, t_hi), in primary-key order."""
    sc = np.flatnonzero((T0 + np.arange(ENC_SCRAPES) * INTERVAL_MS >= t_lo)
                        & (T0 + np.arange(ENC_SCRAPES) * INTERVAL_MS < t_hi))
    h = np.repeat(series, len(sc))
    t = np.tile(sc, len(series))
    return {"metric_id": np.full(len(h), METRIC_ID, np.uint64), "tsid": tsids[h],
            "field_id": np.full(len(h), field, np.uint64),
            "ts": T0 + t.astype(np.int64) * INTERVAL_MS, "value": final[h, field, t]}


async def sidecar_lanes(store, root: str, storage) -> dict:
    """Codec and page widths per lane of the first SST's sidecar."""
    from horaedb_tpu_torch.storage import encoding as enc

    first = min(storage.manifest.all_ssts(), key=lambda s: s.id)
    sidecar = enc.decode_blob(await store.get(f"{root}/data/{first.id}.enc"))
    return {n: (lane.codec, sorted({p.width for p in lane.pages}))
            for n, lane in sidecar.lanes.items()}


async def encoded_paths(torch, rng, dev, store, workdir, counted, cap) -> dict:
    """Phases 3g and 3h: encoded tables written and read on the card under
    every HORAEDB_DECODE_IMPL pin."""
    import horaedb_tpu_torch as port
    from horaedb_tpu_torch.engine_query import query_downsample
    from horaedb_tpu_torch.ops import decode
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.storage import ObjectBasedStorage, ScanRequest, StorageConfig, TimeRange
    from horaedb_tpu_torch.storage.config import EncodingConfig

    out: dict = {}
    window = TimeRange(T0, T0 + ENC_WINDOW_MS)

    async def open_enc(root):
        return await ObjectBasedStorage.try_new(
            root, store, arrow_schema(False), 4, SEGMENT_MS,
            config=StorageConfig(encoding=EncodingConfig(enabled=True)),
            enable_compaction_scheduler=False, device=dev, time_column="ts")  # 121 writes: the
        # manifest merger folds their deltas, as it would for any ingest

    def query_pred(metric_id: int):
        return F.And(F.Compare("metric_id", "eq", metric_id), F.Compare("field_id", "eq", 0),
                     F.time_range_pred("ts", window.start, window.end))

    async def pinned(name, impl, storage, fn, need=()):
        """Run `fn` under one decode pin with the counts at 0; every SST read
        must take the encoded branch (none under raw)."""
        reader = storage.parquet_reader
        reader.sst_reads = {"encoded": 0, "parquet": 0}
        decode.reset_page_counts()
        port.reset_launch_counts()
        cap.on = impl == "device"
        with EnvPin(HORAEDB_DECODE_IMPL=impl):
            t = time.perf_counter()
            res = await fn()
            secs = time.perf_counter() - t
        cap.on = False
        counts = port.launch_counts()
        counted(name, counts)
        reads = dict(reader.sst_reads)
        if impl == "raw":
            require(reads["encoded"] == 0 and reads["parquet"] > 0, f"{name}: {reads}")
        else:
            require(reads["parquet"] == 0 and reads["encoded"] > 0,
                    f"{name}: an SST read skipped the encoded branch: {reads}")
        for k in need:
            require(counts[k] > 0, f"{name}: the read did not launch {k}")
        if impl in ("raw", "host"):
            require(not any(counts[k] for k in DECODE_NAMES.values()),
                    f"{name}: a decode kernel launched under {impl}")
        return res, {"s": secs, "sst_reads": reads, "pages": decode.page_counts(),
                     "launches": {k: v for k, v in counts.items() if v}}

    # g. TSBS cpu-only, ten fields
    t = time.perf_counter()
    tsids, values, resend, new_values, final = make_enc_data(rng)
    out["data_s"] = time.perf_counter() - t
    cpu = await open_enc("cpu10")
    port.reset_launch_counts()
    rows, write_s = await write_enc(cpu, rng, tsids, values, METRIC_ID, resend, new_values)
    torch.cuda.synchronize()
    counted("enc_write", port.launch_counts())
    del values
    ssts = cpu.manifest.all_ssts()
    require(all(s.meta.format_version == 2 for s in ssts), "an encoded write landed as v1")
    lanes = await sidecar_lanes(store, "cpu10", cpu)
    enc_bytes = sum(m.size for m in await store.list("cpu10/data") if m.path.endswith(".enc"))
    out["cpu10"] = {"rows_written": rows, "write_s": write_s, "write_rows_per_s": rows / write_s,
                    "ssts": len(ssts), "sst_bytes": sum(s.meta.size for s in ssts),
                    "enc_bytes": enc_bytes, "lanes": lanes, "predicted": ENC_CODECS}
    print(f"3g codecs per lane (codec, page widths): {lanes}", flush=True)
    for n, (codec, width) in ENC_CODECS.items():
        require(lanes[n][0] == codec and (codec != "dict" or lanes[n][1] == [width]),
                f"3g lane {n}: {lanes[n]}, predicted {codec} at width {width}")
    pred = query_pred(METRIC_ID)
    subset = np.sort(rng.choice(NUM_SERIES, SUBSET, replace=False))
    want, want_sub = enc_oracle(final, 0), enc_oracle(final, 0, subset)

    async def queries():
        return [await query_downsample(cpu, ids, window, BUCKET_MS, pred)
                for ids in (tsids, tsids, tsids[subset])]

    by_pin = {}
    for impl in ("device", "host", "raw"):
        need = ("decode_unpack", "decode_dod", "decode_rle") if impl == "device" else ()
        grids, stat = await pinned(f"enc_query_{impl}", impl, cpu, queries, need)
        check_grids(grids[0], want, f"3g all hosts, {impl}")
        require(bitwise_equal(grids[0], grids[1]), f"3g repeat query under {impl} differs")
        check_grids(grids[2], want_sub, f"3g 1,000 hosts, {impl}")
        by_pin[impl] = {"stat": stat, "grids": grids}
    for impl in ("host", "raw"):
        for g, d in zip(by_pin[impl]["grids"], by_pin["device"]["grids"]):
            require(bitwise_equal(g, d), f"3g grids under {impl} differ from device")
    cache = f"{workdir}/decode_calib.json"
    with EnvPin(HORAEDB_DECODE_CACHE=cache):
        decode.reset_cache(memory_only=True)
        auto, stat = await pinned("enc_query_auto", "auto", cpu, lambda: query_downsample(
            cpu, tsids, window, BUCKET_MS, pred))
        require(bitwise_equal(auto, by_pin["device"]["grids"][0]), "3g grids under auto differ")
        calib = {}
        for codec in decode.DEVICE_CODECS:
            entry, source = decode.calibration_entry(codec, dev)
            calib[codec] = {"impl": entry["impl"], "rows_per_s": entry["ab"], "n": entry["n"],
                            "source": source}
        decode.reset_cache(memory_only=True)
    by_pin["auto"] = {"stat": stat}
    out["cpu10"]["queries"] = {k: v["stat"] for k, v in by_pin.items()}
    out["cpu10"]["calibration"] = calib
    del by_pin
    lo, hi = T0 + 600_000, T0 + ENC_WINDOW_MS - 600_000
    inset = F.And(F.InSet("tsid", tuple(int(v) for v in tsids[subset])),
                  F.Compare("field_id", "eq", 0), F.time_range_pred("ts", lo, hi))
    expect = enc_scan_oracle(tsids, final, subset, 0, lo, hi)
    scans = {}
    for impl in ("device", "raw"):
        need = ("decode_dod", "decode_rle") if impl == "device" else ()
        table, stat = await pinned(f"enc_scan_{impl}", impl, cpu, lambda: timed_scan(
            cpu, ScanRequest(TimeRange(T0, T0 + SEGMENT_MS), predicate=inset)), need)
        require(table[0] is not None and lanes_equal(table_lanes(table[0]), expect),
                f"3g InSet scan under {impl} differs from the oracle")
        scans[impl] = stat
    out["cpu10"]["scan_inset_1000"] = scans
    out["cpu10"]["profile"] = await pinned_profile(torch, cpu, tsids, window, pred)
    await cpu.close()
    del final

    # h. Prometheus `up`: a healthy fleet, 1.0 everywhere
    up = await open_enc("up")
    ones = np.ones((NUM_SERIES, 1, ENC_SCRAPES))
    port.reset_launch_counts()
    rows, write_s = await write_enc(up, rng, tsids, ones, UP_METRIC_ID)
    torch.cuda.synchronize()
    counted("up_write", port.launch_counts())
    lanes = await sidecar_lanes(store, "up", up)
    print(f"3h codecs per lane (codec, page widths): {lanes}", flush=True)
    require(lanes["value"] == ("xor", [0]), f"3h value lane: {lanes['value']}")
    up_want = enc_oracle(ones, 0)
    up_pred = query_pred(UP_METRIC_ID)
    up_q = {}
    for impl in ("device", "host", "raw"):
        need = ("decode_xor", "decode_dod", "decode_rle") if impl == "device" else ()
        grids, stat = await pinned(f"up_query_{impl}", impl, up, lambda: query_downsample(
            up, tsids, window, BUCKET_MS, up_pred), need)
        check_grids(grids, up_want, f"3h avg_over_time(up[5m]), {impl}")
        require(np.array_equal(grids["mean"], np.ones_like(grids["mean"])), "3h: mean != 1")
        up_q[impl] = stat
    out["up"] = {"rows_written": rows, "write_s": write_s, "lanes": lanes, "queries": up_q}
    await up.close()
    return out


async def pinned_profile(torch, storage, ids, window, pred) -> dict:
    """One encoded query (HORAEDB_DECODE_IMPL=device) under the profilers."""
    with EnvPin(HORAEDB_DECODE_IMPL="device"):
        _grids, summary = await profiled_query(torch, storage, ids, window, BUCKET_MS, pred)
    return summary



# -- phase 3i: the metric engine and the query batcher -------------------------
# TSBS cpu-only --scale=10000 with its ten host tags; the ten cpu fields as
# ten Prometheus metrics; 10 s scrapes for 30 minutes of one 2 h segment,
# sent as 60 remote-write payloads of three scrapes each

ENGINE_SCRAPES = 180
ENGINE_PER_PAYLOAD = 3
ENGINE_WINDOW_MS = ENGINE_SCRAPES * INTERVAL_MS
ENGINE_BUCKET_MS = 60_000
ENGINE_MAX_DELAY_MS = 2  # [metric_engine.query.batching] max_delay, docs/example.toml
TSBS_REGIONS = {
    "us-east-1": ("us-east-1a", "us-east-1b", "us-east-1c", "us-east-1e"),
    "us-west-1": ("us-west-1a", "us-west-1b"),
    "us-west-2": ("us-west-2a", "us-west-2b", "us-west-2c"),
    "eu-west-1": ("eu-west-1a", "eu-west-1b", "eu-west-1c"),
    "eu-central-1": ("eu-central-1a", "eu-central-1b"),
    "ap-southeast-1": ("ap-southeast-1a", "ap-southeast-1b"),
    "ap-southeast-2": ("ap-southeast-2a", "ap-southeast-2b"),
    "ap-northeast-1": ("ap-northeast-1a", "ap-northeast-1c"),
    "sa-east-1": ("sa-east-1a", "sa-east-1b", "sa-east-1c"),
}
BURST_A_PANELS = 16
BURST_B_CLIENTS, BURST_B_METRICS, BURST_B_HOSTS = 3, 5, 8


def engine_hosts(rng) -> tuple[list, np.ndarray]:
    """TSBS cpu-only's ten host tags for NUM_SERIES hosts, drawn from the
    seed as TSBS draws them; the label list of host h (name-sorted, without
    __name__) and each host's rack."""
    regions = list(TSBS_REGIONS)
    region = rng.integers(0, len(regions), NUM_SERIES)
    rack = rng.integers(0, 100, NUM_SERIES)
    picks = {k: rng.integers(0, n, NUM_SERIES) for k, n in
             (("dc", 4), ("os", 3), ("arch", 2), ("team", 4), ("service", 20),
              ("version", 2), ("env", 3))}
    tags = []
    for h in range(NUM_SERIES):
        r = regions[region[h]]
        dcs = TSBS_REGIONS[r]
        t = {b"hostname": b"host_%d" % h, b"region": r.encode(),
             b"datacenter": dcs[picks["dc"][h] % len(dcs)].encode(), b"rack": b"%d" % rack[h],
             b"os": (b"Ubuntu16.10", b"Ubuntu16.04LTS", b"Ubuntu15.10")[picks["os"][h]],
             b"arch": (b"x64", b"x86")[picks["arch"][h]],
             b"team": (b"SF", b"NYC", b"LON", b"CHI")[picks["team"][h]],
             b"service": b"%d" % picks["service"][h],
             b"service_version": b"%d" % picks["version"][h],
             b"service_environment": (b"production", b"staging", b"test")[picks["env"][h]]}
        tags.append(sorted(t.items()))
    return tags, rack


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


class PayloadWriter:
    """Remote-write payloads of every (host, field) series with three
    samples each, encoded straight to protobuf wire bytes: each series'
    label bytes are laid into a template once, and each payload writes only
    its 3 x 18 sample bytes per series (value as fixed64, timestamp as a
    6-byte varint, which holds for 2^35 <= ts < 2^42)."""

    SAMPLE = 18  # 0x12 0x10 | 0x09 f64 | 0x10 varint(6)

    def __init__(self, tags: list, fields: tuple, per_payload: int = ENGINE_PER_PAYLOAD):
        self.per = per_payload
        pieces, starts = [], []
        body_samples = per_payload * self.SAMPLE
        pos = 0
        for lab in tags:
            for f in fields:
                labels = b"".join(
                    b"\x0a" + _varint(len(m)) + m
                    for m in (b"\x0a" + _varint(len(k)) + k + b"\x12" + _varint(len(v)) + v
                              for k, v in [(b"__name__", b"cpu_" + f.encode())] + lab))
                head = b"\x0a" + _varint(len(labels) + body_samples) + labels
                pieces.append(head)
                starts.append(pos + len(head))
                pos += len(head) + body_samples
        self.template = np.frombuffer(b"".join(
            p + b"\x00" * body_samples for p in pieces), dtype=np.uint8).copy()
        self.slots = (np.asarray(starts, np.int64)[:, None]
                      + np.arange(body_samples, dtype=np.int64)).ravel()

    def payload(self, values: np.ndarray, ts: np.ndarray) -> bytes:
        """values: [series, per_payload] f64; ts: [per_payload] int64, one
        per scrape."""
        n = values.shape[0]
        require(int(ts.min()) >= 2**35 and int(ts.max()) < 2**42, "timestamp varint width")
        block = np.empty((n, self.per, self.SAMPLE), np.uint8)
        block[:, :, 0], block[:, :, 1], block[:, :, 2] = 0x12, 0x10, 0x09
        block[:, :, 3:11] = np.ascontiguousarray(values).view(np.uint8).reshape(
            n, self.per, 8)
        block[:, :, 11] = 0x10
        groups = (ts[:, None] >> (7 * np.arange(6))) & 0x7F
        groups[:, :5] |= 0x80
        block[:, :, 12:] = groups.astype(np.uint8)[None]
        self.template[self.slots] = block.reshape(-1)
        return self.template.tobytes()


def engine_oracle(values: np.ndarray, field: int, hosts: np.ndarray) -> dict:
    """1-minute grids of one field over `hosts` (in answer order): six
    scrapes a cell."""
    per = ENGINE_BUCKET_MS // INTERVAL_MS
    cells = values[hosts, field, :].reshape(len(hosts), ENGINE_SCRAPES // per, per)
    return {"sum": cells.sum(axis=2), "count": np.full(cells.shape[:2], float(per)),
            "min": cells.min(axis=2), "max": cells.max(axis=2)}


def same_answer(got, want) -> bool:
    """Engine answers (tsids, grids) bitwise equal: floats as u64 views,
    NaN-aware for the mean (empty cells)."""
    if (got is None) != (want is None):
        return False
    if got is None:
        return True
    if got[0] != want[0]:
        return False
    for k in ("sum", "count", "min", "max"):
        if not np.array_equal(np.asarray(got[1][k]).view(np.uint64),
                              np.asarray(want[1][k]).view(np.uint64)):
            return False
    gm, wm = np.asarray(got[1]["mean"]), np.asarray(want[1]["mean"])
    return bool(np.array_equal(np.isnan(gm), np.isnan(wm))
                and np.array_equal(np.where(np.isnan(gm), 0.0, gm).view(np.uint64),
                                   np.where(np.isnan(wm), 0.0, wm).view(np.uint64)))


class CaptureStacked:
    """Keeps the arguments of the first stacked_downsample call made inside
    the block (burst A's launch), for phase 4."""

    def __init__(self):
        self.args = None

    def __enter__(self):
        from horaedb_tpu_torch.ops import aggregate as agg

        self.orig = agg.stacked_downsample

        def stacked(*a, **k):
            if self.args is None:
                self.args = (a, k)
            return self.orig(*a, **k)

        agg.stacked_downsample = stacked
        return self

    def __exit__(self, *exc):
        from horaedb_tpu_torch.ops import aggregate as agg

        agg.stacked_downsample = self.orig


async def engine_paths(torch, rng, dev, workdir, counted) -> dict:
    """Phase 3i: the TSBS cpu-only dashboard through MetricEngine and the
    query batcher (module docstring)."""
    import asyncio

    import horaedb_tpu_torch as port
    from horaedb_tpu_torch.common.hash import seahash_many
    from horaedb_tpu_torch.common.time_ext import ReadableDuration
    from horaedb_tpu_torch.engine import MetricEngine, QueryRequest
    from horaedb_tpu_torch.engine.types import metric_id_of, series_key_of
    from horaedb_tpu_torch.objstore import LocalStore
    from horaedb_tpu_torch.server import batching
    from horaedb_tpu_torch.serving import ServingTierConfig
    from horaedb_tpu_torch.storage import scanstats

    out: dict = {}
    t = time.perf_counter()
    tags, rack = engine_hosts(rng)
    host_tsid = seahash_many([series_key_of(lab) for lab in tags])
    require(len(np.unique(host_tsid)) == NUM_SERIES, "host tsids collided")
    tsid_host = {int(x): h for h, x in enumerate(host_tsid)}
    values = rng.uniform(0, 100, (NUM_SERIES, len(CPU_FIELDS), ENGINE_SCRAPES))
    writer = PayloadWriter(tags, CPU_FIELDS)
    out["data_s"] = time.perf_counter() - t

    eng = await MetricEngine.open("tsbs_engine", LocalStore(f"{workdir}/engine"),
                                  enable_compaction=False,
                                  serving=ServingTierConfig(enabled=False), device=dev)
    port.reset_launch_counts()
    ts0 = T0 + np.arange(ENGINE_SCRAPES, dtype=np.int64) * INTERVAL_MS
    flat = values.reshape(NUM_SERIES * len(CPU_FIELDS), ENGINE_SCRAPES)
    written, build_s = 0, 0.0
    t = time.perf_counter()
    for p in range(ENGINE_SCRAPES // ENGINE_PER_PAYLOAD):
        sl = slice(p * ENGINE_PER_PAYLOAD, (p + 1) * ENGINE_PER_PAYLOAD)
        tb = time.perf_counter()
        payload = writer.payload(flat[:, sl], ts0[sl])
        build_s += time.perf_counter() - tb
        written += await eng.write_payload(payload)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t - build_s
    counted("engine_write", port.launch_counts())
    del writer, payload
    require(written == values.size, f"engine write: {written} samples of {values.size}")
    data = eng.data_table
    out["write"] = {"samples": written, "payloads": ENGINE_SCRAPES // ENGINE_PER_PAYLOAD,
                    "write_s": write_s, "samples_per_s": written / write_s,
                    "payload_build_s": build_s, "data_ssts": len(data.manifest.all_ssts()),
                    "data_sst_bytes": sum(s.meta.size for s in data.manifest.all_ssts()),
                    "series": sum(eng.series_count(b"cpu_" + f.encode()) for f in CPU_FIELDS)}
    print(f"3i write: {written} samples in {write_s:.2f} s through write_payload "
          f"({written / write_s:.0f} samples/s; payload encoding {build_s:.2f} s apart)",
          flush=True)
    mids = {}
    for f in CPU_FIELDS:
        name = b"cpu_" + f.encode()
        hit = eng.metric_mgr.get(name)
        require(hit is not None and hit[0] == metric_id_of(name), f"metric id of {name}")
        require(eng.series_count(name) == NUM_SERIES, f"series of {name}")
        mids[f] = hit[0]

    window = (T0, T0 + ENGINE_WINDOW_MS)
    batcher = batching.GLOBAL_BATCHER
    batcher.configure(batching.BatchingConfig(
        max_delay=ReadableDuration.millis(ENGINE_MAX_DELAY_MS)))

    def check_answer(req, got, field: int, what: str):
        mid = mids[CPU_FIELDS[field]]
        want_ids = sorted(eng.index_mgr.find_tsids(mid, req.filters, req.matchers))
        require(got is not None and got[0] == want_ids, f"{what}: tsid order")
        hosts = np.array([tsid_host[x] for x in got[0]])
        check_grids(got[1], engine_oracle(values, field, hosts), what)

    async def solo(reqs, name):
        answers, secs = [], []
        port.reset_launch_counts()
        with EnvPin(HORAEDB_BATCH="off"):
            for r in reqs:
                t = time.perf_counter()
                answers.append(await eng.query(r))
                secs.append(time.perf_counter() - t)
        counts = port.launch_counts()
        counted(name, counts)
        require(counts["stacked_downsample"] == 0, f"{name}: a solo query launched stacked")
        return answers, secs

    async def burst(reqs, name):
        """All members issued together, each under its own collector. The
        dashboard holds one batcher token across the burst (as
        the JAX package's tests do), so the first panel, too, waits for its
        company instead of taking the lone-query path."""
        notes = [None] * len(reqs)

        async def one(i):
            with scanstats.scan_stats() as st:
                r = await eng.query(reqs[i])
            notes[i] = dict(st.counts)
            return r

        port.reset_launch_counts()
        tok = batcher.begin()
        try:
            t = time.perf_counter()
            got = await asyncio.gather(*(one(i) for i in range(len(reqs))))
            wall = time.perf_counter() - t
        finally:
            batcher.end(tok)
        counts = port.launch_counts()
        counted(name, counts)
        return got, notes, wall, counts

    def batch_families() -> dict:
        return {fam: {"/".join(f"{k}={v}" for k, v in labels) + suffix: value
                      for suffix, labels, value in getattr(batching, fam).samples()
                      if not suffix.endswith("_bucket")}
                for fam in ("BATCH_QUERIES", "BATCH_LAUNCHES", "BATCH_GROUP_SIZE",
                            "BATCH_PAD_WASTE", "BATCH_WINDOW_WAIT")}

    # burst A: a 16-panel dashboard, one rack a panel, all in class 128
    per_rack = np.bincount(rack, minlength=100)
    racks = [r for r in range(100) if 65 <= per_rack[r] <= 128][:BURST_A_PANELS]
    require(len(racks) == BURST_A_PANELS, f"only {len(racks)} racks hold 65-128 hosts")
    reqs_a = [QueryRequest(metric=b"cpu_usage_user", start_ms=window[0], end_ms=window[1],
                           bucket_ms=ENGINE_BUCKET_MS, filters=[(b"rack", b"%d" % r)])
              for r in racks]
    solo_a, solo_a_s = await solo(reqs_a, "engine_solo_a")
    with CaptureStacked() as cap:
        got_a, notes_a, wall_a, counts_a = await burst(reqs_a, "engine_burst_a")
    require(counts_a["stacked_downsample"] == 1,
            f"burst A: stacked_downsample launched {counts_a['stacked_downsample']} times; "
            f"notes {notes_a}")
    for i, (req, g, w, n) in enumerate(zip(reqs_a, got_a, solo_a, notes_a)):
        require(n.get("batched_with") == BURST_A_PANELS, f"burst A panel {i}: notes {n}")
        require(same_answer(g, w), f"burst A panel {i}: differs from its HORAEDB_BATCH=off run")
        check_answer(req, g, 0, f"burst A panel {i} (rack {racks[i]})")
    (ts_b, _sid, _v, _ok, _t0, bucket_ms), kw = cap.args
    union_route = sorted(k for k in ("index_merge_filter", "index_merge_mask", "packed_merge",
                                     "scan_kernel") if counts_a[k])
    out["burst_a"] = {"panels": BURST_A_PANELS, "racks": racks,
                      "hosts": int(per_rack[racks].sum()), "wall_s": wall_a,
                      "solo_sum_s": sum(solo_a_s), "solo_s": solo_a_s,
                      "stacked_shape": list(ts_b.shape), "spad": kw["num_series"],
                      "buckets": kw["num_buckets"], "notes": notes_a[0],
                      "union_scan_route": union_route,
                      "launches": {k: v for k, v in counts_a.items() if v}}
    print(f"3i burst A: {BURST_A_PANELS} panels, {int(per_rack[racks].sum())} hosts, wall "
          f"{wall_a:.3f} s against {sum(solo_a_s):.3f} s for the solo queries; stacked "
          f"[B, R] = {list(ts_b.shape)}, S = {kw['num_series']}, T = {kw['num_buckets']}; "
          f"union scan route {union_route}", flush=True)

    # the same burst under torch.profiler: device busy share
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got_p, _n, wall_p, _c = await burst(reqs_a, "engine_burst_a_profiled")
        torch.cuda.synchronize()
    for g, w in zip(got_p, got_a):
        require(same_answer(g, w), "burst A under the profiler differs")
    out["burst_a"]["profile"] = device_summary(prof, wall_p)

    # burst B: TSBS single-groupby-5-8-1, three clients
    reqs_b, fields_b = [], []
    for _client in range(BURST_B_CLIENTS):
        hosts = rng.choice(NUM_SERIES, BURST_B_HOSTS, replace=False)
        rx = b"|".join(b"host_%d" % h for h in sorted(hosts))
        for f in range(BURST_B_METRICS):
            reqs_b.append(QueryRequest(metric=b"cpu_" + CPU_FIELDS[f].encode(),
                                       start_ms=window[0], end_ms=window[1],
                                       bucket_ms=ENGINE_BUCKET_MS,
                                       matchers=[(b"hostname", "re", rx)]))
            fields_b.append(f)
    solo_b, solo_b_s = await solo(reqs_b, "engine_solo_b")

    def check_b(got, notes, what):
        for i, (req, g, w) in enumerate(zip(reqs_b, got, solo_b)):
            require(same_answer(g, w), f"{what} query {i}: differs from its HORAEDB_BATCH=off run")
            check_answer(req, g, fields_b[i], f"{what} query {i}")
        return sorted(n.get("batched_with", 0) for n in notes)

    # at the documented window: whatever groups the arrivals form
    got_b, notes_b, wall_b, counts_b = await burst(reqs_b, "engine_burst_b")
    rode_b = check_b(got_b, notes_b, "burst B")
    out["burst_b"] = {"queries": len(reqs_b), "max_delay_ms": ENGINE_MAX_DELAY_MS,
                      "wall_s": wall_b, "solo_sum_s": sum(solo_b_s), "batched_with": rode_b,
                      "launches": {k: v for k, v in counts_b.items() if v}}
    print(f"3i burst B ({ENGINE_MAX_DELAY_MS} ms window): {len(reqs_b)} queries, wall "
          f"{wall_b:.3f} s against {sum(solo_b_s):.3f} s for the solo queries; "
          f"{counts_b['stacked_downsample']} stacked launches, batched_with {rode_b}", flush=True)

    # the matchers' resolution, serially, sizes the window that gathers them
    t = time.perf_counter()
    for r in reqs_b:
        eng._resolve_query(r.metric, r.filters, r.matchers)
    resolve_s = time.perf_counter() - t
    wide_ms = max(ENGINE_MAX_DELAY_MS, round(2e3 * resolve_s))
    batcher.configure(batching.BatchingConfig(max_delay=ReadableDuration.millis(wide_ms)))
    try:
        got_w, notes_w, wall_w, counts_w = await burst(reqs_b, "engine_burst_b_wide")
    finally:
        batcher.configure(batching.BatchingConfig(
            max_delay=ReadableDuration.millis(ENGINE_MAX_DELAY_MS)))
    require(counts_w["stacked_downsample"] == 1,
            f"burst B ({wide_ms} ms window): stacked_downsample launched "
            f"{counts_w['stacked_downsample']} times; notes {notes_w}")
    require(check_b(got_w, notes_w, f"burst B ({wide_ms} ms window)") == [len(reqs_b)] * len(reqs_b),
            f"burst B ({wide_ms} ms window): notes {notes_w}")
    out["burst_b_wide"] = {"max_delay_ms": wide_ms, "resolve_s": resolve_s, "wall_s": wall_w,
                           "notes": notes_w[0],
                           "launches": {k: v for k, v in counts_w.items() if v}}
    print(f"3i burst B ({wide_ms} ms window, twice the {resolve_s:.3f} s its 15 matchers take "
          f"to resolve one after another): wall {wall_w:.3f} s, one stacked launch", flush=True)

    # a lone query: the solo route, no window
    port.reset_launch_counts()
    with scanstats.scan_stats() as st:
        t = time.perf_counter()
        lone = await eng.query(reqs_a[0])
        lone_s = time.perf_counter() - t
    counts = port.launch_counts()
    counted("engine_lone", counts)
    require(st.counts.get("batched_with") == 1 and "batch_window" not in st.seconds,
            f"lone query: notes {st.counts}")
    require(counts["stacked_downsample"] == 0 and counts["block_sum_count"] > 0,
            f"lone query: launches {counts}")
    require(same_answer(lone, solo_a[0]), "lone query differs from its solo run")
    out["lone"] = {"s": lone_s, "notes": dict(st.counts),
                   "launches": {k: v for k, v in counts.items() if v}}
    out["batch_families"] = batch_families()
    print(f"3i horaedb_batch_*: {json.dumps(out['batch_families'])}", flush=True)
    # j. PromQL on the same engine, before it closes
    out["promql"] = await promql_paths(torch, eng, values, tags, workdir, counted)
    await eng.close()
    out["capture"] = cap
    return out


# -- phase 3j: PromQL range queries over the engine, and the calibrated dispatcher

PROMQL_QUERIES = {
    # TSBS double-groupby-1's grid over one metric: every host, 5-minute steps
    "Q1": ("avg_over_time(cpu_usage_user[5m])", 300_000),
    "Q2": ("max by (region) (max_over_time(cpu_usage_system[1m]))", 60_000),
    # TSBS single-groupby-1-8-1
    "Q3": ('max_over_time(cpu_usage_user{hostname=~"host_(1|2|3|4|5|6|7|8)"}[1m])', 60_000),
    # TSBS high-cpu-all: an instant selector (raw path) and a comparison
    "Q4": ("cpu_usage_user > 90", 300_000),
    # lastpoint-like: last_over_time with window == step (raw path)
    "Q5": ("last_over_time(cpu_usage_user[10m])", 600_000),
    "Q6": ("topk(5, avg_over_time(cpu_usage_user[5m]))", 300_000),
}


def promql_oracle(name: str, values: np.ndarray, regions: list) -> dict:
    """Host (or region) -> per-step values of query `name` from the
    generator's values [hosts, fields, scrapes] (field 0 usage_user, 1
    usage_system; scrape i at T0 + i * INTERVAL_MS); steps run from
    T0 + step to T0 + ENGINE_WINDOW_MS, and a step's window is the step
    before it."""
    per5, per1 = 300_000 // INTERVAL_MS, 60_000 // INTERVAL_MS
    n = values.shape[0]
    if name in ("Q1", "Q6"):
        mean = values[:, 0].reshape(n, -1, per5).sum(axis=2) / per5
        if name == "Q1":
            return {f"host_{h}": mean[h] for h in range(n)}
        top = np.argsort(-mean, axis=0, kind="stable")[:5]
        keep = np.zeros(mean.shape, bool)
        keep[top, np.arange(mean.shape[1])[None, :]] = True
        return {f"host_{h}": np.where(keep[h], mean[h], np.nan)
                for h in np.flatnonzero(keep.any(axis=1))}
    if name == "Q2":
        mx = values[:, 1].reshape(n, -1, per1).max(axis=2)
        out = {}
        for r in sorted(set(regions)):
            out[r] = mx[[i for i in range(n) if regions[i] == r]].max(axis=0)
        return out
    if name == "Q3":
        mx = values[1:9, 0].reshape(8, -1, per1).max(axis=2)
        return {f"host_{h}": mx[h - 1] for h in range(1, 9)}
    if name == "Q4":
        idx = np.minimum(np.arange(1, ENGINE_WINDOW_MS // 300_000 + 1) * per5,
                         values.shape[2] - 1)
        inst = values[:, 0, idx]
        hot = np.where(inst > 90, inst, np.nan)
        return {f"host_{h}": hot[h] for h in range(n) if not np.isnan(hot[h]).all()}
    per10 = 600_000 // INTERVAL_MS
    last = values[:, 0, per10 - 1::per10]
    return {f"host_{h}": last[h] for h in range(n)}


def promql_answer(series, key: str) -> dict:
    return {sv.labels[key]: sv.values for sv in series}


def check_promql(name: str, series, want: dict) -> None:
    key = "region" if name == "Q2" else "hostname"
    got = promql_answer(series, key)
    require(sorted(got) == sorted(want), f"3j {name}: the series set differs from the oracle "
                                         f"({len(got)} against {len(want)})")
    exact = name in ("Q2", "Q3", "Q4", "Q5")  # max and selections: exact; means: rtol
    for k, w in want.items():
        g = got[k]
        if exact:
            require(np.array_equal(g, w, equal_nan=True), f"3j {name}: {k} differs")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True,
                                       err_msg=f"3j {name}: {k} differs")


async def promql_paths(torch, eng, values: np.ndarray, tags: list, workdir: str,
                       counted) -> dict:
    """Phase 3j: Q1-Q6 through `evaluate_range` on phase 3i's engine, from a
    fresh calibration cache, each held against the numpy oracle; Q1 under
    every device pin, bitwise equal to `block`'s grid."""
    import horaedb_tpu_torch as port
    from horaedb_tpu_torch.ops import agg_registry
    from horaedb_tpu_torch.promql.eval import evaluate_range
    from horaedb_tpu_torch.storage import scanstats

    os.environ["HORAEDB_AGG_CACHE"] = f"{workdir}/agg_calib_3j.json"
    os.environ.pop("HORAEDB_AGG_CALIB_N", None)
    agg_registry.reset_cache(memory_only=True)
    regions = [dict(lab)[b"region"].decode() for lab in tags]
    out: dict = {"queries": {}}

    async def run(expr: str, step: int):
        with scanstats.scan_stats() as st:
            t = time.perf_counter()
            steps, series = await evaluate_range(eng, expr, T0 + step, T0 + ENGINE_WINDOW_MS,
                                                 step)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        notes = {k: v for k, v in st.counts.items() if k.startswith(("agg_impl_", "promql_"))}
        return steps, series, secs, notes

    port.reset_launch_counts()
    answers = {}
    for name, (expr, step) in PROMQL_QUERIES.items():
        steps, series, secs, notes = await run(expr, step)
        require(not isinstance(series, float) and len(series) > 0, f"3j {name}: no answer")
        check_promql(name, series, promql_oracle(name, values, regions))
        answers[name] = series
        out["queries"][name] = {"expr": expr, "step_ms": step, "steps": len(steps),
                                "series": len(series), "s": secs, "notes": notes}
        print(f"3j {name} {expr} (step {step // 1000} s): {len(series)} series x {len(steps)} "
              f"steps in {secs:.3f} s; notes {notes}", flush=True)
    counts = port.launch_counts()
    counted("promql", counts)
    for k in ("lane_sum_count", "block_sum_count", "block_min_max"):
        require(counts[k] > 0, f"3j: the queries did not launch {k}")
    entries = agg_registry._calib_cache.load().get("entries") or {}
    platform = eng.device.type
    device_names = agg_registry.sorted_impl_names(platform)
    require(f"{platform}/sorted/dense" in entries and f"{platform}/sorted/sparse" in entries,
            f"3j: the pushdowns did not calibrate both density classes on the card: "
            f"{sorted(entries)}")
    for key, entry in entries.items():
        require(key.startswith(f"{platform}/"), f"3j: calibrated {key} off the card")
        require(not entry["rejected"], f"3j: calibration {key} rejected {entry['rejected']}")
        if "/sorted/" in key:
            require(sorted(entry["ab"]) == sorted(device_names),
                    f"3j: calibration {key} timed {sorted(entry['ab'])}")
        print(f"3j calibration {key}: impl {entry['impl']}, rows/s {json.dumps(entry['ab'])}, "
              f"rejected {entry['rejected']}", flush=True)
    out["calibration"] = entries

    # Q1 under every device pin: the grid of `block`, bitwise
    expr, step = PROMQL_QUERIES["Q1"]

    def stacked(series):
        rows = promql_answer(series, "hostname")
        return np.stack([rows[k] for k in sorted(rows)])

    pins = {}
    with EnvPin(HORAEDB_AGG_IMPL="block"):
        _s, base, _t, _n = await run(expr, step)
    for name in agg_registry.SORTED_IMPLS:
        if agg_registry.SORTED_IMPLS[name].kind != "device":
            continue
        port.reset_launch_counts()
        with EnvPin(HORAEDB_AGG_IMPL=name):
            _s, series, secs, notes = await run(expr, step)
        c = port.launch_counts()
        require(c["lane_sum_count"] == 0, f"3j Q1 pinned to {name}: f64 reached lane_sum_count")
        require(np.array_equal(stacked(series).view(np.uint64), stacked(base).view(np.uint64)),
                f"3j Q1 pinned to {name}: not bitwise equal to block")
        pins[name] = {"s": secs, "notes": notes}
    out["q1_pins"] = pins
    print(f"3j Q1 bitwise equal under every device pin: "
          + ", ".join(f"{k} {v['s']:.3f} s" for k, v in pins.items()), flush=True)
    return out


def check_stacked_kernel(torch, rng, dev) -> None:
    """Phase 2: stacked_downsample against its plain version on CPU copies
    (each cell's rows summed in the kernel's association there), bitwise on every grid,
    sums as u64 views; and one query stacked at a non-zero lane offset
    against its solo reduction (downsample_sorted, kernels B and C)."""
    from horaedb_tpu_torch.ops import aggregate as agg

    def lanes(B, R, S, T, fill=0.8):
        ts = rng.integers(-2000, (T + 2) * 1000, (B, R)).astype(np.int64)
        sid = rng.integers(-1, S + 1, (B, R)).astype(np.int32)
        v = rng.uniform(-1e3, 1e3, (B, R))
        ok = rng.random((B, R)) < fill
        t0 = rng.integers(-500, 500, B).astype(np.int64)
        return [ts + t0[:, None], sid, v, ok, t0, S, T]

    cases = {"B=1": lanes(1, 4096, 40, 12)}
    c = lanes(16, 2048, 64, 30)
    c[3][3:] = False
    cases["B=16, empty lanes"] = c
    c = lanes(4, 3000, 8, 5)
    c[3][1] = False
    c[2].flat[rng.choice(c[2].size, 30, replace=False)] = np.resize([np.nan, np.inf, -np.inf],
                                                                     30)
    cases["an all-masked lane, NaN and +-inf, rows before t0 and past the grid, sid out of "
          "range, a t0 per lane"] = c
    B, R = 3, 6151
    sid = np.zeros((B, R), np.int32)
    sid[:, 2500:] = 1
    cases["runs straddling 8- and 2048-row boundaries"] = [
        np.tile(np.arange(R, dtype=np.int64) % 1000, (B, 1)), sid, rng.uniform(0, 1, (B, R)),
        np.ones((B, R), bool), np.zeros(B, np.int64), 2, 1]
    for name, (ts, sid, v, ok, t0, S, T) in cases.items():
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ts, sid, v, ok, t0)]
        got = agg.stacked_downsample(*(a.to(dev) for a in host), 1000, S, T)
        want = agg.stacked_downsample(*host, 1000, S, T)
        torch.cuda.synchronize()
        for k in ("sum", "count", "min", "max", "mean"):
            require(np.array_equal(got[k].cpu().numpy().view(np.uint64),
                                   want[k].numpy().view(np.uint64)),
                    f"stacked_downsample != plain on {name!r}: {k}")
    # stacked == solo, bitwise, at lane 5 of 16
    S, T, bucket_ms, t0 = 100, 30, 60_000, T0
    per = rng.integers(0, 3 * T, S)
    sid = np.repeat(np.arange(S, dtype=np.int32), per)
    ts = t0 + rng.integers(0, T * bucket_ms, len(sid)).astype(np.int64)
    order = np.lexsort((ts, sid))
    sid, ts = sid[order], ts[order]
    v = rng.uniform(0, 100, len(sid))
    solo = agg.downsample_sorted(ts, sid, v, t0, bucket_ms, S, T, device=dev)
    B, R, lane = 16, 8192, 5
    arrs = [np.zeros((B, R), np.int64), np.zeros((B, R), np.int32), np.zeros((B, R)),
            np.zeros((B, R), bool), np.full(B, t0, np.int64)]
    for q in range(B):
        n = len(ts) if q == lane else int(rng.integers(0, R))
        arrs[0][q, :n] = ts if q == lane else t0 + rng.integers(0, T * bucket_ms, n)
        arrs[1][q, :n] = sid if q == lane else np.sort(rng.integers(0, 128, n))
        arrs[2][q, :n] = v if q == lane else rng.uniform(0, 100, n)
        arrs[3][q, :n] = True
    got = agg.stacked_downsample(*(torch.from_numpy(a).to(dev) for a in arrs), bucket_ms, 128, T)
    for k in ("sum", "count", "min", "max", "mean"):
        require(np.array_equal(got[k][lane, :S].cpu().numpy().view(np.uint64),
                               solo[k].cpu().numpy().view(np.uint64)),
                f"stacked_downsample at lane {lane} != downsample_sorted (solo): {k}")


def stacked_records(torch, cap: CaptureStacked, dev, save_to: str | None = None) -> list[dict]:
    """Phase 4: stacked_downsample against its plain version on burst A's
    own launch inputs, timed by CUDA events and by device ms; with
    `save_to`, those inputs go to that file (torch.save) for
    `chip_ab.py agg-pair --stacked-call`."""
    from horaedb_tpu_torch.ops import aggregate as agg

    require(cap.args is not None, "burst A made no stacked launch")
    (ts, sid, values, valid, t0, bucket_ms), kw = cap.args
    ns, nbk = kw["num_series"], kw["num_buckets"]
    if save_to is not None:
        torch.save({"lanes": [a.cpu() for a in (ts, sid, values, valid, t0)],
                    "bucket_ms": bucket_ms, "num_series": ns, "num_buckets": nbk}, save_to)
    got = agg.stacked_downsample(ts, sid, values, valid, t0, bucket_ms, ns, nbk)
    want = agg.stacked_downsample(*(a.cpu() for a in (ts, sid, values, valid, t0)), bucket_ms,
                                  ns, nbk)
    for k in ("sum", "count", "min", "max", "mean"):
        require(np.array_equal(got[k].cpu().numpy().view(np.uint64),
                               want[k].numpy().view(np.uint64)),
                f"stacked_downsample != plain at burst A's shape: {k}")
    err = abs_err(torch, got["sum"].cpu(), want["sum"])
    b, r = ts.shape
    cells = b * ns * nbk
    real = int(valid.sum())
    # the library yardstick: two index_add_ and two scatter_reduce over the
    # same flat ids (rows outside their grid at a sentinel cell)
    bucket = torch.div(ts - t0[:, None], bucket_ms, rounding_mode="floor")
    ok = valid & (bucket >= 0) & (bucket < nbk) & (sid >= 0) & (sid < ns)
    lane = torch.arange(b, device=dev)[:, None]
    idx = torch.where(ok, lane * ns * nbk + sid.long() * nbk + bucket, cells).reshape(-1)
    flat_v = values.reshape(-1)
    ones = torch.ones_like(flat_v)

    def library():
        torch.zeros(cells + 1, dtype=flat_v.dtype, device=dev).index_add_(0, idx, flat_v)
        torch.zeros(cells + 1, dtype=flat_v.dtype, device=dev).index_add_(0, idx, ones)
        torch.full((cells + 1,), torch.inf, dtype=flat_v.dtype, device=dev).scatter_reduce_(
            0, idx, flat_v, "amin", include_self=True)
        torch.full((cells + 1,), -torch.inf, dtype=flat_v.dtype, device=dev).scatter_reduce_(
            0, idx, flat_v, "amax", include_self=True)

    # each padded row read once (ts 8 B, sid 4 B, value 8 B, valid 1 B), the
    # five f64 grids written once
    nb, kind = bound(b * r * (8 + 4 + 8 + 1) + cells * 40, 0)

    def kern():
        return agg.stacked_downsample(ts, sid, values, valid, t0, bucket_ms, ns, nbk)

    dms, ops = device_ms(torch, kern, calls=20, with_ops=True)
    return [{
        "name": "stacked_downsample", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/grouped_stats.cu + onesweep.cuh, segreduce.cuh "
                  "(grouped_stats_stacked_launch)",
        "replaces": "horaedb_tpu/ops/aggregate.py:281",
        "shape": f"[B, R] = [{b}, {r}] padded rows ({real} real), {b} x {ns} series x {nbk} "
                 f"buckets = {cells} cells",
        "max_abs_err": err,
        "ms": cuda_ms(torch, kern), "device_ms": dms, "device_ops": ops,
        "plain_ms": cuda_ms(torch, lambda: agg.stacked_downsample_plain(
            ts, sid, values, valid, t0, bucket_ms, ns, nbk), iters=5, warmup=1),
        "bound_ms": nb, "bound_by": kind, "library_ms": cuda_ms(torch, library),
        "library_call": "index_add_ x2 + scatter_reduce amin/amax over the flat cell ids",
    }]


def host_top(host) -> list:
    import pstats

    stats = pstats.Stats(host)
    return sorted(((f"{fn[0].rsplit('/', 1)[-1]}:{fn[2]}", st[2])
                   for fn, st in stats.stats.items()), key=lambda kv: -kv[1])[:12]


def device_summary(prof, wall: float) -> dict:
    """Device busy time and share of a profiled window, its H2D and D2H
    copies, and the largest device kernels."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    h2d = sum(e.self_device_time_total for e in ev if "HtoD" in e.key) / 1e6
    d2h = sum(e.self_device_time_total for e in ev if "DtoH" in e.key) / 1e6
    top = sorted(((e.key[:60], e.self_device_time_total / 1e6) for e in ev),
                 key=lambda kv: -kv[1])[:8]
    by_kernel = {}
    for e in ev:
        name = kernel_name(e.key)
        by_kernel[name] = by_kernel.get(name, 0.0) + e.self_device_time_total / 1e6
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "h2d_s": h2d, "d2h_s": d2h, "kernels_s": busy - h2d - d2h, "device_top": top,
            "device_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


def kernel_name(key: str) -> str:
    """A profiler key without its return type and parameter list:
    `onesweep::sweep_kernel<unsigned long, int>` for the look-back sweep."""
    name = key.strip()
    if name.endswith(")") and not name.startswith("Memcpy"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):  # the '(' that opens the last group
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].strip()
                break
    return name[5:] if name.startswith("void ") else name


async def profiled_query(torch, storage, ids, window, bucket_ms, pred):
    """One query_downsample under torch.profiler and cProfile: its grids
    and where its time went."""
    import cProfile

    from torch.profiler import ProfilerActivity, profile

    from horaedb_tpu_torch.engine_query import query_downsample

    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        host.enable()
        grids = await query_downsample(storage, ids, window, bucket_ms, pred)
        host.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    summary = device_summary(prof, wall)
    summary["host_top_self_s"] = host_top(host)
    return grids, summary


async def profile_paths(torch, storage, ids, window, pred, seg0) -> dict:
    """One query under torch.profiler and cProfile, and one raw scan under
    torch.profiler with its host decode timed apart: wall time, device busy
    time and share, H2D copy time, the largest device kernels and host
    functions."""
    import cProfile

    from torch.profiler import ProfilerActivity, profile

    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.storage import ScanRequest

    _grids, query = await profiled_query(torch, storage, ids, window, BUCKET_MS, pred)
    reader = storage.parquet_reader
    ssts = storage.select_ssts(seg0)
    t = time.perf_counter()
    await reader._read_tables(ssts, reader._resolve_read_names(None, False), None)
    decode_s = time.perf_counter() - t
    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        host.enable()
        async for _b in storage.scan(ScanRequest(seg0, predicate=F.Compare("metric_id", "eq",
                                                                            METRIC_ID))):
            pass
        host.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    scan = device_summary(prof, wall)
    scan["host_read_decode_s"] = decode_s
    scan["host_top_self_s"] = host_top(host)
    return {"query": query, "scan_auto_metric_eq": scan}


# -- phase 3l: the mesh, several slots of the one card ---------------------------
# The JAX package's multi-device paths (parallel/, cluster/partial.py,
# engine/region.py) on mesh slots that all sit on cuda:0, as the JAX tests
# put 8 virtual devices on one host: the sharded scan (8 slots), the packed
# downsample on a rows 2 x series 2 mesh, the regioned scatter-gather read
# (4 regions, 2 "nodes", the fold on 4 slots) and the 3-axis multisegment
# step (seg 2 x rows 2 x series 2).

MESH_SLOTS, MERGE_SLOTS, NUM_REGIONS, REGION_PAYLOADS = 4, 8, 4, 6
SEG_BUCKETS = SEGMENT_MS // BUCKET_MS


class CaptureMesh:
    """Keeps the inputs of the first sharded_packed_merge, sharded_downsample
    and sharded_grid_fold calls made inside the block (their own main-path
    inputs, for phase 4), and the merge's result."""

    def __init__(self):
        self.merge = self.down = self.fold = None

    def __enter__(self):
        from horaedb_tpu_torch.parallel import merge as pmerge
        from horaedb_tpu_torch.parallel import scan as pscan

        self.orig = (pmerge.sharded_packed_merge, pscan.sharded_downsample,
                     pmerge.sharded_grid_fold)

        def merge(packed, seq_width, do_dedup, mesh, defer=False, key_bits=None):
            res = self.orig[0](packed, seq_width, do_dedup, mesh, defer=defer, key_bits=key_bits)
            if self.merge is None:
                self.merge = {"packed": packed, "seq_width": seq_width, "do_dedup": do_dedup,
                              "mesh": mesh, "key_bits": key_bits}

                def collect(res=res):
                    got = res() if defer else res
                    self.merge["result"] = got
                    return got
                return collect if defer else collect()
            return res

        def down(*a, **k):
            if self.down is None:
                self.down = (a, k)
            return self.orig[1](*a, **k)

        def fold(mesh, stacked):
            # the largest call: device_fold_safe's probe folds [2, 2, 1]
            if self.fold is None or stacked["sum"].size > self.fold[1]["sum"].size:
                self.fold = (mesh, stacked)
            return self.orig[2](mesh, stacked)

        pmerge.sharded_packed_merge, pscan.sharded_downsample = merge, down
        pmerge.sharded_grid_fold = fold
        return self

    def __exit__(self, *exc):
        from horaedb_tpu_torch.parallel import merge as pmerge
        from horaedb_tpu_torch.parallel import scan as pscan

        pmerge.sharded_packed_merge, pscan.sharded_downsample, pmerge.sharded_grid_fold = \
            self.orig


def card_mesh(torch, dev, n: int, names=None):
    """n slots of the one card: a (rows, series=2) mesh, or the 3-axis
    (seg, rows, series) mesh when `names` says so."""
    from horaedb_tpu_torch.parallel.mesh import Mesh, make_mesh

    if names is None:
        return make_mesh(n, series_parallel=2, devices=[dev] * n)
    slots = np.empty(n, dtype=object)
    slots[:] = [dev] * n
    return Mesh(slots.reshape(2, n // 4, 2), names)


def grids_close(got: dict, want: dict, what: str) -> None:
    """Counts, min and max exact; sums rtol 1e-12 (the mesh folds the row
    shards' partial sums, the single device one run)."""
    for k in ("count", "min", "max"):
        require(np.array_equal(got[k], want[k]), f"{what}: {k} differs")
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-12, atol=0,
                               err_msg=f"{what}: sums differ")


def check_mesh_kernels(torch, rng, dev) -> None:
    """Phase 2: the four mesh kernels against their plain versions on CPU
    copies (where index_add_ folds in row order), bitwise: grid_fold on NaN
    payloads, +-0.0, subnormals and infinities, k = 1 and 5;
    sample_sort_merge on random, all-sentinel, one-group and skewed keys
    (also against packed_merge); sharded_downsample on prime series counts
    (the pads), sorted and unsorted rows, a predicate;
    multisegment_downsample with a t0 per segment."""
    from horaedb_tpu_torch.backend import u64_to_i64
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.ops import merge
    from horaedb_tpu_torch.ops import mesh as mesh_ops
    from horaedb_tpu_torch.parallel import merge as pmerge
    from horaedb_tpu_torch.parallel import scan as pscan

    cpu = torch.device("cpu")
    specials = np.array([0x7FF8000000000001, 0x7FF0000000000005, 0xFFF8000000000002,
                         0x8000000000000000, 0x0, 0x1, 0x800FFFFFFFFFFFFF,
                         0x0010000000000000, 0x7FF0000000000000, 0xFFF0000000000000],
                        np.uint64).view(np.float64)
    # the k = 9 case (the kernel's loop past its unrolled k <= 8) draws from
    # its own generator, so the main paths' data stays as it was
    for k, cells, g in ((1, 1_001, rng), (5, 30_011, rng), (9, 30_002, np.random.default_rng(9))):
        grids = {}
        for key in mesh_ops.FOLD_KEYS:
            a = g.normal(size=(k, cells)) * (1e-308 if key == "sum" else 1.0)
            hit = g.random((k, cells)) < 0.3
            a[hit] = g.choice(specials, int(hit.sum()))
            grids[key] = a
        got = mesh_ops.grid_fold({key: torch.from_numpy(a).to(dev) for key, a in grids.items()})
        want = mesh_ops.grid_fold_plain({key: torch.from_numpy(a) for key, a in grids.items()})
        for key in mesh_ops.FOLD_KEYS:
            require(np.array_equal(got[key].cpu().numpy().view(np.uint64),
                                   want[key].numpy().view(np.uint64)),
                    f"grid_fold != plain ({key}, k={k})")
    require(pmerge.device_fold_safe(card_mesh(torch, dev, MESH_SLOTS)),
            "device_fold_safe is False on the card")

    mesh8, cpu8 = card_mesh(torch, dev, MERGE_SLOTS), card_mesh(torch, cpu, MERGE_SLOTS)
    # 42- and 63-bit keys (6 and 8 digit sweeps a step) draw from their own
    # generator, so the later phases' data stays as it was
    wide = np.random.default_rng(11)
    for case, key_bits in (("random", None), ("sentinel", None), ("single", None),
                           ("skew", None), ("random", 42), ("random", 63)):
        n, width = 300_007, 8
        g = rng if key_bits is None else wide
        grp = g.integers(0, 20_000 if key_bits is None else 2**(key_bits - width),
                         n).astype(np.uint64)
        if case == "single":
            grp[:] = 77
        elif case == "skew":
            grp[: n * 9 // 10] = 5
        packed = (grp << np.uint64(width)) | g.integers(0, 1 << width, n).astype(np.uint64)
        packed[g.random(n) < 0.15] = pmerge._SENTINEL
        if case == "sentinel":
            packed[:] = pmerge._SENTINEL
        what = case if key_bits is None else f"{case}, {key_bits}-bit keys"
        for dedup in (True, False):
            got = pmerge.sharded_packed_merge(packed, width, dedup, mesh8, key_bits=key_bits)
            idx, cnt = merge.packed_merge(torch.from_numpy(u64_to_i64(packed)).to(dev), 63,
                                          width, dedup)
            require(np.array_equal(got, idx[: int(cnt.item())].cpu().numpy().astype(np.int64)),
                    f"sample_sort_merge != packed_merge ({what}, dedup={dedup})")
            require(np.array_equal(got, pmerge.sharded_packed_merge_plain(packed, width, dedup,
                                                                          cpu8)),
                    f"sample_sort_merge != plain ({what}, dedup={dedup})")

    mesh4, cpu4 = card_mesh(torch, dev, MESH_SLOTS), card_mesh(torch, cpu, MESH_SLOTS)
    for num_series, sorted_rows, pred in ((7, True, None), (13, False, None),
                                          (13, True, F.Compare("__val__", "gt", -0.3))):
        n = 50_021
        sid = rng.integers(0, num_series, n).astype(np.int32)
        ts = rng.integers(-3_000, 62_000, n).astype(np.int64)
        if sorted_rows:
            order = np.lexsort((ts, sid))
            sid, ts = sid[order], ts[order]
        lanes = (ts, sid, rng.normal(size=n), rng.random(n) > 0.05)
        pads = (0, num_series + 1, 0, False)
        on_card, _ = pscan.shard_rows(mesh4, lanes, pad_value=pads)
        on_cpu, _ = pscan.shard_rows(cpu4, lanes, pad_value=pads)
        got = pscan.sharded_downsample(mesh4, *on_card, 0, 5_000, num_series + 1, 12,
                                       predicate=pred, sorted_input=sorted_rows)
        # CPU slots run every kernel's plain version; the pin keeps the
        # dispatcher off the host reduceat lane (kernel B's plain version)
        with EnvPin(HORAEDB_AGG_IMPL="block"):
            want = pscan.sharded_downsample(cpu4, *on_cpu, 0, 5_000, num_series + 1, 12,
                                            predicate=pred, sorted_input=sorted_rows)
        for key in ("sum", "count", "min", "max"):
            require(np.array_equal(got[key].cpu().numpy().view(np.uint64),
                                   want[key].numpy().view(np.uint64)),
                    f"sharded_downsample != plain ({key}, {num_series} series)")
    lanes = [torch.from_numpy(a) for a in (
        rng.integers(0, 80_000, (2, 20_000)).astype(np.int64),
        rng.integers(0, 16, (2, 20_000)).astype(np.int32),
        rng.normal(size=(2, 20_000)), rng.random((2, 20_000)) > 0.1)]
    t0 = np.array([0, 3_000], np.int64)
    names = ("seg", "rows", "series")
    got = pscan.build_multisegment_downsample(card_mesh(torch, dev, 8, names), 16, 8)(
        *[x.to(dev) for x in lanes], t0, 10_000)
    want = pscan.build_multisegment_downsample(card_mesh(torch, cpu, 8, names), 16, 8)(
        *lanes, t0, 10_000)
    for key in ("sum", "count", "min", "max"):
        require(np.array_equal(got[key].cpu().numpy().view(np.uint64),
                               want[key].numpy().view(np.uint64)),
                f"multisegment_downsample != plain ({key})")


async def mesh_scan_paths(torch, dev, data, storage, dense, query_pred, grids0, want,
                          counted) -> dict:
    """Phase 3l on 3a's tables: (1) 3d's dense segment scanned under
    HORAEDB_SCAN_PATH=sharded with an 8-slot mesh installed: lane for lane
    the default scan, its merge indices equal to packed_merge's, the
    sharded note and no fallback note; (2) 3b's packed downsample (10K
    series x 48 buckets) with a 4-slot mesh installed: equal to 3b's grids
    and the oracle; (4) `entry.dryrun_multichip(4)` on the card, then the
    3-axis step over 3a's two segments, one a seg-shard: equal to 3b's
    grids segment by segment."""
    import asyncio

    import horaedb_tpu_torch as port
    from horaedb_tpu_torch import entry
    from horaedb_tpu_torch.backend import order_key
    from horaedb_tpu_torch.engine_query import query_downsample
    from horaedb_tpu_torch.ops import merge
    from horaedb_tpu_torch.parallel import scan as pscan
    from horaedb_tpu_torch.parallel.mesh import set_active_mesh
    from horaedb_tpu_torch.storage import ScanRequest, TimeRange, scanstats

    tsids = data[0]
    out: dict = {}
    seg0 = TimeRange(T0, T0 + SEGMENT_MS)
    window = TimeRange(T0, T0 + WINDOW_MS)

    # 1. the sharded scan
    default, _ = await timed_scan(dense, ScanRequest(seg0))
    mesh8 = card_mesh(torch, dev, MERGE_SLOTS)
    port.reset_launch_counts()
    set_active_mesh(mesh8)
    try:
        with EnvPin(HORAEDB_SCAN_PATH="sharded"), CaptureMesh() as mcap, \
                scanstats.scan_stats() as st:
            table, secs = await timed_scan(dense, ScanRequest(seg0))
    finally:
        set_active_mesh(None)
    counts = port.launch_counts()
    counted("scan_sharded", counts)
    notes = dict(st.counts)
    require(counts["sample_sort_merge"] > 0, "the sharded scan did not launch sample_sort_merge")
    require(notes.get("path_device_merge_sharded", 0) > 0
            and not any(k.startswith("path_sharded_fallback") for k in notes),
            f"sharded scan notes: {notes}")
    require(lanes_equal(table_lanes(table), table_lanes(default)),
            "sharded scan differs from the default scan")
    cap = mcap.merge
    key = torch.from_numpy(order_key(cap["packed"])).to(dev)
    idx, cnt = merge.packed_merge(key, cap["key_bits"], cap["seq_width"], cap["do_dedup"])
    require(np.array_equal(cap["result"], idx[: int(cnt.item())].cpu().numpy().astype(np.int64)),
            "sample_sort_merge indices differ from packed_merge's")
    out["sharded_scan"] = {"rows": table.num_rows, "s": secs, "slots": MERGE_SLOTS,
                           "notes": notes, "launches": {k: v for k, v in counts.items() if v}}
    print(f"3l sharded scan: {table.num_rows} rows in {secs:.3f} s on {MERGE_SLOTS} slots, "
          f"equal to the default scan", flush=True)
    del table, default, key

    # 2. the packed downsample with the mesh installed
    mesh4 = card_mesh(torch, dev, MESH_SLOTS)
    port.reset_launch_counts()
    set_active_mesh(mesh4)
    try:
        with CaptureMesh() as dcap:
            t = time.perf_counter()
            got = await query_downsample(storage, tsids, window, BUCKET_MS, query_pred)
            secs = time.perf_counter() - t
    finally:
        set_active_mesh(None)
    counts = port.launch_counts()
    counted("downsample_mesh", counts)
    for k in ("sharded_downsample", "grid_fold"):
        require(counts[k] > 0, f"the mesh downsample did not launch {k}")
    check_grids(got, want, "mesh downsample against the oracle")
    grids_close(got, grids0, "mesh downsample against the single-device route")
    out["mesh_downsample"] = {"s": secs, "slots": MESH_SLOTS,
                              "launches": {k: v for k, v in counts.items() if v}}
    print(f"3l mesh downsample: {NUM_SERIES} x {WINDOW_MS // BUCKET_MS} in {secs:.3f} s on "
          f"{MESH_SLOTS} slots", flush=True)

    # 4. multisegment: the dry run, then 3a's two segments in one step
    port.reset_launch_counts()
    t = time.perf_counter()
    # the dry run drives its own event loops: a worker thread, outside this one
    await asyncio.to_thread(entry.dryrun_multichip, MESH_SLOTS, device=dev)
    out["dryrun_s"] = time.perf_counter() - t
    counted("dryrun_multichip", port.launch_counts())
    _tsids, ts, _v, _r, _n, final = data
    per = SEGMENT_MS // INTERVAL_MS
    grid = final.reshape(NUM_SERIES, len(ts))
    lanes = [np.stack([np.tile(ts[g * per:(g + 1) * per], NUM_SERIES) for g in (0, 1)]),
             np.stack([np.repeat(np.arange(NUM_SERIES, dtype=np.int32), per)] * 2),
             np.stack([grid[:, g * per:(g + 1) * per].ravel() for g in (0, 1)])]
    lanes = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in lanes]
    lanes.append(torch.ones(lanes[0].shape, dtype=torch.bool, device=dev))
    t0_seg = np.array([T0, T0 + SEGMENT_MS], np.int64)
    mesh3 = card_mesh(torch, dev, 8, ("seg", "rows", "series"))
    fn3 = pscan.build_multisegment_downsample(mesh3, NUM_SERIES, SEG_BUCKETS)
    port.reset_launch_counts()
    t = time.perf_counter()
    out3 = fn3(*lanes, t0_seg, BUCKET_MS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = port.launch_counts()
    counted("multisegment", counts)
    # one slot pass (one sort) a slot of the 8, and no other sort
    require(counts["multisegment_downsample"] == 8 and counts["grouped_stats"] == 0,
            f"multisegment launched {counts['multisegment_downsample']} slot passes and "
            f"{counts['grouped_stats']} grouped_stats sorts, not 8 and 0")
    require(tuple(out3["sum"].shape) == (2, NUM_SERIES, SEG_BUCKETS), "multisegment shape")
    for g in (0, 1):
        sl = slice(g * SEG_BUCKETS, (g + 1) * SEG_BUCKETS)
        grids_close({k: out3[k][g].cpu().numpy() for k in ("sum", "count", "min", "max")},
                    {k: grids0[k][:, sl] for k in ("sum", "count", "min", "max")},
                    f"multisegment segment {g}")
    out["multisegment"] = {"s": secs, "rows": int(lanes[0].numel()), "slots": 8,
                           "shape": list(out3["sum"].shape),
                           "launches": {k: v for k, v in counts.items() if v}}
    print(f"3l multisegment: [2, {NUM_SERIES}, {SEG_BUCKETS}] from {lanes[0].numel()} rows in "
          f"{secs:.3f} s, equal to each segment's single-device grids", flush=True)
    return out, {"merge": mcap.merge, "down": dcap.down, "multiseg": (fn3, lanes, t0_seg)}


async def region_paths(torch, rng, dev, counted) -> tuple[dict, tuple]:
    """Phase 3l (3): the regioned scatter-gather read. 4 regions at series
    granularity on a fresh MemStore; TSBS cpu-only's 10,000 hosts with
    3i's tags, cpu_usage_user at 10 s scrapes for 30 minutes (1.8M samples)
    in 6 payloads; a double-groupby-1-shaped downsample (1-minute buckets,
    all hosts) through `query` (the host fold), then `query_partial_grids`
    split over two "nodes", the wire round trip, and `merge_partials` on a
    4-slot mesh (kernel grid_fold): bitwise equal to `query`."""
    import dataclasses

    import horaedb_tpu_torch as port
    from horaedb_tpu_torch.cluster.partial import decode_partials, encode_partials, merge_partials
    from horaedb_tpu_torch.common.hash import seahash_many
    from horaedb_tpu_torch.engine import QueryRequest
    from horaedb_tpu_torch.engine.region import RegionedEngine
    from horaedb_tpu_torch.engine.types import series_key_of
    from horaedb_tpu_torch.objstore import MemStore
    from horaedb_tpu_torch.parallel.merge import device_fold_safe
    from horaedb_tpu_torch.serving import ServingTierConfig

    out: dict = {}
    tags, _rack = engine_hosts(rng)
    host_tsid = seahash_many([series_key_of(lab) for lab in tags])
    tsid_host = {int(x): h for h, x in enumerate(host_tsid)}
    values = rng.uniform(0, 100, (NUM_SERIES, 1, ENGINE_SCRAPES))
    per = ENGINE_SCRAPES // REGION_PAYLOADS
    writer = PayloadWriter(tags, ("usage_user",), per_payload=per)
    eng = await RegionedEngine.open("tsbs_regions", MemStore(), num_regions=NUM_REGIONS,
                                    enable_compaction=False,
                                    serving=ServingTierConfig(enabled=False), device=dev)
    ts0 = T0 + np.arange(ENGINE_SCRAPES, dtype=np.int64) * INTERVAL_MS
    port.reset_launch_counts()
    written = 0
    t = time.perf_counter()
    for p in range(REGION_PAYLOADS):
        sl = slice(p * per, (p + 1) * per)
        written += await eng.write_payload(writer.payload(values[:, 0, sl], ts0[sl]))
    torch.cuda.synchronize()
    out["write_s"] = time.perf_counter() - t
    counted("region_write", port.launch_counts())
    require(written == values.size, f"regioned write: {written} of {values.size} samples")
    spread = [e.series_count(b"cpu_usage_user") for e in eng.engines.values()]
    require(sum(spread) == NUM_SERIES and min(spread) > 0, f"series per region: {spread}")
    req = QueryRequest(metric=b"cpu_usage_user", start_ms=T0, end_ms=T0 + ENGINE_WINDOW_MS,
                       bucket_ms=ENGINE_BUCKET_MS)
    mesh4 = card_mesh(torch, dev, MESH_SLOTS)
    with EnvPin(HORAEDB_BATCH="off"):
        port.reset_launch_counts()
        t = time.perf_counter()
        single = await eng.query(req)
        out["query_s"] = time.perf_counter() - t
        counted("region_query", port.launch_counts())
        require(single is not None and len(single[0]) == NUM_SERIES, "regioned query: series")
        hosts = np.array([tsid_host[x] for x in single[0]])
        check_grids(single[1], engine_oracle(values, 0, hosts), "regioned query")
        require(device_fold_safe(mesh4), "device_fold_safe is False on the card's mesh")
        port.reset_launch_counts()
        t = time.perf_counter()
        parts, wire = [], 0
        for node, group in (("node-a", [0, 1]), ("node-b", [2, 3])):
            frag = await eng.query_partial_grids(dataclasses.replace(req, regions=group))
            buf = encode_partials(node, frag)
            wire += len(buf)
            parts.extend(decode_partials(buf)[1])
        t_fold = time.perf_counter()
        with CaptureMesh() as fcap:
            merged = merge_partials(parts, order=list(eng.engines), device_mesh=mesh4)
        torch.cuda.synchronize()
        out["scatter_gather_s"] = time.perf_counter() - t
        out["fold_s"] = time.perf_counter() - t_fold
        counts = port.launch_counts()
        counted("region_scatter_gather", counts)
    require(counts["grid_fold"] > 0, "the scatter-gather fold did not launch grid_fold")
    require(same_answer(merged, single), "scatter-gather grids differ from query()'s")
    out.update(samples=written, series_per_region=spread, wire_bytes=wire,
               fold_shape=list(fcap.fold[1]["sum"].shape))
    print(f"3l regions: {written} samples in {out['write_s']:.2f} s, query {out['query_s']:.3f} "
          f"s, scatter-gather {out['scatter_gather_s']:.3f} s (fold {out['fold_s']:.3f} s, "
          f"{fcap.fold[1]['sum'].shape}), bitwise equal", flush=True)
    await eng.close()
    return out, fcap.fold


def mesh_step_library(torch, dev, ts_l, sid_l, val_l, ok_l, t0s, num_series: int,
                      num_buckets: int):
    """The yardstick of the downsample rows and of the two mesh steps: a
    function making 2 index_add_ + 2 scatter_reduce calls over the flat cell
    ids of the same rows (lists of row lanes, one t0 each)."""
    flats, vals = [], []
    for ts, sid, v, ok, t0 in zip(ts_l, sid_l, val_l, ok_l, t0s):
        b = torch.div(ts - t0, BUCKET_MS, rounding_mode="floor")
        good = ok & (b >= 0) & (b < num_buckets) & (sid >= 0) & (sid < num_series)
        flats.append(torch.where(good, sid.long() * num_buckets + b, num_series * num_buckets))
        vals.append(v)
    flat, v = torch.cat(flats), torch.cat(vals)
    cells = num_series * num_buckets

    def library():
        s = torch.zeros(cells + 1, dtype=torch.float64, device=dev).index_add_(0, flat, v)
        c = torch.zeros(cells + 1, dtype=torch.float64, device=dev).index_add_(
            0, flat, torch.ones_like(v))
        mn = torch.full((cells + 1,), torch.inf, dtype=torch.float64,
                        device=dev).scatter_reduce_(0, flat, v, "amin")
        mx = torch.full((cells + 1,), -torch.inf, dtype=torch.float64,
                        device=dev).scatter_reduce_(0, flat, v, "amax")
        return s, c, mn, mx
    return library


def mesh_records(torch, dev, caps: dict, fold_cap) -> list[dict]:
    """Phase 4: the four mesh kernels at phase 3l's shapes against their
    plain versions on the card, timed (kernel, plain, library yardstick)."""
    from horaedb_tpu_torch.backend import order_key, to_device
    from horaedb_tpu_torch.ops import mesh as mesh_ops
    from horaedb_tpu_torch.parallel import merge as pmerge
    from horaedb_tpu_torch.parallel import scan as pscan

    records = []
    # sample_sort_merge: 3l's sharded scan, 8 slots
    m = caps["merge"]
    plan = pmerge.SamplePlan(m["packed"], m["seq_width"], m["do_dedup"], m["mesh"],
                             m["key_bits"])
    got = pmerge._collect(plan.run())
    want = pmerge._collect(plan.run(plain=True))
    require(np.array_equal(got, want), "sample_sort_merge != plain at 3l's shape")
    n, k = len(m["packed"]), len(got)
    key = torch.from_numpy(order_key(m["packed"])).to(dev)
    # each key read once (8 B/row), each survivor's row id written once
    nb, kind = bound(n * 8 + k * 4, 0)
    records.append({
        "name": "sample_sort_merge", "route": "cuda",
        "source": "horaedb_tpu_torch/ops/csrc/sample_sort_merge.cu",
        "replaces": "horaedb_tpu/parallel/merge.py:137",
        "shape": f"{n} rows over {plan.d_slots} slots of one card, {m['key_bits']}-bit key, "
                 f"cap {plan.cap}, {k} survivors",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, plan.run, iters=5, warmup=1),
        "plain_ms": cuda_ms(torch, lambda: plan.run(plain=True), iters=3, warmup=1),
        "bound_ms": nb, "bound_by": kind, "library_ms": None,
        "one_key_sort_ms": cuda_ms(torch, lambda: torch.sort(key, stable=True), iters=5),
        "packed_keys": [{"lanes": ["packed"], "digits": -(-m["key_bits"] // 8)}],
        "sort_path": f"valid-row partition, then {-(-m['key_bits'] // 8)} look-back sweeps "
                     f"(onesweep.cuh, u64 keys, int32 rows) in each of {2 * plan.d_slots} "
                     f"slot steps"})
    del plan, key

    # grid_fold: one slot's launch of 3l's scatter-gather fold
    mesh, stacked = fold_cap
    kk, S, B = stacked["sum"].shape
    local = -(-S // mesh.size)
    part = {key: to_device(np.ascontiguousarray(stacked[key][:, :local]), dev)
            for key in mesh_ops.FOLD_KEYS}
    got = mesh_ops.grid_fold(part)
    want = mesh_ops.grid_fold_plain(part)
    for key in mesh_ops.FOLD_KEYS:
        require(torch.equal(got[key].view(torch.int64), want[key].view(torch.int64)),
                f"grid_fold != plain at 3l's shape ({key})")

    def fold_library():
        return (part["sum"].sum(0), part["count"].sum(0), part["min"].amin(0),
                part["max"].amax(0))

    cells = local * B
    # each partial read once, the four grids written once
    nb, kind = bound(4 * 8 * cells * (kk + 1), 4 * kk * cells)
    records.append({
        "name": "grid_fold", "route": "cuda", "source": "horaedb_tpu_torch/ops/csrc/grid_fold.cu",
        "replaces": "horaedb_tpu/parallel/merge.py:282",
        "shape": f"[{kk}, {local}, {B}] a slot (3l's [{kk}, {S}, {B}] over {mesh.size} slots)",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: mesh_ops.grid_fold(part)),
        "plain_ms": cuda_ms(torch, lambda: mesh_ops.grid_fold_plain(part)),
        "bound_ms": nb, "bound_by": kind, "library_ms": cuda_ms(torch, fold_library),
        "library_call": "sum x2, amin, amax over dim 0"})
    del part

    def step_record(name: str, replaces: str, shape: str, step, rows: int, cells: int,
                    library) -> dict:
        """A mesh step whole, from the raw lanes to the folded grids: held
        bitwise against the same step through the plain route (each slot's
        plain version on CPU copies of its lanes, where index_add_ folds in
        row order) and through the parent's route on the same card tensors
        (SlotRoute), and timed with the plain route on the card, the
        parent's route and its library yardstick."""
        got = step()
        for route, on in (("plain", "cpu"), ("parent", None)):
            with SlotRoute(route, on):
                want = step()
            for key in mesh_ops.FOLD_KEYS:
                require(torch.equal(got[key].view(torch.int64), want[key].view(torch.int64)),
                        f"{name} step != the {route} route at 3l's shape ({key})")
        with SlotRoute("plain"):
            plain_ms = cuda_ms(torch, step, iters=3, warmup=1)
        with SlotRoute("parent"):
            parent_ms = cuda_ms(torch, step, iters=5, warmup=1)
        # read ts 8 + sid 4 + value 8 + valid 1 a row once, write the five
        # grids (sum, count, min, max, mean) once: 21 B a row, 40 B a cell
        nb, kind = bound(rows * 21 + cells * 40, 0)
        return {
            "name": name, "route": "cuda",
            "source": "horaedb_tpu_torch/ops/csrc/sharded_downsample.cu", "replaces": replaces,
            "shape": shape, "max_abs_err": 0.0,
            "ms": cuda_ms(torch, step, iters=5, warmup=1), "device_ms": device_ms(torch, step),
            "plain_ms": plain_ms, "parent_route_ms": parent_ms,
            "bound_ms": nb, "bound_by": kind, "library_ms": cuda_ms(torch, library, iters=5),
            "library_call": "index_add_ x2 + scatter_reduce amin/amax over the flat cell ids "
                            "of the step's rows"}

    # sharded_downsample: 3l's mesh downsample, segment 0's run, the whole step
    a, kw = caps["down"]
    mesh4, ts_l, sid_l, val_l, ok_l = a[:5]
    t0, num_series, num_buckets = kw["t0"], kw["num_series"], kw["num_buckets"]
    rows = sum(int(t.numel()) for t in ts_l)
    records.append(step_record(
        "sharded_downsample", "horaedb_tpu/parallel/scan.py:197",
        f"3l's mesh downsample step: {rows} sorted rows on {mesh4.size} slots (rows 2 x series "
        f"2), {num_series} series x {num_buckets} buckets",
        lambda: pscan.sharded_downsample(mesh4, ts_l, sid_l, val_l, ok_l, t0, kw["bucket_ms"],
                                         num_series, num_buckets,
                                         sorted_input=kw["sorted_input"]),
        rows, num_series * num_buckets,
        mesh_step_library(torch, dev, ts_l, sid_l, val_l, ok_l, [t0] * len(ts_l), num_series,
                          num_buckets)))

    # multisegment_downsample: 3l's 3-axis step over 3a's two segments
    fn3, lanes, t0_seg = caps["multiseg"]
    # segment 1's series offset past segment 0's: one flat grid of both
    seg_lanes = [[x[g] for g in (0, 1)] for x in lanes]
    seg_lanes[1][1] = seg_lanes[1][1] + NUM_SERIES
    records.append(step_record(
        "multisegment_downsample", "horaedb_tpu/parallel/scan.py:286",
        f"3l's 3-axis step: [2, {lanes[0].shape[1]}] rows on 8 slots (seg 2 x rows 2 x series "
        f"2), {NUM_SERIES} series x {SEG_BUCKETS} buckets a segment",
        lambda: fn3(*lanes, t0_seg, BUCKET_MS), int(lanes[0].numel()),
        2 * NUM_SERIES * SEG_BUCKETS,
        mesh_step_library(torch, dev, *seg_lanes, [int(t) for t in t0_seg], 2 * NUM_SERIES,
                          SEG_BUCKETS)))
    return records


class SlotRoute:
    """Inside the block, the mesh steps take another route through each
    slot: `plain`, the slot pass's plain version (on device `on`, default
    the lanes' own) and grid_fold's; or `parent`, the route the slot pass
    replaced: the cell keys (`sharded_keys_plain`, bitwise the key kernel it
    had), then kernels B and C over them (sorted rows) or grouped_stats
    three times (the values and the weights over the clipped keys, min and
    max over the dropping keys), and kernel grid_fold."""

    def __init__(self, route: str, on=None):
        self.route, self.on = route, on

    def __enter__(self):
        import torch

        from horaedb_tpu_torch.ops import mesh as mesh_ops

        self.orig = (mesh_ops.slot_grids, mesh_ops.grid_fold)
        grids_of = mesh_ops.slot_grids_plain if self.route == "plain" else parent_slot_grids

        def slot(*args, out=None, library=None):
            dev = args[0].device
            if self.on is not None:
                args = [a.to(self.on) if torch.is_tensor(a) else a for a in args]
            grids = {k: v.to(dev) for k, v in grids_of(*args).items()}
            if out is None:
                return grids
            for k, t in out.items():
                t.copy_(grids[k])
            return out

        mesh_ops.slot_grids = slot
        if self.route == "plain":
            mesh_ops.grid_fold = mesh_ops.grid_fold_plain
        return self

    def __exit__(self, *exc):
        from horaedb_tpu_torch.ops import mesh as mesh_ops

        mesh_ops.slot_grids, mesh_ops.grid_fold = self.orig


def parent_slot_grids(ts, sid, vals, valid, mask, t0, bucket_ms, lo, local_series, num_buckets,
                      sorted_input, with_minmax=True) -> dict:
    """One slot's flat grids through the parent's route (SlotRoute)."""
    import torch

    from horaedb_tpu_torch.ops import blockagg
    from horaedb_tpu_torch.ops import mesh as mesh_ops
    from horaedb_tpu_torch.ops.aggregate import grouped_stats

    cells = local_series * num_buckets
    safe, flat, vm, w, ok = mesh_ops.sharded_keys_plain(ts, sid, vals, valid, mask, t0,
                                                        bucket_ms, lo, local_series, num_buckets)
    if mesh_ops.sorted_route(sorted_input, cells):
        s, c = blockagg.block_sum_count(safe, vm, cells, weights=w)
        mn, mx = blockagg.block_min_max(safe, vm, cells, valid=ok)
    else:
        kc = torch.clamp(safe, 0, cells)
        s = grouped_stats(vm, kc, None, cells)["sum"]
        c = grouped_stats(w, kc, None, cells)["sum"]
        g = grouped_stats(vm, flat, None, cells)
        mn, mx = g["min"], g["max"]
    out = {"sum": s, "count": c}
    if with_minmax:
        out["min"], out["max"] = mn, mx
    return out


# profiler windows taken again because they had lost device records
# (profiled_events); printed with phase 4's records, and in chip_ab.py's JSON
RETAKEN_WINDOWS = [0]


def profiled_events(torch, fn, calls: int, tries: int = 8) -> list:
    """The device records (torch.profiler) of `calls` calls of fn(), after
    one call outside the window. A window can lose records: one in which
    some kernel, copy or memset does not come out a whole number of times a
    call is taken again (counted in RETAKEN_WINDOWS), and the run fails
    when none of `tries` windows is whole."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        names = {}
        for e in events:
            names[e.name] = names.get(e.name, 0) + 1
        if all(c % calls == 0 for c in names.values()):
            return events
        RETAKEN_WINDOWS[0] += 1
    raise SmokeFailure(f"{tries} profiler windows of {calls} calls each lost device records")


def device_ms(torch, fn, calls: int = 5, with_ops: bool = False):
    """Device ms a call of fn(): every kernel, copy and memset it runs
    (`profiled_events`, the mean of `calls` calls); with_ops: (ms, the
    device operations a call runs)."""
    events = profiled_events(torch, fn, calls)
    ms = sum(e.time_range.elapsed_us() for e in events) / calls / 1e3
    return (ms, len(events) / calls) if with_ops else ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-stacked-call", default=None, metavar="FILE",
                    help="save burst A's stacked_downsample inputs to FILE (torch.save), for "
                         "chip_ab.py agg-pair --stacked-call")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import shutil
    import tempfile

    # the aggregation dispatcher's calibration file, for the run only (3j
    # starts another, fresh one)
    calib_dir = tempfile.mkdtemp(prefix="chip_smoke_calib_")
    os.environ["HORAEDB_AGG_CACHE"] = f"{calib_dir}/torch_agg_calib.json"
    try:
        return run_smoke(torch, args.seed, args.save_stacked_call)
    finally:
        shutil.rmtree(calib_dir, ignore_errors=True)


def run_smoke(torch, seed: int, save_stacked: str | None = None) -> int:
    """Phases 1 to 4 (module docstring) on cuda:0."""
    import asyncio
    import tempfile

    from horaedb_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    t_all = time.perf_counter()
    t = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t:.1f} s wall, per kernel "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()), flush=True)
    occupancy = sweep_occupancy()
    print(f"onesweep sweep_kernel occupancy [{card}]: {json.dumps(occupancy)}", flush=True)
    seg_occupancy = segreduce_occupancy()
    print(f"segreduce run_kernel occupancy [{card}]: {json.dumps(seg_occupancy)}", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    data = make_data(rng)
    records = check_kernels(torch, rng, dev) + check_merge_kernels(torch, rng, dev, data)
    check_fused_kernels(torch, rng, dev)
    check_decode_kernels(torch, rng, dev)
    check_stacked_kernel(torch, rng, dev)
    check_agg_kernels(torch, rng, dev)
    check_mesh_kernels(torch, rng, dev)
    long_runs = check_long_runs(torch, np.random.default_rng([seed, 1]), dev)
    sort_paths = check_sort_paths(torch, np.random.default_rng([seed, 2]), dev)
    print(f"phase 2: {time.perf_counter() - t_all:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        result = asyncio.run(main_paths(torch, rng, dev, data, workdir))
    result["long_runs"] = long_runs
    result["sort_paths"] = sort_paths
    result["sweep_occupancy"] = occupancy
    result["segreduce_occupancy"] = seg_occupancy
    print(f"phase 3: {time.perf_counter() - t_all:.1f} s", flush=True)
    records += fused_records(torch, result.pop("fused_capture"), dev, seed)
    records += decode_records(torch, result.pop("decode_capture"), dev)
    records += stacked_records(torch, result.pop("stacked_capture"), dev, save_stacked)
    records += agg_records(torch, dev, result.pop("last_write_capture"))
    records += mesh_records(torch, dev, result.pop("mesh_capture"), result.pop("fold_capture"))
    result["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    for r in records:
        r["launches"] = result["kernel_launches"][r["name"]]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{r['name']}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}, "
              f"{r['launches']} launches [{card}]", flush=True)
        if "device_ops" in r:
            print(f"{r['name']}: device {r['device_ms']:.4f} ms a call (torch.profiler), "
                  f"{r['device_ops']:g} device operations a call [{card}]", flush=True)
        if "main_call_ms" in r:
            print(f"{r['name']}: as downsample_sorted calls it: {r['main_call_ms']:.4f} ms, "
                  f"bound {r['main_call_bound_ms']:.4f} ms [{card}]", flush=True)
    print(f"profiler windows retaken (lost device records): {RETAKEN_WINDOWS[0]}", flush=True)
    profiled = result.pop("profile")
    result["smoke_s"] = time.perf_counter() - t_all
    print(json.dumps({"main_paths": result, "card": card}), flush=True)
    print(json.dumps({"profile": profiled, "card": card}), flush=True)
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
