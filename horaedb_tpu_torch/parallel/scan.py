"""Sharded scan -> filter -> aggregate over the mesh.

A port of the JAX package's `parallel/scan.py`: rows shard over the "rows"
axis, the series dimension over "series", and the row shards' partial
(sum, count, min, max) grids combine over "rows". The JAX package does the
combine with psum/pmin/pmax inside `shard_map`; the port's host drives one
step per slot and folds the row shards' grids left to right, in slot
order, on the series slot's device, through kernel `grid_fold`, so the
combine is deterministic.

Each slot's step (`_local_grids`) is one slot pass
(`csrc/sharded_downsample.cu`, with kernel E for a predicate): from the raw
lanes to the slot's partial grids of its series slice, folding sorted rows
as they lie and sorting other rows once by cell first. The passes of a
series slot write into one stacked buffer on its first row slot's device,
which `grid_fold` folds. On CPU slots every kernel runs its plain version,
so a mesh of CPU slots is the step's reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from horaedb_tpu_torch.backend import to_device
from horaedb_tpu_torch.common import deadline as deadline_ctx
from horaedb_tpu_torch.common.error import HoraeError, ensure
from horaedb_tpu_torch.ops import agg_registry, blockagg
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops import mesh as mesh_ops
from horaedb_tpu_torch.ops.filter import Predicate
from horaedb_tpu_torch.parallel.mesh import Mesh
from horaedb_tpu_torch.server.metrics import GLOBAL_METRICS
from horaedb_tpu_torch.storage import scanstats

H2D_SECONDS = GLOBAL_METRICS.histogram(
    "horaedb_h2d_transfer_seconds",
    help="Host->device placement time per sharded-scan input batch "
         "(dispatch only unless a scanstats collector fences transfers).",
)
H2D_BYTES = GLOBAL_METRICS.counter(
    "horaedb_h2d_transfer_bytes_total",
    help="Bytes placed onto the mesh by sharded scans.",
)
SCAN_PATH = GLOBAL_METRICS.counter(
    "horaedb_scan_path_total",
    help="Merge route the scan planner took (host SIMD, single-device "
         "kernel, or the cross-chip sharded merge).",
    labelnames=("path",),
)

# predicate lanes of a mesh step, with the host dtypes that set the literal casts
_LANE_DTYPES = {"__ts__": np.dtype(np.int64), "__sid__": np.dtype(np.int32),
                "__val__": np.dtype(np.float64)}


def _local_grids(ts, sid, vals, valid, t0, bucket_ms, series_lo, local_series, num_buckets,
                 with_minmax, sorted_input=False, program=None, library="sharded_downsample",
                 out=None):
    """Partial grids for one slot's rows, restricted to the series slice
    [series_lo, series_lo + local_series): flat [local_series *
    num_buckets] tensors of sum and count (min and max too when
    `with_minmax`), written into `out` when given and the pass can (a slot
    on the card of `out`).

    Rows outside the slice go to the sentinel key (one prefix or suffix run
    in (sid, ts) order, never fragmented); predicate and bucket misses keep
    clipped in-range keys and ride the weight column. One slot pass
    (`ops/mesh.py::slot_grids`): `sorted_input` declares rows ordered by
    (sid, ts), folded as they lie; other rows are sorted once by cell
    first. The sorted route asks the calibrated dispatcher, as kernels B
    and C did: every device name is kernel B's function for f64 values,
    so the pass computes it; a host lane (`reduceat`, CPU tensors only,
    refused on the card) reduces the keys of `sharded_keys_plain`."""
    num_cells = local_series * num_buckets
    mask = None
    if program is not None:
        lanes = {"__ts__": ts, "__sid__": sid, "__val__": vals}
        if ts.device.type == "cpu":
            mask = filter_ops.eval_program_plain(program, lanes, ts.shape[0])
        else:
            mask = torch.empty(ts.shape[0], dtype=torch.uint8, device=ts.device)
            filter_ops.launch_program(program, lanes, ts.shape[0], mask, library=library)
    args = (ts, sid, vals, valid, mask, t0, bucket_ms, series_lo, local_series, num_buckets)
    if mesh_ops.sorted_route(sorted_input, num_cells):
        impl = blockagg.resolve_sorted_impl(None, ts.shape[0], num_cells, ts.device)
        if agg_registry.is_host_impl(impl):
            safe, _flat, vm, w, ok = mesh_ops.sharded_keys_plain(*args)
            s, c = blockagg.sorted_segment_sum_count(safe, vm, num_cells, impl=impl, weights=w)
            grids = {"sum": s, "count": c}
            if with_minmax:
                grids["min"], grids["max"] = blockagg.sorted_segment_min_max(
                    safe, vm, num_cells, impl=impl, valid=ok)
            return grids
    if out is not None and out["sum"].device != ts.device:  # the grids share one device
        out = None
    return mesh_ops.slot_grids(*args, sorted_input, with_minmax, out=out, library=library)


def _fold_rows(slots_of_series, lanes, t0, bucket_ms, series_lo, local_series, num_buckets,
               with_minmax, sorted_input, program, library) -> dict:
    """The slot passes of one series slot's row shards, then their left
    fold in slot order on the first one's device: the port's psum / pmin /
    pmax over "rows". Each pass writes its partial straight into one
    [rows, local_series, num_buckets] buffer a grid on that device; a slot
    on another card (or a host lane) copies its partial in."""
    home = slots_of_series[0]
    keys = mesh_ops.FOLD_KEYS if with_minmax else mesh_ops.FOLD_KEYS[:2]
    buf = torch.empty((len(keys), len(slots_of_series), local_series, num_buckets),
                      dtype=torch.float64, device=home)
    per_slot = buf.view(len(keys), len(slots_of_series), -1).unbind(1)
    for r, dev in enumerate(slots_of_series):
        dst = dict(zip(keys, per_slot[r].unbind(0)))
        part = _local_grids(*[x[r].to(dev) for x in lanes], t0, bucket_ms, series_lo,
                            local_series, num_buckets, with_minmax, sorted_input=sorted_input,
                            program=program, library=library, out=dst)
        for k in keys:
            if part[k].data_ptr() != dst[k].data_ptr():
                dst[k].copy_(part[k])
    return mesh_ops.grid_fold(dict(zip(keys, buf.unbind(0))))


def _check_shards(lanes, n_shards: int, what: str) -> None:
    for lane in lanes:
        if not (isinstance(lane, (list, tuple)) and len(lane) == n_shards):
            raise HoraeError(f"{what}: each lane must be a list of {n_shards} row shards "
                             f"(shard_rows output), got {type(lane).__name__}")


def _step(mesh: Mesh, ts, sid, vals, valid, t0, bucket_ms, num_series, num_buckets,
          program, with_minmax, sorted_input, slots=None, library="sharded_downsample"):
    """The sharded step over a ("rows", "series") slot grid `slots`
    (default the mesh's): per slot its partial grids, folded over "rows" on
    the series slot's device, gathered along "series" onto the first
    slot's device. Lanes are lists of row shards."""
    slots = mesh.devices if slots is None else slots
    rows_par, series_par = slots.shape
    if num_series % series_par:
        raise HoraeError(f"num_series={num_series} must divide over series axis={series_par}")
    _check_shards((ts, sid, vals, valid), rows_par, library)
    local_series = num_series // series_par
    parts: dict[str, list] = {}
    for s in range(series_par):
        folded = _fold_rows(list(slots[:, s]), (ts, sid, vals, valid), t0, bucket_ms,
                            s * local_series, local_series, num_buckets, with_minmax,
                            sorted_input, program, library)
        for k, v in folded.items():
            parts.setdefault(k, []).append(v)
    home = slots[0, 0]
    out = {k: torch.cat([v.to(home) for v in vs]) for k, vs in parts.items()}
    out["mean"] = out["sum"] / out["count"]
    return out


def build_sharded_downsample(
    mesh: Mesh,
    num_series: int,
    num_buckets: int,
    predicate: Predicate | None = None,
    with_minmax: bool = True,
    sorted_input: bool = False,
):
    """The sharded downsample step for a fixed grid shape: returns
    fn(ts, sid, vals, valid, t0, bucket_ms) -> dict of [num_series,
    num_buckets] grids (sum, count, mean, and min, max unless
    `with_minmax=False`) on the first slot's device. Each lane is a list of
    `mesh.shape["rows"]` row shards (`shard_rows`). The predicate reads the
    lanes `__ts__`, `__sid__` and `__val__`."""
    series_par = mesh.shape["series"]
    ensure(num_series % series_par == 0,
           f"num_series={num_series} must divide over series axis={series_par}")
    program = filter_ops.compile_program(predicate, _LANE_DTYPES)

    def fn(ts, sid, vals, valid, t0, bucket_ms):
        return _step(mesh, ts, sid, vals, valid, int(t0), int(bucket_ms), num_series,
                     num_buckets, program, with_minmax, sorted_input)

    return fn


def sharded_downsample(
    mesh: Mesh,
    ts,
    sid,
    vals,
    valid,
    t0,
    bucket_ms,
    num_series: int,
    num_buckets: int,
    predicate: Predicate | None = None,
    with_minmax: bool = True,
    sorted_input: bool = False,
):
    """One-shot wrapper of `build_sharded_downsample`, with the cooperative
    deadline checked before any launch and the route counted."""
    deadline_ctx.check("device_lane")
    SCAN_PATH.labels("sharded").inc()
    fn = build_sharded_downsample(mesh, num_series, num_buckets, predicate, with_minmax,
                                  sorted_input)
    return fn(ts, sid, vals, valid, t0, bucket_ms)


def build_multisegment_downsample(mesh: Mesh, num_series: int, num_buckets: int):
    """The 3-axis step over a ("seg", "rows", "series") mesh: "seg" shards
    independent time segments (nothing crosses it), "rows" data-parallels
    each segment's rows, "series" shards the output grids.

    Returns fn(ts, sid, vals, valid, t0_seg, bucket_ms): lanes are
    [n_segments, rows] tensors (n_segments equal to the seg axis, rows
    dividing the rows axis) and `t0_seg` one t0 per segment; the outputs
    are [n_segments, num_series, num_buckets] grids of sum, count, min, max
    and mean on the first slot's device. Rows are taken as unsorted, as
    the JAX step takes them."""
    ensure(tuple(mesh.axis_names) == ("seg", "rows", "series"),
           f"multisegment_downsample needs a (seg, rows, series) mesh, got {mesh.axis_names}")
    series_par = mesh.shape["series"]
    ensure(num_series % series_par == 0,
           f"num_series={num_series} must divide over series axis={series_par}")
    segs, rows_par = mesh.shape["seg"], mesh.shape["rows"]

    def fn(ts, sid, vals, valid, t0_seg, bucket_ms):
        if ts.shape[0] != segs:
            raise HoraeError(f"n_segments must equal the seg mesh axis (got {ts.shape[0]} "
                             f"segments for {segs} seg-shards)")
        n = ts.shape[1]
        if n % rows_par:
            raise HoraeError(f"{n} rows do not divide over rows axis={rows_par}")
        per = n // rows_par
        t0s = [int(t) for t in (t0_seg.tolist() if hasattr(t0_seg, "tolist") else t0_seg)]
        outs = []
        for g in range(segs):
            lanes = [[x[g, r * per:(r + 1) * per] for r in range(rows_par)]
                     for x in (ts, sid, vals, valid)]
            outs.append(_step(mesh, *lanes, t0s[g], int(bucket_ms), num_series, num_buckets,
                              None, True, False, slots=mesh.devices[g],
                              library="multisegment_downsample"))
        home = mesh.devices.flat[0]
        return {k: torch.stack([o[k].to(home) for o in outs])
                for k in ("sum", "count", "min", "max", "mean")}

    return fn


def sharded_grouped_stats(
    mesh: Mesh,
    group_idx,
    vals,
    valid,
    num_groups: int,
    predicate: Predicate | None = None,
    with_minmax: bool = True,
):
    """Group-by aggregation = downsample with one bucket: group ids play the
    series role, the bucket axis is a singleton."""
    ts = [torch.zeros(g.shape, dtype=torch.int64, device=g.device) for g in group_idx]
    out = sharded_downsample(
        mesh, ts, group_idx, vals, valid,
        t0=0, bucket_ms=1, num_series=num_groups, num_buckets=1,
        predicate=predicate, with_minmax=with_minmax,
    )
    return {k: v[:, 0] for k, v in out.items()}


def shard_rows(mesh: Mesh, arrays: tuple, pad_value=0):
    """Place 1-D host arrays onto the mesh row-sharded: pad to a multiple of
    the rows axis and return (lanes, valid), each lane (and `valid`) a list
    of `mesh.shape["rows"]` row shards, shard r on the device of slot
    (r, 0). The staging is one pinned host buffer per lane and one H2D
    copy per lane and device (one per lane on a one-card mesh; the shards
    are views of it). Placement is timed into
    `horaedb_h2d_transfer_seconds`; with a scanstats collector attached
    the copies are fenced, so the histogram carries transfer time.

    `pad_value` is one scalar for every lane or one per lane: the sid lane
    of sorted input must pad with an out-of-range sentinel (>= the padded
    series count) so tail pad rows keep the keys monotone."""
    deadline_ctx.check("device_lane")
    rows_par = mesh.shape["rows"]
    n = len(arrays[0])
    pad = (-n) % rows_par
    per = (n + pad) // rows_par
    pads = (list(pad_value) if isinstance(pad_value, (tuple, list))
            else [pad_value] * len(arrays))
    ensure(len(pads) == len(arrays),
           f"per-lane pad_value needs {len(arrays)} entries, got {len(pads)}")
    padded = []
    for a, pv in zip(arrays, pads):
        a = np.asarray(a)
        if pad:
            g = np.empty(n + pad, dtype=a.dtype)
            g[:n] = a
            g[n:] = pv
            a = g
        padded.append(a)
    valid = np.ones(n + pad, dtype=bool)
    valid[n:] = False
    homes = [mesh.devices.reshape(rows_par, -1)[r, 0] for r in range(rows_par)]
    t0 = time.perf_counter()
    out = []
    nbytes = 0
    for a in padded + [valid]:
        nbytes += a.nbytes
        if len(set(homes)) == 1:
            whole = to_device(a, homes[0])
            out.append([whole[r * per:(r + 1) * per] for r in range(rows_par)])
        else:
            out.append([to_device(a[r * per:(r + 1) * per], homes[r]) for r in range(rows_par)])
    if scanstats.current() is not None and any(d.type == "cuda" for d in homes):
        torch.cuda.synchronize()  # attribution fence; profiling runs only
    H2D_SECONDS.observe(time.perf_counter() - t0)
    H2D_BYTES.inc(nbytes)
    return tuple(out[:-1]), out[-1]
