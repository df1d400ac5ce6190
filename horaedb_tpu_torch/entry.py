"""Entry points of the port: the single-device forward step and the mesh
dry run.

A port of the JAX package's `__graft_entry__.py`. The flagship step is the
range-aggregate downsample (filter -> series x time-bucket grid): `entry()`
returns it with example arguments; `dryrun_multichip(n)` runs the sharded
step over an n-slot (rows x series) mesh, the 3-axis multisegment step,
the engine's downsample with the mesh installed, and the cross-slot
sample-sort merge at the kernel and the scan level, each checked against
the single-device route. Slots default to one card (`device`, "cuda" by
default): several slots on one card are the counterpart of the JAX
package's virtual devices. The JAX dry run also compacts through the
sharded merge; the port has no compaction yet, so that part is left out.
"""

from __future__ import annotations

import numpy as np
import torch

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device


def entry(device=DEFAULT_DEVICE):
    """(fn, example_args): the single-device forward step, kernel
    `downsample` (then `grouped_stats`) on `device`. `example_args` are
    numpy; `fn` takes numpy arrays or tensors and returns the mean grid."""
    from horaedb_tpu_torch.ops import aggregate

    dev = resolve_device(device)
    num_series, num_buckets = 8, 16

    def forward(ts, sid, vals, valid, t0, bucket_ms):
        lanes = [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(dev)
                 for a in (ts, sid, vals, valid)]
        out = aggregate.downsample(*lanes, int(t0), int(bucket_ms),
                                   num_series=num_series, num_buckets=num_buckets)
        return out["mean"]

    n = 1024
    rng = np.random.default_rng(0)
    example_args = (
        rng.integers(0, num_buckets * 300_000, n).astype(np.int64),
        rng.integers(0, num_series, n).astype(np.int32),
        rng.normal(size=n),
        np.ones(n, dtype=bool),
        np.int64(0),
        np.int64(300_000),
    )
    return forward, example_args


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> None:
    """Run the sharded scan step once over an n-slot mesh on `device`.

    Mesh: (rows = n // sp, series = sp). Phases: the sharded downsample
    with a predicate against the host oracle; the 3-axis ("seg", "rows",
    "series") step (n divisible by 4); the engine's downsample with the
    mesh installed against the single-device route; the cross-slot merge
    against kernel D and a sharded scan against the default scan."""
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.parallel import make_mesh, sharded_downsample
    from horaedb_tpu_torch.parallel.mesh import Mesh
    from horaedb_tpu_torch.parallel.scan import build_multisegment_downsample, shard_rows

    dev = resolve_device(device)
    series_parallel = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, series_parallel=series_parallel, devices=[dev] * n_devices)

    num_series, num_buckets = 4 * series_parallel, 8
    n = 64 * mesh.shape["rows"]
    rng = np.random.default_rng(0)
    ts = rng.integers(0, num_buckets * 1000, n).astype(np.int64)
    sid = rng.integers(0, num_series, n).astype(np.int32)
    vals = rng.normal(size=n)

    (d_ts, d_sid, d_vals), d_valid = shard_rows(mesh, (ts, sid, vals))
    out = sharded_downsample(
        mesh, d_ts, d_sid, d_vals, d_valid,
        t0=0, bucket_ms=1000,
        num_series=num_series, num_buckets=num_buckets,
        predicate=F.Compare("__val__", "gt", -10.0),
    )
    total = float(out["sum"].sum())
    expect = float(vals[vals > -10.0].sum())
    assert abs(total - expect) < 1e-6 * max(1.0, abs(expect)), (total, expect)
    assert tuple(out["sum"].shape) == (num_series, num_buckets), tuple(out["sum"].shape)
    print(f"dryrun_multichip OK: mesh={mesh.shape} rows={n} "
          f"grid=({num_series},{num_buckets}) sum={total:.4f}")

    # the 3-axis step: ("seg", "rows", "series"), one time segment a seg-shard
    if n_devices % (2 * series_parallel) == 0 and n_devices >= 4:
        segs = 2
        rows_par = n_devices // (segs * series_parallel)
        slots = np.empty(n_devices, dtype=object)
        slots[:] = [dev] * n_devices
        mesh3 = Mesh(slots.reshape(segs, rows_par, series_parallel), ("seg", "rows", "series"))
        rows = 64 * rows_par
        ts3 = rng.integers(0, 8_000, (segs, rows)).astype(np.int64)
        sid3 = rng.integers(0, num_series, (segs, rows)).astype(np.int32)
        vals3 = rng.normal(size=(segs, rows))
        fn3 = build_multisegment_downsample(mesh3, num_series, 8)
        lanes = [torch.from_numpy(a).to(dev) for a in (ts3, sid3, vals3)]
        out3 = fn3(*lanes, torch.ones((segs, rows), dtype=torch.bool, device=dev),
                   np.zeros(segs, dtype=np.int64), 1000)
        got = out3["sum"].cpu().numpy()
        for s in range(segs):
            exp = float(vals3[s].sum())
            assert abs(float(got[s].sum()) - exp) < 1e-6 * max(1.0, abs(exp))
        print(f"dryrun_multichip 3-axis OK: mesh={mesh3.shape} grids={got.shape}")

    _dryrun_storage_on_mesh(mesh, num_series, num_buckets, dev)
    _dryrun_sharded_merge(mesh, n_devices, dev)


def _dryrun_sharded_merge(mesh, n_devices: int, dev) -> None:
    import asyncio
    import os

    import pyarrow as pa

    from horaedb_tpu_torch.backend import u64_to_i64
    from horaedb_tpu_torch.objstore import MemStore
    from horaedb_tpu_torch.ops.merge import packed_merge
    from horaedb_tpu_torch.parallel.merge import _SENTINEL, sharded_packed_merge
    from horaedb_tpu_torch.parallel.mesh import set_active_mesh
    from horaedb_tpu_torch.storage import (
        ObjectBasedStorage,
        ScanRequest,
        TimeRange,
        WriteRequest,
    )

    # kernel level: duplicated groups and sentinel-masked rows
    rng = np.random.default_rng(21)
    n, seq_width = 200_000, 8
    grp = rng.integers(0, 9_000, n).astype(np.uint64)
    seq = rng.integers(0, 1 << seq_width, n).astype(np.uint64)
    packed = (grp << np.uint64(seq_width)) | seq
    packed[rng.random(n) < 0.15] = _SENTINEL
    out_idx, kcnt = packed_merge(torch.from_numpy(u64_to_i64(packed)).to(dev), 63, seq_width,
                                 True)
    single = out_idx[: int(kcnt.item())].cpu().numpy().astype(np.int64)
    sharded = sharded_packed_merge(packed, seq_width, True, mesh)
    np.testing.assert_array_equal(sharded, single)

    # scan level: an overlapping-SST scan with the sharded merge forced
    # must equal the default route bytewise
    SEG = 3_600_000
    schema = pa.schema([("pk1", pa.int64()), ("pk2", pa.int64()),
                        ("ts", pa.int64()), ("value", pa.float64())])

    async def scan_once(force_sharded: bool) -> pa.Table:
        rng = np.random.default_rng(22)
        eng = await ObjectBasedStorage.try_new(
            "db", MemStore(), schema, 2, SEG, enable_compaction_scheduler=False,
            start_background_merger=False, device=dev)
        for _w in range(3):
            m = 4000
            batch = pa.RecordBatch.from_pydict(
                {"pk1": rng.integers(0, 600, m).astype(np.int64),
                 "pk2": rng.integers(0, 4, m).astype(np.int64),
                 "ts": rng.integers(0, SEG - 1, m).astype(np.int64),
                 "value": rng.normal(size=m)},
                schema=schema)
            await eng.write(WriteRequest(batch, TimeRange(0, SEG)))
        old = os.environ.get("HORAEDB_SCAN_PATH")
        if force_sharded:
            os.environ["HORAEDB_SCAN_PATH"] = "sharded"
            set_active_mesh(mesh)
        try:
            out = [b async for b in eng.scan(ScanRequest(range=TimeRange(0, SEG)))]
        finally:
            if old is None:
                os.environ.pop("HORAEDB_SCAN_PATH", None)
            else:
                os.environ["HORAEDB_SCAN_PATH"] = old
            set_active_mesh(None)
        await eng.close()
        return pa.Table.from_batches(out)

    t_sharded = asyncio.run(scan_once(True))
    t_default = asyncio.run(scan_once(False))
    assert t_sharded.equals(t_default), "sharded scan diverged from default"
    print(f"dryrun_multichip sharded-merge OK: {n_devices}-slot sample sort == "
          f"single-device ({len(single)} survivors kernel-level, {t_sharded.num_rows} "
          f"rows scan-level)")


def _dryrun_storage_on_mesh(mesh, num_series: int, num_buckets: int, dev) -> None:
    import asyncio

    from horaedb_tpu_torch.engine import tables
    from horaedb_tpu_torch.engine.data import SampleManager
    from horaedb_tpu_torch.objstore import MemStore
    from horaedb_tpu_torch.parallel.mesh import set_active_mesh
    from horaedb_tpu_torch.storage.storage import ObjectBasedStorage
    from horaedb_tpu_torch.storage.types import TimeRange

    HOUR = 3_600_000
    rng = np.random.default_rng(7)

    async def run() -> None:
        data_t = await ObjectBasedStorage.try_new(
            "data", MemStore(), tables.DATA_SCHEMA, tables.DATA_NUM_PKS, HOUR,
            enable_compaction_scheduler=False, device=dev)
        mgr = SampleManager(data_t, HOUR)
        tsids = np.arange(1, num_series + 1, dtype=np.uint64) * 1000
        metric_id = 42
        # two segments x two overlapping SSTs each (duplicates exercise the
        # merge and dedup before the sharded reduction)
        n = 512
        for seg in range(2):
            for _dup in range(2):
                idx = rng.integers(0, num_series, n)
                ts = (seg * HOUR + rng.integers(0, HOUR, n)).astype(np.int64)
                await mgr.persist(np.full(n, metric_id, dtype=np.uint64), tsids[idx], ts,
                                  rng.normal(size=n))
        ids = [int(t) for t in tsids]
        set_active_mesh(mesh)
        try:
            sharded = await mgr.query_downsample(metric_id, ids, TimeRange(0, 2 * HOUR),
                                                 bucket_ms=HOUR // num_buckets)
        finally:
            set_active_mesh(None)
        local = await mgr.query_downsample(metric_id, ids, TimeRange(0, 2 * HOUR),
                                           bucket_ms=HOUR // num_buckets)
        s_tsids, s_grids = sharded
        l_tsids, l_grids = local
        assert list(s_tsids) == list(l_tsids)
        np.testing.assert_array_equal(s_grids["count"], l_grids["count"])
        np.testing.assert_allclose(s_grids["sum"], l_grids["sum"], rtol=1e-12, atol=0)
        await data_t.close()
        print(f"dryrun_multichip storage OK: mesh={mesh.shape} series={len(s_tsids)} "
              f"rows_scanned={int(l_grids['count'].sum())}")

    asyncio.run(run())
