"""The port's manifest merger (`horaedb_tpu_torch/storage/manifest`): its
loop merges on a tick and on a signal, and closing it leaves no task it
made pending (each round's sleep and queue wait are cancelled and awaited
with the loop). Runs on the CPU in well under a second."""

import asyncio

import pytest

from horaedb_tpu_torch.common.time_ext import ReadableDuration
from horaedb_tpu_torch.objstore import MemStore
from horaedb_tpu_torch.storage.config import ManifestConfig
from horaedb_tpu_torch.storage.manifest import ManifestMerger


async def _drive(how: str) -> tuple[int, list]:
    """Start a merger whose merges only count, drive it `how`, close it:
    (merges seen, tasks made since the start that are still pending)."""
    before = set(asyncio.all_tasks())
    interval = ReadableDuration.millis(5 if how == "tick" else 60_000)
    merger = ManifestMerger("root", MemStore(),
                            ManifestConfig(merge_interval=interval, min_merge_threshold=0,
                                           soft_merge_threshold=0))
    merged = asyncio.Event()
    merges = 0

    async def do_merge() -> None:
        nonlocal merges
        merges += 1
        merged.set()

    merger.do_merge = do_merge
    merger.start()
    await asyncio.sleep(0)
    if how != "idle":
        if how == "signal":
            merger.maybe_schedule_merge()
        else:
            merger._deltas_num = 1  # a tick merges when a delta waits
        await asyncio.wait_for(merged.wait(), 1.0)
    await merger.close()
    return merges, [t for t in asyncio.all_tasks() - before if not t.done()]


@pytest.mark.parametrize("how", ["idle", "signal", "tick"])
def test_closed_merger_leaves_no_task_pending(how):
    merges, pending = asyncio.run(_drive(how))
    assert merges == 0 if how == "idle" else merges >= 1
    assert pending == [], [t.get_coro() for t in pending]
