"""Manifest: snapshot plus delta log over the object store.

A port of the JAX package's `storage/manifest/__init__.py`, on the same
object layout, so either package opens a root the other wrote:

- an in-memory list of live SSTs; every update writes one protobuf delta to
  `{root}/manifest/delta/{id}` (the durability point), then applies it in
  memory;
- a merger folds deltas into the binary `{root}/manifest/snapshot` on a
  timer or when signalled; opening runs a first merge, so recovery reads
  the snapshot after folding leftover deltas;
- above the soft delta count a merge is scheduled; above the hard count
  the update is rejected;
- a merge applies every add before every delete (deltas are read in no
  particular order); deleting merged deltas after the snapshot lands is
  best-effort.

Tombstone and rollup records are not ported. A root that holds any is
refused with `NotPortedError`: opening it without them would resurrect
deleted rows or serve from a registry the port cannot keep.
"""

from __future__ import annotations

import asyncio
import logging

from horaedb_tpu_torch.common.error import HoraeError, NotPortedError, context
from horaedb_tpu_torch.objstore import NotFound, ObjectStore
from horaedb_tpu_torch.storage.config import ManifestConfig
from horaedb_tpu_torch.storage.manifest.encoding import Snapshot, decode_update, encode_update
from horaedb_tpu_torch.storage.sst import FileMeta, SstFile, allocate_id
from horaedb_tpu_torch.storage.types import TimeRange

logger = logging.getLogger(__name__)

PREFIX_PATH = "manifest"
SNAPSHOT_FILENAME = "snapshot"
DELTA_PREFIX = "delta"
UNPORTED_RECORD_PREFIXES = ("tombstone", "rollup")


def snapshot_path(root: str) -> str:
    return f"{root}/{PREFIX_PATH}/{SNAPSHOT_FILENAME}"


def delta_dir(root: str) -> str:
    return f"{root}/{PREFIX_PATH}/{DELTA_PREFIX}"


def delta_path(root: str, file_id: int) -> str:
    return f"{delta_dir(root)}/{file_id}"


class ManifestMerger:
    """Delta -> snapshot folder: the bootstrap merge at open, a background
    loop, and the delta-count backpressure."""

    def __init__(self, root: str, store: ObjectStore, config: ManifestConfig):
        self._root = root
        self._store = store
        self._config = config
        self._deltas_num = 0
        self._merge_signal: asyncio.Queue[None] = asyncio.Queue(maxsize=config.channel_size)
        self._task: asyncio.Task | None = None
        self._merge_lock = asyncio.Lock()

    async def bootstrap(self) -> None:
        """Fold leftover deltas of a previous life into the snapshot."""
        await self.do_merge()

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="manifest-merger")

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def maybe_schedule_merge(self) -> None:
        """Count one new delta: above the soft limit signal a merge, above
        the hard limit reject the update."""
        self._deltas_num += 1
        if self._deltas_num > self._config.hard_merge_threshold:
            self._deltas_num -= 1
            raise HoraeError(
                f"Too many manifest delta files: {self._deltas_num + 1}, "
                f"hard limit: {self._config.hard_merge_threshold}"
            )
        if self._deltas_num > self._config.soft_merge_threshold:
            try:
                self._merge_signal.put_nowait(None)
            except asyncio.QueueFull:
                pass  # a merge is already queued

    def on_delta_write_failed(self) -> None:
        self._deltas_num -= 1

    async def _run(self) -> None:
        """Merge on every interval tick or signal, when enough deltas wait.
        Each round's two waiting tasks are cancelled and awaited however the
        round ends, `close()` cancelling it included, so a closed merger
        leaves no task pending."""
        interval = self._config.merge_interval.seconds
        while True:
            sleep = asyncio.create_task(asyncio.sleep(interval))
            recv = asyncio.create_task(self._merge_signal.get())
            try:
                done, _ = await asyncio.wait({sleep, recv},
                                             return_when=asyncio.FIRST_COMPLETED)
            finally:
                for t in (sleep, recv):
                    t.cancel()
                await asyncio.gather(sleep, recv, return_exceptions=True)
            for t in done:
                exc = t.exception()
                if exc is not None:
                    raise exc
            if self._deltas_num > self._config.min_merge_threshold:
                try:
                    await self.do_merge()
                except Exception:  # noqa: BLE001 - keep the loop alive
                    logger.exception("manifest merge failed; will retry")

    async def do_merge(self) -> None:
        """Fold every delta file into the snapshot."""
        async with self._merge_lock:
            metas = await self._store.list(delta_dir(self._root))
            if not metas:
                return
            paths = [m.path for m in metas]
            blobs = await asyncio.gather(*(self._store.get(p) for p in paths))
            snapshot = await read_snapshot(self._store, snapshot_path(self._root))

            all_adds: list[SstFile] = []
            all_deletes: list[int] = []
            for blob in blobs:
                adds, deletes = decode_update(blob)
                all_adds.extend(adds)
                all_deletes.extend(deletes)
            snapshot.add_records(all_adds)
            snapshot.delete_records(all_deletes)
            data = snapshot.to_bytes()
            with context("write manifest snapshot"):
                await self._store.put(snapshot_path(self._root), data)
            # commit point passed: delta deletions are best-effort
            results = await asyncio.gather(*(self._store.delete(p) for p in paths),
                                           return_exceptions=True)
            for p, r in zip(paths, results):
                if isinstance(r, BaseException):
                    logger.error("failed to delete merged delta %s: %s", p, r)
            self._deltas_num = max(0, self._deltas_num - len(paths))


async def read_snapshot(store: ObjectStore, path: str) -> Snapshot:
    """A missing snapshot is an empty one."""
    try:
        data = await store.get(path)
    except NotFound:
        return Snapshot.empty()
    with context(f"decode manifest snapshot {path}"):
        return Snapshot.from_bytes(data)


class Manifest:
    """Live-SST registry."""

    def __init__(self, root: str, store: ObjectStore, config: ManifestConfig):
        self._root = root
        self._store = store
        self._ssts: list[SstFile] = []
        self._merger = ManifestMerger(root, store, config)

    @classmethod
    async def try_new(
        cls,
        root: str,
        store: ObjectStore,
        config: ManifestConfig | None = None,
        start_background_merger: bool = True,
    ) -> "Manifest":
        m = cls(root, store, config or ManifestConfig())
        for kind in UNPORTED_RECORD_PREFIXES:
            found = await store.list(f"{root}/{PREFIX_PATH}/{kind}")
            if found:
                raise NotPortedError(
                    f"not ported yet: manifest {kind} records ({len(found)} under "
                    f"{root}/{PREFIX_PATH}/{kind}); opening without them would "
                    "change what scans return"
                )
        await m._merger.bootstrap()
        snapshot = await read_snapshot(store, snapshot_path(root))
        m._ssts = snapshot.into_ssts()
        logger.info("manifest loaded: root=%s ssts=%d", root, len(m._ssts))
        if start_background_merger:
            m._merger.start()
        return m

    async def close(self) -> None:
        await self._merger.close()

    async def add_file(self, file_id: int, meta: FileMeta) -> None:
        await self.update([SstFile(id=file_id, meta=meta)], [])

    async def update(self, to_adds: list[SstFile], to_deletes: list[int]) -> None:
        """Durability point: write one delta file, then apply in memory.
        Hard backpressure may reject the update."""
        # encode before counting the delta: an encode failure must not
        # leak an increment the merger can never drain
        payload = encode_update(to_adds, to_deletes)
        self._merger.maybe_schedule_merge()
        path = delta_path(self._root, allocate_id())
        try:
            with context("write manifest delta"):
                await self._store.put(path, payload)
        except Exception:
            self._merger.on_delta_write_failed()
            raise
        delete_set = set(to_deletes)
        self._ssts = [s for s in self._ssts if s.id not in delete_set]
        self._ssts.extend(to_adds)

    def all_ssts(self) -> list[SstFile]:
        return list(self._ssts)

    def find_ssts(self, time_range: TimeRange) -> list[SstFile]:
        """SSTs whose time range overlaps `time_range`."""
        return [s for s in self._ssts if s.meta.time_range.overlaps(time_range)]
