"""The port's storage engine: parquet SSTs and a manifest in an object store.

A port of the JAX package's `storage/storage.py::ObjectBasedStorage`, on
the same object layout, so either package opens a root the other wrote:

    {root}/manifest/snapshot          binary snapshot (manifest/encoding.py)
    {root}/manifest/delta/{id}        protobuf deltas
    {root}/data/{id}.sst              sorted parquet SSTs
    {root}/data/{id}.enc              encoded-lane sidecar of a format-v2 SST

- write: the segment check, the primary-key sort (kernel A on the card,
  run in a worker thread, skipped when the batch is already sorted), the
  builtin columns, a parquet encode off the event loop (streamed to the
  store for large tables), with encoding enabled the `.enc` sidecar
  (storage/encoding.py) after the SST object lands, then the manifest
  delta commits the SST (format v2 with its lane codecs when the sidecar
  was written);
- scan: per-segment scans (storage/read.py), segments old -> new, with the
  next segment's read overlapping the consumer.

Not ported yet: the compaction scheduler and bloom-filter sidecars
(asking for either is refused when storage opens instead of quietly doing
nothing), the epoch fence, read-only replica views, retention masking and
tombstone deletes (which `time_column` enables in the JAX package), and
the CPU executors of the JAX package's `try_new` (those parameters do not
exist here).
"""

from __future__ import annotations

import asyncio
import io
import logging
import queue
import threading
from typing import AsyncIterator

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device
from horaedb_tpu_torch.common.error import HoraeError, NotPortedError, context, ensure
from horaedb_tpu_torch.objstore import NotFound, ObjectStore
from horaedb_tpu_torch.ops import sort as sort_ops
from horaedb_tpu_torch.ops.blocks import arrow_column_to_numpy
from horaedb_tpu_torch.storage import encoding as enc_mod
from horaedb_tpu_torch.storage.config import StorageConfig
from horaedb_tpu_torch.storage.manifest import Manifest
from horaedb_tpu_torch.storage.read import ParquetReader, _is_binary_like
from horaedb_tpu_torch.storage.sst import (
    FileMeta,
    SstFile,
    SstPathGenerator,
    allocate_id,
    ensure_id_above,
)
from horaedb_tpu_torch.storage.types import (
    ScanRequest,
    StorageSchema,
    TimeRange,
    Timestamp,
    WriteRequest,
    WriteResult,
)

logger = logging.getLogger(__name__)

# tables above this many bytes stream their encode to the store in chunks
STREAM_CHUNK = 4 << 20


def _is_pk_sorted(keys: list[np.ndarray]) -> bool:
    """O(n) check that rows are lexicographically nondecreasing over `keys`
    (most significant first)."""
    n = len(keys[0])
    if n <= 1:
        return True
    decided_lt = np.zeros(n - 1, dtype=bool)
    for k in keys:
        a, b = k[:-1], k[1:]
        if ((a > b) & ~decided_lt).any():
            return False
        decided_lt |= a < b
    return True


def _refuse_unported(config: StorageConfig, enable_compaction_scheduler: bool) -> None:
    asked = []
    if enable_compaction_scheduler:
        asked.append("the compaction scheduler (pass enable_compaction_scheduler=False)")
    write = config.write
    if write.enable_bloom_filter or any(
            getattr(o, "enable_bloom_filter", None) for o in (write.column_options or {}).values()):
        asked.append("bloom-filter sidecars")
    if asked:
        raise NotPortedError("not ported yet: " + "; ".join(asked))


class ObjectBasedStorage:
    """Columnar storage over parquet SSTs in an object store."""

    def __init__(self) -> None:
        raise HoraeError("use `await ObjectBasedStorage.try_new(...)`")

    @classmethod
    async def try_new(
        cls,
        root: str,
        store: ObjectStore,
        arrow_schema: pa.Schema,
        num_primary_keys: int,
        segment_duration_ms: int,
        config: StorageConfig | None = None,
        enable_compaction_scheduler: bool = True,
        start_background_merger: bool = True,
        device=DEFAULT_DEVICE,
        time_column: str | None = None,
    ) -> "ObjectBasedStorage":
        """Open (or create) the table at `root` in `store`; merges, the
        write sort and the decode kernels run on `device` ("cuda" by
        default, which raises where there is no card; "cpu" runs the
        kernels' plain versions). Opening folds leftover manifest deltas
        and reclaims orphan SST objects.

        `time_column`: the schema column holding the row's timestamp. The
        encoder keeps `dict` off that lane (a time-ordered lane of a few
        distinct values would otherwise encode as dict, not dod)."""
        config = config or StorageConfig()
        _refuse_unported(config, enable_compaction_scheduler)
        if time_column is not None:
            ensure(time_column in arrow_schema.names, f"time_column {time_column!r} not in schema")
        self = object.__new__(cls)
        self._device = resolve_device(device)
        self._time_column = time_column
        # file_id -> (format_version, encodings) of a just-written SST,
        # consumed by the FileMeta of its write
        self._pending_enc: dict[int, tuple] = {}
        self._root = root.strip("/")
        self._store = store
        self._config = config
        ensure(segment_duration_ms > 0, f"segment duration must be positive, got "
               f"{segment_duration_ms}")
        self._segment_duration = segment_duration_ms
        self._schema = StorageSchema.try_new(arrow_schema, num_primary_keys, config.update_mode)
        self._manifest = await Manifest.try_new(
            self._root, store, config.manifest, start_background_merger=start_background_merger)
        existing = self._manifest.all_ssts()
        if existing:
            # never allocate at or below an id the manifest already holds
            ensure_id_above(max(s.id for s in existing))
        self._path_gen = SstPathGenerator(self._root)
        await self._gc_orphan_ssts()
        self._reader = ParquetReader(store, self._path_gen, self._schema, self._device,
                                     scan_block_rows=config.scan_block_rows,
                                     enc_cache_bytes=config.encoding.sidecar_cache.as_bytes())
        return self

    async def close(self) -> None:
        await self._manifest.close()

    async def _gc_orphan_ssts(self) -> None:
        """Reclaim data objects the manifest does not reference (a crash
        between upload and commit). Best-effort: a faulty store at open
        degrades to a log line. Orphan ids also raise the id floor, so a
        fresh write never reuses an occupied `.sst` path."""
        try:
            metas = await self._store.list(f"{self._root}/data")
        except Exception as e:  # noqa: BLE001 - GC is best-effort at open
            logger.warning("orphan sst gc skipped (list failed): %s", e)
            return
        live = {s.id for s in self._manifest.all_ssts()}
        by_id: dict[int, list[str]] = {}
        for m in metas:
            stem, _, ext = m.path.rsplit("/", 1)[-1].partition(".")
            if ext not in ("sst", "bloom", "enc") or not stem.isdigit():
                continue
            if int(stem) not in live:
                by_id.setdefault(int(stem), []).append(m.path)
        if not by_id:
            return
        ensure_id_above(max(by_id))
        paths = [p for ps in by_id.values() for p in ps]
        results = await asyncio.gather(*(self._store.delete(p) for p in paths),
                                       return_exceptions=True)
        failed = [p for p, r in zip(paths, results) if isinstance(r, BaseException)]
        for p in failed:
            logger.warning("orphan sst gc: failed to delete %s", p)
        logger.info("orphan sst gc: root=%s orphans=%d objects=%d (failed=%d)",
                    self._root, len(by_id), len(paths), len(failed))

    # -- accessors ------------------------------------------------------------
    @property
    def schema(self) -> StorageSchema:
        return self._schema

    @property
    def manifest(self) -> Manifest:
        return self._manifest

    @property
    def parquet_reader(self) -> ParquetReader:
        return self._reader

    @property
    def device(self) -> torch.device:
        """The device the merges, sorts and reductions of this table run on."""
        return self._device

    def select_ssts(self, time_range: TimeRange) -> list[SstFile]:
        """SSTs whose time range overlaps `time_range`."""
        return self._manifest.find_ssts(time_range)

    def group_by_segment(self, ssts: list[SstFile]) -> list[list[SstFile]]:
        """Bucket SSTs by segment start, ordered old -> new."""
        buckets: dict[int, list[SstFile]] = {}
        for s in ssts:
            seg = Timestamp(s.meta.time_range.start).truncate_by(self._segment_duration)
            buckets.setdefault(seg.value, []).append(s)
        return [buckets[k] for k in sorted(buckets)]

    # -- write path -----------------------------------------------------------
    async def write(self, req: WriteRequest) -> None:
        if req.enable_check:
            start_seg = Timestamp(req.time_range.start).truncate_by(self._segment_duration)
            end_seg = Timestamp(req.time_range.end - 1).truncate_by(self._segment_duration)
            ensure(start_seg == end_seg,
                   f"time range of one write must fall in one segment, "
                   f"range: [{req.time_range.start}, {req.time_range.end})")
        result = await self.write_batch(req.batch)
        fmt, encodings = self.pop_enc_meta(result.id)
        meta = FileMeta(max_sequence=result.seq, num_rows=req.batch.num_rows,
                        size=result.size, time_range=req.time_range,
                        format_version=fmt, encodings=encodings)
        await self._manifest.add_file(result.id, meta)

    async def write_batch(self, batch: pa.RecordBatch) -> WriteResult:
        file_id = allocate_id()
        sorted_batch = await asyncio.to_thread(self._sort_batch, batch)
        # the id doubles as the write sequence
        table = pa.Table.from_batches([self._schema.fill_builtin_columns(sorted_batch, file_id)])
        size = await self.write_sst(file_id, table)
        return WriteResult(id=file_id, seq=file_id, size=size)

    def _sort_batch(self, batch: pa.RecordBatch) -> pa.RecordBatch:
        """Primary-key sort: the permutation comes from the device (kernel A;
        this runs in a worker thread, on that thread's current stream), and
        the gather of every column is one arrow take on the host."""
        if batch.num_rows <= 1:
            return batch
        pk_names = self._schema.primary_key_names
        if any(_is_binary_like(batch.schema.field(n).type) for n in pk_names):
            raise NotPortedError("not ported yet: binary primary keys (the host sort route)")
        keys = [arrow_column_to_numpy(batch.column(batch.schema.names.index(n)))
                for n in pk_names]
        if _is_pk_sorted(keys):
            return batch
        perm = sort_ops.sort_permutation(keys, device=self._device)
        if perm.device.type == "cuda":
            torch.cuda.current_stream(perm.device).synchronize()
        return batch.take(pa.array(perm.cpu().numpy()))

    def _writer_kwargs(self) -> dict:
        """ParquetWriter options from WriteConfig, per-column overrides
        applied."""
        cfg = self._config.write
        sorting = [pq.SortingColumn(i) for i in range(self._schema.num_primary_keys)] + [
            pq.SortingColumn(self._schema.seq_idx)]
        names = self._schema.arrow_schema.names
        col_opts = cfg.column_options or {}

        def opt(n: str, attr: str):
            per = col_opts.get(n)
            return getattr(per, attr, None) if per is not None else None

        if any(opt(n, "enable_dict") is not None for n in names):
            use_dictionary: bool | list = [
                n for n in names
                if (opt(n, "enable_dict") if opt(n, "enable_dict") is not None
                    else cfg.enable_dict)]
        else:
            use_dictionary = cfg.enable_dict
        global_comp = cfg.compression.value if cfg.compression.value != "none" else "NONE"
        if any(opt(n, "compression") for n in names):
            compression: str | dict = {n: (opt(n, "compression") or global_comp) for n in names}
        else:
            compression = global_comp
        column_encoding = {n: opt(n, "encoding") for n in names if opt(n, "encoding")}
        # type-driven defaults where no override and no dictionary applies:
        # DELTA_BINARY_PACKED on integer lanes, BYTE_STREAM_SPLIT on floats
        if use_dictionary is not True:
            dict_cols = set(use_dictionary) if isinstance(use_dictionary, list) else set()
            for n in names:
                if n in column_encoding or n in dict_cols:
                    continue
                t = self._schema.arrow_schema.field(n).type
                if pa.types.is_integer(t) or pa.types.is_timestamp(t):
                    column_encoding[n] = "DELTA_BINARY_PACKED"
                elif pa.types.is_floating(t):
                    column_encoding[n] = "BYTE_STREAM_SPLIT"
        return dict(compression=compression, use_dictionary=use_dictionary,
                    write_statistics=True, write_batch_size=cfg.write_batch_size,
                    column_encoding=column_encoding or None,
                    sorting_columns=sorting if cfg.enable_sorting_columns else None)

    async def write_sst(self, file_id: int, table: pa.Table) -> int:
        """Encode a sorted, builtin-filled table as one parquet SST and put it
        in the store; returns the object's size. Small tables encode in one
        worker-thread call and one put; large ones stream: a producer thread
        encodes into bounded chunks that the store writes as they come, so
        host memory stays O(row group + chunk). With encoding enabled, the
        `.enc` sidecar follows the SST object on both routes."""
        path = self._path_gen.generate(file_id)
        max_rg = self._config.write.max_row_group_size
        # the manifest carries num_rows and size as u32
        ensure(table.num_rows < 2**32, f"sst row count too large: {table.num_rows}")
        kwargs = self._writer_kwargs()
        if table.nbytes <= 4 * STREAM_CHUNK:
            def _encode_small() -> bytes:
                sink = io.BytesIO()
                with pq.ParquetWriter(sink, table.schema, **kwargs) as writer:
                    writer.write_table(table, row_group_size=max_rg)
                return sink.getvalue()

            blob = await asyncio.to_thread(_encode_small)
            ensure(len(blob) < 2**32, f"sst too large for manifest format: {len(blob)}")
            with context(f"write sst {path}"):
                await self._store.put(path, blob)
            await self._write_enc_sidecar(file_id, path, table)
            return len(blob)
        size = await self._write_sst_streamed(path, table, kwargs, max_rg)
        await self._write_enc_sidecar(file_id, path, table)
        return size

    def pop_enc_meta(self, file_id: int) -> tuple[int, tuple]:
        """(format_version, encodings) of a just-written SST, consumed once
        by the FileMeta of its write."""
        return self._pending_enc.pop(file_id, (enc_mod.SST_FORMAT_V1, ()))

    async def _write_enc_sidecar(self, file_id: int, path: str, table: pa.Table) -> None:
        """The encoded-lane sidecar, after the SST object lands and before
        the manifest can reference it: a registered v2 SST always has its
        sidecar. The encode and the blob run off the event loop. A failed
        encode or put reclaims the SST object (best effort) and raises;
        the pending entry is recorded last, so a failed write never
        strands one."""
        cfg = self._config.encoding
        if not cfg.enabled or table.num_rows < cfg.min_rows:
            return

        def _encode_and_pack():
            e = enc_mod.encode_table(table, cfg.page_rows, cfg.max_dict, self._time_column,
                                     cfg.lanes)
            return (e, enc_mod.encode_blob(e)) if e is not None else (None, None)

        try:
            enc, blob = await asyncio.to_thread(_encode_and_pack)
            if enc is None:
                return
            await self._store.put(self._path_gen.generate_enc(file_id), blob)
        except BaseException:
            try:
                await self._store.delete(path)
            except Exception:  # noqa: BLE001 - orphan cleanup is best-effort
                logger.warning("orphaned sst object %s after enc sidecar failure", path)
            raise
        self._pending_enc[file_id] = (enc_mod.SST_FORMAT_V2, enc.descriptor())

    async def _write_sst_streamed(self, path: str, table: pa.Table, kwargs: dict,
                                  max_rg: int) -> int:
        q: queue.Queue = queue.Queue(maxsize=4)
        cancel = threading.Event()
        done = threading.Event()

        class _Sink(io.RawIOBase):
            def __init__(self):
                self.parts: list[bytes] = []
                self.pending = 0

            def writable(self):
                return True

            def write(self, b):
                if cancel.is_set():
                    raise OSError("sst stream cancelled")
                self.parts.append(bytes(b))
                self.pending += len(b)
                while self.pending >= STREAM_CHUNK:
                    blob = b"".join(self.parts)
                    q.put(blob[:STREAM_CHUNK])
                    rest = blob[STREAM_CHUNK:]
                    self.parts = [rest] if rest else []
                    self.pending = len(rest)
                return len(b)

            def flush_tail(self):
                if self.pending:
                    q.put(b"".join(self.parts))
                    self.parts = []
                    self.pending = 0

        def _produce() -> None:
            try:
                sink = _Sink()
                with pq.ParquetWriter(sink, table.schema, **kwargs) as writer:
                    writer.write_table(table, row_group_size=max_rg)
                sink.flush_tail()
                q.put(None)  # EOF
            except BaseException as e:  # noqa: BLE001 - relayed to the consumer
                q.put(e)
            finally:
                done.set()

        threading.Thread(target=_produce, name="sst-encode", daemon=True).start()

        async def chunks():
            total = 0
            while True:
                item = await asyncio.to_thread(q.get)
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                total += len(item)
                ensure(total < 2**32, f"sst too large for manifest format: {total}")
                yield item

        try:
            with context(f"write sst {path}"):
                return await self._store.put_stream(path, chunks())
        finally:
            cancel.set()
            while not done.is_set():
                try:  # unblock a producer stuck on a full queue
                    q.get_nowait()
                except queue.Empty:
                    pass
                done.wait(timeout=0.05)

    # -- scan path --------------------------------------------------------------
    async def scan(self, req: ScanRequest) -> AsyncIterator[pa.RecordBatch]:
        """Per-segment scans, old segments first. The next segment's read
        and merge overlap the consumer draining the current one; an early
        consumer break cancels that prefetch."""
        ssts = self.select_ssts(req.range)
        if not ssts:
            return
        segments = self.group_by_segment(ssts)

        def start(seg):
            return asyncio.ensure_future(self.scan_segment_retrying(
                seg, req.range,
                lambda fresh: self._reader.scan_segment(
                    fresh, predicate=req.predicate, projections=req.projections,
                    keep_builtin=False),
                empty_result=[]))

        pending = start(segments[0])
        try:
            for i in range(len(segments)):
                batches = await pending
                pending = start(segments[i + 1]) if i + 1 < len(segments) else None
                for b in batches:
                    yield b
        finally:
            if pending is not None:
                pending.cancel()
                try:
                    await pending
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass

    async def scan_segment_retrying(self, seg_ssts, time_range, op, empty_result=None):
        """Run a per-segment scan `op`, refreshing the segment's SST list
        from the manifest on NotFound (an SST deleted between the caller's
        manifest snapshot and the read); an empty refresh means the data is
        gone."""
        seg_key = Timestamp(seg_ssts[0].meta.time_range.start).truncate_by(
            self._segment_duration).value
        for _attempt in range(3):
            try:
                return await op(seg_ssts)
            except NotFound:
                fresh = [s for s in self._manifest.find_ssts(time_range)
                         if Timestamp(s.meta.time_range.start).truncate_by(
                             self._segment_duration).value == seg_key]
                if not fresh:
                    return empty_result
                logger.info("segment scan raced a delete; retrying with %d fresh ssts",
                            len(fresh))
                seg_ssts = fresh
        return await op(seg_ssts)  # last attempt: let NotFound propagate
