"""Region partitioning: range-partitioned regions over one object store.

A port of the JAX package's `engine/region.py` (the RFC's distributed
design, docs/rfcs/20240827-metric-engine.md:28-76):

- `RangeRouter` (descriptor v2, the default): explicit ranges of the
  64-bit hash space at SERIES granularity, the route hash being the tsid
  (seahash of the canonical series key), so one metric's series spread
  over every region and a read fans out and folds;
- `RegionRouter` (descriptor v1): metric-granularity multiply-shift, so
  stores written by either package under v1 keep opening;
- `RegionedEngine`: one `MetricEngine` per region under `{root}/region-{id}`
  of one shared store. Writes split per region on the series' hash lanes;
  queries route (v1) or fan out and fold (v2) through
  `cluster/partial.py::merge_grids`, the same fold the distributed
  scatter-gather read runs over `query_partial_grids` fragments.

The REGIONS descriptor is byte-identical to the JAX package's, so a store
written by either opens in the other. Not ported yet, and refused with
`NotPortedError`: `split_region`, `promote_region`, `refresh_region`,
partial writers (`writable_regions`) and read-only replica views
(`read_only`), which need the epoch fence and the replica views; the
parser pool (`parser_pool`): payloads decode with the port's numpy wire
decoder in a worker thread.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json

import numpy as np

from horaedb_tpu_torch.common import deadline as deadline_ctx
from horaedb_tpu_torch.common.error import NotPortedError, ensure
from horaedb_tpu_torch.common.hash import seahash, seahash_many
from horaedb_tpu_torch.engine.engine import NAME_LABEL, MetricEngine, QueryRequest
from horaedb_tpu_torch.engine.types import series_key_of
from horaedb_tpu_torch.ingest.types import ParsedWriteRequest
from horaedb_tpu_torch.ingest.wire_parser import WireParser
from horaedb_tpu_torch.objstore import NotFound
from horaedb_tpu_torch.storage import scanstats

_TOP = 1 << 64


class RegionRouter:
    """Descriptor-v1 routing: metric -> region by multiply-shift over the
    top 32 bits of the metric id."""

    def __init__(self, num_regions: int):
        self.num_regions = num_regions

    def region_of_name(self, metric_name: bytes) -> int:
        return self.region_of_id(seahash(metric_name))

    def region_of_id(self, metric_id: int) -> int:
        return ((metric_id >> 32) * self.num_regions) >> 32

    def regions_of_ids(self, metric_ids: np.ndarray) -> np.ndarray:
        """`region_of_id` over a u64 id lane (the same formula)."""
        ids = metric_ids.astype(np.uint64, copy=False)
        return (
            ((ids >> np.uint64(32)) * np.uint64(self.num_regions))
            >> np.uint64(32)
        ).astype(np.int64)


class RangeRouter:
    """Descriptor-v2 routing: region `ids[i]` owns hashes in
    `[starts[i], starts[i+1])` (the last up to 2^64). The scalar and the
    vectorized paths share one boundary array, so writes and queries never
    disagree."""

    def __init__(self, starts: list[int], ids: list[int], granularity: str):
        ensure(len(starts) == len(ids) and starts and starts[0] == 0,
               "malformed region ranges")
        ensure(all(a < b for a, b in zip(starts, starts[1:])),
               "region range starts must be strictly increasing")
        ensure(granularity in ("series", "metric"),
               f"unknown region granularity: {granularity!r}")
        self.starts = list(starts)
        self._starts_u64 = np.asarray(starts, dtype=np.uint64)
        self.ids = list(ids)
        self._ids_arr = np.asarray(ids, dtype=np.int64)
        self.granularity = granularity

    def slot_of_hash(self, h: int) -> int:
        return int(np.searchsorted(self._starts_u64, np.uint64(h), side="right")) - 1

    def region_of_hash(self, h: int) -> int:
        return self.ids[self.slot_of_hash(h)]

    def region_of_name(self, metric_name: bytes) -> int:
        """Owner of the METRIC hash: the metadata routing surface (at series
        granularity the data routes by tsid)."""
        return self.region_of_hash(seahash(metric_name))

    def regions_of_lanes(self, metric_ids: np.ndarray, tsids: np.ndarray) -> np.ndarray:
        """Region id per series from its hash lanes."""
        lane = tsids if self.granularity == "series" else metric_ids
        lane = lane.astype(np.uint64, copy=False)
        slots = np.searchsorted(self._starts_u64, lane, side="right") - 1
        return self._ids_arr[slots]

    def to_descriptor(self, initial_num_regions: int) -> dict:
        return {
            "version": 2,
            "granularity": self.granularity,
            "initial_num_regions": initial_num_regions,
            "regions": [{"id": i, "start": s} for i, s in zip(self.ids, self.starts)],
        }

    @classmethod
    def from_descriptor(cls, desc: dict) -> "RangeRouter":
        regions = sorted(desc["regions"], key=lambda r: r["start"])
        return cls(
            [r["start"] for r in regions],
            [r["id"] for r in regions],
            desc.get("granularity", "series"),
        )


def _subset_request(req: ParsedWriteRequest, series_idx: np.ndarray) -> ParsedWriteRequest:
    """A per-region view of a parsed request holding only `series_idx`
    (sorted): sample and exemplar lanes filtered, their series indices
    remapped to the subset's order, metadata lanes stripped (the regioned
    engine routes metadata by family name once)."""
    remap = np.full(req.n_series, -1, dtype=np.int64)
    remap[series_idx] = np.arange(len(series_idx))
    smask = remap[req.sample_series] >= 0
    emask = (remap[req.exemplar_series] >= 0 if len(req.exemplar_series)
             else np.zeros(0, dtype=bool))
    sub_counts = req.series_sample_count[series_idx]
    sub_starts = np.concatenate(([0], np.cumsum(sub_counts)[:-1])).astype(np.int64)
    return ParsedWriteRequest(
        payload=req.payload,
        series_label_start=req.series_label_start[series_idx],
        series_label_count=req.series_label_count[series_idx],
        series_sample_start=sub_starts,
        series_sample_count=sub_counts,
        label_name_off=req.label_name_off,
        label_name_len=req.label_name_len,
        label_value_off=req.label_value_off,
        label_value_len=req.label_value_len,
        sample_value=req.sample_value[smask],
        sample_ts=req.sample_ts[smask],
        sample_series=remap[req.sample_series[smask]],
        exemplar_value=req.exemplar_value[emask],
        exemplar_ts=req.exemplar_ts[emask],
        exemplar_series=(remap[req.exemplar_series[emask]]
                         if len(req.exemplar_series) else req.exemplar_series),
        exemplar_label_start=req.exemplar_label_start[emask],
        exemplar_label_count=req.exemplar_label_count[emask],
        ex_label_name_off=req.ex_label_name_off,
        ex_label_name_len=req.ex_label_name_len,
        ex_label_value_off=req.ex_label_value_off,
        ex_label_value_len=req.ex_label_value_len,
        meta_type=req.meta_type[:0],
        meta_name_off=req.meta_name_off[:0],
        meta_name_len=req.meta_name_len[:0],
        series_key_lo=None if req.series_key_lo is None else req.series_key_lo[series_idx],
        series_key_hi=None if req.series_key_hi is None else req.series_key_hi[series_idx],
    )


class RegionedEngine:
    """N region engines over one shared object store, and the router."""

    def __init__(self) -> None:
        raise RuntimeError("use RegionedEngine.open")

    @classmethod
    async def open(
        cls,
        root: str,
        store,
        num_regions: int,
        parser_pool=None,
        granularity: str = "series",
        writable_regions: "set[int] | None" = None,
        **engine_kwargs,
    ) -> "RegionedEngine":
        """Open (or create) the regions under `root`. The initial region
        count and the granularity are part of the on-disk layout (the
        REGIONS descriptor pins them; a mismatch fails). `engine_kwargs` go
        to every region's `MetricEngine.open` (`device=` among them)."""
        asked = []
        if parser_pool is not None:
            asked.append("the parser pool (parser_pool)")
        if writable_regions is not None:
            asked.append("partial writers (writable_regions)")
        if engine_kwargs.get("read_only"):
            asked.append("read-only replica views (read_only)")
        if asked:
            raise NotPortedError("not ported yet: " + "; ".join(asked))
        desc_path = f"{root}/REGIONS"
        self = object.__new__(cls)
        self._root = root
        self._store = store
        self._desc_path = desc_path
        self._parser = WireParser()
        self._initial_num_regions = num_regions
        try:
            desc = json.loads((await store.get(desc_path)).decode())
            if desc.get("version") == 2:
                ensure(
                    desc.get("initial_num_regions") == num_regions,
                    f"store at {root!r} was created with "
                    f"num_regions={desc.get('initial_num_regions')}; "
                    f"reopening with {num_regions} would strand data — "
                    f"repartitioning requires a split or a rewrite, not a "
                    f"config change",
                )
                ensure(
                    desc.get("granularity", "series") == granularity,
                    f"store at {root!r} was created with granularity="
                    f"{desc.get('granularity')!r}; reopening with "
                    f"{granularity!r} would reroute series away from their "
                    f"data",
                )
                self.router = RangeRouter.from_descriptor(desc)
            else:
                ensure(
                    desc.get("num_regions") == num_regions,
                    f"store at {root!r} was created with "
                    f"num_regions={desc.get('num_regions')}; reopening with "
                    f"{num_regions} would strand data — repartitioning "
                    f"requires a rewrite, not a config change",
                )
                self.router = RegionRouter(num_regions)
        except NotFound:
            self.router = RangeRouter(
                [i * _TOP // num_regions for i in range(num_regions)],
                list(range(num_regions)),
                granularity,
            )
            await store.put(desc_path,
                            json.dumps(self.router.to_descriptor(num_regions)).encode())
        self._engine_kwargs = engine_kwargs
        region_ids = (self.router.ids if isinstance(self.router, RangeRouter)
                      else list(range(num_regions)))
        self.engines: dict[int, MetricEngine] = {}
        try:
            for i in region_ids:
                self.engines[i] = await MetricEngine.open(
                    f"{root}/region-{i}", store, **engine_kwargs)
        except BaseException:
            # close the regions that did open: a retry must not leak them
            await asyncio.gather(*(e.close() for e in self.engines.values()),
                                 return_exceptions=True)
            raise
        return self

    @property
    def _legacy(self) -> bool:
        return not isinstance(self.router, RangeRouter)

    async def split_region(self, region_id: int) -> int:
        raise NotPortedError("not ported yet: split_region (needs the epoch fence)")

    async def promote_region(self, region_id: int, fence_node_id: str) -> int:
        raise NotPortedError("not ported yet: promote_region (needs the epoch fence)")

    async def refresh_region(self, region_id: int) -> int:
        raise NotPortedError("not ported yet: refresh_region (needs the replica views)")

    async def close(self) -> None:
        await asyncio.gather(*(e.close() for e in self.engines.values()))

    async def flush(self) -> None:
        await asyncio.gather(*(e.flush() for e in self.engines.values()))

    # -- write path ----------------------------------------------------------
    async def write_payload(self, payload: bytes) -> int:
        """Parse one remote-write payload (in a worker thread) and route it."""
        parsed = await asyncio.to_thread(self._parser.parse, payload)
        return await self.write_parsed(parsed)

    async def write_parsed(self, req: ParsedWriteRequest) -> int:
        """Split per region on the hash lanes and delegate. A request whose
        series all route to one region delegates without copying."""
        for i in range(len(req.meta_type)):
            name = req.meta_name(i)
            self.engines[self.router.region_of_name(name)] \
                .metric_mgr.record_metadata(name, int(req.meta_type[i]))
        if req.n_series == 0:
            return 0
        if self._legacy:
            regions = self.router.regions_of_ids(self._hash_lanes(req, need_tsids=False)[0])
        else:
            mids, tsids = self._hash_lanes(req, self.router.granularity == "series")
            regions = self.router.regions_of_lanes(mids, tsids)
        uniq = np.unique(regions)
        if len(uniq) == 1:
            if len(req.meta_type):
                req = dataclasses.replace(req, meta_type=req.meta_type[:0],
                                          meta_name_off=req.meta_name_off[:0],
                                          meta_name_len=req.meta_name_len[:0])
            return await self.engines[int(uniq[0])].write_parsed(req)
        # every region's write settles before the call returns or raises
        results = await asyncio.gather(*(
            self.engines[r].write_parsed(_subset_request(req, np.flatnonzero(regions == r)))
            for r in uniq.tolist()
        ), return_exceptions=True)
        errors = [r for r in results if isinstance(r, BaseException)]
        if errors:
            raise errors[0]
        return sum(results)

    @staticmethod
    def _hash_lanes(req: ParsedWriteRequest, need_tsids: bool) -> tuple[np.ndarray, np.ndarray]:
        """The series' hash lanes as the JAX package's native parser gives
        them (`horaedb_tpu/native/remote_write_parser.cc::compute_hashes`):
        metric id = seahash(`__name__` value), 0 without one, and tsid =
        seahash of the canonical key of the other labels: the engine's own
        tsid. (The JAX package's pure-Python fallback hashes the key with
        `__name__` in it, and so routes other series than its native
        parser; the port follows the native parser.)"""
        names, has_name, keys = [], [], []
        for s in range(req.n_series):
            name, rest = None, []
            for k, v in req.series_labels(s):
                if k == NAME_LABEL:
                    name = v
                else:
                    rest.append((k, v))
            names.append(name or b"")
            has_name.append(name is not None)
            if need_tsids:
                keys.append(series_key_of(rest))
        mids = np.where(np.asarray(has_name, dtype=bool), seahash_many(names), np.uint64(0))
        return mids, (seahash_many(keys) if need_tsids else mids)

    # -- read path -------------------------------------------------------------
    def _engine_for(self, metric: bytes) -> MetricEngine:
        return self.engines[self.router.region_of_name(metric)]

    async def query(self, req: QueryRequest):
        """Raw rows (bucket_ms None) or (tsids, grids): v1 routes to the
        metric's region; v2 fans out to every region and folds the grids in
        region order (`merge_grids`, on the host)."""
        if self._legacy:
            scanstats.note_max("regions_fanout", 1)
            return await self._engine_for(req.metric).query(req)
        deadline_ctx.check("region_fanout")
        ids = list(self.engines)
        scanstats.note_max("regions_fanout", len(ids))
        results = await asyncio.gather(*(self.engines[i].query(req) for i in ids))
        tagged = [(i, r) for i, r in zip(ids, results) if r is not None]
        if not tagged:
            return None
        if req.bucket_ms is None:
            return _merge_raw_tables(tagged, self.router, req.limit)
        return _merge_grids([r for _, r in tagged])

    async def query_partial_grids(self, req: QueryRequest):
        """The scatter-gather leaf: the per-region downsample of the regions
        `req.regions` names (None: all), UNMERGED, as [(region_id, tsids,
        grids)]. Folded by `cluster/partial.py::merge_partials` in this
        engine's region order (`list(self.engines)`), any split of the
        regions across nodes gives `query`'s grids bit for bit."""
        ensure(req.bucket_ms is not None,
               "query_partial_grids requires a bucketed (grid) query")
        deadline_ctx.check("region_fanout")
        if self._legacy:
            rid = self.router.region_of_name(req.metric)
            if req.regions is not None and int(rid) not in [int(r) for r in req.regions]:
                return []
            out = await self.engines[rid].query(req)
            return [] if out is None else [(int(rid), out[0], out[1])]
        ids = list(self.engines)
        if req.regions is not None:
            want = {int(r) for r in req.regions}
            ids = [i for i in ids if int(i) in want]
        scanstats.note_max("regions_fanout", len(ids))
        results = await asyncio.gather(*(self.engines[i].query(req) for i in ids))
        return [(int(i), r[0], r[1]) for i, r in zip(ids, results) if r is not None]

    def label_values(self, metric: bytes, key: bytes) -> list[bytes]:
        if self._legacy:
            return self._engine_for(metric).label_values(metric, key)
        out: set[bytes] = set()
        for e in self.engines.values():
            out.update(e.label_values(metric, key))
        return sorted(out)

    def series(self, metric: bytes):
        if self._legacy:
            return self._engine_for(metric).series(metric)
        by_tsid: dict[str, dict] = {}
        for e in self.engines.values():
            for row in e.series(metric):
                by_tsid.setdefault(row.get("__tsid__", repr(row)), row)
        # numeric order, as the single engine's sorted(per_tsid)
        return [by_tsid[k] for k in sorted(
            by_tsid, key=lambda k: (0, int(k)) if k.isdigit() else (1, 0, k)
        )]

    def metric_names(self) -> list[bytes]:
        out: list[bytes] = []
        for e in self.engines.values():
            out.extend(e.metric_names())
        return sorted(set(out))

    def series_count(self, metric: bytes) -> int:
        if self._legacy:
            return self._engine_for(metric).series_count(metric)
        return sum(e.series_count(metric) for e in self.engines.values())

    def label_names(self) -> list[bytes]:
        out: set[bytes] = set()
        for e in self.engines.values():
            out.update(e.label_names())
        return sorted(out)

    def series_labels_map(
        self, metric: bytes, tsids: "list[int] | None" = None
    ) -> dict[int, dict[bytes, bytes]]:
        if self._legacy:
            return self._engine_for(metric).series_labels_map(metric, tsids)
        out: dict[int, dict[bytes, bytes]] = {}
        for e in self.engines.values():
            for t, labs in e.series_labels_map(metric, tsids).items():
                out.setdefault(t, labs)
        return out

    async def match_series(
        self, metric: bytes, filters, matchers
    ) -> dict[int, dict[bytes, bytes]]:
        if self._legacy:
            return await self._engine_for(metric).match_series(metric, filters, matchers)
        out: dict[int, dict[bytes, bytes]] = {}
        for e in self.engines.values():
            for t, labs in (await e.match_series(metric, filters, matchers)).items():
                out.setdefault(t, labs)
        return out

    def metadata(self) -> "dict[bytes, str]":
        out: dict[bytes, str] = {}
        for e in self.engines.values():
            out.update(e.metadata())
        return out


def _merge_raw_tables(tagged: list, router, limit: int | None):
    """Concatenate per-region raw-row tables, order by (tsid, field_id, ts)
    and drop cross-region duplicates of one sample key (the region that
    owns the series' hash wins)."""
    import pyarrow as pa

    parts = []
    for region_id, table in tagged:
        lane_col = "tsid" if router.granularity == "series" else "metric_id"
        if lane_col in table.column_names:
            lane = table.column(lane_col).to_numpy().astype(np.uint64, copy=False)
            owner = router._ids_arr[np.searchsorted(router._starts_u64, lane, side="right") - 1]
            prio = (owner != region_id).astype(np.int8)
        else:
            prio = np.ones(table.num_rows, np.int8)
        parts.append(table.append_column("__prio__", pa.array(prio)))
    merged = pa.concat_tables(parts)
    sort_keys = [(c, "ascending") for c in ("tsid", "field_id", "ts")
                 if c in merged.column_names]
    merged = merged.sort_by(sort_keys + [("__prio__", "ascending")])
    if len(sort_keys) == 3 and len(tagged) > 1 and merged.num_rows:
        cols = [merged.column(c).to_numpy() for c, _ in sort_keys]
        keep = np.ones(merged.num_rows, dtype=bool)
        keep[1:] = ~np.logical_and.reduce([c[1:] == c[:-1] for c in cols])
        if not keep.all():
            merged = merged.filter(pa.array(keep))
    merged = merged.drop_columns(["__prio__"])
    if limit is not None:
        merged = merged.slice(0, limit)
    return merged


def _merge_grids(results: list):
    """Per-region (tsids, grids) folded by the one fold of
    cluster/partial.py, so a distributed read folds with the same code in
    the same region order."""
    from horaedb_tpu_torch.cluster.partial import merge_grids

    return merge_grids(results)
