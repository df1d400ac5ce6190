"""Storage configuration of the port: the knobs its write, manifest and
scan paths read.

Copied from the JAX package's `storage/config.py` (same names, same
defaults): `UpdateMode`, `ParquetCompression`, `ColumnOptions`,
`WriteConfig`, `EncodingConfig`, `ManifestConfig` and `StorageConfig`. The
rollup, scheduler and cache knobs wait for the slices that port those
layers; a config that asks for a layer the port lacks (bloom filters) is
refused when storage opens.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from horaedb_tpu_torch.common.size_ext import ReadableSize
from horaedb_tpu_torch.common.time_ext import ReadableDuration


class UpdateMode(enum.Enum):
    """How duplicate primary keys merge at read time."""

    OVERWRITE = "Overwrite"  # keep the row with max sequence
    APPEND = "Append"        # keep every row


class ParquetCompression(enum.Enum):
    UNCOMPRESSED = "none"
    SNAPPY = "snappy"
    LZ4 = "lz4"
    ZSTD = "zstd"
    GZIP = "gzip"


@dataclass
class ColumnOptions:
    """Per-column parquet overrides."""

    enable_dict: bool | None = None
    enable_bloom_filter: bool | None = None
    encoding: str | None = None
    compression: str | None = None


@dataclass
class WriteConfig:
    """Parquet writer knobs."""

    max_row_group_size: int = 8192
    write_batch_size: int = 1024
    enable_sorting_columns: bool = True
    enable_dict: bool = False
    enable_bloom_filter: bool = False
    compression: ParquetCompression = ParquetCompression.SNAPPY
    column_options: dict | None = None


@dataclass
class EncodingConfig:
    """Encoded-lane SST sidecars (storage/encoding.py): the
    compressed-domain scan's write side.

    When enabled, every SST write also emits a `{id}.enc` sidecar holding
    per-lane columnar encodings (dict/rle/dod/xor) with per-page zone
    maps, and the SST is registered as format v2; readers evaluate
    predicates on the encoded form and decode the kept pages through
    ops/decode.py. Disabled tables write plain v1 SSTs. Per-lane codec
    choice is by measured encoded size, never configured."""

    enabled: bool = False
    # rows per encoded page (zone-map/pruning granule, shared across lanes)
    page_rows: int = 4096
    # dictionary-encoding cardinality ceiling per lane
    max_dict: int = 4096
    # SSTs below this row count skip the sidecar (the fixed header/page
    # overhead outweighs any decode win on tiny registration batches)
    min_rows: int = 256
    # explicit lane allowlist; None encodes every eligible numeric lane
    lanes: "list[str] | None" = None
    # reader-side decoded-sidecar cache budget (LRU by resident bytes);
    # 0 disables caching
    sidecar_cache: ReadableSize = field(default_factory=lambda: ReadableSize.mb(32))


@dataclass
class ManifestConfig:
    """Manifest merger thresholds: above the soft limit a merge is
    scheduled; above the hard limit writes are rejected until the merger
    catches up."""

    channel_size: int = 3
    merge_interval: ReadableDuration = field(default_factory=lambda: ReadableDuration.secs(5))
    min_merge_threshold: int = 10
    soft_merge_threshold: int = 50
    hard_merge_threshold: int = 90


@dataclass
class StorageConfig:
    """`scan_block_rows`: the most rows one merge pass of a segment scan
    holds; a larger multi-SST segment takes the chunked scan."""

    write: WriteConfig = field(default_factory=WriteConfig)
    encoding: EncodingConfig = field(default_factory=EncodingConfig)
    manifest: ManifestConfig = field(default_factory=ManifestConfig)
    update_mode: UpdateMode = UpdateMode.OVERWRITE
    scan_block_rows: int = 32 * 1024 * 1024
