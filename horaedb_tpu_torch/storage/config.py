"""Storage configuration of the port: the knobs its write, manifest and
scan paths read.

Copied from the JAX package's `storage/config.py` (same names, same
defaults): `UpdateMode`, `ParquetCompression`, `ColumnOptions`,
`WriteConfig`, `EncodingConfig`, `ManifestConfig` and `StorageConfig`. The
rollup, scheduler and cache knobs wait for the slices that port those
layers; a config that asks for a layer the port lacks (bloom filters,
encoded sidecars) is refused when storage opens.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

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
    """Encoded-lane SST sidecars (format v2). The port writes format-v1
    SSTs only, so `enabled` must stay False; the codec knobs wait for the
    decode slice."""

    enabled: bool = False


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
