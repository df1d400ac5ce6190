"""Storage of the port: parquet SSTs and a manifest in an object store,
the raw scan and the segment downsample."""

from horaedb_tpu_torch.storage.config import (
    ManifestConfig,
    StorageConfig,
    UpdateMode,
    WriteConfig,
)
from horaedb_tpu_torch.storage.sst import FileMeta, SstFile, SstPathGenerator, allocate_id
from horaedb_tpu_torch.storage.storage import ObjectBasedStorage
from horaedb_tpu_torch.storage.types import (
    ScanRequest,
    StorageSchema,
    TimeRange,
    Timestamp,
    WriteRequest,
    WriteResult,
)

__all__ = [
    "FileMeta", "ManifestConfig", "ObjectBasedStorage", "ScanRequest", "SstFile",
    "SstPathGenerator", "StorageConfig", "StorageSchema", "TimeRange", "Timestamp",
    "UpdateMode", "WriteConfig", "WriteRequest", "WriteResult", "allocate_id",
]
