"""Storage of the port: sorted in-memory runs and the segment downsample."""

from horaedb_tpu_torch.storage.config import StorageConfig, UpdateMode
from horaedb_tpu_torch.storage.storage import ObjectBasedStorage
from horaedb_tpu_torch.storage.types import TimeRange, WriteRequest

__all__ = ["ObjectBasedStorage", "StorageConfig", "TimeRange", "UpdateMode", "WriteRequest"]
