"""Open stored state written elsewhere with the port.

For this database the stored SST tree takes the place a model's weights
have. The JAX package and the port share one object layout (parquet SSTs,
the manifest snapshot and its protobuf deltas), so a root the JAX package
wrote in a `LocalStore` directory opens here as it is, and the port's own
roots open in the JAX package.
"""

from __future__ import annotations

import pyarrow as pa

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device
from horaedb_tpu_torch.objstore import LocalStore
from horaedb_tpu_torch.storage.config import StorageConfig
from horaedb_tpu_torch.storage.storage import ObjectBasedStorage


async def open_local_root(directory: str, root: str, arrow_schema: pa.Schema,
                          num_primary_keys: int, segment_duration_ms: int,
                          config: StorageConfig | None = None,
                          device=DEFAULT_DEVICE) -> ObjectBasedStorage:
    """The table `root` of the `LocalStore` at `directory`, opened by the
    port (no background merger, no compaction). Opening folds leftover
    manifest deltas into the snapshot, as the JAX package's open does."""
    device = resolve_device(device)  # before anything touches the directory
    return await ObjectBasedStorage.try_new(
        root, LocalStore(directory), arrow_schema, num_primary_keys, segment_duration_ms,
        config=config, enable_compaction_scheduler=False, start_background_merger=False,
        device=device,
    )
