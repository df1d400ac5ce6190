"""Storage configuration of the port: the knobs this slice's path reads.

Copied from the JAX package's `storage/config.py` (same names, same
defaults); the parquet, encoding, rollup, manifest and scheduler knobs wait
for the slices that port those layers.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class UpdateMode(enum.Enum):
    """How duplicate primary keys merge at read time."""

    OVERWRITE = "Overwrite"  # keep the row with max sequence
    APPEND = "Append"        # concatenate binary value columns


@dataclass
class StorageConfig:
    """`scan_block_rows`: the most rows one device pass of a segment
    scan may hold. A larger multi-run segment needs the chunked scan,
    which this slice does not port (it raises)."""

    update_mode: UpdateMode = UpdateMode.OVERWRITE
    scan_block_rows: int = 32 * 1024 * 1024

