"""Mesh parallelism: the distributed execution layer of the port.

A port of the JAX package's `parallel/`: a mesh of slots (`mesh.py`), the
sharded downsample over it (`scan.py`) and the cross-slot sample-sort merge
and partial-grid fold (`merge.py`). The host drives one step per slot;
several slots may share one card. Multi-process bootstrap (the JAX
package's `parallel/distributed.py`: `initialize`, `global_mesh`) is not
ported yet.
"""

from horaedb_tpu_torch.parallel.mesh import make_mesh, mesh_devices
from horaedb_tpu_torch.parallel.scan import sharded_downsample, sharded_grouped_stats

__all__ = [
    "make_mesh",
    "mesh_devices",
    "sharded_downsample",
    "sharded_grouped_stats",
]
