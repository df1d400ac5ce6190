"""Protobuf wire types of the manifest deltas.

`sst_pb2.py` and `protos/sst.proto` are byte-identical copies of the JAX
package's: the generated module registers `sst.proto` (package
`horaedb_tpu.sst`) in protobuf's default descriptor pool, and a process
that imports both packages loads the file once per copy. Identical bytes
share one registration; any change would fail as a duplicate file.
"""

from horaedb_tpu_torch.pb import sst_pb2

__all__ = ["sst_pb2"]
