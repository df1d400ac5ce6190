"""Protobuf wire types of the manifest deltas and of remote write.

`sst_pb2.py`, `remote_write_pb2.py` and `protos/{sst,remote_write}.proto`
are byte-identical copies of the JAX package's: each generated module
registers its `.proto` file (packages `horaedb_tpu.sst` and
`horaedb_tpu.remote_write`) in protobuf's default descriptor pool, and a
process that imports both packages loads each file once per copy.
Identical bytes share one registration; any change would fail as a
duplicate file.
"""

from horaedb_tpu_torch.pb import remote_write_pb2, sst_pb2

__all__ = ["remote_write_pb2", "sst_pb2"]
