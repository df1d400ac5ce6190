"""Prometheus remote-write ingest of the port: the columnar decoded form
(`ParsedWriteRequest`) and the wire decoder (`WireParser`)."""

from horaedb_tpu_torch.ingest.types import ParsedWriteRequest
from horaedb_tpu_torch.ingest.wire_parser import WireParser

__all__ = ["ParsedWriteRequest", "WireParser"]
