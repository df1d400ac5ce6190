# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: sst.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tsst.proto\x12\x0fhoraedb_tpu.sst"\'\n\tTimeRange\x12\r\n\x05start\x18\x01 \x01(\x03\x12\x0b\n\x03end\x18\x02 \x01(\x03"\xb9\x01\n\x07SstMeta\x12\x14\n\x0cmax_sequence\x18\x01 \x01(\x04\x12\x10\n\x08num_rows\x18\x02 \x01(\r\x12\x0c\n\x04size\x18\x03 \x01(\r\x12.\n\ntime_range\x18\x04 \x01(\x0b2\x1a.horaedb_tpu.sst.TimeRange\x12\x16\n\x0eformat_version\x18\x05 \x01(\r\x120\n\tencodings\x18\x06 \x03(\x0b2\x1d.horaedb_tpu.sst.LaneEncoding"=\n\x07SstFile\x12\n\n\x02id\x18\x01 \x01(\x04\x12&\n\x04meta\x18\x02 \x01(\x0b2\x18.horaedb_tpu.sst.SstMeta"O\n\x0eManifestUpdate\x12)\n\x07to_adds\x18\x01 \x03(\x0b2\x18.horaedb_tpu.sst.SstFile\x12\x12\n\nto_deletes\x18\x02 \x03(\x04"-\n\x0cLaneEncoding\x12\x0e\n\x06column\x18\x01 \x01(\t\x12\r\n\x05codec\x18\x02 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'sst_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
# @@protoc_insertion_point(module_scope)
