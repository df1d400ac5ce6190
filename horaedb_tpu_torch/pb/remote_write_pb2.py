# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: remote_write.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12remote_write.proto\x12\x18horaedb_tpu.remote_write\"\x8a\x01\n\x0cWriteRequest\x12\x38\n\ntimeseries\x18\x01 \x03(\x0b\x32$.horaedb_tpu.remote_write.TimeSeries\x12:\n\x08metadata\x18\x03 \x03(\x0b\x32(.horaedb_tpu.remote_write.MetricMetadataJ\x04\x08\x02\x10\x03\"\x86\x02\n\x0eMetricMetadata\x12\x41\n\x04type\x18\x01 \x01(\x0e\x32\x33.horaedb_tpu.remote_write.MetricMetadata.MetricType\x12\x1a\n\x12metric_family_name\x18\x02 \x01(\x0c\x12\x0c\n\x04help\x18\x04 \x01(\x0c\x12\x0c\n\x04unit\x18\x05 \x01(\x0c\"y\n\nMetricType\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x0b\n\x07\x43OUNTER\x10\x01\x12\t\n\x05GAUGE\x10\x02\x12\r\n\tHISTOGRAM\x10\x03\x12\x12\n\x0eGAUGEHISTOGRAM\x10\x04\x12\x0b\n\x07SUMMARY\x10\x05\x12\x08\n\x04INFO\x10\x06\x12\x0c\n\x08STATESET\x10\x07\"\xa7\x01\n\nTimeSeries\x12/\n\x06labels\x18\x01 \x03(\x0b\x32\x1f.horaedb_tpu.remote_write.Label\x12\x31\n\x07samples\x18\x02 \x03(\x0b\x32 .horaedb_tpu.remote_write.Sample\x12\x35\n\texemplars\x18\x03 \x03(\x0b\x32\".horaedb_tpu.remote_write.Exemplar\"$\n\x05Label\x12\x0c\n\x04name\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"*\n\x06Sample\x12\r\n\x05value\x18\x01 \x01(\x01\x12\x11\n\ttimestamp\x18\x02 \x01(\x03\"]\n\x08\x45xemplar\x12/\n\x06labels\x18\x01 \x03(\x0b\x32\x1f.horaedb_tpu.remote_write.Label\x12\r\n\x05value\x18\x02 \x01(\x01\x12\x11\n\ttimestamp\x18\x03 \x01(\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'remote_write_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _WRITEREQUEST._serialized_start=49
  _WRITEREQUEST._serialized_end=187
  _METRICMETADATA._serialized_start=190
  _METRICMETADATA._serialized_end=452
  _METRICMETADATA_METRICTYPE._serialized_start=331
  _METRICMETADATA_METRICTYPE._serialized_end=452
  _TIMESERIES._serialized_start=455
  _TIMESERIES._serialized_end=622
  _LABEL._serialized_start=624
  _LABEL._serialized_end=660
  _SAMPLE._serialized_start=662
  _SAMPLE._serialized_end=704
  _EXEMPLAR._serialized_start=706
  _EXEMPLAR._serialized_end=799
# @@protoc_insertion_point(module_scope)
