# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: pilosa_tpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10pilosa_tpu.proto\x12\x05proto\"-\n\x0fQueryPQLRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\x0b\n\x03pql\x18\x02 \x01(\t\"\x1e\n\x0fQuerySQLRequest\x12\x0b\n\x03sql\x18\x01 \x01(\t\",\n\x0bStatusError\x12\x0c\n\x04\x43ode\x18\x01 \x01(\r\x12\x0f\n\x07Message\x18\x02 \x01(\t\",\n\nColumnInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61tatype\x18\x02 \x01(\t\"\'\n\x07\x44\x65\x63imal\x12\r\n\x05value\x18\x01 \x01(\x03\x12\r\n\x05scale\x18\x02 \x01(\x03\"\x1b\n\x0bUint64Array\x12\x0c\n\x04vals\x18\x01 \x03(\x04\"\x1b\n\x0bStringArray\x12\x0c\n\x04vals\x18\x01 \x03(\t\"\xb1\x02\n\x0e\x43olumnResponse\x12\x13\n\tstringVal\x18\x01 \x01(\tH\x00\x12\x13\n\tuint64Val\x18\x02 \x01(\x04H\x00\x12\x12\n\x08int64Val\x18\x03 \x01(\x03H\x00\x12\x11\n\x07\x62oolVal\x18\x04 \x01(\x08H\x00\x12\x11\n\x07\x62lobVal\x18\x05 \x01(\x0cH\x00\x12,\n\x0euint64ArrayVal\x18\x06 \x01(\x0b\x32\x12.proto.Uint64ArrayH\x00\x12,\n\x0estringArrayVal\x18\x07 \x01(\x0b\x32\x12.proto.StringArrayH\x00\x12\x14\n\nfloat64Val\x18\x08 \x01(\x01H\x00\x12$\n\ndecimalVal\x18\t \x01(\x0b\x32\x0e.proto.DecimalH\x00\x12\x16\n\x0ctimestampVal\x18\n \x01(\tH\x00\x42\x0b\n\tcolumnVal\"\x94\x01\n\x0bRowResponse\x12\"\n\x07headers\x18\x01 \x03(\x0b\x32\x11.proto.ColumnInfo\x12&\n\x07\x63olumns\x18\x02 \x03(\x0b\x32\x15.proto.ColumnResponse\x12\'\n\x0bStatusError\x18\x03 \x01(\x0b\x32\x12.proto.StatusError\x12\x10\n\x08\x64uration\x18\x04 \x01(\x03\"-\n\x03Row\x12&\n\x07\x63olumns\x18\x01 \x03(\x0b\x32\x15.proto.ColumnResponse\"\x88\x01\n\rTableResponse\x12\"\n\x07headers\x18\x01 \x03(\x0b\x32\x11.proto.ColumnInfo\x12\x18\n\x04rows\x18\x02 \x03(\x0b\x32\n.proto.Row\x12\'\n\x0bStatusError\x18\x03 \x01(\x0b\x32\x12.proto.StatusError\x12\x10\n\x08\x64uration\x18\x04 \x01(\x03\"Z\n\tIdsOrKeys\x12!\n\x03ids\x18\x01 \x01(\x0b\x32\x12.proto.Uint64ArrayH\x00\x12\"\n\x04keys\x18\x02 \x01(\x0b\x32\x12.proto.StringArrayH\x00\x42\x06\n\x04type\"\x86\x01\n\x0eInspectRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12!\n\x07\x63olumns\x18\x02 \x01(\x0b\x32\x10.proto.IdsOrKeys\x12\x14\n\x0c\x66ilterFields\x18\x03 \x03(\t\x12\r\n\x05limit\x18\x04 \x01(\x04\x12\x0e\n\x06offset\x18\x05 \x01(\x04\x12\r\n\x05query\x18\x06 \x01(\t\"\x15\n\x05Index\x12\x0c\n\x04name\x18\x01 \x01(\t\"E\n\x12\x43reateIndexRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04keys\x18\x02 \x01(\x08\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\"\x15\n\x13\x43reateIndexResponse\"\x1f\n\x0fGetIndexRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"/\n\x10GetIndexResponse\x12\x1b\n\x05index\x18\x01 \x01(\x0b\x32\x0c.proto.Index\"\x13\n\x11GetIndexesRequest\"3\n\x12GetIndexesResponse\x12\x1d\n\x07indexes\x18\x01 \x03(\x0b\x32\x0c.proto.Index\"\"\n\x12\x44\x65leteIndexRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x15\n\x13\x44\x65leteIndexResponse2\xd0\x04\n\x06Pilosa\x12\x46\n\x0b\x43reateIndex\x12\x19.proto.CreateIndexRequest\x1a\x1a.proto.CreateIndexResponse\"\x00\x12\x43\n\nGetIndexes\x12\x18.proto.GetIndexesRequest\x1a\x19.proto.GetIndexesResponse\"\x00\x12=\n\x08GetIndex\x12\x16.proto.GetIndexRequest\x1a\x17.proto.GetIndexResponse\"\x00\x12\x46\n\x0b\x44\x65leteIndex\x12\x19.proto.DeleteIndexRequest\x1a\x1a.proto.DeleteIndexResponse\"\x00\x12:\n\x08QuerySQL\x12\x16.proto.QuerySQLRequest\x1a\x12.proto.RowResponse\"\x00\x30\x01\x12?\n\rQuerySQLUnary\x12\x16.proto.QuerySQLRequest\x1a\x14.proto.TableResponse\"\x00\x12:\n\x08QueryPQL\x12\x16.proto.QueryPQLRequest\x1a\x12.proto.RowResponse\"\x00\x30\x01\x12?\n\rQueryPQLUnary\x12\x16.proto.QueryPQLRequest\x1a\x14.proto.TableResponse\"\x00\x12\x38\n\x07Inspect\x12\x15.proto.InspectRequest\x1a\x12.proto.RowResponse\"\x00\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'pilosa_tpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _QUERYPQLREQUEST._serialized_start=27
  _QUERYPQLREQUEST._serialized_end=72
  _QUERYSQLREQUEST._serialized_start=74
  _QUERYSQLREQUEST._serialized_end=104
  _STATUSERROR._serialized_start=106
  _STATUSERROR._serialized_end=150
  _COLUMNINFO._serialized_start=152
  _COLUMNINFO._serialized_end=196
  _DECIMAL._serialized_start=198
  _DECIMAL._serialized_end=237
  _UINT64ARRAY._serialized_start=239
  _UINT64ARRAY._serialized_end=266
  _STRINGARRAY._serialized_start=268
  _STRINGARRAY._serialized_end=295
  _COLUMNRESPONSE._serialized_start=298
  _COLUMNRESPONSE._serialized_end=603
  _ROWRESPONSE._serialized_start=606
  _ROWRESPONSE._serialized_end=754
  _ROW._serialized_start=756
  _ROW._serialized_end=801
  _TABLERESPONSE._serialized_start=804
  _TABLERESPONSE._serialized_end=940
  _IDSORKEYS._serialized_start=942
  _IDSORKEYS._serialized_end=1032
  _INSPECTREQUEST._serialized_start=1035
  _INSPECTREQUEST._serialized_end=1169
  _INDEX._serialized_start=1171
  _INDEX._serialized_end=1192
  _CREATEINDEXREQUEST._serialized_start=1194
  _CREATEINDEXREQUEST._serialized_end=1263
  _CREATEINDEXRESPONSE._serialized_start=1265
  _CREATEINDEXRESPONSE._serialized_end=1286
  _GETINDEXREQUEST._serialized_start=1288
  _GETINDEXREQUEST._serialized_end=1319
  _GETINDEXRESPONSE._serialized_start=1321
  _GETINDEXRESPONSE._serialized_end=1368
  _GETINDEXESREQUEST._serialized_start=1370
  _GETINDEXESREQUEST._serialized_end=1389
  _GETINDEXESRESPONSE._serialized_start=1391
  _GETINDEXESRESPONSE._serialized_end=1442
  _DELETEINDEXREQUEST._serialized_start=1444
  _DELETEINDEXREQUEST._serialized_end=1478
  _DELETEINDEXRESPONSE._serialized_start=1480
  _DELETEINDEXRESPONSE._serialized_end=1501
  _PILOSA._serialized_start=1504
  _PILOSA._serialized_end=2096
# @@protoc_insertion_point(module_scope)
