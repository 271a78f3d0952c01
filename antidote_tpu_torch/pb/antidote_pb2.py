# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: antidote.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0e\x61ntidote.proto\x12\nantidotepb\"\xf0\x01\n\x07\x41pbTerm\x12\x11\n\x07integer\x18\x01 \x01(\x12H\x00\x12\x10\n\x06\x62inary\x18\x02 \x01(\x0cH\x00\x12\x0e\n\x04text\x18\x03 \x01(\tH\x00\x12\x11\n\x07\x62oolean\x18\x04 \x01(\x08H\x00\x12\x10\n\x06number\x18\x05 \x01(\x01H\x00\x12\'\n\x05tuple\x18\x06 \x01(\x0b\x32\x16.antidotepb.ApbTermSeqH\x00\x12&\n\x04list\x18\x07 \x01(\x0b\x32\x16.antidotepb.ApbTermSeqH\x00\x12%\n\x03map\x18\x08 \x01(\x0b\x32\x16.antidotepb.ApbTermMapH\x00\x12\x0e\n\x04none\x18\t \x01(\x08H\x00\x42\x03\n\x01t\"0\n\nApbTermSeq\x12\"\n\x05items\x18\x01 \x03(\x0b\x32\x13.antidotepb.ApbTerm\"4\n\nApbTermMap\x12&\n\x05pairs\x18\x01 \x03(\x0b\x32\x17.antidotepb.ApbTermPair\"S\n\x0b\x41pbTermPair\x12 \n\x03key\x18\x01 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.antidotepb.ApbTerm\"e\n\x0e\x41pbBoundObject\x12 \n\x03key\x18\x01 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\x0c\n\x04type\x18\x02 \x01(\t\x12#\n\x06\x62ucket\x18\x03 \x01(\x0b\x32\x13.antidotepb.ApbTerm\"\x9d\x01\n\x10\x41pbTxnProperties\x12\x1b\n\x13ignore_client_clock\x18\x01 \x01(\x08\x12\x35\n\x07\x63\x65rtify\x18\x02 \x01(\x0e\x32$.antidotepb.ApbTxnProperties.Certify\"5\n\x07\x43\x65rtify\x12\x0b\n\x07\x44\x45\x46\x41ULT\x10\x00\x12\x0b\n\x07\x43\x45RTIFY\x10\x01\x12\x10\n\x0c\x44ONT_CERTIFY\x10\x02\"k\n\x13\x41pbStartTransaction\x12\"\n\x05\x63lock\x18\x01 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\x30\n\nproperties\x18\x02 \x01(\x0b\x32\x1c.antidotepb.ApbTxnProperties\"G\n\x17\x41pbStartTransactionResp\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0c\n\x04txid\x18\x02 \x01(\x0c\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"K\n\x0e\x41pbReadObjects\x12+\n\x07objects\x18\x01 \x03(\x0b\x32\x1a.antidotepb.ApbBoundObject\x12\x0c\n\x04txid\x18\x02 \x01(\x0c\"Y\n\x12\x41pbReadObjectsResp\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12#\n\x06values\x18\x02 \x03(\x0b\x32\x13.antidotepb.ApbTerm\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"t\n\x0b\x41pbUpdateOp\x12*\n\x06object\x18\x01 \x01(\x0b\x32\x1a.antidotepb.ApbBoundObject\x12\x11\n\toperation\x18\x02 \x01(\t\x12&\n\tparameter\x18\x03 \x01(\x0b\x32\x13.antidotepb.ApbTerm\"J\n\x10\x41pbUpdateObjects\x12(\n\x07updates\x18\x01 \x03(\x0b\x32\x17.antidotepb.ApbUpdateOp\x12\x0c\n\x04txid\x18\x02 \x01(\x0c\"2\n\x10\x41pbOperationResp\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"$\n\x14\x41pbCommitTransaction\x12\x0c\n\x04txid\x18\x01 \x01(\x0c\"#\n\x13\x41pbAbortTransaction\x12\x0c\n\x04txid\x18\x01 \x01(\x0c\"Z\n\rApbCommitResp\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12)\n\x0c\x63ommit_clock\x18\x02 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"\x99\x01\n\x14\x41pbStaticReadObjects\x12\"\n\x05\x63lock\x18\x01 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\x30\n\nproperties\x18\x02 \x01(\x0b\x32\x1c.antidotepb.ApbTxnProperties\x12+\n\x07objects\x18\x03 \x03(\x0b\x32\x1a.antidotepb.ApbBoundObject\"\x8a\x01\n\x18\x41pbStaticReadObjectsResp\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12#\n\x06values\x18\x02 \x03(\x0b\x32\x13.antidotepb.ApbTerm\x12)\n\x0c\x63ommit_clock\x18\x03 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\r\n\x05\x65rror\x18\x04 \x01(\t\"\x98\x01\n\x16\x41pbStaticUpdateObjects\x12\"\n\x05\x63lock\x18\x01 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\x30\n\nproperties\x18\x02 \x01(\x0b\x32\x1c.antidotepb.ApbTxnProperties\x12(\n\x07updates\x18\x03 \x03(\x0b\x32\x17.antidotepb.ApbUpdateOp\"\x1c\n\x1a\x41pbGetConnectionDescriptor\"T\n\x1e\x41pbGetConnectionDescriptorResp\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x12\n\ndescriptor\x18\x02 \x01(\x0c\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"&\n\x0f\x41pbConnectToDcs\x12\x13\n\x0b\x64\x65scriptors\x18\x01 \x03(\x0c\"\x1c\n\x0b\x41pbCreateDc\x12\r\n\x05nodes\x18\x01 \x03(\t\"\x10\n\x0e\x41pbAdminStatus\"W\n\x12\x41pbAdminStatusResp\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12!\n\x04info\x18\x02 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"\x1a\n\nApbGetFlag\x12\x0c\n\x04name\x18\x01 \x01(\t\">\n\nApbSetFlag\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.antidotepb.ApbTerm\"Q\n\x0b\x41pbFlagResp\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.antidotepb.ApbTerm\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"-\n\x0c\x41pbErrorResp\x12\x0f\n\x07message\x18\x01 \x01(\t\x12\x0c\n\x04\x63ode\x18\x02 \x01(\rb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'antidote_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _APBTERM._serialized_start=31
  _APBTERM._serialized_end=271
  _APBTERMSEQ._serialized_start=273
  _APBTERMSEQ._serialized_end=321
  _APBTERMMAP._serialized_start=323
  _APBTERMMAP._serialized_end=375
  _APBTERMPAIR._serialized_start=377
  _APBTERMPAIR._serialized_end=460
  _APBBOUNDOBJECT._serialized_start=462
  _APBBOUNDOBJECT._serialized_end=563
  _APBTXNPROPERTIES._serialized_start=566
  _APBTXNPROPERTIES._serialized_end=723
  _APBTXNPROPERTIES_CERTIFY._serialized_start=670
  _APBTXNPROPERTIES_CERTIFY._serialized_end=723
  _APBSTARTTRANSACTION._serialized_start=725
  _APBSTARTTRANSACTION._serialized_end=832
  _APBSTARTTRANSACTIONRESP._serialized_start=834
  _APBSTARTTRANSACTIONRESP._serialized_end=905
  _APBREADOBJECTS._serialized_start=907
  _APBREADOBJECTS._serialized_end=982
  _APBREADOBJECTSRESP._serialized_start=984
  _APBREADOBJECTSRESP._serialized_end=1073
  _APBUPDATEOP._serialized_start=1075
  _APBUPDATEOP._serialized_end=1191
  _APBUPDATEOBJECTS._serialized_start=1193
  _APBUPDATEOBJECTS._serialized_end=1267
  _APBOPERATIONRESP._serialized_start=1269
  _APBOPERATIONRESP._serialized_end=1319
  _APBCOMMITTRANSACTION._serialized_start=1321
  _APBCOMMITTRANSACTION._serialized_end=1357
  _APBABORTTRANSACTION._serialized_start=1359
  _APBABORTTRANSACTION._serialized_end=1394
  _APBCOMMITRESP._serialized_start=1396
  _APBCOMMITRESP._serialized_end=1486
  _APBSTATICREADOBJECTS._serialized_start=1489
  _APBSTATICREADOBJECTS._serialized_end=1642
  _APBSTATICREADOBJECTSRESP._serialized_start=1645
  _APBSTATICREADOBJECTSRESP._serialized_end=1783
  _APBSTATICUPDATEOBJECTS._serialized_start=1786
  _APBSTATICUPDATEOBJECTS._serialized_end=1938
  _APBGETCONNECTIONDESCRIPTOR._serialized_start=1940
  _APBGETCONNECTIONDESCRIPTOR._serialized_end=1968
  _APBGETCONNECTIONDESCRIPTORRESP._serialized_start=1970
  _APBGETCONNECTIONDESCRIPTORRESP._serialized_end=2054
  _APBCONNECTTODCS._serialized_start=2056
  _APBCONNECTTODCS._serialized_end=2094
  _APBCREATEDC._serialized_start=2096
  _APBCREATEDC._serialized_end=2124
  _APBADMINSTATUS._serialized_start=2126
  _APBADMINSTATUS._serialized_end=2142
  _APBADMINSTATUSRESP._serialized_start=2144
  _APBADMINSTATUSRESP._serialized_end=2231
  _APBGETFLAG._serialized_start=2233
  _APBGETFLAG._serialized_end=2259
  _APBSETFLAG._serialized_start=2261
  _APBSETFLAG._serialized_end=2323
  _APBFLAGRESP._serialized_start=2325
  _APBFLAGRESP._serialized_end=2406
  _APBERRORRESP._serialized_start=2408
  _APBERRORRESP._serialized_end=2453
# @@protoc_insertion_point(module_scope)
