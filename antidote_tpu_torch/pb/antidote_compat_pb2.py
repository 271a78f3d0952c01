# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: antidote_tpu/pb/antidote_compat.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n%antidote_tpu/pb/antidote_compat.proto\x12\x11\x61ntidotepb.compat\"\x1f\n\x10\x41pbCounterUpdate\x12\x0b\n\x03inc\x18\x01 \x01(\x12\"\"\n\x11\x41pbGetCounterResp\x12\r\n\x05value\x18\x01 \x02(\x11\"\x87\x01\n\x0c\x41pbSetUpdate\x12\x39\n\x06optype\x18\x01 \x02(\x0e\x32).antidotepb.compat.ApbSetUpdate.SetOpType\x12\x0c\n\x04\x61\x64\x64s\x18\x02 \x03(\x0c\x12\x0c\n\x04rems\x18\x03 \x03(\x0c\" \n\tSetOpType\x12\x07\n\x03\x41\x44\x44\x10\x01\x12\n\n\x06REMOVE\x10\x02\"\x1e\n\rApbGetSetResp\x12\r\n\x05value\x18\x01 \x03(\x0c\"\x1d\n\x0c\x41pbRegUpdate\x12\r\n\x05value\x18\x01 \x02(\x0c\"\x1e\n\rApbGetRegResp\x12\r\n\x05value\x18\x01 \x02(\x0c\"!\n\x0f\x41pbGetMVRegResp\x12\x0e\n\x06values\x18\x01 \x03(\x0c\"D\n\tApbMapKey\x12\x0b\n\x03key\x18\x01 \x02(\x0c\x12*\n\x04type\x18\x02 \x02(\x0e\x32\x1c.antidotepb.compat.CRDT_type\"y\n\x0c\x41pbMapUpdate\x12\x36\n\x07updates\x18\x01 \x03(\x0b\x32%.antidotepb.compat.ApbMapNestedUpdate\x12\x31\n\x0bremovedKeys\x18\x02 \x03(\x0b\x32\x1c.antidotepb.compat.ApbMapKey\"v\n\x12\x41pbMapNestedUpdate\x12)\n\x03key\x18\x01 \x02(\x0b\x32\x1c.antidotepb.compat.ApbMapKey\x12\x35\n\x06update\x18\x02 \x02(\x0b\x32%.antidotepb.compat.ApbUpdateOperation\"m\n\x0b\x41pbMapEntry\x12)\n\x03key\x18\x01 \x02(\x0b\x32\x1c.antidotepb.compat.ApbMapKey\x12\x33\n\x05value\x18\x02 \x02(\x0b\x32$.antidotepb.compat.ApbReadObjectResp\"@\n\rApbGetMapResp\x12/\n\x07\x65ntries\x18\x01 \x03(\x0b\x32\x1e.antidotepb.compat.ApbMapEntry\"\x1e\n\rApbFlagUpdate\x12\r\n\x05value\x18\x01 \x02(\x08\"\x1f\n\x0e\x41pbGetFlagResp\x12\r\n\x05value\x18\x01 \x02(\x08\"\x0e\n\x0c\x41pbCrdtReset\"8\n\x10\x41pbTxnProperties\x12\x12\n\nread_write\x18\x01 \x01(\r\x12\x10\n\x08red_blue\x18\x02 \x01(\r\"Y\n\x0e\x41pbBoundObject\x12\x0b\n\x03key\x18\x01 \x02(\x0c\x12*\n\x04type\x18\x02 \x02(\x0e\x32\x1c.antidotepb.compat.CRDT_type\x12\x0e\n\x06\x62ucket\x18\x03 \x02(\x0c\"i\n\x0e\x41pbReadObjects\x12\x37\n\x0c\x62oundobjects\x18\x01 \x03(\x0b\x32!.antidotepb.compat.ApbBoundObject\x12\x1e\n\x16transaction_descriptor\x18\x02 \x02(\x0c\"\xc0\x02\n\x12\x41pbUpdateOperation\x12\x36\n\tcounterop\x18\x01 \x01(\x0b\x32#.antidotepb.compat.ApbCounterUpdate\x12.\n\x05setop\x18\x02 \x01(\x0b\x32\x1f.antidotepb.compat.ApbSetUpdate\x12.\n\x05regop\x18\x03 \x01(\x0b\x32\x1f.antidotepb.compat.ApbRegUpdate\x12.\n\x05mapop\x18\x05 \x01(\x0b\x32\x1f.antidotepb.compat.ApbMapUpdate\x12\x30\n\x07resetop\x18\x06 \x01(\x0b\x32\x1f.antidotepb.compat.ApbCrdtReset\x12\x30\n\x06\x66lagop\x18\x07 \x01(\x0b\x32 .antidotepb.compat.ApbFlagUpdate\"\x7f\n\x0b\x41pbUpdateOp\x12\x36\n\x0b\x62oundobject\x18\x01 \x02(\x0b\x32!.antidotepb.compat.ApbBoundObject\x12\x38\n\toperation\x18\x02 \x02(\x0b\x32%.antidotepb.compat.ApbUpdateOperation\"c\n\x10\x41pbUpdateObjects\x12/\n\x07updates\x18\x01 \x03(\x0b\x32\x1e.antidotepb.compat.ApbUpdateOp\x12\x1e\n\x16transaction_descriptor\x18\x02 \x02(\x0c\"a\n\x13\x41pbStartTransaction\x12\x11\n\ttimestamp\x18\x01 \x01(\x0c\x12\x37\n\nproperties\x18\x02 \x01(\x0b\x32#.antidotepb.compat.ApbTxnProperties\"5\n\x13\x41pbAbortTransaction\x12\x1e\n\x16transaction_descriptor\x18\x01 \x02(\x0c\"6\n\x14\x41pbCommitTransaction\x12\x1e\n\x16transaction_descriptor\x18\x01 \x02(\x0c\"\x86\x01\n\x16\x41pbStaticUpdateObjects\x12;\n\x0btransaction\x18\x01 \x02(\x0b\x32&.antidotepb.compat.ApbStartTransaction\x12/\n\x07updates\x18\x02 \x03(\x0b\x32\x1e.antidotepb.compat.ApbUpdateOp\"\x87\x01\n\x14\x41pbStaticReadObjects\x12;\n\x0btransaction\x18\x01 \x02(\x0b\x32&.antidotepb.compat.ApbStartTransaction\x12\x32\n\x07objects\x18\x02 \x03(\x0b\x32!.antidotepb.compat.ApbBoundObject\"/\n\x0c\x41pbErrorResp\x12\x0e\n\x06\x65rrmsg\x18\x01 \x02(\x0c\x12\x0f\n\x07\x65rrcode\x18\x02 \x02(\r\"6\n\x10\x41pbOperationResp\x12\x0f\n\x07success\x18\x01 \x02(\x08\x12\x11\n\terrorcode\x18\x02 \x01(\r\"]\n\x17\x41pbStartTransactionResp\x12\x0f\n\x07success\x18\x01 \x02(\x08\x12\x1e\n\x16transaction_descriptor\x18\x02 \x01(\x0c\x12\x11\n\terrorcode\x18\x03 \x01(\r\"\xbb\x02\n\x11\x41pbReadObjectResp\x12\x35\n\x07\x63ounter\x18\x01 \x01(\x0b\x32$.antidotepb.compat.ApbGetCounterResp\x12-\n\x03set\x18\x02 \x01(\x0b\x32 .antidotepb.compat.ApbGetSetResp\x12-\n\x03reg\x18\x03 \x01(\x0b\x32 .antidotepb.compat.ApbGetRegResp\x12\x31\n\x05mvreg\x18\x04 \x01(\x0b\x32\".antidotepb.compat.ApbGetMVRegResp\x12-\n\x03map\x18\x06 \x01(\x0b\x32 .antidotepb.compat.ApbGetMapResp\x12/\n\x04\x66lag\x18\x07 \x01(\x0b\x32!.antidotepb.compat.ApbGetFlagResp\"o\n\x12\x41pbReadObjectsResp\x12\x0f\n\x07success\x18\x01 \x02(\x08\x12\x35\n\x07objects\x18\x02 \x03(\x0b\x32$.antidotepb.compat.ApbReadObjectResp\x12\x11\n\terrorcode\x18\x03 \x01(\r\"H\n\rApbCommitResp\x12\x0f\n\x07success\x18\x01 \x02(\x08\x12\x13\n\x0b\x63ommit_time\x18\x02 \x01(\x0c\x12\x11\n\terrorcode\x18\x03 \x01(\r\"\x88\x01\n\x18\x41pbStaticReadObjectsResp\x12\x36\n\x07objects\x18\x01 \x02(\x0b\x32%.antidotepb.compat.ApbReadObjectsResp\x12\x34\n\ncommittime\x18\x02 \x02(\x0b\x32 .antidotepb.compat.ApbCommitResp*\x84\x01\n\tCRDT_type\x12\x0b\n\x07\x43OUNTER\x10\x03\x12\t\n\x05ORSET\x10\x04\x12\n\n\x06LWWREG\x10\x05\x12\t\n\x05MVREG\x10\x06\x12\x08\n\x04GMAP\x10\x08\x12\t\n\x05RWSET\x10\n\x12\t\n\x05RRMAP\x10\x0b\x12\x0e\n\nFATCOUNTER\x10\x0c\x12\x0b\n\x07\x46LAG_EW\x10\r\x12\x0b\n\x07\x46LAG_DW\x10\x0e')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'antidote_tpu.pb.antidote_compat_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CRDT_TYPE._serialized_start=3107
  _CRDT_TYPE._serialized_end=3239
  _APBCOUNTERUPDATE._serialized_start=60
  _APBCOUNTERUPDATE._serialized_end=91
  _APBGETCOUNTERRESP._serialized_start=93
  _APBGETCOUNTERRESP._serialized_end=127
  _APBSETUPDATE._serialized_start=130
  _APBSETUPDATE._serialized_end=265
  _APBSETUPDATE_SETOPTYPE._serialized_start=233
  _APBSETUPDATE_SETOPTYPE._serialized_end=265
  _APBGETSETRESP._serialized_start=267
  _APBGETSETRESP._serialized_end=297
  _APBREGUPDATE._serialized_start=299
  _APBREGUPDATE._serialized_end=328
  _APBGETREGRESP._serialized_start=330
  _APBGETREGRESP._serialized_end=360
  _APBGETMVREGRESP._serialized_start=362
  _APBGETMVREGRESP._serialized_end=395
  _APBMAPKEY._serialized_start=397
  _APBMAPKEY._serialized_end=465
  _APBMAPUPDATE._serialized_start=467
  _APBMAPUPDATE._serialized_end=588
  _APBMAPNESTEDUPDATE._serialized_start=590
  _APBMAPNESTEDUPDATE._serialized_end=708
  _APBMAPENTRY._serialized_start=710
  _APBMAPENTRY._serialized_end=819
  _APBGETMAPRESP._serialized_start=821
  _APBGETMAPRESP._serialized_end=885
  _APBFLAGUPDATE._serialized_start=887
  _APBFLAGUPDATE._serialized_end=917
  _APBGETFLAGRESP._serialized_start=919
  _APBGETFLAGRESP._serialized_end=950
  _APBCRDTRESET._serialized_start=952
  _APBCRDTRESET._serialized_end=966
  _APBTXNPROPERTIES._serialized_start=968
  _APBTXNPROPERTIES._serialized_end=1024
  _APBBOUNDOBJECT._serialized_start=1026
  _APBBOUNDOBJECT._serialized_end=1115
  _APBREADOBJECTS._serialized_start=1117
  _APBREADOBJECTS._serialized_end=1222
  _APBUPDATEOPERATION._serialized_start=1225
  _APBUPDATEOPERATION._serialized_end=1545
  _APBUPDATEOP._serialized_start=1547
  _APBUPDATEOP._serialized_end=1674
  _APBUPDATEOBJECTS._serialized_start=1676
  _APBUPDATEOBJECTS._serialized_end=1775
  _APBSTARTTRANSACTION._serialized_start=1777
  _APBSTARTTRANSACTION._serialized_end=1874
  _APBABORTTRANSACTION._serialized_start=1876
  _APBABORTTRANSACTION._serialized_end=1929
  _APBCOMMITTRANSACTION._serialized_start=1931
  _APBCOMMITTRANSACTION._serialized_end=1985
  _APBSTATICUPDATEOBJECTS._serialized_start=1988
  _APBSTATICUPDATEOBJECTS._serialized_end=2122
  _APBSTATICREADOBJECTS._serialized_start=2125
  _APBSTATICREADOBJECTS._serialized_end=2260
  _APBERRORRESP._serialized_start=2262
  _APBERRORRESP._serialized_end=2309
  _APBOPERATIONRESP._serialized_start=2311
  _APBOPERATIONRESP._serialized_end=2365
  _APBSTARTTRANSACTIONRESP._serialized_start=2367
  _APBSTARTTRANSACTIONRESP._serialized_end=2460
  _APBREADOBJECTRESP._serialized_start=2463
  _APBREADOBJECTRESP._serialized_end=2778
  _APBREADOBJECTSRESP._serialized_start=2780
  _APBREADOBJECTSRESP._serialized_end=2891
  _APBCOMMITRESP._serialized_start=2893
  _APBCOMMITRESP._serialized_end=2965
  _APBSTATICREADOBJECTSRESP._serialized_start=2968
  _APBSTATICREADOBJECTSRESP._serialized_end=3104
# @@protoc_insertion_point(module_scope)
