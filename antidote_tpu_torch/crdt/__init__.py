"""CRDT type system — op-based types matching the reference's antidote_crdt
behaviour (downstream/update split).  Importing this package registers all
thirteen types:

counters: counter_pn, counter_fat, counter_b
registers: register_lww, register_mv
sets: set_go, set_aw, set_rw
flags: flag_ew, flag_dw
maps: map_go, map_rr
sequences: rga
"""

from antidote_tpu_torch.crdt.base import (  # noqa: F401
    CRDT,
    DownstreamCtx,
    DownstreamError,
    all_types,
    get_type,
    is_type,
)
from antidote_tpu_torch.crdt.counters import CounterB, CounterFat, CounterPN  # noqa: F401
from antidote_tpu_torch.crdt.registers import RegisterLWW, RegisterMV  # noqa: F401
from antidote_tpu_torch.crdt.sets import SetAW, SetGO, SetRW  # noqa: F401
from antidote_tpu_torch.crdt.flags import FlagDW, FlagEW  # noqa: F401
from antidote_tpu_torch.crdt.maps import MapGO, MapRR  # noqa: F401
from antidote_tpu_torch.crdt.rga import RGA  # noqa: F401
