from antidote_tpu_torch.oplog.log import DurableLog  # noqa: F401
from antidote_tpu_torch.oplog.partition import PartitionLog  # noqa: F401
from antidote_tpu_torch.oplog.records import (  # noqa: F401
    LogRecord,
    OpId,
    TxnAssembler,
)
