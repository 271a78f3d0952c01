from antidote_tpu_torch.txn.clock import HybridClock  # noqa: F401
from antidote_tpu_torch.txn.coordinator import (  # noqa: F401
    Coordinator,
    Transaction,
    TransactionAborted,
    TxnProperties,
    TxnState,
)
from antidote_tpu_torch.txn.manager import CertificationError, PartitionManager  # noqa: F401
from antidote_tpu_torch.txn.node import Node  # noqa: F401
