"""The operation log (counterpart of antidote_tpu/oplog/).

The port has the record types (``records.py``, copied verbatim) and the
log's directory fsync (``log._fsync_dir``).  ``DurableLog``
(``oplog/log.py``) and ``PartitionLog`` (``oplog/partition.py``) wait
for ROADMAP §1 item 10 (the transaction manager writes them) and item 15.
"""

from antidote_tpu_torch.oplog.records import (  # noqa: F401
    LogRecord,
    OpId,
    TxnAssembler,
)
