"""Transactions (counterpart of antidote_tpu/txn/).

The port has only ``manager.PartitionRetired`` so far, which the JAX
package's ``__init__`` does not export; every export of that
``__init__`` waits: ``HybridClock``, ``Coordinator``, ``Transaction``,
``TransactionAborted``, ``TxnProperties``, ``TxnState``,
``CertificationError`` and ``PartitionManager`` for ROADMAP §1 item 10
(``txn/manager.py`` with the serve plane), ``Node`` for item 14.
"""
