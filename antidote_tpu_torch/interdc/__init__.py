"""Inter-DC replication (counterpart of antidote_tpu/interdc/).

The port has the txn wire format (``wire.py``, ``termcodec.py``, copied
verbatim) and the causal dependency gate (``dep.py`` over the device
ring of ``gate_kernels.py``).  ``InProcBus`` (``transport.py``) and
``DataCenter`` (``dc.py``, with ``sub_buf.py`` and ``tcp.py``: the
pub/sub that feeds the gate) wait for ROADMAP §1 item 15.
"""

from antidote_tpu_torch.interdc.wire import InterDcTxn  # noqa: F401
