"""Inter-DC replication (reference §2.3: inter_dc_* modules).

Txn stream pub/sub with opid-watermark gap repair, causal dependency
gating, and DC membership — transport-agnostic (in-process bus for
simulated DCs and tests; the C++ TCP transport for real deployments).
"""

from antidote_tpu_torch.interdc.wire import InterDcTxn  # noqa: F401
from antidote_tpu_torch.interdc.transport import InProcBus  # noqa: F401
from antidote_tpu_torch.interdc.dc import DataCenter  # noqa: F401
