"""Vector clocks: the host algebra (``vc``) and the dense tensor kernels
(``dense``)."""

from antidote_tpu_torch.clocks.vc import VC, ClockDomain, vc_max, vc_min  # noqa: F401
from antidote_tpu_torch.clocks import dense  # noqa: F401
