"""Clock / metadata plane (counterpart of antidote_tpu/meta/): the host
GST fold and the metadata sender, copied verbatim.  The device tracker
(``meta/device_stable.py``, a cross-chip ``pmin``) comes with the mesh,
ROADMAP §1 item 5; on one card the live system folds on the host."""

from antidote_tpu_torch.meta.gossip import StableTimeTracker  # noqa: F401
from antidote_tpu_torch.meta.stable_store import StableMetaData  # noqa: F401
