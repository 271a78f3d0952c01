"""Clock / metadata plane (counterpart of antidote_tpu/meta/): the host
GST fold and the metadata sender, copied verbatim, and the device
tracker (``meta/device_stable.py``: the GST as each mesh device's own
min followed by the gather-min), which a ring-placed node builds over
two or more mesh devices."""

from antidote_tpu_torch.meta.gossip import StableTimeTracker  # noqa: F401
from antidote_tpu_torch.meta.stable_store import StableMetaData  # noqa: F401
