"""The stable-time tracker factory (counterpart of
antidote_tpu/meta/device_stable.py).

Port: only :func:`make_stable_tracker` is here.  On one card it returns
the host fold (``StableTimeTracker``, meta/gossip.py), as the JAX
factory does below two devices.  The device-collective tracker
(``DeviceStableTimeTracker``: partition rows on their chips, the GST a
cross-chip min) comes with the mesh (ROADMAP §1 item 5); where the JAX
factory would build it, this one raises ``NotImplementedError``, as
``txn/node.py`` does for the same configuration.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from antidote_tpu_torch.meta.gossip import StableTimeTracker


def make_stable_tracker(config, dc_id, n_partitions: int,
                        placement: Optional[List[int]] = None,
                        **kw) -> StableTimeTracker:
    """Tracker factory honoring the node's placement policy: the host
    fold, and ``NotImplementedError`` where the JAX package would build
    the device-collective plane (the data plane ring-placed over more
    than one device).  ``placement`` maps row index -> device index
    for callers whose rows are a slice of a larger ring."""
    if (config is not None and config.device_store
            and config.device_placement == "ring"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "device_placement='ring' over several cards folds the "
            "stable time on the devices (meta/device_stable.py), which "
            "the port has not yet (ROADMAP §1 item 5)")
    return StableTimeTracker(dc_id, n_partitions, **kw)
