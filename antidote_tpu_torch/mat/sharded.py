"""Pod-sharding settings of the live device plane (counterpart of
antidote_tpu/mat/sharded.py).

Only the factory is here: :class:`ShardSettings` and
:func:`sharded_from_config`, which ``txn/node.py`` calls for every plane
it builds.  The sharded stores, ``ShardRouter`` and the mesh itself come
with ROADMAP §1 item 5.  What changed: the factory counts CUDA devices
(``torch.cuda.device_count()``), not jax devices, and the settings hold
no mesh.  Below two cards it returns the disabled settings, as the
reference does below two devices; where the reference would build a
mesh (``mat_sharded=True`` on two or more cards, or ``"auto"`` on two or
more cards, which are never a virtual CPU mesh) it raises
``NotImplementedError``, so a multi-card node never runs unsharded
where its configuration asked for a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ShardSettings:
    """Resolved pod-sharding knobs — built from Config by
    :func:`sharded_from_config` (the single factory).  The port builds
    no mesh yet, so ``enabled`` is always False."""

    mesh: None = None
    axis: str = "part"

    @property
    def enabled(self) -> bool:
        return self.mesh is not None


def sharded_from_config(config) -> ShardSettings:
    """Resolve ``Config.mat_sharded`` (auto / True / False) to the
    node's shard mesh: none below two CUDA devices or with the knob
    off; otherwise the reference would shard the plane over a mesh of
    every card, which the port cannot yet."""
    knob = "auto" if config is None else getattr(config, "mat_sharded",
                                                 "auto")
    if knob is False or torch.cuda.device_count() < 2:
        return ShardSettings()
    raise NotImplementedError(
        f"mat_sharded={knob!r} on {torch.cuda.device_count()} cards "
        "shards the device plane over a mesh, which the port has not "
        "yet (ROADMAP §1 item 5); set Config.mat_sharded=False")
