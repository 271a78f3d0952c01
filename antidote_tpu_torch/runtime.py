"""Process-level runtime state (counterpart of antidote_tpu/runtime.py).

Copied verbatim: :func:`tune_runtime` (the GC and GIL knobs a serving
process sets; the cluster's ``NodeServer`` calls it) and
:data:`COLLECTIVE_LOCK`.

Ported: the device mesh.  JAX shards over a ``jax.sharding.Mesh`` with
``shard_map``, one controller driving every chip; PyTorch has no such
program in one process, so the port keeps that design by hand:

- :class:`Mesh` is a hashable list of devices along one axis
  (``part``), one entry a shard;
- :func:`mesh_devices` is the process's device list: every CUDA card by
  default, or the list :func:`set_mesh_devices` put in its place, the
  counterpart of the process-wide
  ``--xla_force_host_platform_device_count`` (eight ``cpu`` entries for
  the CPU tests, eight entries of ``cuda:0`` to run a mesh of eight
  shards on one card);
- :func:`shard_map` runs a function once per shard on that shard's
  device, each replicated argument copied once to each device;
- :func:`pmin`, :func:`psum` and :func:`pmax` gather the shards'
  results to the mesh's first device (``tensor.to(dev)``, which orders
  itself after the source device's queued work) and reduce them there.

A mesh whose entries are not distinct CUDA cards (CPU entries, or one
card repeated) is *virtual*: the same code runs, but with no peer copy
between two cards.
"""

from __future__ import annotations

import gc
import sys
from typing import Callable, Iterable, List, Optional, Sequence

import torch

_tuned = False


def tune_runtime(switch_interval_s: float = 0.0005,
                 gc_thresholds=(50000, 50, 50)) -> None:
    """Idempotent per-process tuning; call when this process's main
    duty is serving a node (NodeServer does this automatically)."""
    global _tuned
    if _tuned:
        return
    _tuned = True
    sys.setswitchinterval(switch_interval_s)
    gc.freeze()
    gc.set_threshold(*gc_thresholds)


# ---------------------------------------------------------------------------
# the mesh


def _norm(device) -> torch.device:
    """``device`` as a torch.device with an index on CUDA (``cuda`` and
    ``cuda:0`` name one card, and a mesh compares its entries)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


class Mesh:
    """A one-axis mesh: ``devices[i]`` holds shard i.  Hashable and
    compared by its devices and axis, as JAX's ``Mesh`` is, so two
    planes sharded over the same devices group together in a fused
    read (``closure.device``)."""

    def __init__(self, devices: Iterable, axis: str = "part"):
        self.devices = tuple(_norm(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def virtual(self) -> bool:
        """True when the entries are not distinct CUDA cards."""
        return is_virtual(self.devices)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis == other.axis)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def is_virtual(devices: Sequence) -> bool:
    devs = [_norm(d) for d in devices]
    return (any(d.type != "cuda" for d in devs)
            or len(set(devs)) < len(devs))


#: the process's mesh devices when set by :func:`set_mesh_devices`
_mesh_override: Optional[List[torch.device]] = None


def set_mesh_devices(devices: Optional[Iterable]) -> Optional[list]:
    """Put ``devices`` in place of the process's mesh devices (None
    goes back to every CUDA card); returns the list it replaced, for a
    caller that restores it."""
    global _mesh_override
    prev = _mesh_override
    _mesh_override = (None if devices is None
                      else [_norm(d) for d in devices])
    return prev


def mesh_devices(device=None) -> List[torch.device]:
    """The devices a mesh or a ring placement spreads over: every CUDA
    card, or the list :func:`set_mesh_devices` set.  With ``device``
    (where a caller keeps its state), only a list of that device's kind
    is returned, else none: a node built on the CPU never places a plane
    on a card."""
    devs = (list(_mesh_override) if _mesh_override is not None
            else [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())])
    if device is not None:
        kind = torch.device(device).type
        if any(d.type != kind for d in devs):
            return []
    return devs


# ---------------------------------------------------------------------------
# one function per shard, and the collectives


def _replicate(mesh: Mesh, value) -> List:
    """``value`` (a tensor, a numpy array or None) on every shard's
    device: one copy a device, shared by the shards on one device."""
    if value is None:
        return [None] * len(mesh.devices)
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
    on = {}
    return [on.setdefault(d, t.to(d)) for d in mesh.devices]


def shard_map(fn: Callable, mesh: Mesh, sharded: Sequence = (),
              replicated: Sequence = ()) -> list:
    """``fn(i, *sharded_i, *replicated_i)`` for every shard i, on shard
    i's device, in shard order (the counterpart of JAX's ``shard_map``:
    ``sharded`` holds one list a sharded argument, its i-th entry shard
    i's part; each ``replicated`` argument is copied once to each
    device).  Returns the per-shard results."""
    reps = [_replicate(mesh, r) for r in replicated]
    return [fn(i, *(s[i] for s in sharded), *(r[i] for r in reps))
            for i in range(len(mesh.devices))]


def _gathered(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' results stacked on the mesh's first device."""
    return torch.stack([p.to(mesh.devices[0]) for p in parts])


def pmin(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' results gathered to the mesh's first device and
    reduced by elementwise min (JAX's ``lax.pmin`` over ``part``)."""
    g = _gathered(parts, mesh)
    return g.all(dim=0) if g.dtype == torch.bool else g.amin(dim=0)


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise max over the shards' results (``lax.pmax``)."""
    g = _gathered(parts, mesh)
    return g.any(dim=0) if g.dtype == torch.bool else g.amax(dim=0)


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise sum over the shards' numeric results, in their dtype
    (``lax.psum``)."""
    g = _gathered(parts, mesh)
    return g.sum(dim=0, dtype=g.dtype)


#: process-wide serialization of XLA programs containing COLLECTIVES:
#: JAX's single-controller model does not support concurrent collective
#: programs over the same devices — two threads interleaving their
#: pmin/psum programs abort inside the XLA runtime (caught by the
#: causal-checker stress loops via the device stable fold).  Every
#: collective launch site takes this lock; real deployments run one
#: node per host process, so it is uncontended there.
import threading as _threading

COLLECTIVE_LOCK = _threading.Lock()
