"""antidote_tpu_torch — the PyTorch/CUDA port of antidote_tpu.

The port runs the OR-Set (``set_aw``) materializer superstep — append a
batch of committed ops into each key's ring lanes, fold the ops stable
at the GST into the base dot table, and read every key's element
presence at a read vector clock — on one NVIDIA H100, through the
hand-written CUDA kernels in ``csrc/orset_kernels.cu``; the shard store
of every other CRDT type, the RGA sequence store, and the live device
plane over them (``mat/device_plane.py``) in plain PyTorch; the causal
dependency gate (``interdc/dep.py``, its fixpoint a CUDA kernel); and
the single-DC transaction path that serves users (``api.AntidoteGPU``
over the coordinator, the partition managers, the op log and the read
serve plane), every partition's device plane on the card.

The package imports ``torch`` and never ``jax``: it carries its own
copies of what it needs from the JAX package.  Entry points that create
state run on the card unless the caller passes ``device="cpu"``;
functions that take tensors run where their tensors are.  Data crosses
between the host and the card through :func:`upload` (a pinned copy,
no wait) and :func:`to_host` (one wait a device for any number of
tensors), which every module of the package uses.
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point should build its state on.

    ``None`` means the card: it resolves to ``cuda`` and raises when no
    card is present, so a run meant for the GPU never carries on quietly
    on the CPU.  Any explicit device (``"cpu"``, ``"cuda:1"``) is taken
    as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "antidote_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To the card through a
    pinned copy and without blocking: an upload from pageable memory
    waits for the card's queue."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host(tensors) -> list:
    """numpy copies of ``tensors`` with ONE wait for the card: every
    copy is queued into pinned memory without blocking, then the host
    waits once for each device's stream."""
    devs = {t.device for t in tensors if t.is_cuda}
    if not devs:
        return [t.numpy() for t in tensors]
    outs = []
    for t in tensors:
        if t.is_cuda:
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
            t = dst
        outs.append(t)
    for dev in devs:
        torch.cuda.current_stream(dev).synchronize()
    return [t.numpy() for t in outs]
