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
functions that take tensors run where their tensors are.
"""

from __future__ import annotations

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
