"""Carry a shard's state across from numpy arrays (for example those of
the JAX package's shard states, read with ``np.asarray``): the port's
counterpart of loading weights."""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import fields

import numpy as np
import torch

from antidote_tpu_torch import resolve_device


def state_from_numpy(cls, src, device=None):
    """A ``cls`` state (one of mat/store.py's ``*ShardState`` classes or
    mat/rga_store.py's ``RgaStoreState``) holding copies of ``src``'s
    arrays, their types kept, on ``device`` (None: the card, or raise).
    ``src`` maps the class's field names to array-likes, and its int
    fields (``n_lanes``, ``actor_bits``) to ints; it may be a mapping or
    any object with those attributes, such as the JAX package's state of
    the same type."""
    dev = resolve_device(device)
    get = src.__getitem__ if isinstance(src, Mapping) else \
        lambda name: getattr(src, name)
    out = {}
    for f in fields(cls):
        v = get(f.name)
        # a copy: the port updates state in place, and must not write
        # through to the caller's arrays
        out[f.name] = int(v) if f.type in (int, "int") else \
            torch.tensor(np.asarray(v), device=dev)
    return cls(**out)
