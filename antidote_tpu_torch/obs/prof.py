"""Device profiler of the port (counterpart of antidote_tpu/obs/prof.py).

Only :func:`annotate` is here: the named range the device plane puts
around its flushes and folds.  The kernel spans, ``profiler.wrap`` and
the compile-cache-miss counters of the JAX module are not ported yet.
"""

from __future__ import annotations

import torch


def annotate(name: str):
    """Context manager labelling the enclosed host and device work in a
    ``torch.profiler`` trace (the JAX module's ``TraceAnnotation``);
    costs next to nothing when no profiler is recording."""
    return torch.profiler.record_function(name)
