"""The packed OR-Set GC kernel's share of its roofline: the least
time the card could move the bytes that the traced steps' GC folds need
(from the shard's shape and the ops the stream holds in the ring,
``portbench/lib/roofline.py``) over the kernel's device time in the
trace (mode 2 of ``orset_kernel`` in ``csrc/orset_kernels.cu``)."""

import re

from portbench.lib import roofline

KERNEL = re.compile(r"orset_kernel<[^,<>]+, ?2>")


def read(ctx):
    tr = ctx["trace"]
    nbytes = ctx["layer"].get("kernel_bytes", {}).get("orset_gc_packed")
    if tr is None or not nbytes:
        return None
    sec, n = tr.kernel(KERNEL)
    if not n:
        return None
    return 100.0 * roofline.bound_s(nbytes) / sec
