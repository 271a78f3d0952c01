"""The packed OR-Set read kernel's share of its roofline: the least
time the card could move the bytes that the traced steps' reads of
every key need (from the shard's shape and the ops the stream holds in
the ring, ``portbench/lib/roofline.py``) over the kernel's device time
in the trace (mode 0 of ``orset_kernel`` in ``csrc/orset_kernels.cu``)."""

import re

from portbench.lib import roofline

KERNEL = re.compile(r"orset_kernel<[^,<>]+, ?0>")


def read(ctx):
    tr = ctx["trace"]
    nbytes = ctx["layer"].get("kernel_bytes", {}).get("orset_read_packed")
    if tr is None or not nbytes:
        return None
    sec, n = tr.kernel(KERNEL)
    if not n:
        return None
    return 100.0 * roofline.bound_s(nbytes) / sec
