"""The 99th percentile of a committed transaction's service time at the
client: from its request's send to its committed reply (retries after a
certification abort included), leaving out the time it waited in the
client's queue for a free connection.  Over the whole window, every
transaction."""

import numpy as np


def read(ctx):
    s = ctx["layer"].get("service_s")
    if not s:
        return None
    return float(np.percentile(np.asarray(s) * 1e3, 99))
