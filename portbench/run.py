"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the port (``antidote_tpu_torch/``).  The cell names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); ``--trace 1`` reports the cell's
per-layer metrics (``portbench/metrics/<metric>.py``) in place of its
end-to-end ones.  The last line of standard output is the result object.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench.lib import harness

    sys.exit(harness.main(sys.argv[1:], ROOT, T_START))
