"""The durable log's directory fsync (counterpart of
antidote_tpu/oplog/log.py).

Only :func:`_fsync_dir` is here, copied verbatim: the copied
``meta/stable_store.py`` makes its renames durable with it.  The durable
log itself (``DurableLog`` and its group-commit plane over the native
core) comes with the host-only remainder (ROADMAP §1 item 15), after the
transaction manager that writes it (item 10).
"""

from __future__ import annotations

import os

from antidote_tpu_torch.obs.spans import tracer


def _fsync_dir(d: str, instant: str = "log_dir_fsync") -> None:
    """Durable rename: fsync the containing directory so a power cut
    cannot resurrect the pre-rename inode (best-effort — not every fs
    exposes a directory fd).  The ONE copy of this discipline: the
    checkpoint writer's rename imports it too (``instant`` names the
    trace event per caller)."""
    try:
        fd = os.open(d or ".", os.O_RDONLY)
    except OSError:
        return
    tracer.instant(instant, "oplog", dir=os.path.basename(d))
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
