"""The node fabric's typed-error decoder (counterpart of
antidote_tpu/cluster/link.py).

Only :func:`_raise_remote` is here, copied verbatim: the coordinator
(``txn/coordinator.py``) raises a remote partition's typed error through
it.  The fabric itself (``NodeLink``) comes with the host-only remainder
(ROADMAP §1 item 6).
"""

from __future__ import annotations


def _raise_remote(kind: str, msg: str):
    from antidote_tpu_torch.txn.manager import CertificationError

    if kind == "certification":
        raise CertificationError(msg)
    if kind == "timeout":
        raise TimeoutError(msg)
    from antidote_tpu_torch.cluster.remote import (
        HandoffParked,
        RemoteCallError,
        WrongOwner,
    )

    if kind == "wrong_owner":
        raise WrongOwner(msg)
    if kind == "parked":
        raise HandoffParked(msg)
    raise RemoteCallError(msg)
