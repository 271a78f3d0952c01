"""Wire protocol: length-framed protobuf over TCP (the reference's
antidote_pb stack — listener, per-connection protocol loop, dispatch —
reference src/antidote_pb_sup.erl, src/antidote_pb_protocol.erl,
src/antidote_pb_process.erl).

``antidote_pb2.py`` and ``antidote_compat_pb2.py`` are byte-identical
copies of the JAX package's, never regenerated, and the ``.proto``
files are never edited: each registers its file (``antidote.proto``,
package ``antidotepb``; ``antidote_tpu/pb/antidote_compat.proto``,
package ``antidotepb.compat``) in protobuf's default descriptor pool,
which accepts a second registration only of the identical serialized
descriptor.  A process that imports both packages (every parity test
does) then shares one set of message classes between them, so the
server's dispatch by ``type(req)`` and the codec's ``MSG_CODES`` see
one class for both packages.
"""

from antidote_tpu_torch.pb.client import PbClient, PbError, PbServerError
from antidote_tpu_torch.pb.server import DEFAULT_PORT, PbServer

__all__ = ["PbClient", "PbError", "PbServerError", "PbServer",
           "DEFAULT_PORT"]
