"""A seeded causal editing history of a partition of RGA documents
over DCs, in the port's ``Payload`` form: the RGA device plane's tests
on the CPU against the JAX package (tests/test_torch_rga_plane.py) and
on the card against the CPU (tests/test_torch_cuda.py) share it.
Nothing here imports JAX (``torch_parity`` does), so the card suite,
which runs where JAX is absent, can import it."""

import numpy as np

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.mat.materializer import Payload


def docs_history(seed, tiers=((1, 24), (1, 12), (2, 6), (4, 3)), ticks=24,
                 lag=2, gst_lag=4, p_delete=0.3,
                 actors=("dc-c", "dc-a", "dc-b")):
    """A causal editing history of a partition of RGA documents over
    ``len(actors)`` DCs, as DC 0 receives it, in ``Payload`` form.
    ``tiers`` gives (documents, ops a tick a document): DC 0 makes the
    rest of a document's ops after the other DCs make a third each.
    Each tick, every DC first receives the other DCs' ops of ``lag``
    ticks before, then types its ops document by document: a delete of
    a random vertex still visible there (``p_delete``), else an insert
    after a random vertex seen there (or the head).  Lamport times are a
    document's; commit times are a DC's, over every document, and an
    op's snapshot VC is what its DC had received (its own column its
    last commit).  DC k's author is ``actors[k]``: DC 0's sorts after
    the others', so each document meets its actors out of string order.

    Returns a list of ticks, each (payloads in DC 0's delivery order:
    the other DCs' ops of t - lag, then its own; DC 0's snapshot VC at
    the tick's end; the GST then: every DC's commits ``gst_lag`` ticks
    old, None before)."""
    rng = np.random.default_rng(seed)
    n = len(actors)
    dcs = [f"dc{k}" for k in range(n)]
    docs = [(f"doc{i}", per) for i, (count, per) in enumerate(
        (c, p) for c, p in tiers for _ in range(c))]
    known = [[0] * n for _ in range(n)]
    lam = [{d: 0 for d, _ in docs} for _ in range(n)]
    seen = [{d: [(0, "")] for d, _ in docs} for _ in range(n)]
    vis = [{d: [] for d, _ in docs} for _ in range(n)]
    made, ct_end, out = [], [], []
    for t in range(ticks):
        mine = []
        for k in range(n):
            if t >= lag:
                for j in range(n):
                    for p in made[t - lag][j] if j != k else ():
                        known[k][j] = max(known[k][j], p.commit_time)
                        uid = p.effect[1]
                        lam[k][p.key] = max(lam[k][p.key], uid[0])
                        if p.effect[0] == "ins":
                            seen[k][p.key].append(uid)
                            vis[k][p.key].append(uid)
                        elif uid in vis[k][p.key]:
                            vis[k][p.key].remove(uid)
            ps = []
            for doc, per in docs:
                rest = per // n
                for _ in range(per - (n - 1) * rest if k == 0 else rest):
                    ss = VC({dcs[j]: c for j, c in enumerate(known[k])
                              if c})
                    known[k][k] += 1
                    lam[k][doc] += 1
                    live = vis[k][doc]
                    if live and rng.random() < p_delete:
                        eff = ("rm", live.pop(int(rng.integers(len(live)))))
                    else:
                        at = seen[k][doc]
                        ref = at[int(rng.integers(len(at)))]
                        uid = (lam[k][doc], actors[k])
                        at.append(uid)
                        live.append(uid)
                        eff = ("ins", uid, ref, 32 + int(rng.integers(95)))
                    ps.append(Payload(
                        key=doc, type_name="rga", effect=eff,
                        commit_dc=dcs[k], commit_time=known[k][k],
                        snapshot_vc=ss, txid=(k, known[k][k])))
            mine.append(ps)
        made.append(mine)
        ct_end.append([known[k][k] for k in range(n)])
        delivered = [p for j in range(1, n) for p in made[t - lag][j]] \
            if t >= lag else []
        gst = VC({dcs[j]: c for j, c in enumerate(ct_end[t - gst_lag])
                   if c}) if t >= gst_lag else None
        out.append((delivered + mine[0],
                    VC({dcs[j]: c for j, c in enumerate(known[0]) if c}),
                    gst))
    return out

