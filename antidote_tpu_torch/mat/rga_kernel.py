"""Batched RGA merge (PyTorch port of antidote_tpu/mat/rga_kernel.py) —
the long-sequence materialization target.

The reference materializes an RGA by splicing one op at a time into a
linked list (host oracle: antidote_tpu/crdt/rga.py).  At 100k-op
collaborative-text logs (BASELINE config 4) that sequential walk is the
bottleneck.  Here the *entire* merge is a fixed-shape parallel program:

1. **Causal tree build.**  Every insert references the vertex to its
   left; with Lamport uids (child.lamport > parent.lamport) the document
   order is exactly the preorder of the tree whose siblings are ordered
   uid-descending.  Parent resolution is a sort + searchsorted over
   packed uids; sibling order is one stable two-key sort.
2. **Euler tour.**  Each vertex gets a down-slot (enter) and an up-slot
   (leave): ``succ(down v) = down firstchild(v) | up v``,
   ``succ(up v) = down nextsib(v) | up parent(v)``.
3. **Pointer-doubling list rank** (Wyllie).  ``ceil(log2(2N))`` rounds of
   ``dist += dist[next]; next = next[next]`` turn the successor list into
   preorder ranks.

Shapes are static: N insert lanes + M delete lanes, padding lanes carry
valid=False.  uids are (lamport, actor) packed into int32 as
``lamport << actor_bits | actor`` and must stay strictly below INT32_MAX,
which the padding sentinel owns.  Duplicate delivery of the same uid is
tolerated (later copies are parked); inserts referencing a uid absent
from the log are excluded together with their subtrees.

The functions run where their tensors are, on the card or the CPU; there
is no hand-written kernel, as the JAX version reaches no Pallas call.
Three things differ from JAX's defaults and are spelled out here: every
sort is stable (``jnp.argsort`` is; ``torch.argsort`` is not unless
asked), XLA's ``mode="drop"`` scatters become :func:`set_drop` (a spare
slot sliced off: torch raises on an index past the end, and a boolean
filter would wait for the card), and the returned dtypes are those JAX
gives under x64 (argsort indices int64, searchsorted int32).  The
merges carry ``obs/prof.py``'s ``@kernel_span("mat.rga")``, as the JAX
version's do: timed in ``detail`` mode when called alone, passed
straight through when called from a wrapped store function (the
store's fold calls :func:`rga_merge_full`).
"""

from __future__ import annotations

import torch

from antidote_tpu_torch.obs.prof import kernel_span

_I32MAX = 2**31 - 1


def pack_uid(lamport, actor, actor_bits: int = 8):
    """int32 packed uid; (0, 0) (the root sentinel) packs to 0."""
    return (lamport.to(torch.int32) << actor_bits) | actor.to(torch.int32)


def argsort(a):
    """Stable argsort (int64 indices), as ``jnp.argsort``."""
    return torch.argsort(a, stable=True)


def searchsorted(sorted_arr, q):
    """Left insertion points as int32, as ``jnp.searchsorted``."""
    return torch.searchsorted(sorted_arr, q, out_int32=True)


def _lexsort2(primary, secondary):
    """argsort by (primary, secondary) via two stable argsorts."""
    o1 = argsort(secondary)
    o2 = argsort(primary[o1])
    return o1[o2]


def set_drop(size: int, fill, dtype, idx, vals):
    """``full((size,), fill).at[idx].set(vals, mode="drop")``: a write
    aimed outside [0, size) is dropped.  Such writes land in a spare
    slot that is sliced off, so nothing waits for the card.  ``vals``
    is a tensor or a Python value; the latter is filled in, as
    assigning it would first copy it to the card, which waits."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=idx.device)
    idx = torch.where((idx >= 0) & (idx < size), idx, size).long()
    if isinstance(vals, torch.Tensor):
        out[idx] = vals
    else:
        out.index_fill_(0, idx, vals)
    return out[:size]


def _shift_down(a):
    """[True, a[1:] != a[:-1]]: the first row of each run of equal keys."""
    head = torch.ones((1,), dtype=torch.bool, device=a.device)
    return torch.cat([head, a[1:] != a[:-1]])


def wyllie(succ):
    """Pointer-doubling list rank over successor slots ``succ`` (int32;
    a terminal slot points to itself).  Returns (dist int32, fin int64):
    each slot's distance to its chain's terminal and that terminal."""
    s = succ.shape[0]
    slot = torch.arange(s, dtype=torch.int32, device=succ.device)
    d = (succ != slot).to(torch.int32)
    nx = succ.long()
    for _ in range(max(1, (s - 1).bit_length())):
        # both right-hand sides read the previous round's d and nx
        d = d + d[nx]
        nx = nx[nx]
    return d, nx


def _merge_impl(ins_lamport, ins_actor, ref_lamport, ref_actor, elem, valid,
                del_lamport, del_actor, del_valid, actor_bits: int = 8):
    """Shared merge body; see :func:`rga_merge` / :func:`rga_merge_full`."""
    dev = ins_lamport.device
    n = ins_lamport.shape[0]
    root = n            # virtual root vertex index
    parked = n + 1      # where padding / unresolvable lanes go

    uid = pack_uid(ins_lamport, ins_actor, actor_bits)
    uid = torch.where(valid, uid, _I32MAX)        # park padding uids
    ref = pack_uid(ref_lamport, ref_actor, actor_bits)

    # -- parent resolution: uid -> vertex index ---------------------------
    by_uid = argsort(uid)                          # [N] int64
    sorted_uid = uid[by_uid]
    # dedup duplicate delivery: all but the first copy of a uid (the one
    # searchsorted binds to) are parked
    dup = torch.empty((n,), dtype=torch.bool, device=dev)
    dup[by_uid] = ~_shift_down(sorted_uid)
    pos = searchsorted(sorted_uid, ref)
    cpos = torch.clamp(pos, 0, n - 1).long()
    hit = (pos < n) & (sorted_uid[cpos] == ref)
    parent = torch.where(
        ref == 0, root, torch.where(hit, by_uid[cpos], parked))
    parent = torch.where(valid & ~dup, parent, parked)   # int64

    # -- sibling lists: sort by (parent, uid desc) ------------------------
    sperm = _lexsort2(parent, -uid)                # [N] vertex ids
    sparent = parent[sperm]
    first = _shift_down(sparent)
    sperm32 = sperm.to(torch.int32)
    # first_child over [0..parked]; only segment heads are written
    first_child = set_drop(n + 2, -1, torch.int32,
                           torch.where(first, sparent, n + 2), sperm32)
    same = sparent[:-1] == sparent[1:]
    next_sib = set_drop(n, -1, torch.int32,
                        torch.where(same, sperm[:-1], n), sperm32[1:])

    # -- Euler tour successors -------------------------------------------
    # slots: down_i = i for i in [0..n] (n = root), up_i = (n+1) + i
    up = n + 1
    v = torch.arange(n + 1, dtype=torch.int32, device=dev)
    fc = first_child[: n + 1]
    succ_down = torch.where(fc >= 0, fc, up + v)
    minus1 = torch.full((1,), -1, dtype=torch.int32, device=dev)
    ns = torch.cat([next_sib, minus1])
    par = torch.cat([parent.to(torch.int32),
                     torch.full((1,), root, dtype=torch.int32, device=dev)])
    succ_up = torch.where(ns >= 0, ns, up + par)
    # terminal self-loop (filled: assigning a Python value to an element
    # copies it to the card first, which waits)
    succ_up[root:].fill_(up + root)
    # parked vertices: self-loop both slots so they never rank
    parked_v = par == parked
    succ_down = torch.where(parked_v, v, succ_down)
    succ_up = torch.where(parked_v, up + v, succ_up)
    succ = torch.cat([succ_down, succ_up])         # [s]

    # -- Wyllie pointer-doubling list rank --------------------------------
    dist, fin = wyllie(succ)
    # after >= log2(s) doublings fin[x] is x's chain terminal: only
    # vertices whose tour ends at up_root are in the document (a vertex
    # under a parked/unresolvable ancestor ends at that ancestor's
    # up-slot instead — excluded, with its whole subtree)
    rank = dist[root] - dist[:n]
    reachable = valid & (parent != parked) & (fin[:n] == up + root)
    rank = torch.where(reachable, rank, _I32MAX)
    # subtree size: the tour walks 2*size-1 steps from down(v) to up(v)
    subtree = torch.where(
        reachable, torch.div(dist[:n] - dist[up:up + n] + 1, 2,
                             rounding_mode="floor"), 0).to(torch.int32)

    # -- tombstones -------------------------------------------------------
    duid = pack_uid(del_lamport, del_actor, actor_bits)
    dpos = searchsorted(sorted_uid, duid)
    dcpos = torch.clamp(dpos, 0, n - 1).long()
    dhit = del_valid & (dpos < n) & (sorted_uid[dcpos] == duid)
    deleted = set_drop(n, False, torch.bool,
                       torch.where(dhit, by_uid[dcpos], n), True)
    visible = reachable & ~deleted

    # -- materialized document -------------------------------------------
    key = torch.where(visible, rank, _I32MAX)
    doc_perm = argsort(key)
    doc = torch.where(visible[doc_perm], elem[doc_perm].to(torch.int32), -1)
    return dict(doc=doc,
                n_visible=torch.sum(visible, dtype=torch.int32),
                rank=rank, visible=visible, reachable=reachable,
                deleted=deleted, subtree=subtree, parent=parent, uid=uid)


@kernel_span("mat.rga")
def rga_merge(ins_lamport, ins_actor, ref_lamport, ref_actor, elem, valid,
              del_lamport, del_actor, del_valid, actor_bits: int = 8):
    """Merge a full RGA op log in one shot.

    Inserts: int32[N] ``ins_lamport``/``ins_actor`` (the vertex),
    ``ref_lamport``/``ref_actor`` (its left neighbour, 0 = head),
    ``elem`` (payload token), bool ``valid``; deletes: int32[M]
    ``del_lamport``/``del_actor`` (targets), bool ``del_valid``.

    Returns ``(doc, n_visible, rank, visible)``:
    - ``doc``: int32[N] — ``elem`` of visible vertices in document order,
      padded with -1;
    - ``n_visible``: int32 scalar;
    - ``rank``: int32[N] preorder position of every vertex (1-based;
      unreachable lanes get INT32_MAX);
    - ``visible``: bool[N] — inserted, not tombstoned, not padding.
    """
    r = _merge_impl(ins_lamport, ins_actor, ref_lamport, ref_actor,
                    elem, valid, del_lamport, del_actor, del_valid,
                    actor_bits)
    return r["doc"], r["n_visible"], r["rank"], r["visible"]


@kernel_span("mat.rga")
def rga_merge_full(ins_lamport, ins_actor, ref_lamport, ref_actor,
                   elem, valid, del_lamport, del_actor, del_valid,
                   actor_bits: int = 8):
    """:func:`rga_merge` variant for the incremental store's fold path
    (mat/rga_store.py).  Returns the full internals dict: ``rank``
    (preorder, 1-based, tombstones ranked — they stay in the folded base
    as splice anchors), ``reachable``, ``deleted``, ``subtree`` sizes
    (preorder sub_end = rank-1 + size, the child-splice bound),
    ``visible``, ``doc``, ``n_visible``, ``parent`` (int64 vertex index;
    N = head, N+1 = parked) and ``uid``."""
    return _merge_impl(ins_lamport, ins_actor, ref_lamport, ref_actor,
                       elem, valid, del_lamport, del_actor, del_valid,
                       actor_bits)
