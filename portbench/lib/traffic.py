"""The one generator every traffic mix of ``portbench/traffic/`` feeds.

A mix is a data file; its ``kind`` picks the stream:

- ``static_txn``: Cure static transactions over the wire (BASELINE
  config 6's pb variant): an update increments one ``counter_pn`` key
  and adds one of ``elems`` elements to one ``set_aw`` key; a read reads
  one counter and one set.  ``update_share`` of them are updates; keys
  are drawn ``uniform`` or ``zipfian`` (YCSB's scrambled zipfian,
  :class:`ScrambledZipfian`).
- ``orset_stream``: the OR-Set superstep's committed-op batches
  (:func:`orset_batch`, a frozen copy of the port's ``mat/synth.py``
  generator, and :func:`batch_lane_offsets`).

Everything is drawn from ``numpy.random.default_rng(seed)``; the same
seed gives the same stream.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

# --------------------------------------------------------------- static txns


class ScrambledZipfian:
    """YCSB's ``ScrambledZipfianGenerator`` (core workloads'
    ``requestdistribution=zipfian``): a zipfian rank over YCSB's fixed
    item count of 10^10 with constant 0.99 (its precomputed zeta), then
    FNV-1a 64 of the rank modulo ``n`` items, so the hot keys lie spread
    over the keyspace."""

    ITEM_COUNT = 10_000_000_000
    ZETAN = 26.46902820178302
    THETA = 0.99

    def __init__(self, n: int):
        self.n = n
        t = self.THETA
        self.alpha = 1.0 / (1.0 - t)
        zeta2 = 1.0 + 0.5 ** t
        self.half_pow = 0.5 ** t
        self.eta = ((1.0 - (2.0 / self.ITEM_COUNT) ** (1.0 - t))
                    / (1.0 - zeta2 / self.ZETAN))

    def ranks(self, u: np.ndarray) -> np.ndarray:
        uz = u * self.ZETAN
        r = (self.ITEM_COUNT * np.power(self.eta * u - self.eta + 1.0,
                                        self.alpha)).astype(np.int64)
        r = np.where(uz < 1.0 + self.half_pow, 1, r)
        return np.where(uz < 1.0, 0, r).astype(np.int64)

    @staticmethod
    def fnv64(v: np.ndarray) -> np.ndarray:
        """YCSB's ``Utils.fnvhash64``: FNV over the 8 low-first octets,
        then the absolute value of the signed result."""
        h = np.full(v.shape, 0xCBF29CE484222325, dtype=np.uint64)
        x = v.astype(np.uint64)
        with np.errstate(over="ignore"):
            for _ in range(8):
                h ^= x & np.uint64(0xFF)
                h *= np.uint64(1099511628211)
                x >>= np.uint64(8)
        return np.abs(h.view(np.int64))

    def draw(self, rng, size: int) -> np.ndarray:
        return self.fnv64(self.ranks(rng.random(size))) % self.n


def key_draw(traffic: Dict[str, Any], n_keys: int):
    if traffic["key_dist"] == "uniform":
        return lambda rng, size: rng.integers(0, n_keys, size=size)
    if traffic["key_dist"] == "zipfian":
        return ScrambledZipfian(n_keys).draw
    raise ValueError(f"unknown key_dist {traffic['key_dist']!r}")


def static_txns(traffic: Dict[str, Any], n_keys: int, rng,
                n: int) -> Dict[str, np.ndarray]:
    """``n`` static transactions of the mix: ``update`` (bool), the
    counter and set key indices, the element added (updates)."""
    keys = key_draw(traffic, n_keys)
    return {"update": rng.random(n) < traffic["update_share"],
            "c_key": keys(rng, n), "s_key": keys(rng, n),
            "elem": rng.integers(0, traffic["elems"], size=n)}


# -------------------------------------------------------------- OR-Set ops


def orset_batch(rng, K: int, B: int, D: int, n_dcs: int,
                clock: np.ndarray, n_elems: int = 8,
                obs_lag: int = 1, add_share: float = 0.7) -> dict:
    """One batch of B committed OR-Set ops over K uniform keys (a frozen
    copy of the port's ``mat/synth.orset_batch``, draws in the same
    order).  ``clock`` (int32[n_dcs]) carries the per-DC commit counters
    across batches and is advanced in place; every op's snapshot VC is
    <= the batch-end frontier."""
    keys = rng.integers(0, K, size=B).astype(np.int32)
    elem = rng.integers(0, n_elems, size=B).astype(np.int32)
    is_add = rng.random(B) < add_share
    dc = rng.integers(0, n_dcs, size=B).astype(np.int32)
    ct = np.zeros(B, dtype=np.int32)
    for d in range(n_dcs):
        m = dc == d
        ct[m] = clock[d] + 1 + np.arange(m.sum(), dtype=np.int32)
        clock[d] += int(m.sum())
    ss = np.zeros((B, D), dtype=np.int32)
    ss[:, :n_dcs] = np.minimum(clock[None, :], ct[:, None] - 1)
    if obs_lag:
        lag = rng.integers(0, obs_lag + 1, size=(B, D)).astype(np.int32)
    else:
        lag = 0
    obs = np.maximum(ss - lag, 0)
    return dict(key_idx=keys, elem_slot=elem, is_add=is_add, dot_dc=dc,
                dot_seq=ct, obs_vv=obs, op_dc=dc.copy(), op_ct=ct.copy(),
                op_ss=ss)


def batch_lane_offsets(key_idx: np.ndarray) -> np.ndarray:
    """The occurrence index of each key within its batch, in batch order
    (a frozen copy of the port's ``store.batch_lane_offsets``)."""
    n = len(key_idx)
    order = np.argsort(key_idx, kind="stable")
    sk = key_idx[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    run_of = np.repeat(np.arange(len(starts)), np.diff(np.r_[starts, n]))
    out = np.empty(n, dtype=np.int32)
    out[order] = np.arange(n) - starts[run_of]
    return out


def orset_pool(traffic: Dict[str, Any], config: Dict[str, Any], rng):
    """The superstep's pool: ``traffic["pool"]`` batches drawn in order
    from one clock, each with its lane offsets, and the per-DC count of
    ops over the pool (int64[D]: what one cycle of the pool advances
    each DC's clock by)."""
    K, D, n = config["keys"], config["dcs"], config["live_dcs"]
    clock = np.zeros(n, dtype=np.int32)
    pool = []
    for _ in range(traffic["pool"]):
        s = orset_batch(rng, K, traffic["batch"], D, n, clock,
                        n_elems=config["elems"], obs_lag=traffic["obs_lag"],
                        add_share=traffic["add_share"])
        s["lane_off"] = batch_lane_offsets(s["key_idx"])
        pool.append(s)
    per_cycle = np.zeros(D, dtype=np.int64)
    per_cycle[:n] = clock
    return pool, per_cycle
