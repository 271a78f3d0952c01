"""The OR-Set superstep cell: the port's ``entry.superstep`` over one
shard of the configuration's shape, fed a stream of committed-op
batches (``traffic.orset_pool``), one superstep after another: append,
a GC fold every ``gc_every``-th step, a read of every key at the batch's
frontier.

Set-up makes the shard and a pool of batches on the card from the seed
and runs the warm-up steps.  The window cycles the pool; each cycle
advances every op's clocks by what one cycle adds to each DC's counter,
so the stream stays a valid causal history.  Once the window has closed,
the plain reference (``portbench/reference/orset.py``) replays every
step from the same generated ops and the run compares the final read of
every key, the per-element counts of sampled steps' reads and the ops
dropped for want of a lane.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import roofline
from portbench.lib import traffic as gen
from portbench.lib.harness import Cell, Check, Outcome
from portbench.lib.trace import Window, span
from portbench.reference.orset import FIELDS, OrsetReplay

INT32_MAX = 2 ** 31 - 1
#: a step's read is sampled when its index is this stride's seeded
#: residue (a prime, so the samples fall on every step of a GC group)
SAMPLE_STRIDE = 509
#: seconds of the window a traced run records
TRACE_S = 3.0


def stacked(pool: List[dict], device) -> Dict[str, torch.Tensor]:
    """The pool on ``device``, one upload a field: field -> [P, B(, D)]."""
    return {f: torch.from_numpy(np.ascontiguousarray(
        np.stack([b[f] for b in pool]))).to(device) for f in FIELDS}


class Stream:
    """The pool cycled without end: step i is batch i mod P, its clocks
    advanced by (i div P) cycles."""

    def __init__(self, pool: Dict[str, torch.Tensor], per_cycle: np.ndarray,
                 live: int):
        self.big = pool
        self.P = pool["key_idx"].shape[0]
        self.per_cycle = per_cycle
        self.step_add = torch.from_numpy(per_cycle.astype(np.int32)).to(
            pool["key_idx"].device)
        self.live = live
        self.cycle = 0

    def _advance(self) -> None:
        # the next cycle's largest clock value must stay an int32
        if (self.cycle + 2) * int(self.per_cycle.max()) > INT32_MAX:
            raise RuntimeError(
                f"the stream's int32 clocks would wrap in cycle "
                f"{self.cycle + 1} ({self.P} batches a cycle, "
                f"{int(self.per_cycle.max())} ops a DC a cycle)")
        b, add, n = self.big, self.step_add, self.live
        b["dot_seq"] += add[b["dot_dc"].long()]
        b["op_ct"] += add[b["op_dc"].long()]
        b["op_ss"][..., :n] += add[:n]
        b["obs_vv"][..., :n] += add[:n]
        self.cycle += 1

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        if i // self.P > self.cycle:
            self._advance()
        return {f: v[i % self.P] for f, v in self.big.items()}


def replay(cfg, pool_np, per_cycle, n_steps, sampled, traced, device):
    """The reference run over steps 0..n_steps-1 from the generated ops:
    returns (final presence, {sampled step: counts}, dropped ops, work),
    ``work`` the ring's contents over the steps ``traced`` (a range):
    reads, ops live at the reads, GC folds, ops live at the folds and
    the distinct keys those name."""
    K, L, E, D = cfg["keys"], cfg["lanes"], cfg["elems"], cfg["dcs"]
    ref = OrsetReplay(K, E, D, L, device)
    stream = Stream(stacked(pool_np, device), per_cycle, cfg["live_dcs"])
    counts = {}
    acc = torch.zeros(3, dtype=torch.int64, device=ref.dev)
    n_gc = 0
    for i in range(n_steps):
        ref.append(stream.batch(i))
        gc = (i + 1) % cfg["gc_every"] == 0
        if gc and i in traced:
            held = torch.cat(ref.held)
            keys = torch.cat([r["key_idx"] for r in ref.ring])[held]
            acc[1] += held.sum()
            acc[2] += torch.unique(keys).numel()
            n_gc += 1
        if gc:
            ref.gc(ref.frontier)
        if i in traced and ref.held:
            acc[0] += sum(h.sum() for h in ref.held)
        if i in sampled:
            counts[i] = ref.counts(ref.frontier).cpu()
    read_ops, gc_ops, gc_keys = acc.tolist()
    work = {"reads": len(traced), "read_ops": read_ops, "gcs": n_gc,
            "gc_ops": gc_ops, "gc_keys": gc_keys}
    return ref.presence(ref.frontier).cpu(), counts, int(ref.dropped), work


def kernel_bytes(shape, work) -> Dict[str, int]:
    """The bytes the traced steps' reads and folds need (roofline.py),
    by the port's kernel that does that work."""
    K, L, E, D, w = shape
    return {
        "orset_read_packed": (
            work["reads"] * roofline.orset_read_bytes(K, L, E, D, w, 0)
            + work["read_ops"] * roofline.op_row_bytes(D, w)),
        "orset_gc_packed": (
            work["gcs"] * roofline.orset_gc_bytes(K, L, E, D, w, 0, 0)
            + work["gc_ops"] * roofline.op_row_bytes(D, w)
            + work["gc_keys"] * (2 * E * D * w + L))}


def run(cell: Cell) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    setup = {"start_s": time.perf_counter() - cell.t_start}
    t = time.perf_counter()
    from antidote_tpu_torch import entry
    from antidote_tpu_torch.mat import store
    from antidote_tpu_torch.obs.prof import profiler

    setup["import_s"] = time.perf_counter() - t
    K, L, E, D = cfg["keys"], cfg["lanes"], cfg["elems"], cfg["dcs"]
    G, P, B = cfg["gc_every"], tr["pool"], tr["batch"]
    t = time.perf_counter()
    rng = np.random.default_rng(cell.seed)
    pool_np, per_cycle = gen.orset_pool(tr, cfg, rng)
    offset = int(rng.integers(SAMPLE_STRIDE))
    setup["pool_host_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if cell.control:
        if cell.control != "stale_read":
            raise ValueError(f"unknown control {cell.control!r}")
        prog = OrsetReplay(K, E, D, L, dev)

        def step(st, b, gc):
            prog.append(b)
            if gc:
                prog.gc(prog.frontier)
            return st, prog.presence(prog.frontier, stale=True), None
        shard = None
    else:
        shard = store.orset_shard_init(K, L, E, D,
                                       dtype=getattr(torch, cfg["dtype"]),
                                       device=dev)

        def step(st, b, gc):
            return entry.superstep(st, b, gc=gc, fused=cfg["fused"])
    stream = Stream(stacked(pool_np, dev), per_cycle, cfg["live_dcs"])
    sync()
    setup["shard_and_pool_s"] = time.perf_counter() - t

    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    samples = {}
    # the shard lives only here: a fold returns new tables, and a name
    # left on the first state would keep its tables alive
    state = {"st": shard, "present": None}
    del shard

    def advance(i: int) -> None:
        """Step i of the stream, its drops counted on the card and, at
        a sampled step, its read's per-element counts kept."""
        state["st"], present, ov = step(state["st"], stream.batch(i),
                                        (i + 1) % G == 0)
        state["present"] = present
        if ov is not None:
            dropped.add_(ov.sum())
        if i % SAMPLE_STRIDE == offset:
            samples[i] = present.sum(dim=0)

    t = time.perf_counter()
    n_warm = tr["warmup_steps"]
    for i in range(n_warm):
        with span("warmup_step"):
            advance(i)
    sync()
    setup["warmup_s"] = time.perf_counter() - t
    warm_dropped = int(dropped)

    win = Window(cell.scratch, cuda, host=False) if cell.trace else None
    if win is not None:
        profiler.reset()
        profiler.configure(detail=True)
        win.start()

    traced = {"to": None}

    def stop_trace(steps_done: int) -> None:
        if win is not None and not win.window_s:
            win.stop()
            profiler.configure(detail=False)
            traced["to"] = steps_done

    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    deadline = t0 + cell.seconds
    i = n_warm
    # the last step read is never a GC step's: its read then folds ring
    # ops on top of the dot table, which the final comparison covers
    while time.perf_counter() < deadline or i % G == 0:
        with span("superstep"):
            advance(i)
        i += 1
        if win is not None and time.perf_counter() - t0 >= TRACE_S:
            stop_trace(i)
    sync()
    t1 = time.perf_counter()
    stop_trace(i)
    n_steps = i
    steps = n_steps - n_warm
    program_dropped = int(dropped)
    window_dropped = program_dropped - warm_dropped
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    width = torch.iinfo(getattr(torch, cfg["dtype"])).bits // 8
    layer = {"shape": (K, L, E, D, width), "steps": steps}
    if win is not None:
        k = profiler.snapshot()["kernels"].get("orset_append")
        if k and k["complete_mean_s"]:
            layer["store.append_ms"] = k["complete_mean_s"] * 1e3
    merges = B * steps - window_dropped

    # the program's answers home, its state freed, then the reference
    final = state["present"].cpu()
    got_counts = {s: c.cpu() for s, c in samples.items()}
    del state, stream, samples, dropped
    if cuda:
        torch.cuda.empty_cache()
    sampled = set(got_counts)
    t = time.perf_counter()
    traced_steps = range(n_warm, traced["to"] or n_warm)
    want, want_counts, ref_dropped, work = replay(
        cfg, pool_np, per_cycle, n_steps, sampled, traced_steps, dev)
    check_s = time.perf_counter() - t
    if cuda:
        torch.cuda.empty_cache()
    off_counts = sum(not torch.equal(got_counts[s], want_counts[s])
                     for s in sampled)
    checks = [
        Check("keys_elems_differ", int((final != want).sum()), 0),
        Check("sampled_reads_differ", off_counts, 0),
        Check("dropped_ops_gap", abs(program_dropped - ref_dropped), 0),
    ]
    setup["reference_check_s"] = check_s
    if win is not None:
        layer["work"] = work
        layer["kernel_bytes"] = kernel_bytes(layer["shape"], work)
    setup["sampled_reads"] = len(sampled)
    return Outcome(
        metrics={"merges_per_s": merges / (t1 - t0), "setup_s": setup_s},
        attempted=B * steps, failed=window_dropped, checks=checks,
        setup=setup, memory_peak_bytes=peak, layer=layer, trace=win)

