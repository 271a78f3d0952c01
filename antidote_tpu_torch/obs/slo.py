"""Declarative SLOs with error budgets over registered metric
families (ISSUE 17).

Every signal the system emits today is judged by a human reading
Grafana.  This module makes the judgment itself machine-readable: an
:class:`Objective` binds a registered metric family to a target, an
observation window and a burn-rate threshold; :func:`evaluate` turns
a samples dict (obs/fleet.py's parsed-exposition shape — local
registry or fleet-merged) into a structured verdict the chaos plane,
``tools/slo_report.py`` and the ``/debug/health`` endpoint all serve
verbatim.

Three objective kinds, one burn-rate algebra:

- ``quantile``  — histogram family; the fraction of observations
  above ``target`` is the bad-event fraction, the error budget is
  ``1 - quantile`` (p99 => 1% of events may be slow), and
  ``burn_rate = bad_fraction / budget_fraction``.  Judged per label
  group (per peer, per DC, per source) — the WORST group decides,
  because "p99 fine on average" is exactly the lie a per-peer SLO
  exists to catch.
- ``counter_max`` — counter family; the summed value (delta against
  an optional ``baseline`` samples snapshot, clamped >= 0) must not
  exceed ``target``.  ``target == 0`` means any event at all exhausts
  the budget (probe violations, subscriber drops).
- ``gauge_max`` — gauge family; the worst child value must stay
  under ``target`` (heartbeat age, checkpoint age).

``burn_rate <= burn_threshold`` (default 1.0 = the budget exactly
spent) is the ok line; ``budget_remaining = max(0, 1 - burn_rate)``.
Burn rates are capped at :data:`BURN_CAP` so verdicts stay strict
JSON — ``Infinity`` is not JSON, and a zero-target breach reports the
cap instead.

Counters and histograms are cumulative since process start, so an
absolute evaluation conflates ancient history with now; callers that
need "over the window" semantics snapshot samples at window start and
pass them as ``baseline`` (``tools/slo_report.py --baseline /
--save-baseline``).  ``/debug/health`` serves the since-process-start
verdict, which is the right default for a freshly deployed node and
is documented as such in monitoring/README.md.

The DEFAULT_OBJECTIVES registry below is test-pinned and swept by the
``static_suite`` slo-coverage pass: every family must be registered
in stats.py and every objective documented in monitoring/README.md's
"SLO objectives" table, both directions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

#: burn-rate cap: verdicts must stay strict JSON (``Infinity`` is
#: not), so a zero-target objective with any bad event reports this
BURN_CAP = 1e9


@dataclass(frozen=True)
class Objective:
    """One SLO: a metric family, a target, and the budget algebra
    knobs.  ``kind`` selects the evaluator (see module docstring)."""

    name: str
    family: str
    kind: str            # "quantile" | "counter_max" | "gauge_max"
    target: float
    quantile: float = 0.99       # quantile kind only
    window_s: float = 3600.0     # the window a baseline should span
    burn_threshold: float = 1.0  # burn rate at which ok flips false
    description: str = ""


#: the shipped SLO registry — swept by static_suite's slo-coverage
#: pass (family registered in stats.py, objective documented in
#: monitoring/README.md, both directions) and pinned by
#: tests/unit/test_slo.py.  Targets are deliberately loose: these are
#: availability floors for the chaos plane to gate on, not perf bars
#: (bench_gate owns those).
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective(
        name="visibility_lag_p99",
        family="antidote_vis_visibility_lag_seconds",
        kind="quantile", target=5.0, quantile=0.99,
        description="remote-update visibility lag p99 per (dc, peer) "
                    "— the GentleRain headline metric"),
    Objective(
        name="commit_latency_p99",
        family="antidote_txn_commit_latency_seconds",
        kind="quantile", target=1.0, quantile=0.99,
        description="local commit latency p99"),
    Objective(
        name="probe_violations",
        family="antidote_vis_probe_violations_total",
        kind="counter_max", target=0.0,
        description="causal-probe ordering violations — zero is the "
                    "contract (Cure's atomic visibility)"),
    Objective(
        name="probe_staleness_p99",
        family="antidote_vis_probe_staleness_seconds",
        kind="quantile", target=5.0, quantile=0.99,
        description="causal-probe write-to-read round-trip p99"),
    Objective(
        name="native_heartbeat_fresh",
        family="antidote_native_heartbeat_age_seconds",
        kind="gauge_max", target=30.0,
        description="native event-thread heartbeat age per ring — a "
                    "stalled ring ages past this"),
    Objective(
        name="subscriber_drops",
        family="antidote_native_sub_dropped_total",
        kind="counter_max", target=0.0,
        description="native hub subscriber frame drops"),
    Objective(
        name="checkpoint_age",
        family="antidote_ckpt_age_seconds",
        kind="gauge_max", target=600.0,
        description="newest checkpoint age per partition — recovery "
                    "replay cost grows past this"),
)


def _grouped(series, drop=("le",)):
    """rows -> {label-key-tuple: rows}, dropping the bucket label so
    one histogram child's cumulative series stays together."""
    groups: Dict[tuple, list] = {}
    for labels, value in series:
        key = tuple(sorted((k, v) for k, v in labels.items()
                           if k not in drop))
        groups.setdefault(key, []).append((labels, value))
    return groups


def _base_index(baseline, sample_name):
    if not baseline:
        return {}
    return {tuple(sorted(labels.items())): value
            for labels, value in baseline.get(sample_name, [])}


def _result(obj: Objective, ok: bool, burn: float, no_data: bool,
            worst: Optional[dict], extra: Optional[dict] = None):
    burn = min(float(burn), BURN_CAP)
    out = {
        "ok": bool(ok),
        "kind": obj.kind,
        "family": obj.family,
        "target": obj.target,
        "window_s": obj.window_s,
        "burn_threshold": obj.burn_threshold,
        "burn_rate": round(burn, 6),
        "budget_remaining": round(max(0.0, 1.0 - burn), 6),
        "no_data": bool(no_data),
        "worst": worst,
        "description": obj.description,
    }
    if obj.kind == "quantile":
        out["quantile"] = obj.quantile
    if extra:
        out.update(extra)
    return out


def _eval_quantile(obj: Objective, samples, baseline):
    bucket_name = obj.family + "_bucket"
    base_idx = _base_index(baseline, bucket_name)
    worst = None
    total_all = bad_all = 0.0
    for gkey, rows in _grouped(samples.get(bucket_name, ())).items():
        by_le: Dict[float, float] = {}
        for labels, value in rows:
            le = labels.get("le")
            if le is None:
                continue
            try:
                bound = float(le)
            except ValueError:
                continue
            base = base_idx.get(tuple(sorted(labels.items())), 0.0)
            by_le[bound] = max(value - base, 0.0)
        if not by_le:
            continue
        les = sorted(by_le)
        total = by_le[les[-1]]  # the +Inf cumulative tail
        if total <= 0:
            continue
        # exposition buckets are cumulative: the count at the first
        # bound >= target is the good-event count
        good = total
        for le in les:
            if le >= obj.target:
                good = by_le[le]
                break
        bad = max(total - good, 0.0)
        want = obj.quantile * total
        p_est = les[-1]
        for le in les:
            if by_le[le] >= want:
                p_est = le
                break
        allowed = max(1.0 - obj.quantile, 1e-9)
        burn = min((bad / total) / allowed, BURN_CAP)
        total_all += total
        bad_all += bad
        if worst is None or burn > worst["burn_rate"]:
            worst = {"labels": dict(gkey), "burn_rate": round(burn, 6),
                     "p_estimate": (None if p_est == float("inf")
                                    else p_est),
                     "total": total, "bad": bad}
    if worst is None:
        return _result(obj, ok=True, burn=0.0, no_data=True,
                       worst=None)
    burn = worst["burn_rate"]
    return _result(obj, ok=burn <= obj.burn_threshold, burn=burn,
                   no_data=False, worst=worst,
                   extra={"observations": total_all,
                          "bad_events": bad_all})


def _eval_counter(obj: Objective, samples, baseline):
    base_idx = _base_index(baseline, obj.family)
    worst = None
    total = 0.0
    seen = False
    for labels, value in samples.get(obj.family, ()):
        seen = True
        delta = max(
            value - base_idx.get(tuple(sorted(labels.items())), 0.0),
            0.0)
        total += delta
        if worst is None or delta > worst["value"]:
            worst = {"labels": dict(labels), "value": delta}
    if not seen:
        return _result(obj, ok=True, burn=0.0, no_data=True,
                       worst=None)
    if obj.target <= 0:
        burn = 0.0 if total <= 0 else BURN_CAP
    else:
        burn = total / obj.target
    return _result(obj, ok=burn <= obj.burn_threshold, burn=burn,
                   no_data=False, worst=worst,
                   extra={"value": total})


def _eval_gauge(obj: Objective, samples, baseline):
    worst = None
    for labels, value in samples.get(obj.family, ()):
        if worst is None or value > worst["value"]:
            worst = {"labels": dict(labels), "value": value}
    if worst is None:
        return _result(obj, ok=True, burn=0.0, no_data=True,
                       worst=None)
    if obj.target <= 0:
        burn = 0.0 if worst["value"] <= 0 else BURN_CAP
    else:
        burn = max(worst["value"], 0.0) / obj.target
    return _result(obj, ok=burn <= obj.burn_threshold, burn=burn,
                   no_data=False, worst=worst)


_KINDS = {"quantile": _eval_quantile,
          "counter_max": _eval_counter,
          "gauge_max": _eval_gauge}


def evaluate(samples, objectives: Optional[Iterable[Objective]] = None,
             baseline=None) -> dict:
    """Judge ``samples`` (obs/fleet.py shape) against the objectives.

    Returns the verdict dict: ``{at_us, ok, failing, objectives}``
    where each objective entry carries the full budget arithmetic
    (burn_rate, budget_remaining, worst offender with its labels).
    ``baseline`` (same samples shape) turns cumulative counter and
    histogram families into window deltas — missing baseline series
    are treated as zero."""
    objectives = (DEFAULT_OBJECTIVES if objectives is None
                  else tuple(objectives))
    per: Dict[str, dict] = {}
    for obj in objectives:
        try:
            ev = _KINDS[obj.kind]
        except KeyError:
            raise ValueError(
                f"objective {obj.name!r}: unknown kind {obj.kind!r}")
        per[obj.name] = ev(obj, samples, baseline)
    failing = sorted(n for n, v in per.items() if not v["ok"])
    return {"at_us": time.time_ns() // 1000,
            "ok": not failing,
            "failing": failing,
            "objectives": per}


def refresh_gauges(verdict: dict) -> None:
    """Mirror a verdict into the SLO_* gauge families so Grafana's
    error-budget panels ride the normal scrape path."""
    from antidote_tpu_torch import stats

    for name, v in verdict.get("objectives", {}).items():
        stats.registry.slo_burn_rate.set(
            v["burn_rate"], objective=name)
        stats.registry.slo_budget_remaining.set(
            v["budget_remaining"], objective=name)
        stats.registry.slo_ok.set(
            1.0 if v["ok"] else 0.0, objective=name)


def evaluate_registry(reg=None, objectives=None, baseline=None) -> dict:
    """Evaluate one process's own registry (the ``/debug/health``
    path).  Round-trips through the exposition text so the local and
    fleet paths are judged by identical parsing rules."""
    from antidote_tpu_torch import stats
    from antidote_tpu_torch.obs import fleet

    reg = stats.registry if reg is None else reg
    samples = fleet.parse_prometheus_text(reg.exposition())
    verdict = evaluate(samples, objectives=objectives,
                       baseline=baseline)
    if reg is stats.registry:
        refresh_gauges(verdict)
    return verdict


def health_json() -> str:
    """The ``/debug/health`` body: the local registry's verdict,
    cumulative since process start (see module docstring)."""
    import json

    return json.dumps(evaluate_registry(), indent=1, sort_keys=True)
