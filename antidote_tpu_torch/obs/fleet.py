"""Fleet health plane: pull-based federation over every node of a
cluster (ISSUE 17).

Every observability surface before this module is per-process: the
stats registry exposes ONE process at ``/metrics``, the pipeline
registry snapshots the DCs of ONE interpreter, the span ring holds
ONE tracer's events.  A cluster verdict ("is visibility lag within
SLO *anywhere*?") needs all of them merged, so this module federates:

- :func:`parse_prometheus_text` — the exposition-format parser; the
  samples dict it returns is the lingua franca ``obs/slo.py`` judges.
- :func:`scrape_endpoint` — one remote node's ``/metrics`` +
  ``/debug/pipeline`` (and optionally ``/debug/spans``) over HTTP.
- :func:`fleet_snapshot` / :func:`merged_metrics` — every source
  (remote endpoints plus, optionally, the local in-process registry
  and pipeline plane) merged into one snapshot; merged samples carry
  a grafted ``src`` label so SLO worst-offender attribution crosses
  node boundaries.
- :class:`FleetScraper` — caller-elected scrape per the mat/serve.py
  no-background-thread discipline; the ``Config.fleet_scrape_s`` knob
  elects the optional loop in the ``obs_causal_probe_s`` mold
  (interdc/dc.py start_bg_processes is the only spawn site).

Dependency-free by design (urllib + re), like stats.py — the fleet
plane must scrape a wedged node from a bare interpreter.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import urllib.request
from typing import Dict, Iterable, List, Optional, Tuple

log = logging.getLogger(__name__)

#: parsed exposition: sample name -> [(labels, value), ...].  Histogram
#: series keep their exposition suffixes (``*_bucket`` with its ``le``
#: label, ``*_sum``, ``*_count``) — obs/slo.py's quantile math consumes
#: the cumulative buckets directly.
Samples = Dict[str, List[Tuple[Dict[str, str], float]]]

_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"   # sample name
    r"(?:\{(.*)\})?"                 # optional label body
    r"\s+(\S+)"                      # value
    r"(?:\s+-?[0-9]+)?$")            # optional timestamp (ignored)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prometheus_text(text: str) -> Samples:
    """Exposition text -> samples dict.  Lines that do not parse are
    skipped, not fatal: a half-garbled scrape of a sick node must
    still contribute the samples it did carry."""
    out: Samples = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            continue
        name, labelbody, raw = m.group(1), m.group(2), m.group(3)
        try:
            value = float(raw)  # accepts +Inf/NaN per the format
        except ValueError:
            continue
        labels = ({k: _unescape(v)
                   for k, v in _LABEL_RE.findall(labelbody)}
                  if labelbody else {})
        out.setdefault(name, []).append((labels, value))
    return out


def local_samples() -> Samples:
    """The in-process registry, round-tripped through the exposition
    text so local and remote sources are judged by identical rules."""
    from antidote_tpu_torch import stats

    return parse_prometheus_text(stats.registry.exposition())


def _http_get(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def scrape_endpoint(url: str, timeout: float = 5.0,
                    spans: bool = False) -> Dict[str, object]:
    """One node's surfaces: ``/metrics`` (mandatory — failure raises),
    ``/debug/pipeline`` (best-effort: a metrics-only endpoint still
    federates), ``/debug/spans`` when ``spans`` is set."""
    base = url.rstrip("/")
    src: Dict[str, object] = {
        "metrics": parse_prometheus_text(
            _http_get(base + "/metrics", timeout).decode(
                "utf-8", "replace"))}
    try:
        src["pipeline"] = json.loads(
            _http_get(base + "/debug/pipeline", timeout).decode(
                "utf-8", "replace"))
    except Exception as e:  # noqa: BLE001 — partial sources are sources
        src["pipeline"] = {"error": repr(e)}
    if spans:
        src["spans"] = json.loads(
            _http_get(base + "/debug/spans", timeout).decode(
                "utf-8", "replace"))
    return src


def fleet_snapshot(urls: Iterable[str] = (),
                   include_local: bool = False,
                   timeout: float = 5.0,
                   spans: bool = False) -> dict:
    """Merge every reachable source into one snapshot.  Unreachable
    endpoints land in ``errors`` (and bump the scrape-error counter)
    instead of failing the fleet — a down node is exactly when the
    health verdict matters."""
    from antidote_tpu_torch import stats

    snap: dict = {"at_us": time.time_ns() // 1000,
                  "sources": {}, "errors": {}}
    if include_local:
        from antidote_tpu_torch.obs import pipeline

        snap["sources"]["local"] = {"metrics": local_samples(),
                                    "pipeline": pipeline.snapshot()}
    for url in urls:
        try:
            snap["sources"][url] = scrape_endpoint(
                url, timeout=timeout, spans=spans)
        except Exception as e:  # noqa: BLE001 — per-source isolation
            snap["errors"][url] = repr(e)
            stats.registry.fleet_scrape_errors.inc(source=str(url))
    return snap


def merged_metrics(snapshot: dict) -> Samples:
    """Union of every source's samples with a ``src`` label grafted
    on, so a per-objective worst offender names the node it lives
    on.  Counter-kind objectives sum across sources; histogram-kind
    objectives keep per-source groups (the ``src`` label joins the
    group key like any other label)."""
    merged: Samples = {}
    for src_name, src in snapshot.get("sources", {}).items():
        for name, series in (src.get("metrics") or {}).items():
            rows = merged.setdefault(name, [])
            for labels, value in series:
                labeled = dict(labels)
                labeled["src"] = str(src_name)
                rows.append((labeled, value))
    return merged


class FleetScraper:
    """Caller-elected fleet scrape.  ``scrape_once()`` is the whole
    API — merge the sources, refresh the FLEET_* gauges, judge the
    merged samples against the default SLOs and refresh the SLO_*
    gauges.  No thread exists unless ``start()`` is called, and the
    only production ``start()`` site is the ``Config.fleet_scrape_s``
    knob gate in interdc/dc.py (the ``obs_causal_probe_s`` mold)."""

    def __init__(self, endpoints: Iterable[str] = (),
                 period_s: float = 0.0, include_local: bool = True,
                 timeout: float = 5.0, name: str = "fleet"):
        self.endpoints = list(endpoints)
        self.period_s = float(period_s)
        self.include_local = bool(include_local)
        self.timeout = float(timeout)
        self.name = str(name)
        self.rounds = 0
        self.last_snapshot: Optional[dict] = None
        self.last_verdict: Optional[dict] = None
        self._prev_scrape_s: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def scrape_once(self) -> dict:
        from antidote_tpu_torch import stats
        from antidote_tpu_torch.obs import slo

        snap = fleet_snapshot(self.endpoints,
                              include_local=self.include_local,
                              timeout=self.timeout)
        now = time.monotonic()
        # the realized inter-scrape gap IS the staleness a reader of
        # the merged snapshot pays; a wedged loop freezes the gauge
        # and shows up as Prometheus staleness/absence
        stats.registry.fleet_scrape_age.set(
            0.0 if self._prev_scrape_s is None
            else now - self._prev_scrape_s)
        self._prev_scrape_s = now
        stats.registry.fleet_sources.set(float(len(snap["sources"])))
        verdict = slo.evaluate(merged_metrics(snap))
        slo.refresh_gauges(verdict)
        snap["verdict"] = verdict
        self.last_snapshot = snap
        self.last_verdict = verdict
        self.rounds += 1
        return snap

    # ---- knob-gated loop (obs_causal_probe_s mold) ----------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-scrape-{self.name}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("fleet scrape round failed")
