"""Observability of the port: the txid-correlated span tracer
(:mod:`antidote_tpu_torch.obs.spans`), the per-subsystem flight recorder
(:mod:`antidote_tpu_torch.obs.events`), the online self-checks
(:mod:`antidote_tpu_torch.obs.probe`), the device profiler's kernel
spans and captures (:mod:`antidote_tpu_torch.obs.prof`), and the
pipeline snapshot, SLOs and fleet federation (``pipeline``, ``slo``,
``fleet``, copied).  Everything here is process-global, like
``stats.registry``."""

from __future__ import annotations

from antidote_tpu_torch.obs.events import FlightRecorder, recorder  # noqa: F401
from antidote_tpu_torch.obs.prof import DeviceProfiler, profiler  # noqa: F401
from antidote_tpu_torch.obs.spans import Span, Tracer, tracer  # noqa: F401


def configure(sample_rate: float | None = None,
              capacity: int | None = None,
              dump_dir: str | None = None,
              selfcheck_set_aw: float | None = None,
              kernel_profile: bool | None = None) -> None:
    """Apply config knobs to the process-global tracer/recorder/probe/
    profiler (Node.__init__ forwards Config.trace_sample_rate & friends
    here).  ``None`` leaves a setting untouched, so tests and operators
    can override a single knob without reciting the rest."""
    from antidote_tpu_torch.obs import probe as _probe

    if sample_rate is not None:
        tracer.sample_rate = float(sample_rate)
    if capacity is not None:
        tracer.set_capacity(int(capacity))
    if dump_dir is not None:
        recorder.dump_dir = dump_dir
    if selfcheck_set_aw is not None:
        _probe.SELF_CHECK_RATE = float(selfcheck_set_aw)
    if kernel_profile is not None:
        profiler.configure(enabled=bool(kernel_profile))
