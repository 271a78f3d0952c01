"""Observability of the port: the txid-correlated span tracer
(:mod:`antidote_tpu_torch.obs.spans`), the per-subsystem flight recorder
(:mod:`antidote_tpu_torch.obs.events`), the online self-checks
(:mod:`antidote_tpu_torch.obs.probe`) and the device profiler's named
ranges (:mod:`antidote_tpu_torch.obs.prof`).  Everything here is
process-global, like ``stats.registry``."""

from __future__ import annotations

from antidote_tpu_torch.obs.events import FlightRecorder, recorder  # noqa: F401
from antidote_tpu_torch.obs.spans import Span, Tracer, tracer  # noqa: F401


def configure(sample_rate: float | None = None,
              capacity: int | None = None,
              dump_dir: str | None = None,
              selfcheck_set_aw: float | None = None,
              kernel_profile: bool | None = None) -> None:
    """Apply config knobs to the process-global tracer/recorder/probe
    (Node.__init__ forwards Config.trace_sample_rate & friends here).
    ``None`` leaves a setting untouched, so tests and operators can
    override a single knob without reciting the rest.

    Port of antidote_tpu/obs/__init__.configure: the port has no
    ``DeviceProfiler`` yet (ROADMAP §1 item 3), so ``kernel_profile=True``
    raises ``NotImplementedError`` before any knob is applied, and
    ``kernel_profile=False`` has nothing to turn off."""
    from antidote_tpu_torch.obs import probe as _probe

    if kernel_profile:
        raise NotImplementedError(
            "obs.configure(kernel_profile=True): the port has no device "
            "profiler yet (ROADMAP §1 item 3)")
    if sample_rate is not None:
        tracer.sample_rate = float(sample_rate)
    if capacity is not None:
        tracer.set_capacity(int(capacity))
    if dump_dir is not None:
        recorder.dump_dir = dump_dir
    if selfcheck_set_aw is not None:
        _probe.SELF_CHECK_RATE = float(selfcheck_set_aw)
