"""Observability of the port: the txid-correlated span tracer
(:mod:`antidote_tpu_torch.obs.spans`), the per-subsystem flight recorder
(:mod:`antidote_tpu_torch.obs.events`) and the device profiler's named
ranges (:mod:`antidote_tpu_torch.obs.prof`).  Everything here is
process-global, like ``stats.registry``."""
