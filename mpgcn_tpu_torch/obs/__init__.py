"""The telemetry plane (counterpart of mpgcn_tpu/obs/): ``metrics``
(counters, gauges, histograms, the Prometheus text encoder, the
``MetricsServer`` sidecar), ``trace`` (span ids and the span log),
``flight`` (the in-memory flight recorder dumped on the failure paths),
``device`` (the card's memory gauges), ``stats`` (the ``stats`` command)
and ``perf`` (service-level objectives, the ``slo`` command, the
kernel-library cache).

Import-empty on purpose: utils/logging.py tees into ``obs.flight``, and
``obs.trace`` imports utils/logging back."""
